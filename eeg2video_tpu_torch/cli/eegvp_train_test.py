"""CLI: EEG-VP 40-class benchmark over DE_1per1s features.

Counterpart of ``eeg2video_tpu/cli/eegvp_train_test.py``, the contract of
reference EEG-VP/EEG_VP_train_test.py: 7-fold leave-one-block-out per subject,
top-1 / top-5, confusion matrix, saved predictions (``sub{n}_top1.npy``,
``_preds.npy``, ``_confusion.npy``). ``--fold_parallel`` runs the seven folds
as one batched program on the one card; ``--device`` defaults to ``cuda``
(``cpu`` for a dry run).

Under a launcher (``torchrun --nproc_per_node N``; on the CPU, gloo), as
JAX's CLI decides (:37-49 there): ``--fold_parallel`` at a world of 7 or
more ranks trains the folds on a 7-rank fold mesh
(``parallel.make_fold_mesh``), one fold a rank, the ranks past it exit 0;
at a smaller world, or without ``--fold_parallel``, rank 0 runs alone and
the other ranks exit 0. Only rank 0 logs and writes.
"""

import argparse
import os

import numpy as np

from ..data import meta
from ..data.io import save_array, subject_files
from ..parallel import init_distributed, is_host0, make_fold_mesh
from ..parallel.distributed import rank, world_size
from ..train.eegvp import EEGVPConfig, run_benchmark
from ..utils import get_logger, resolve_device

log = get_logger(__name__)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--feature_dir", default="./data/Preprocessing/DE_1per1s")
    p.add_argument("--out_dir", default="./outputs/eegvp")
    p.add_argument("--subs", type=int, nargs="*", default=None)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--encoder", default="glfnet_mlp")
    p.add_argument("--fold_parallel", action="store_true",
                   help="run all 7 folds as one batched program: across a 7-rank 'fold' "
                        "mesh under a launcher of 7 or more ranks, batched on one card "
                        "otherwise (the reference loops folds serially)")
    p.add_argument("--device", default="cuda",
                   help="the card by default (fails where there is none); 'cpu' for a dry run")
    args = p.parse_args(argv)
    init_distributed(args.device)  # a launcher's group, if any, before anything else
    device = resolve_device(args.device)
    mesh = None
    if world_size() > 1:
        if args.fold_parallel and world_size() >= meta.N_BLOCKS:
            mesh = make_fold_mesh(meta.N_BLOCKS, device)
            if not mesh.active:
                return
            log.info("fold-parallel over %d ranks", meta.N_BLOCKS)
        elif rank():
            return  # rank 0 runs alone

    cfg = EEGVPConfig(epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
                      encoder=args.encoder)
    all_top1 = []
    for sub, path in subject_files(args.feature_dir, args.subs):
        feats = np.load(path)  # (7, 40, 5, 2, 62, 5)
        n_per_block = int(np.prod(feats.shape[1:4]))
        feats = feats.reshape(7, n_per_block, meta.N_CHANNELS, meta.N_BANDS).astype(np.float32)
        reps = n_per_block // meta.N_CONCEPTS  # 10 for DE_1per1s
        labels = meta.all_labels(reps)
        res = run_benchmark(feats, labels, cfg, seed=sub, verbose=is_host0(),
                            fold_parallel=args.fold_parallel, mesh=mesh, device=device)
        log.info("sub%d: top1 %.3f+-%.3f top5 %.3f+-%.3f", sub,
                 res["top1_mean"], res["top1_std"], res["top5_mean"], res["top5_std"])
        all_top1.append(res["top1_mean"])
        if is_host0():
            save_array(os.path.join(args.out_dir, f"sub{sub}_top1.npy"),
                       np.asarray([f["test_top1"] for f in res["folds"]]))
            save_array(os.path.join(args.out_dir, f"sub{sub}_preds.npy"),
                       np.stack([f["predictions"] for f in res["folds"]]))
            save_array(os.path.join(args.out_dir, f"sub{sub}_confusion.npy"),
                       np.stack([f["confusion"] for f in res["folds"]]))
    if all_top1:
        log.info("mean over subjects: top1 %.3f", float(np.mean(all_top1)))


if __name__ == "__main__":
    main()
