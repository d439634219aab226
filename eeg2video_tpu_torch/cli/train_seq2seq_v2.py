"""CLI: train the Seq2Seq EEG -> latent transformer on one GPU.

Counterpart of ``eeg2video_tpu/cli/train_seq2seq_v2.py``: the contract of
reference Seq2Seq/my_autoregressive_transformer.py __main__ (L278-391) plus
the README branch flags ``--normalize`` / ``--stats_path`` saving mean_z /
std_z (+ 1e-8) to stats.npz (README.md:129-138). Writes to ``--save_path``:
``eeg_scaler.npz`` (the train split's EEG z-score), ``seq2seq.pt`` (a state
dict in the reference's keys, what ``cli.inference_seq2seq_v2 --ckpt`` and
``cli.serve --seq2seq_ckpt`` read) and the block-7 rollout
``latent_out_block7_40_classes.npy``, de-normalized. ``--device`` defaults
to ``cuda``.
"""

import argparse
import os

import numpy as np
import torch

from ..data.io import load_array, save_array
from ..models.seq2seq import Seq2SeqTransformer
from ..train.seq2seq import (Seq2SeqTrainConfig, prepare_seq2seq_data, rollout_latents,
                             train_seq2seq)
from ..utils import get_logger, resolve_device

log = get_logger(__name__)


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--eeg", default="./data/Preprocessing/Segmented_Rawf_200Hz_2s/sub1.npy")
    p.add_argument("--train_latents", default="./data/1200_latent.npy")
    p.add_argument("--test_latents", default="./data/40classes_latents.pt")
    p.add_argument("--save_path", default="./outputs/seq2seq")
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--normalize", action="store_true",
                   help="z-score latents; stats saved to --stats_path")
    p.add_argument("--stats_path", default=None, help="default: --save_path/stats.npz")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="where training runs: the card by default (fails where "
                        "there is none); 'cpu' for a dry run")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)  # fail before reading anything

    eeg = load_array(args.eeg)
    tr_eeg, tr_lat, te_eeg, _, scaler = prepare_seq2seq_data(
        eeg, load_array(args.train_latents), load_array(args.test_latents))
    # the train split's EEG scaler: inference and serving z-score raw EEG with
    # it instead of refitting from the training arrays
    os.makedirs(args.save_path, exist_ok=True)
    scaler.save(os.path.join(args.save_path, "eeg_scaler.npz"))

    if args.normalize:
        mean_z = tr_lat.mean(axis=0, keepdims=True)
        std_z = tr_lat.std(axis=0, keepdims=True) + 1e-8
        tr_lat = (tr_lat - mean_z) / std_z
        stats = args.stats_path or os.path.join(args.save_path, "stats.npz")
        os.makedirs(os.path.dirname(os.path.abspath(stats)), exist_ok=True)
        np.savez(stats, mean_z=mean_z, std_z=std_z)
        log.info("latent stats -> %s", stats)

    cfg = Seq2SeqTrainConfig(epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
                             normalize=args.normalize)
    sd, losses = train_seq2seq(tr_eeg, tr_lat, cfg, seed=args.seed, device=device)
    path = os.path.join(args.save_path, "seq2seq.pt")
    torch.save({k: v.cpu() for k, v in sd.items()}, path)

    # block-7 rollout artifact (reference L377-387)
    model = Seq2SeqTransformer().to(device).eval().requires_grad_(False)
    model.load_state_dict(sd, strict=True)
    out = rollout_latents(model, te_eeg)
    if args.normalize:
        out = out * std_z + mean_z
    save_array(os.path.join(args.save_path, "latent_out_block7_40_classes.npy"), out)
    log.info("saved rollout %s and %s (final loss %.5f)", out.shape, path, losses[-1])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
