"""CLI: semantic embeddings from DE features (the test block).

Counterpart of ``eeg2video_tpu/cli/inference_semantic.py``: the predictor's
output feeds ``cli.inference_eeg2video --embeddings`` as the (200, 77*768)
semantic-embedding array (reference inference_eeg2video.py:43). ``--ckpt`` is
the ``.pt`` that ``cli.train_semantic`` writes (the port's keys;
``convert.from_jax.semantic_state_dict_from_jax`` makes one from a JAX tree),
``--torch_ckpt`` the reference's eeg2text .pt. ``--int8`` runs the
weight-only-int8 runtime, one ``int8_dense`` launch a layer on the card.
``--device`` defaults to ``cuda``.
"""

import argparse

from ..data import meta
from ..data.io import load_array, save_array
from ..serving.runtimes import load_semantic_state
from ..train.semantic import predict_semantic, predict_semantic_int8
from ..utils import StandardScaler, get_logger, resolve_device

log = get_logger(__name__)


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--features", default="./data/Preprocessing/DE_1per2s/sub1.npy")
    p.add_argument("--ckpt", default="./outputs/semantic/semantic.pt")
    p.add_argument("--torch_ckpt", default=None,
                   help="reference eeg2text_40_classes.pt instead of --ckpt")
    p.add_argument("--scaler", default="./outputs/semantic/scaler.npz")
    p.add_argument("--block", type=int, default=6)
    p.add_argument("--hidden", type=int, default=10000)
    p.add_argument("--int8", action="store_true",
                   help="weight-only-int8 runtime (ops/int8_dense): a quarter of the "
                        "weight bytes a call")
    p.add_argument("--out", default="./outputs/semantic/semantic_embeddings.npy")
    p.add_argument("--device", default="cuda",
                   help="where the model runs: the card by default (fails where "
                        "there is none); 'cpu' for a dry run")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)  # fail before reading anything

    feats = load_array(args.features)  # (7, 40, 5, 62, 5)
    block = meta.reorder_by_gt(feats[args.block], args.block)
    eeg = block.reshape(-1, meta.N_CHANNELS * meta.N_BANDS)
    eeg = StandardScaler.load(args.scaler).transform(eeg)

    path = args.torch_ckpt or args.ckpt
    if args.int8:  # the int8 runtime takes the widths of the weights
        emb = predict_semantic_int8(load_semantic_state(path), eeg, device=device)
    else:
        emb = predict_semantic(load_semantic_state(path, args.hidden), eeg, device=device)
    save_array(args.out, emb)
    log.info("semantic embeddings %s -> %s", emb.shape, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
