"""CLI: train the semantic predictor (DE features -> CLIP text space) on one GPU.

Counterpart of ``eeg2video_tpu/cli/train_semantic.py``, the contract of
reference EEG2Video_New/Semantic/eeg_text.py __main__ (L108-175): DE_1per2s
features, per-block Text_embeddings/block{i}.pt targets (the reference's
missing f-string at L128, which loads the literal 'block{i}.pt', is not
replicated), MSE, Adam 5e-4 cosine, 200 epochs, batch 32; ``--legacy`` takes
DE_1per1s window means and one text_embeddings array. Writes
``<save_path>/semantic.pt`` (a state dict in the port's keys, what
``cli.serve --semantic_ckpt`` and ``cli.inference_semantic --ckpt`` read) and
``<save_path>/scaler.npz``. ``--device`` defaults to ``cuda``; the JAX
trainer's ``--tp/--pp/--n_micro`` (multi-GPU) are refused by name.
"""

import argparse
import os

import torch

from ..data.io import load_array
from ..train.semantic import (SemanticTrainConfig, prepare_semantic_data,
                              prepare_semantic_data_legacy, train_semantic)
from ..utils import get_logger, resolve_device

log = get_logger(__name__)


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--features", default="./data/Preprocessing/DE_1per2s/sub1.npy")
    p.add_argument("--text_dir", default="./data/Text_embeddings",
                   help="dir with block{i}.pt CLIP text embeddings (i=0..5)")
    p.add_argument("--legacy", action="store_true",
                   help="legacy data plumbing: DE_1per1s window-mean features "
                        "+ a single text_embeddings.npy (reference "
                        "train_semantic_predictor.py:80-115)")
    p.add_argument("--text_embeddings", default="./data/Text_embeddings/text_embeddings.npy",
                   help="(--legacy) combined text embedding file")
    p.add_argument("--save_path", default="./outputs/semantic")
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--hidden", type=int, default=10000)
    p.add_argument("--tp", type=int, default=1, help="(not ported: refused) multi-GPU")
    p.add_argument("--pp", type=int, default=1, help="(not ported: refused) multi-GPU")
    p.add_argument("--n_micro", type=int, default=1,
                   help="(not ported: refused) microbatches of the pipelined form")
    p.add_argument("--use_8bit_adam", action="store_true",
                   help="int8 Adam moments: a quarter of the optimizer state's "
                        "bytes (train/optim.py)")
    p.add_argument("--seed", type=int, default=114514)
    p.add_argument("--device", default="cuda",
                   help="where training runs: the card by default (fails where "
                        "there is none); 'cpu' for a dry run")
    return p


def main(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    for flag in ("tp", "pp", "n_micro"):
        if getattr(args, flag) != 1:
            p.error(f"--{flag}: the tensor-parallel and pipelined semantic trainers are "
                    "multi-GPU and not ported yet (ROADMAP.md §1 item 7); this entry point "
                    "runs on one GPU")
    device = resolve_device(args.device)  # fail before reading anything

    feats = load_array(args.features)
    if args.legacy:
        eeg, text, scaler = prepare_semantic_data_legacy(feats, load_array(args.text_embeddings))
    else:
        texts = [load_array(os.path.join(args.text_dir, f"block{i}.pt")) for i in range(6)]
        eeg, text, scaler = prepare_semantic_data(feats, texts)

    cfg = SemanticTrainConfig(epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
                              hidden=args.hidden, out_dim=text.shape[-1],
                              use_8bit_adam=args.use_8bit_adam)
    sd, losses = train_semantic(eeg, text, cfg, seed=args.seed, device=device)
    os.makedirs(args.save_path, exist_ok=True)
    path = os.path.join(args.save_path, "semantic.pt")
    torch.save({k: v.cpu() for k, v in sd.items()}, path)
    scaler.save(os.path.join(args.save_path, "scaler.npz"))
    log.info("semantic predictor saved to %s (final loss %.5f)", path, losses[-1])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
