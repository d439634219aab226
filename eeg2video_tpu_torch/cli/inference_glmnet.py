"""CLI: GLMNet inference -> per-window EEG embeddings (7, 40, 5, 7, 512).

Counterpart of ``eeg2video_tpu/cli/inference_glmnet.py``, the README GLMNet
inference contract (README.md:93-103): the train split's normalization
statistics reloaded; the [batch, 7 windows, 512] embeddings the Seq2Seq stage
reads, computed in chunks of 2048 windows. ``--ckpt`` is a checkpoint written
by ``cli.train_glmnet`` (its ``ckpt`` directory or one ``train_state_<n>.pt``
file: a GLMNet state dict; ``convert.from_jax.encoder_state_dict_from_jax``
carries a JAX tree into one). ``--device`` defaults to ``cuda``.
"""

import argparse
import os

import numpy as np
import torch

from ..data.io import load_array, save_array
from ..models import make_encoder
from ..train.checkpoint import latest_checkpoint
from ..utils import get_logger, resolve_device

log = get_logger(__name__)

CHUNK = 2048  # windows a forward


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--raw_dir", default="./data/Preprocessing/Segmented_500ms_sw")
    p.add_argument("--de_dir", default="./data/Preprocessing/DE_1per500ms")
    p.add_argument("--sub", type=int, default=1)
    p.add_argument("--ckpt", default="./outputs/glmnet/ckpt")
    p.add_argument("--norm_stats", default="./outputs/glmnet/norm_stats.npz")
    p.add_argument("--emb_dim", type=int, default=256)
    p.add_argument("--out", default="./outputs/glmnet/embeddings.npy")
    p.add_argument("--device", default="cuda",
                   help="the card by default (fails where there is none); 'cpu' for a dry run")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    raw_sw = load_array(os.path.join(args.raw_dir, f"sub{args.sub}.npy"))
    de_sw = load_array(os.path.join(args.de_dir, f"sub{args.sub}.npy"))
    z = np.load(args.norm_stats)
    raw = ((raw_sw - z["mean"].reshape(1, 1, 1, 1, -1, 1))
           / z["std"].reshape(1, 1, 1, 1, -1, 1)).astype(np.float32)

    path = latest_checkpoint(args.ckpt)
    if path is None:
        raise SystemExit(f"no checkpoint in {args.ckpt}")
    model = make_encoder("glmnet", out_dim=40, emb_dim=args.emb_dim)
    model.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    model = model.to(device).eval()

    # (7, 40, 5, 7w, 62, 100) -> per trial (7 windows) embeddings
    b, c, r, w = raw.shape[:4]
    xr = raw.reshape(-1, 1, *raw.shape[4:])
    xf = de_sw.reshape(-1, *de_sw.shape[4:]).astype(np.float32)
    outs = []
    with torch.no_grad():
        for s in range(0, len(xr), CHUNK):
            emb = model(torch.as_tensor(xr[s:s + CHUNK], device=device),
                        torch.as_tensor(xf[s:s + CHUNK], device=device), return_embedding=True)
            outs.append(emb.cpu().numpy())
    emb = np.concatenate(outs).reshape(b, c, r, w, -1)  # (7, 40, 5, 7, 512)
    save_array(args.out, emb)
    log.info("embeddings %s -> %s", emb.shape, args.out)
    return emb


if __name__ == "__main__":
    main()
