"""CLI: VAE-encode per-clip GIFs into video latents.

Counterpart of ``eeg2video_tpu/cli/generate_video_latents.py``, the contracts
of reference Seq2Seq/generate_1200_latent.py (blocks 0-5 -> 1200_latent.npy,
(1200, 4, 6, 36, 64)) and generate_40classes_latents.py (block 6 ->
40classes_latents.pt, (200, 4, 6, 36, 64)): the posterior's mean, with no
0.18215 scaling, as the reference takes ``latent_dist.mean``
(generate_1200_latent.py:38). Frames go through the encoder one at a time, in
float32 unless ``--dtype bfloat16``; the output is laid out (N, C, F, H, W).
``--vae`` is a diffusers directory or a state-dict file of the port's
``AutoencoderKL``; ``--torch_vae`` a torch AutoencoderKL state dict (the
diffusers keys) at ``VAEConfig()``. ``--device`` defaults to ``cuda``.
"""

import argparse
import os

import numpy as np
import torch

from ..convert.export_diffusion import load_torch_state_dict
from ..data import meta
from ..data.io import save_array
from ..data.video import load_gif
from ..models.vae import AutoencoderKL, VAEConfig
from ..utils import get_logger, resolve_device
from .inference_eeg2video import load_vae_state

log = get_logger(__name__)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--gif_root", default="./data/Video_gifs")
    p.add_argument("--vae", default="./checkpoints/vae/ckpt")
    p.add_argument("--torch_vae", default=None,
                   help="a torch AutoencoderKL .bin/.pt state dict instead of --vae")
    p.add_argument("--blocks", type=int, nargs="*", default=list(range(6)))
    p.add_argument("--out", default="./data/1200_latent.npy")
    p.add_argument("--batch", type=int, default=12, help="clips read per group")
    p.add_argument("--dtype", default="float32", choices=sorted(_DTYPES),
                   help="float32 keeps the latents a parity target")
    p.add_argument("--device", default="cuda",
                   help="where the VAE runs: the card by default (fails where "
                        "there is none); 'cpu' for a dry run")
    return p


def load_vae(vae_ckpt, torch_vae=None, dtype=torch.float32, device="cuda"):
    """The ``AutoencoderKL`` of ``--vae`` / ``--torch_vae`` in eval mode on
    ``device`` in ``dtype``."""
    if torch_vae:
        cfg, sd = VAEConfig(), load_torch_state_dict(torch_vae)
    else:
        cfg, sd = load_vae_state(vae_ckpt)
    vae = AutoencoderKL(cfg)
    vae.load_state_dict(sd, strict=True)
    return vae.to(device=device, dtype=dtype).eval().requires_grad_(False)


@torch.no_grad()
def encode_gifs(vae, paths, batch: int = 12):
    """GIF clips of F frames -> (N, C, F, H/8, W/8) float32 numpy latents: the
    posterior mean of each frame, frames through the encoder one at a time,
    ``batch`` clips read and sent to the device at a time."""
    p = next(vae.parameters())
    out = []
    for s in range(0, len(paths), batch):
        clips = np.stack([load_gif(path) for path in paths[s:s + batch]])  # (n, F, H, W, 3)
        frames = torch.from_numpy(clips).to(p.device).float().div_(127.5).sub_(1.0)
        frames = frames.flatten(0, 1).to(p.dtype)
        z = torch.stack([vae.encode(fr[None])[0][0].float() for fr in frames])
        z = z.reshape(clips.shape[0], clips.shape[1], *z.shape[1:])  # (n, F, h, w, C)
        # the reference's layout (B, C, F, H, W) (generate_1200_latent.py:43)
        out.append(z.permute(0, 4, 1, 2, 3).cpu().numpy())
    return np.concatenate(out)


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)  # fail before reading anything
    vae = load_vae(args.vae, args.torch_vae, _DTYPES[args.dtype], device)
    latents = []
    for blk in args.blocks:
        d = os.path.join(args.gif_root, f"Block{blk}")
        paths = [os.path.join(d, f"{i}.gif") for i in range(meta.N_CONCEPTS * meta.N_REPS)]
        latents.append(encode_gifs(vae, paths, args.batch))
        log.info("block %d encoded", blk)
    out = np.concatenate(latents)
    save_array(args.out, out)
    log.info("latents %s -> %s", out.shape, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
