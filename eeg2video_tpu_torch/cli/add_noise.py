"""CLI: DANA dynamic noise adding over Seq2Seq latents.

Counterpart of ``eeg2video_tpu/cli/add_noise.py``. Contract of reference
EEG2Video_New/DANA/add_noise.py __main__ (L100-130): optical-flow scores ->
beta_d per clip (0.3 fast / 0.2 slow, threshold 1.799), 500-step q-sample,
saves 40_classes_latent_add_noise.pt.

The reference computes GT-reordered labels but then indexes the un-reordered
``labels`` (its L120 bug). Default here is the corrected (reordered) indexing
to match the latents' class order; pass ``--replicate_label_bug`` for the
reference's behavior. The draws come from a ``torch.Generator`` on
``--device`` (default ``cuda``) seeded by ``--seed``, so the noise differs
from the JAX package's and from the reference's global torch seed.
"""

import argparse

import numpy as np
import torch

from ..data import meta
from ..data.io import load_array, save_array
from ..diffusion import dana
from ..utils import get_logger, resolve_device

log = get_logger(__name__)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--latents", default="./outputs/seq2seq/latent_out_block7_40_classes.npy")
    p.add_argument("--flow_scores", default="./data/meta_info/All_video_optical_flow_score.npy")
    p.add_argument("--block", type=int, default=6)
    p.add_argument("--out", default="./outputs/dana/40_classes_latent_add_noise.pt")
    p.add_argument("--seed", type=int, default=3407)
    p.add_argument("--time_steps", type=int, default=500)
    p.add_argument("--replicate_label_bug", action="store_true")
    p.add_argument("--threshold", type=float, default=1.799,
                   help="fast-motion score cut (reference add_noise.py:107); "
                        "re-anchor for scores on another scale than the "
                        "shipped table's")
    p.add_argument("--device", default="cuda",
                   help="where the noise is drawn and mixed: the card by default "
                        "(fails where there is none); 'cpu' for a dry run")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    latents = load_array(args.latents).astype(np.float32)  # (200, 6, 4, 36, 64)
    flow = load_array(args.flow_scores)[args.block]  # (200,) presentation order

    labels = np.asarray(flow >= args.threshold, np.int32)
    if not args.replicate_label_bug:
        # reorder flow labels into class order to match the latents
        idx = meta.block_reorder_indices(args.block)
        labels = labels.reshape(meta.N_CONCEPTS, meta.N_REPS)[idx].reshape(-1)
    betas = np.where(labels == 1, dana.BETA_FAST,
                     dana.BETA_SLOW).astype(np.float32)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    out = dana.dana_add_noise(gen, torch.from_numpy(latents).to(device), betas,
                              time_steps=args.time_steps).cpu().numpy()
    save_array(args.out, out)
    log.info("DANA latents %s -> %s", out.shape, args.out)


if __name__ == "__main__":
    main()
