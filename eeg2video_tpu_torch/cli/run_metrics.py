"""CLI: evaluate generated clips against ground truth, on the card.

Counterpart of ``eeg2video_tpu/cli/run_metrics.py`` (the contract of the
reference's 40_class_run_metrics.py main loop): read the generated
``{i}.gif`` clips (class order) and the block-6 ground-truth GIFs
(presentation order, matched through ``meta.block_reorder_indices(6)``),
score SSIM, MSE, PSNR and hue over every frame with ``eval.metrics`` on
``--device`` (default ``cuda``), and with ``--classifier`` the ViT (image)
and VideoMAE (video) n-way accuracies from local Hugging Face checkpoints.
Prints the results as JSON and writes them to ``--out``. GIFs are read with
the port's ``load_gif``.
"""

import argparse
import json
import os

import numpy as np

from ..data import meta
from ..data.video import load_gif
from ..eval.metrics import (classifier_metrics, hue_score_only, mse_score_only,
                            psnr_score_only, ssim_score_only)
from ..utils import get_logger, resolve_device

log = get_logger(__name__)


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--pred_dir", required=True, help="generated {i}.gif clips (class order)")
    p.add_argument("--gt_dir", required=True, help="ground-truth Block6 gifs (presentation order)")
    p.add_argument("--n_clips", type=int, default=200)
    p.add_argument("--classifier", action="store_true",
                   help="also run ViT/VideoMAE n-way metrics (needs local HF checkpoints)")
    p.add_argument("--n_way", type=int, nargs="*", default=[2, 40])
    p.add_argument("--num_trials", type=int, default=100)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda",
                   help="the card by default (fails where there is none); 'cpu' for a dry run")
    return p


def gt_order():
    """Prediction i (class order) -> its ground-truth clip's index in the
    block-6 presentation order (reference legacy L284-290)."""
    idx = meta.block_reorder_indices(6)
    return (idx[:, None] * meta.N_REPS + np.arange(meta.N_REPS)).reshape(-1)


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    order = gt_order()
    preds = np.stack([load_gif(os.path.join(args.pred_dir, f"{i}.gif"))
                      for i in range(args.n_clips)]).astype(np.float32)
    gts = np.stack([load_gif(os.path.join(args.gt_dir, f"{int(order[i])}.gif"))
                    for i in range(args.n_clips)]).astype(np.float32)
    pf = preds.reshape(-1, *preds.shape[2:])  # frames
    gf = gts.reshape(-1, *gts.shape[2:])

    results = {}
    results["ssim"], results["ssim_std"] = ssim_score_only(pf, gf, device=device)
    results["mse"], results["mse_std"] = mse_score_only(pf, gf, device=device)
    results["psnr"], results["psnr_std"] = psnr_score_only(pf, gf, device=device)
    results["hue"], results["hue_std"] = hue_score_only(pf, gf, device=device)
    if args.classifier:
        rng = np.random.default_rng(0)
        for nw in args.n_way:
            accs, _ = classifier_metrics(pf, gf, kind="image", n_way=nw,
                                         num_trials=args.num_trials, rng=rng, device=device)
            results[f"img_{nw}way"] = float(np.mean(accs))
            accs, _ = classifier_metrics(preds, gts, kind="video", n_way=nw,
                                         num_trials=args.num_trials, rng=rng, device=device)
            results[f"video_{nw}way"] = float(np.mean(accs))

    print(json.dumps(results, indent=2))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    log.info("metrics over %d clips written", args.n_clips)
    return results


if __name__ == "__main__":
    main()
