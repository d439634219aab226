"""A checkout-shaped directory whose cells are the benchmark's at a tiny
size, for running the harness on the CPU (``run.py --device cpu``). The
limits stay the cells' own but for the training cells' gradient gaps."""

from __future__ import annotations

import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TINY_UNET = {"block_out_channels": [32, 64, 64, 64], "attention_heads": 4,
             "norm_num_groups": 8}
TINY_VAE = {"block_out_channels": [32, 32, 64, 64], "layers_per_block": 1, "norm_num_groups": 8}


def make_root(tmp):
    """Copy perfbench and BENCHMARK.json under ``tmp`` and shrink every
    configuration and cell; returns the root."""
    root = os.path.join(str(tmp), "checkout")
    shutil.copytree(os.path.join(REPO, "perfbench"), os.path.join(root, "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    os.symlink(os.path.join(REPO, "eeg2video_tpu_torch"), os.path.join(root, "eeg2video_tpu_torch"))
    cfg_dir = os.path.join(root, "perfbench", "configs")
    for name in os.listdir(cfg_dir):
        path = os.path.join(cfg_dir, name)
        with open(path) as f:
            cfg = json.load(f)
        cfg["unet"].update(TINY_UNET)
        if "vae" in cfg:
            cfg["vae"].update(TINY_VAE)
        if "semantic" in cfg:
            cfg["semantic"]["hidden"] = 64
        if "generation" in cfg:
            cfg["generation"].update(video_length=4, height=64, width=64, num_inference_steps=3)
        cfg["train"].update(train_batch_size=2, n_sample_frames=4, height=64, width=64)
        with open(path, "w") as f:
            json.dump(cfg, f)
    wl_dir = os.path.join(root, "perfbench", "workloads")
    for name in os.listdir(wl_dir):
        path = os.path.join(wl_dir, name)
        with open(path) as f:
            wl = json.load(f)
        p = wl["params"]
        if wl["traffic"] == "serve_closed_loop":
            p.update(clients=2, clips=8, check_clips=2, trace_skip=1, trace_dispatches=2)
            flags = p["server_flags"]
            flags[flags.index("--max_batch") + 1] = "2"
        else:
            p.update(clips=6, check_steps=3, window_chunk=1, trace_steps=1, planned_steps=40)
            # a tiny UNet's bf16 gradients sit farther from f32 than the full
            # width's (median leaf about 0.006-0.008 against 0.0005, worst
            # leaf up to 0.03 against 0.01)
            wl["limits"].update(grad_gap=0.1, median_grad_gap=0.03)
        with open(path, "w") as f:
            json.dump(wl, f)
    return root
