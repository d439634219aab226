"""Time the full-width train step of one or more checkouts on one GPU.

    python -m eeg2video_tpu_torch.utils.step_ab --tree PARENT --tree . --tree . --tree PARENT
    python -m eeg2video_tpu_torch.utils.step_ab --dtype float32 --dtype bfloat16 \\
        --tree PARENT --tree . --out step_ab.jsonl

Each ``--tree`` is the root of a checkout. Its ``eeg2video_tpu_torch`` is
imported in a process of its own (two versions never share a process), and
its kernels are built before anything is timed. For each ``--dtype`` (the
trainer's ``compute_dtype``, default float32) the process builds
``UNet3DConfig()`` with random weights from a seed, as chip_smoke.py's train
phases do, and posteriors and contexts of batch 10 from a seed. It times the
first optimizer step on the host clock between two synchronizations (what
chip_smoke.py reports as a step's seconds), runs the next ``--profiled``
steps under torch.profiler, counting the device kernels and copies by name
(chip_smoke.py profiles the second step), then times ``--steps`` more.

One JSON line per (tree, dtype) on standard output: the tree, the card's name
and power limit, the loss and seconds of the first step, each later step's
seconds and their median, the peak memory of the later steps, and for each
profiled step its kernel count and device-busy ms. ``count_diff`` gives the
names whose count in the first profiled step differs from the first tree's at
the same dtype, as {name: [first tree's count, this tree's]}, and
``self_diff`` those whose count differs between this process's first and last
profiled steps. With ``--out`` each line, with every name's count and device
ms in the first profiled step, is also appended to that file. Given in the
order parent, change, change, parent, the trees compare two versions in one
call on one card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

BATCH = 10


def _counts(torch, prof):
    """{kernel or copy name: [launches, device ms]} of one profiled step."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        c = out.setdefault(e.name, [0, 0.0])
        c[0] += 1
        c[1] += e.time_range.elapsed_us() / 1e3
    return out


def _diff(a, b):
    return {n: [a.get(n, [0])[0], b.get(n, [0])[0]] for n in sorted(set(a) | set(b))
            if a.get(n, [0])[0] != b.get(n, [0])[0]}


def _one(tree, dtype, steps, profiled):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from eeg2video_tpu_torch.models.init import random_init_
    from eeg2video_tpu_torch.models.unet3d import UNet3DConditionModel, UNet3DConfig
    from eeg2video_tpu_torch.ops import _build
    from eeg2video_tpu_torch.train import videodiffusion as vd

    _build.library()  # the kernels' build is not timed
    dev = torch.device("cuda")
    g = torch.Generator(device="cuda").manual_seed(14)
    with torch.device("meta"):
        unet = UNet3DConditionModel(UNet3DConfig())
    unet = random_init_(unet.to_empty(device="cuda"), g)
    state = vd.init_video_train_state(unet, vd.VideoDiffusionTrainConfig(compute_dtype=dtype),
                                      dev)
    post = torch.cat([torch.randn(BATCH, 6, 36, 64, 4, generator=g, device=dev),
                      -4.0 + 0.1 * torch.randn(BATCH, 6, 36, 64, 4, generator=g, device=dev)],
                     dim=-1)
    ctx = torch.randn(BATCH, 77, 768, generator=g, device=dev)

    def step():
        return vd.train_step(state, None, post, ctx, 0)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = float(step())
    first_s = time.perf_counter() - t0
    prof_counts = []
    for _ in range(profiled):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        prof_counts.append(_counts(torch, prof))
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for _ in range(steps):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    rec = {"tree": tree, "dtype": dtype, "card": smi.strip().splitlines()[0] if smi else None,
           "loss": loss, "first_s": first_s, "step_s": secs,
           "median_s": statistics.median(secs) if secs else None,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "profiled": [{"kernels": sum(c[0] for c in pc.values()),
                         "busy_ms": sum(c[1] for c in pc.values())} for pc in prof_counts],
           "self_diff": _diff(prof_counts[0], prof_counts[-1]) if prof_counts else {},
           "counts": prof_counts[0] if prof_counts else {}}
    print(json.dumps(rec), flush=True)
    del state, unet
    torch.cuda.empty_cache()


def _child(tree, dtypes, steps, profiled):
    for dtype in dtypes:
        _one(tree, dtype, steps, profiled)


_CHILD = """
import importlib.util, json, sys
tree, path, args = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
sys.path.insert(0, tree)
spec = importlib.util.spec_from_file_location("step_ab_child", path)
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
mod._child(tree, *args)
"""


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", action="append", required=True,
                        help="root of a checkout (repeat: one process each, in order)")
    parser.add_argument("--dtype", action="append", choices=("float32", "bfloat16"),
                        help="the trainer's compute_dtype (repeat; default float32)")
    parser.add_argument("--profiled", type=int, default=2,
                        help="profiled steps after the first")
    parser.add_argument("--steps", type=int, default=5, help="timed steps after those")
    parser.add_argument("--out", help="append every line, with all counts, to this file")
    args = parser.parse_args(argv)
    dtypes = args.dtype or ["float32"]
    first, rc = {}, 0
    for tree in args.tree:
        res = subprocess.run([sys.executable, "-c", _CHILD, os.path.abspath(tree),
                              os.path.abspath(__file__),
                              json.dumps([dtypes, args.steps, args.profiled])],
                             stdout=subprocess.PIPE, text=True)
        rc |= res.returncode
        for line in res.stdout.splitlines():
            if not line.startswith("{"):
                print(line)
                continue
            rec = json.loads(line)
            counts = rec.pop("counts")
            rec["count_diff"] = _diff(first.setdefault(rec["dtype"], counts), counts)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps({**rec, "counts": counts}) + "\n")
            print(json.dumps(rec), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
