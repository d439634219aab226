"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's configuration, cell file and traffic driver by the names
``BENCHMARK.json`` gives them (``harness/bench.py``), makes the weights and
inputs from ``--seed`` on the card, warms up, measures for ``--seconds``,
checks the timed path's outputs against the plain reference under
``perfbench/reference``, and prints one JSON line: with ``--trace 0`` the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics read
from a profiled window after the measured one. The numbers compared, each
beside its limit, are the last lines on standard error and the last key of
the result line.

Exits non-zero and prints no result where the card is missing or the cell
asks for more cards than there are, and where ``jax``, ``jaxlib``, ``flax``
or the JAX package is loaded once the window has closed.
``--device cpu`` skips the look for a card: the tests run cells at a tiny
size that way.
"""

import time

STARTED = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "eeg2video_tpu")


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", default="cuda",
                   help="cpu: run without a card (the tests, at a tiny size)")
    p.add_argument("--root", default=ROOT, help="the checkout that holds BENCHMARK.json")
    return p


def forbidden_modules():
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole: eeg2video_tpu_torch is not eeg2video_tpu."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None):
    args = build_parser().parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    if args.root not in sys.path:
        sys.path.insert(0, args.root)
    import torch

    from perfbench.harness.bench import Bench
    from perfbench.harness.context import Context

    bench = Bench(args.root)
    cell = bench.cell(args.workload)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("perfbench: no CUDA device", file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell["chips"]:
            print(f"perfbench: {cell['name']} needs {cell['chips']} cards, "
                  f"{torch.cuda.device_count()} found", file=sys.stderr)
            return 2
    build = os.path.join(args.root, "eeg2video_tpu_torch", "_build")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(build, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build, "triton"))
    workload = bench.workload(cell["name"])
    driver = bench.traffic(workload["traffic"])
    print(f"[perfbench] torch and the driver imported {time.time() - STARTED:.1f} s after start",
          file=sys.stderr)
    scratch = tempfile.mkdtemp(prefix="perfbench-", dir=os.environ.get("TMPDIR"))
    ctx = Context(root=args.root, cell=cell, workload=workload,
                  config=bench.config(cell["config"]), seed=args.seed, seconds=args.seconds,
                  trace=bool(args.trace), device=args.device, scratch=scratch,
                  started=STARTED)
    try:
        run = driver.run(ctx)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    found = forbidden_modules()
    if found:
        print(f"perfbench: loaded {', '.join(found)}; the benchmark may not load JAX or "
              "the JAX package", file=sys.stderr)
        return 3

    metrics = {}
    if not args.trace:
        for m in bench.end_to_end(cell["name"]):
            if m["name"] not in run.e2e:
                raise RuntimeError(f"{driver.__name__} gave no {m['name']}")
            metrics[m["name"]] = {"value": run.e2e[m["name"]], "unit": m["unit"]}
    else:
        for m in bench.per_layer(cell["name"]):
            value = bench.metric(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if args.device == "cuda" else args.device,
              "kind": torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu",
              "count": cell["chips"], "memory_peak_bytes": int(run.memory_peak_bytes)}
    line = {"correct": all(v <= lim for _, v, lim in run.checks) and bool(run.checks),
            "attempted": run.attempted, "failed": run.failed, "metrics": metrics,
            "device": device}
    if args.trace and run.trace is not None:
        device["busy_s"] = run.trace.busy_s()
        device["window_s"] = run.trace.window_s
        line["breakdown"] = run.trace.breakdown()
    line["window"] = {k: v for k, v in run.counters.items() if isinstance(v, (int, float))}
    if run.detail:
        line["detail"] = run.detail
    line["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in run.checks}
    for name, v, lim in run.checks:
        print(f"check {name} = {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
