"""Readings that a cell's limits are set from: the program's check numbers
over many seeds (the lower readings) and the control's (the upper), in one
process.

    python3 perfbench/calibrate.py --workload <cell> --seconds 6 \\
        --seeds 11 12 ... --control fp8 --control-seeds 21 22 23

For each seed of ``--seeds`` a short run of the cell (its own load and
sizes, ``--seconds`` of window) prints its check numbers; for each seed of
``--control-seeds`` and each kind of ``--control`` the driver's ``control``
(the reference put in the program's place: "fp8" at the precision below the
configuration's, "half_batch" a training step whose loss leaves out half of
the batch) prints its numbers. One JSON line each. The benchmark's runs do
not run this.
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


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=6.0)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control", nargs="*", default=["fp8"])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--device", default="cuda")
    p.add_argument("--root", default=ROOT)
    args = p.parse_args(argv)
    if args.root not in sys.path:
        sys.path.insert(0, args.root)
    from perfbench.harness.bench import Bench
    from perfbench.harness.context import Context, free_device_memory

    bench = Bench(args.root)
    cell = bench.cell(args.workload)
    workload = bench.workload(cell["name"])
    driver = bench.traffic(workload["traffic"])

    def context(seed, scratch):
        return Context(root=args.root, cell=cell, workload=workload,
                       config=bench.config(cell["config"]), seed=seed, seconds=args.seconds,
                       trace=False, device=args.device, scratch=scratch, started=time.time())

    jobs = [("program", s) for s in args.seeds]
    jobs += [(kind, s) for s in args.control_seeds for kind in args.control]
    for kind, seed in jobs:
        scratch = tempfile.mkdtemp(prefix="calibrate-", dir=os.environ.get("TMPDIR"))
        t = time.time()
        try:
            ctx = context(seed, scratch)
            if kind == "program":
                run = driver.run(ctx)
                numbers = {**{name: v for name, v, _ in run.checks}, **run.detail}
            else:
                numbers = driver.control(ctx, kind)
        finally:
            shutil.rmtree(scratch, ignore_errors=True)
            free_device_memory()
        print(json.dumps({"cell": cell["name"], "kind": kind, "seed": seed, **numbers,
                          "seconds": time.time() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
