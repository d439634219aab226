"""Time the semantic trainer on the world's GPUs: one GPU, then pp and tp.

    torchrun --nproc_per_node 4 -m eeg2video_tpu_torch.utils.mesh_semantic \\
        --layout pp3 --layout tp2 --layout tp4

At ``SemanticPredictor()`` (hidden 10000, 894.5M parameters) every run takes
``--steps`` steps at batch ``--batch`` on seeded rows (targets a seeded linear
map of the features), with f32 Adam and then with 8-bit Adam, from the same
initial weights (``train_semantic``'s draw from its seed). First rank 0 trains
alone (one GPU: the reference) while the others wait; then each ``--layout``:
``ppN`` is ``train_semantic(pp=N)`` over the world's first N ranks
(``--n_micro`` microbatches), ``tpN`` ``train_semantic`` on a (dp 1, tp N)
mesh of the first N ranks (``make_mesh(..., leave_idle=True)``); the ranks
past a run idle.

Rank 0 prints one JSON line per run and optimizer: the losses and their
largest relative gap to one GPU's, the seconds of each step on the host clock
between two synchronizations (the first includes the first calls' set-up)
and the median of the later ones, and per rank the peak device memory and
the bytes of the parameters it trains plus its optimizer's state; with the
card's name and power limit. ``--device cpu --hidden 64`` rehearses it over
gloo.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

from .mesh_step import _card


def _parse_layout(text):
    kind, n = text[:2], text[2:]
    if kind not in ("pp", "tp") or not n.isdigit():
        raise argparse.ArgumentTypeError(f"--layout ppN or tpN, got {text!r}")
    return kind, int(n)


def _data(torch, dev, rows):
    g = torch.Generator(device=dev).manual_seed(31)
    x = torch.randn(rows, 310, generator=g, device=dev)
    w = torch.randn(310, 77 * 768, generator=g, device=dev) * (0.1 / 310 ** 0.5)
    return x.cpu().numpy(), (x @ w).cpu().numpy()


def _run(torch, args, dev, run, eight_bit, eeg, text):
    """One run on this rank: (losses, seconds a step, peak bytes, bytes of
    the trained parameters and the optimizer's state); empty on an idle
    rank."""
    from ..parallel import make_mesh
    from ..parallel.distributed import rank
    from ..train.optim import state_bytes
    from ..train.semantic import SemanticTrainConfig, train_semantic

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    cfg = SemanticTrainConfig(epochs=1, batch_size=args.batch, hidden=args.hidden,
                              use_8bit_adam=eight_bit)
    rec = {"t": [], "losses": [], "bytes": 0}

    def on_step(step, loss, opt):
        sync()
        rec["t"].append(time.perf_counter())
        rec["losses"].append(float(loss))
        rec["bytes"] = state_bytes(opt) + sum(p.numel() * p.element_size()
                                              for g in opt.param_groups for p in g["params"])

    kw = {}
    if run is not None:
        kind, n = run
        kw = (dict(pp=n, n_micro=args.n_micro) if kind == "pp" else
              dict(mesh=make_mesh(dp=1, tp=n, device=dev, leave_idle=True)))
    if run is not None or rank() == 0:
        sync()
        rec["t"].append(time.perf_counter())
        train_semantic(eeg, text, cfg, seed=47, device=dev, on_step=on_step, **kw)
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    secs = [b - a for a, b in zip(rec["t"], rec["t"][1:])]
    return rec["losses"], secs, peak, rec["bytes"]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    # not --run: torchrun's parser takes that prefix for its own --run-path
    p.add_argument("--layout", type=_parse_layout, action="append", required=True,
                   help="ppN or tpN (repeatable): N at most the world size")
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--n_micro", type=int, default=8)
    p.add_argument("--hidden", type=int, default=10000)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch
    import torch.distributed as dist

    from ..parallel import init_distributed, is_host0
    from ..utils import resolve_device

    owned = not dist.is_initialized()
    init_distributed(args.device)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    card = _card() if dev.type == "cuda" else "cpu"
    world = dist.get_world_size() if dist.is_initialized() else 1
    eeg, text = _data(torch, dev, args.steps * args.batch)
    for eight_bit in (False, True):
        reference = None
        for run in [None, *args.layout]:
            losses, secs, peak, resident = _run(torch, args, dev, run, eight_bit, eeg, text)
            every = [(peak, resident)]
            if world > 1:
                every = [None] * world
                dist.all_gather_object(every, (peak, resident))
            if reference is None:
                reference = losses
            if is_host0():
                print(json.dumps({
                    "layout": "one GPU" if run is None else f"{run[0]} {run[1]}",
                    "optimizer": "8-bit Adam" if eight_bit else "f32 Adam", "world": world,
                    "batch": args.batch, "losses": losses,
                    "max_rel_gap_to_one_gpu": max(abs(a - b) / abs(b)
                                                  for a, b in zip(losses, reference)),
                    "seconds": secs, "median_after_first": statistics.median(secs[1:] or secs),
                    "peak_gib_per_rank": [e[0] / 2**30 for e in every],
                    "params_and_optimizer_bytes_per_rank": [e[1] for e in every],
                    "card": card}), flush=True)
            if dist.is_initialized() and world > 1:
                dist.barrier()
    if owned and dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
