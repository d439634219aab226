"""The fine-tune step of the port's trainer over a resident clip set.

Set-up makes the UNet's float32 weights from the seed on the card, builds
one ``TrainState`` (the configuration's optimizer, freeze rule and gradient
checkpointing) and the resident set: ``clips`` posteriors (mean || logvar,
(F, H/8, W/8, 8)) and contexts (77, 768), both drawn from the seed. The
order of the rows is one permutation of the set per epoch, drawn from the
seed, cut into steps of ``batch``.

The first ``check_steps`` steps run in set-up through the window's own call,
``train/videodiffusion.train_epoch``, on rows that all differ. They build
and warm every kernel, and the check reads from them each step's loss, the
first step's gradient as AdamW holds it (its first moment over 1 - beta1)
and, after the last of them, each trainable leaf's change. The window then
calls ``train_epoch`` on the following steps, a few at a time, until
``--seconds`` have passed and the card is synchronized; ``step_s`` is the
window's time over its steps. With ``--trace 1`` the profiler then covers
``trace_steps`` more steps.

The check, once the program's state is freed: ``reference/train.py``
follows the same steps from the same weights, rows and seed in float32.
Leaves whose reference gradient is under a thousandth of the median leaf's
are left out of the change's comparison (they move by round-off alone).
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from perfbench.harness import context as hctx
from perfbench.harness.context import Run
from perfbench.harness.trace import Tracer
from perfbench.harness.weights import generator, make_state, sub_seed
from perfbench.reference import train as ref_train
from perfbench.reference import unet3d as ref_unet
from perfbench.reference.numerics import Numerics, exact_f32


def make_data(ctx):
    """Resident posteriors and contexts, and the rows of every step."""
    p, t, dev, seed = ctx.params, ctx.config["train"], ctx.device, ctx.seed
    h, w = t["height"] // 8, t["width"] // 8
    n, f, batch = p["clips"], t["n_sample_frames"], t["train_batch_size"]
    g = generator(seed, "posteriors", dev)
    mean = p["latent_std"] * torch.randn((n, f, h, w, 4), generator=g, device=dev)
    logvar = p["logvar_mean"] + p["logvar_std"] * torch.randn((n, f, h, w, 4), generator=g,
                                                              device=dev)
    post = torch.cat([mean, logvar], dim=-1)
    ctxs = torch.randn((n, 77, ctx.config["unet"]["cross_attention_dim"]),
                       generator=generator(seed, "contexts", dev), device=dev)
    rng = np.random.default_rng(sub_seed(seed, "order"))
    per_epoch = n // batch
    epochs = -(-p["planned_steps"] // per_epoch)
    rows = np.concatenate([rng.permutation(n)[:per_epoch * batch] for _ in range(epochs)])
    return post, ctxs, rows.reshape(-1, batch)


def steps_of(rows, at, n):
    """Rows of steps at, at + 1, ..., at + n - 1, the order starting over
    past its end."""
    return np.take(rows, np.arange(at, at + n), axis=0, mode="wrap")


def run(ctx):
    from eeg2video_tpu_torch.models.unet3d import UNet3DConditionModel, UNet3DConfig
    from eeg2video_tpu_torch.train.videodiffusion import (TrainState,
                                                          VideoDiffusionTrainConfig, train_epoch)

    p, cfg, dev, seed = ctx.params, ctx.config, ctx.device, ctx.seed
    ucfg, tcfg = cfg["unet"], cfg["train"]
    train_seed = sub_seed(seed, "steps") % (1 << 31)
    with torch.device("meta"):
        unet = UNet3DConditionModel(hctx.dataclass_of(UNet3DConfig, ucfg))
    unet = unet.to_empty(device=dev)
    unet.load_state_dict(make_state(ref_unet.param_shapes(ucfg), seed, "unet", dev), strict=True)
    hctx.free_device_memory()
    state = TrainState(unet, VideoDiffusionTrainConfig(
        learning_rate=tcfg["learning_rate"], adam_b1=tcfg["adam_beta1"],
        adam_b2=tcfg["adam_beta2"], weight_decay=tcfg["adam_weight_decay"],
        adam_eps=tcfg["adam_epsilon"], max_grad_norm=tcfg["max_grad_norm"],
        compute_dtype=tcfg["compute_dtype"], remat=tcfg["gradient_checkpointing"]), dev)
    post, ctxs, rows = make_data(ctx)
    k = p["check_steps"]
    ctx.log(f"train state built {time.time() - ctx.started:.1f} s after start")

    names = list(state.masters)
    start = {n: m.detach().clone() for n, m in state.masters.items()}
    losses, first_grad = [], {}
    beta1 = state.optimizer.param_groups[0]["betas"][0]

    def on_step(st, loss):
        losses.append(loss)
        if st.step == 1:  # an optimizer that took no step holds no moment: a zero gradient
            for n, m in st.masters.items():
                moment = st.optimizer.state.get(m, {}).get("exp_avg")
                first_grad[n] = (0.0 if moment is None
                                 else float(torch.linalg.vector_norm(moment / (1.0 - beta1))))

    train_epoch(state, None, post, ctxs, rows[:k], train_seed, on_step=on_step)
    change = {n: float(torch.linalg.vector_norm(state.masters[n].detach() - start[n]))
              for n in names}
    program = {"loss": [float(x) for x in losses], "grad_norm": first_grad,
               "change_norm": change}
    del start

    setup_peak = hctx.reset_peak(dev)
    setup_s = time.time() - ctx.started
    at, steps, chunk = k, 0, p["window_chunk"]
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        train_epoch(state, None, post, ctxs, steps_of(rows, at, chunk), train_seed)
        at, steps = at + chunk, steps + chunk
    hctx.sync(dev)
    window_s = time.perf_counter() - t0
    window_peak = hctx.peak(dev)
    trace = None
    if ctx.trace:
        tracer = Tracer(ctx.scratch, dev)
        tracer.start()
        train_epoch(state, None, post, ctxs, steps_of(rows, at, p["trace_steps"]), train_seed)
        tracer.stop()
        t = time.perf_counter()
        trace = tracer.read()
        ctx.log(f"trace read in {time.perf_counter() - t:.1f} s")
    used = rows[:k]
    inputs = ([post[r].cpu() for r in used], [ctxs[r].cpu() for r in used])
    del state, unet, post, ctxs
    hctx.free_device_memory()
    t = time.perf_counter()
    reference = follow(ctx, inputs, train_seed, Numerics("f32"))
    ctx.log(f"reference check in {time.perf_counter() - t:.1f} s")
    checks, detail = compare(program, reference, ctx.workload["limits"])
    counters = {"window_s": window_s, "window_steps": steps, "setup_s": setup_s,
                "traced_steps": p["trace_steps"] if ctx.trace else 0,
                "unet_batch": tcfg["train_batch_size"], "frames": tcfg["n_sample_frames"],
                "height": tcfg["height"], "width": tcfg["width"]}
    return Run(e2e={"step_s": window_s / steps, "setup_s": setup_s,
                    "peak_gib": window_peak / 2 ** 30},
               attempted=steps, failed=0, checks=checks, detail=detail,
               memory_peak_bytes=max(setup_peak, window_peak), counters=counters, trace=trace,
               config=cfg, params=p)


def follow(ctx, inputs, train_seed, num, keep_rows=None):
    """The reference's readings over the check's steps at ``num``'s precision."""
    dev = ctx.device
    with exact_f32():
        weights = make_state(ref_unet.param_shapes(ctx.config["unet"]), ctx.seed, "unet", dev)
        return ref_train.follow(weights, ctx.config["unet"], ctx.config["train"], num,
                                [t.to(dev) for t in inputs[0]], [t.to(dev) for t in inputs[1]],
                                train_seed, micro=ctx.params["reference_micro_batch"],
                                keep_rows=keep_rows)


def compare(program, reference, limits):
    """The numbers compared: ``grad_gap`` and ``change_gap``, the worst
    leaf's gap of norms (the first step's gradient as AdamW got it; the
    change after the last step) over the larger of the reference leaf's norm
    and the median leaf's, ``change_gap`` without the leaves that round-off
    alone moves; ``median_grad_gap``, the median leaf's gradient gap, steady
    from seed to seed where the worst leaf's swings. Besides, not compared
    (neither the control nor a fault reads far enough above sound runs, see
    PERF.md): ``first_loss_gap`` and ``loss_gap``, the first and the worst
    step's |loss - reference| / reference; and the worst leaves' names."""
    losses = [abs(a - b) / abs(b) for a, b in zip(program["loss"], reference["loss"])]
    rg = reference["grad_norm"]
    med = statistics.median(rg.values())
    moving = [n for n in rg if rg[n] >= 1e-3 * med]

    def leaf_gaps(key, leaves):
        ref = reference[key]
        floor = statistics.median(ref[n] for n in leaves)
        return [(abs(program[key][n] - ref[n]) / max(ref[n], floor), n) for n in leaves]

    grads = leaf_gaps("grad_norm", list(rg))
    grad, grad_leaf = max(grads)
    change, change_leaf = max(leaf_gaps("change_norm", moving))
    checks = [("grad_gap", grad, limits["grad_gap"]),
              ("median_grad_gap", statistics.median(g for g, _ in grads),
               limits["median_grad_gap"]),
              ("change_gap", change, limits["change_gap"])]
    detail = {"first_loss_gap": losses[0], "loss_gap": max(losses), "grad_leaf": grad_leaf,
              "change_leaf": change_leaf, "left_out": len(rg) - len(moving)}
    return checks, detail


def control(ctx, kind):
    """The check's numbers with the reference put in the program's place:
    "fp8" computes it at the precision below the configuration's bf16;
    "half_batch" takes each step's loss over the first half of its rows."""
    post, ctxs, rows = make_data(ctx)
    used = rows[:ctx.params["check_steps"]]
    inputs = ([post[r].cpu() for r in used], [ctxs[r].cpu() for r in used])
    del post, ctxs
    train_seed = sub_seed(ctx.seed, "steps") % (1 << 31)
    if kind == "fp8":
        low = follow(ctx, inputs, train_seed, Numerics("fp8"))
    elif kind == "half_batch":
        low = follow(ctx, inputs, train_seed, Numerics("f32"), keep_rows=max(1, len(used[0]) // 2))
    else:
        raise ValueError(f"no {kind!r} control for training")
    ref = follow(ctx, inputs, train_seed, Numerics("f32"))
    limits = {name: float("inf") for name in ctx.workload["limits"]}
    checks, detail = compare(low, ref, limits)
    return {**{name: v for name, v, _ in checks}, **detail}
