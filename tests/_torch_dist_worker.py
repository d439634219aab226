"""Worker processes of the port's multi-process CPU tests
(tests/test_torch_parallel.py, test_torch_ring.py,
test_torch_sharded_generation.py, test_torch_ring_bwd.py,
test_torch_sharded_training.py, test_torch_sharded_serving.py,
test_torch_pipeline_parallel.py, test_torch_fold_mesh.py,
test_torch_glmnet_dp.py, test_torch_fsdp_gather.py).

``start(case, world, inputs, tmp_path)`` starts ``world`` processes with the
``spawn`` start method (the pytest process holds JAX's runtime, which a fork
would copy), each joins a gloo group on a file store in ``tmp_path`` with a
60 s timeout (``start``'s ``timeout``) and runs ``case(rank, world,
inputs)`` from this module, which imports torch and the port only; the caller may compute JAX's side
meanwhile. ``Spawn.join`` waits for them against one deadline (120 s from
the start); past it they are killed and the test fails. A worker's exception
fails the test with its traceback. It returns the case's result of every
rank, in rank order. ``spawn`` is ``start`` then ``join``.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import pickle
import sys
import time
import traceback

TIMEOUT = datetime.timedelta(seconds=60)
DEADLINE = 120.0


def _entry(rank, world, case, store, inputs_path, out_dir, timeout):
    try:
        import torch
        import torch.distributed as dist

        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=world, timeout=timeout)
        with open(inputs_path, "rb") as f:
            inputs = pickle.load(f)
        result = globals()[case](rank, world, inputs)
        with open(os.path.join(out_dir, f"result{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


class Spawn:
    def __init__(self, case, world, inputs, tmp_path, deadline, timeout=TIMEOUT):
        self.case, self.world = case, world
        self.out_dir = os.path.join(os.fspath(tmp_path), f"spawn_{case}_{world}")
        os.makedirs(self.out_dir)
        inputs_path = os.path.join(self.out_dir, "inputs.pkl")
        with open(inputs_path, "wb") as f:
            pickle.dump(inputs, f)
        ctx = multiprocessing.get_context("spawn")
        store = os.path.join(self.out_dir, "store")
        self.procs = [ctx.Process(target=_entry, daemon=True,
                                  args=(r, world, case, store, inputs_path, self.out_dir,
                                        timeout))
                      for r in range(world)]
        for p in self.procs:
            p.start()
        self.deadline = deadline
        self.end = time.monotonic() + deadline
        self.results = None

    def join(self):
        if self.results is not None:
            return self.results
        for p in self.procs:
            p.join(max(0.0, self.end - time.monotonic()))
        hung = [r for r, p in enumerate(self.procs) if p.is_alive()]
        for p in self.procs:
            if p.is_alive():
                p.kill()
            p.join()
        errors = []
        for r in range(self.world):
            path = os.path.join(self.out_dir, f"error{r}.txt")
            if os.path.exists(path):
                with open(path) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
        if hung:
            raise AssertionError(f"{self.case}: ranks {hung} passed the {self.deadline:.0f} s "
                                 "deadline and were killed\n" + "\n".join(errors))
        if errors or any(p.exitcode != 0 for p in self.procs):
            raise AssertionError(f"{self.case}: exit codes {[p.exitcode for p in self.procs]}\n"
                                 + "\n".join(errors))
        results = []
        for r in range(self.world):
            with open(os.path.join(self.out_dir, f"result{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        self.results = results
        return results


def start(case, world, inputs, tmp_path, deadline=DEADLINE, timeout=TIMEOUT):
    return Spawn(case, world, inputs, tmp_path, deadline, timeout)


def spawn(case, world, inputs, tmp_path, deadline=DEADLINE):
    return start(case, world, inputs, tmp_path, deadline).join()


# --- helpers of the cases ---------------------------------------------------

def _t(a):
    import torch

    return None if a is None else torch.from_numpy(a)


def _np(t):
    return t.detach().numpy().copy()


def _raises(exc, fn):
    """The message of the ``exc`` that ``fn()`` raises, or None."""
    try:
        fn()
    except exc as e:
        return str(e)
    return None


def _group_ranks(mesh):
    import torch.distributed as dist

    return {axis: (None if mesh.group(axis) is None
                   else dist.get_process_group_ranks(mesh.group(axis)))
            for axis in ("dp", "sp", "tp")}


def _attention_calls(fn):
    """The attention calls (what launches ``flash_attention_fwd`` on the
    card: the ring's hops and the one-GPU path's calls) while ``fn()`` runs."""
    from eeg2video_tpu_torch.models import attention3d
    from eeg2video_tpu_torch.ops import ring

    sites = [(ring, "flash_attention_fwd"), (attention3d, "flash_attention"),
             (attention3d, "flash_attention_fwd")]
    real = [(mod, name, getattr(mod, name)) for mod, name in sites]
    calls = []

    def counted(f):
        return lambda *a, **k: calls.append(1) or f(*a, **k)

    try:
        for mod, name, f in real:
            setattr(mod, name, counted(f))
        fn()
    finally:
        for mod, name, f in real:
            setattr(mod, name, f)
    return len(calls)


def _host0_filter():
    """(INFO passes, ERROR passes) through the port's host-0 log filter."""
    import logging

    from eeg2video_tpu_torch.utils.logging import _Host0Filter

    return tuple(_Host0Filter().filter(logging.LogRecord("t", level, "f", 1, "m", None, None))
                 for level in (logging.INFO, logging.ERROR))


def _tiny_pipeline(inputs):
    import torch

    from eeg2video_tpu_torch.diffusion.pipeline import EEG2VideoPipeline
    from eeg2video_tpu_torch.models.unet3d import UNet3DConfig
    from eeg2video_tpu_torch.models.vae import VAEConfig

    cfg = dataclasses.replace(UNet3DConfig.tiny(), cross_attention_dim=768)
    return EEG2VideoPipeline.create(
        {k: torch.from_numpy(v) for k, v in inputs["unet"].items()},
        {k: torch.from_numpy(v) for k, v in inputs["vae"].items()},
        cfg, VAEConfig.tiny(), dtype=torch.float32, device="cpu")


# --- the cases ----------------------------------------------------------------

def parallel_cases(rank, world, inputs):
    """make_mesh's groups at world size 2, local_batch_slice, shard_params with
    unet_tp_rules on the tiny UNet, and a tp = 2 transformer block."""
    import torch

    from eeg2video_tpu_torch.models.attention3d import BasicTransformerBlock
    from eeg2video_tpu_torch.models.unet3d import UNet3DConditionModel, UNet3DConfig
    from eeg2video_tpu_torch.parallel import local_batch_slice, make_mesh, shard_params
    from eeg2video_tpu_torch.train import unet_tp_rules

    out = {"meshes": {}}
    for dp, sp, tp in ((2, 1, 1), (1, 2, 1), (1, 1, 2)):
        mesh = make_mesh(dp=dp, sp=sp, tp=tp, device="cpu", timeout=TIMEOUT)
        out["meshes"][(dp, sp, tp)] = (mesh.coords, _group_ranks(mesh))
    out["slice"] = local_batch_slice(6)
    out["log"] = _host0_filter()

    tp_mesh = make_mesh(dp=1, sp=1, tp=2, device="cpu", timeout=TIMEOUT)
    unet = UNet3DConditionModel(UNet3DConfig.tiny())
    unet.load_state_dict({k: torch.from_numpy(v) for k, v in inputs["unet"].items()},
                         strict=True)
    shard_params(unet, tp_mesh, unet_tp_rules)
    out["params"] = {n: _np(p) for n, p in unet.named_parameters()}
    out["unet_mesh"] = unet.mesh is tp_mesh

    blk = BasicTransformerBlock(64, 4, 16, 16)
    blk.load_state_dict({k: torch.from_numpy(v) for k, v in inputs["block"].items()},
                        strict=True)
    x, ctx = _t(inputs["x"]), _t(inputs["ctx"])
    with torch.no_grad():
        shard_params(blk, tp_mesh, unet_tp_rules)
        out["block"] = _np(blk(x, ctx))
    return out


def ring_cases(rank, world, inputs):
    """Ring attention at world size 2: ring and replicated-KV mode with and
    without bias on a (1, 2, 1) mesh, sp = 1 on a (2, 1, 1) mesh against
    flash_attention_plain, the divisibility errors."""
    import torch

    from eeg2video_tpu_torch.ops.attention import flash_attention_plain
    from eeg2video_tpu_torch.ops.ring import ring_attention_packed
    from eeg2video_tpu_torch.parallel import make_mesh

    heads = inputs["heads"]
    q, k, v, k77, v77, bias, bias77 = (_t(inputs[n]) for n in
                                       ("q", "k", "v", "k77", "v77", "bias", "bias77"))
    sp_mesh = make_mesh(dp=1, sp=2, tp=1, device="cpu", timeout=TIMEOUT)
    out = {"groups": _group_ranks(sp_mesh)}
    with torch.no_grad():
        out["ring"] = _np(ring_attention_packed(q, k, v, heads, sp_mesh))
        out["ring_bias"] = _np(ring_attention_packed(q, k, v, heads, sp_mesh, bias=bias))
        out["repkv"] = _np(ring_attention_packed(q, k77, v77, heads, sp_mesh))
        out["repkv_bias"] = _np(ring_attention_packed(q, k77, v77, heads, sp_mesh,
                                                      bias=bias77))
        out["tokens_error"] = _raises(ValueError, lambda: ring_attention_packed(
            q[:, :511], k[:, :511], v[:, :511], heads, sp_mesh))
        dp_mesh = make_mesh(dp=2, sp=1, tp=1, device="cpu", timeout=TIMEOUT)
        out["sp1_equal"] = torch.equal(ring_attention_packed(q, k, v, heads, dp_mesh),
                                       flash_attention_plain(q, k, v, heads))
        tp_mesh = make_mesh(dp=1, sp=1, tp=2, device="cpu", timeout=TIMEOUT)
        out["heads_error"] = _raises(ValueError, lambda: ring_attention_packed(
            q, k, v, 1, tp_mesh))
    return out


def ring_sp_tp_cases(rank, world, inputs):
    """sp = 2 x tp = 2 at world size 4: the ring over each rank's heads // tp
    heads, with and without bias."""
    import torch

    from eeg2video_tpu_torch.ops.ring import ring_attention_packed
    from eeg2video_tpu_torch.parallel import make_mesh

    heads = inputs["heads"]
    q, k, v, bias = (_t(inputs[n]) for n in ("q", "k", "v", "bias"))
    mesh = make_mesh(dp=1, sp=2, tp=2, device="cpu", timeout=TIMEOUT)
    with torch.no_grad():
        return {"groups": _group_ranks(mesh),
                "plain": _np(ring_attention_packed(q, k, v, heads, mesh)),
                "bias": _np(ring_attention_packed(q, k, v, heads, mesh, bias=bias))}


def generation_cases(rank, world, inputs):
    """EEG2VideoPipeline.shard at (dp, sp, tp) = (2,1,1), (1,2,1), (1,1,2) on
    the tiny pipeline, the indivisible batch, the latents=None draw under dp
    = 2, and inference_eeg2video.main --dp 2."""
    import numpy as np
    import torch

    from eeg2video_tpu_torch.cli import inference_eeg2video
    from eeg2video_tpu_torch.data import video
    from eeg2video_tpu_torch.parallel import make_mesh
    from eeg2video_tpu_torch.train import unet_tp_rules

    emb, neg, lat = inputs["emb"], inputs["neg"], inputs["lat"]
    kw = inputs["kw"]
    out = {"videos": {}}
    for dims in ((2, 1, 1), (1, 2, 1), (1, 1, 2)):
        dp, sp, tp = dims
        pipe = _tiny_pipeline(inputs).shard(
            make_mesh(dp=dp, sp=sp, tp=tp, device="cpu", timeout=TIMEOUT), unet_tp_rules)
        out["videos"][dims] = _np(pipe(emb[:2], neg, latents=lat[:2], **kw))
    pipe = _tiny_pipeline(inputs).shard(make_mesh(dp=1, sp=2, device="cpu", timeout=TIMEOUT))
    out["sp_calls"] = _attention_calls(lambda: pipe(
        emb[:2], neg, latents=lat[:2], **{**kw, "num_inference_steps": 1, "decode": False}))
    pipe = _tiny_pipeline(inputs).shard(make_mesh(dp=2, device="cpu", timeout=TIMEOUT))
    out["batch_error"] = _raises(ValueError, lambda: pipe(emb[:3], neg, latents=lat[:3], **kw))
    out["drawn"] = _np(pipe(emb[:2], neg, generator=torch.Generator().manual_seed(5),
                            **{**kw, "num_inference_steps": 1, "decode": False}))

    written = []
    real = video.save_videos_grid

    def record(videos, path, **k):
        written.append(os.path.basename(path))
        return real(videos, path, **k)

    video.save_videos_grid = record
    inference_eeg2video.load_pipeline = lambda *a, **k: _tiny_pipeline(inputs)
    inference_eeg2video.main([*inputs["cli_args"], "--dp", "2"])
    out["written"] = sorted(written)
    out["dir_made"] = os.path.isdir(inputs["cli_out"])
    return out


# --- training: the ring's backward, the tp block, the step on a mesh ------------

def _ring_grads(fn, operands, dout):
    """(out, grads of every operand) of ``fn(*operands)`` against ``dout``."""
    import torch

    leaves = [None if t is None else t.clone().requires_grad_() for t in operands]
    out = fn(*leaves)
    wanted = [t for t in leaves if t is not None]
    grads = torch.autograd.grad((out * dout).sum(), wanted)
    return [_np(out)] + [_np(g) for g in grads]


def ring_bwd_cases(rank, world, inputs):
    """The ring's gradients at sp = 2 (world size 2): ring and replicated-KV
    mode with and without bias through ring_attention_packed, and the local
    shards' gradients through ring_attention_inner (the ring with bias)."""
    import torch

    from eeg2video_tpu_torch.ops.ring import ring_attention_inner, ring_attention_packed
    from eeg2video_tpu_torch.parallel import make_mesh

    heads = inputs["heads"]
    t = {n: _t(inputs[n]) for n in ("q", "k", "v", "k77", "v77", "bias", "bias77", "dout")}
    mesh = make_mesh(dp=1, sp=2, tp=1, device="cpu", timeout=TIMEOUT)
    out = {}
    for case, (k, v, b) in inputs["cases"].items():
        out[case] = _ring_grads(
            lambda q_, k_, v_, b_: ring_attention_packed(q_, k_, v_, heads, mesh, bias=b_),
            [t["q"], t[k], t[v], None if b is None else t[b]], t["dout"])
    lq = t["q"].shape[1] // 2
    rows = slice(rank * lq, (rank + 1) * lq)
    scale = (t["q"].shape[-1] // heads) ** -0.5
    out["inner"] = _ring_grads(
        lambda q_, k_, v_, b_: ring_attention_inner(q_, k_, v_, heads, scale, mesh.group("sp"),
                                                    2, bias=b_),
        [t["q"][:, rows], t["k"][:, rows], t["v"][:, rows], t["bias"][..., rows]],
        t["dout"][:, rows])
    return out


def ring_bwd_sp_tp_cases(rank, world, inputs):
    """The ring's gradients at sp = 2 x tp = 2 (world size 4), heads over
    tp, with and without bias."""
    from eeg2video_tpu_torch.ops.ring import ring_attention_packed
    from eeg2video_tpu_torch.parallel import make_mesh

    heads = inputs["heads"]
    q, k, v, bias, dout = (_t(inputs[n]) for n in ("q", "k", "v", "bias", "dout"))
    mesh = make_mesh(dp=1, sp=2, tp=2, device="cpu", timeout=TIMEOUT)
    return {b: _ring_grads(lambda q_, k_, v_, b_: ring_attention_packed(
        q_, k_, v_, heads, mesh, bias=b_, head_axis="tp"), [q, k, v, bias if b else None], dout)
        for b in (False, True)}


def _tp_block_grads(inputs):
    """A transformer block at tp = 2 with train=True: its output, the
    gradients of its input, context and attention bias, and every
    parameter's gradient (this rank's shard)."""
    import torch

    from eeg2video_tpu_torch.models.attention3d import BasicTransformerBlock
    from eeg2video_tpu_torch.parallel import make_mesh, shard_params
    from eeg2video_tpu_torch.train import unet_tp_rules

    mesh = make_mesh(dp=1, sp=1, tp=2, device="cpu", timeout=TIMEOUT)
    blk = BasicTransformerBlock(64, 4, 16, 16)
    blk.load_state_dict({k: torch.from_numpy(v) for k, v in inputs["block"].items()},
                        strict=True)
    shard_params(blk, mesh, unet_tp_rules)
    x, ctx, bias = (_t(inputs[n]).requires_grad_() for n in ("x", "ctx_block", "bias"))
    out = blk(x, ctx, bias, train=True)
    (out * _t(inputs["dout"])).sum().backward()
    return {"out": _np(out), "x": _np(x.grad), "ctx": _np(ctx.grad), "bias": _np(bias.grad),
            "params": {n: _np(p.grad) for n, p in blk.named_parameters()}}


def _micro_unet(inputs):
    import torch

    from eeg2video_tpu_torch.models.unet3d import UNet3DConditionModel, UNet3DConfig

    unet = UNet3DConditionModel(UNet3DConfig(**inputs["ucfg"]))
    unet.load_state_dict({k: torch.from_numpy(v) for k, v in inputs["unet"].items()},
                         strict=True)
    return unet


def _mesh_state(inputs, mesh, fsdp, eight_bit, dtype):
    import dataclasses

    from eeg2video_tpu_torch.parallel import shard_params
    from eeg2video_tpu_torch.train import init_video_train_state, unet_tp_rules
    from eeg2video_tpu_torch.train.videodiffusion import VideoDiffusionTrainConfig

    unet = _micro_unet(inputs)
    if mesh.size("tp") > 1:
        shard_params(unet, mesh, unet_tp_rules)
    cfg = dataclasses.replace(VideoDiffusionTrainConfig(**inputs["tcfg"]),
                              use_8bit_adam=eight_bit, compute_dtype=dtype)
    return init_video_train_state(unet, cfg, "cpu", mesh=mesh, fsdp=fsdp)


def _mesh_step(state, inputs, step):
    """One train_step on this rank's dp slice of the batch, JAX's draws of
    ``step`` (global) passed in."""
    from eeg2video_tpu_torch.parallel import shard_batch
    from eeg2video_tpu_torch.train import train_step

    post, ctx = (shard_batch(_t(inputs[n]), state.mesh) for n in ("post", "ctx"))
    t, noise, eps = (_t(a) for a in inputs["draws"][step])
    return float(train_step(state, None, post, ctx, seed=0, t=t, noise=noise, eps=eps))


def _opt_shapes(state):
    return {n: {k: tuple(v.shape) for k, v in state.optimizer.state[m].items()
                if hasattr(v, "shape") and v.dim()}
            for n, m in state.masters.items()}


def training_cases(rank, world, inputs):
    """The fine-tune step on the micro UNet at each mesh of
    ``inputs["layouts"][world]``, (dp, sp, tp, fsdp, 8-bit, compute dtype): the dp-mean
    loss and, on rank 0, the parameters after it (whole). At world size 2
    also the tp block's gradients; with fsdp or 8-bit Adam the masters' and
    moments' shapes, the resident bytes, the checkpoint, and a second step's
    loss and parameters. Then ``train_tuneavideo.main`` with each of
    ``inputs["cli"][world]``'s lists of flags."""
    out = {}
    if world == 2:
        out["block"] = _tp_block_grads(inputs)
    from eeg2video_tpu_torch.parallel import make_mesh

    for key in inputs["layouts"][world]:
        dp, sp, tp, fsdp, eight, dtype = key
        mesh = make_mesh(dp=dp, sp=sp, tp=tp, device="cpu", timeout=TIMEOUT)
        state = _mesh_state(inputs, mesh, fsdp, eight, dtype)
        res = {"loss": _mesh_step(state, inputs, 0),
               "params": {n: _np(v) for n, v in state.params_f32().items()}}
        if fsdp or eight:
            res["masters"] = {n: tuple(m.shape) for n, m in state.masters.items()}
            res["moments"] = _opt_shapes(state)
            res["resident"] = state.resident_bytes()
            res["ckpt"] = state.state_dict()
            res["loss2"] = _mesh_step(state, inputs, 1)
            res["params2"] = {n: _np(v) for n, v in state.params_f32().items()}
        if rank:  # the gathers ran on every rank; rank 0 returns what they gave
            res = {k: res[k] for k in ("loss", "loss2") if k in res}
        out[key] = res
    out["cli"] = [_train_cli(inputs, flags) for flags in inputs["cli"][world]]
    if world == 2:
        out["mesh_step"] = _mesh_step_lines()
    return out


def _mesh_step_lines():
    """``utils.mesh_step`` on the micro UNet over this world (dp = 2): its
    JSON lines (rank 0 prints them)."""
    import contextlib
    import io
    import json

    from eeg2video_tpu_torch.utils import mesh_step

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mesh_step.main(["--device", "cpu", "--tiny", "--batch", "2", "--steps", "2",
                        "--mesh", "2,1,1", "--mesh", "2,1,1,fsdp"])
    return [json.loads(line) for line in buf.getvalue().splitlines()]


class _Clips:
    """A stand-in for VideoClipDataset: the clips of ``pixels``."""

    def __init__(self, pixels):
        self.pixels = pixels

    def __call__(self, paths, ids):
        return self

    def __len__(self):
        return len(self.pixels)

    def load_all(self):
        import numpy as np

        return self.pixels, np.arange(len(self.pixels))


def _train_cli(inputs, flags):
    """``train_tuneavideo.main`` on the micro UNet, the tiny VAE and the
    clips of ``inputs["clips"]``: the per-epoch losses and the last train
    state (rank 0)."""
    import json

    import torch

    from eeg2video_tpu_torch.cli import train_tuneavideo as cli
    from eeg2video_tpu_torch.models.unet3d import UNet3DConfig

    cli.UNet3DConfig = lambda: UNet3DConfig(**inputs["ucfg"])
    cli.VideoClipDataset = _Clips(inputs["clips"])
    out_dir = os.path.join(inputs["cli_dir"],
                           f"w{torch.distributed.get_world_size()}_" + "_".join(flags))
    assert cli.main([*inputs["cli_args"], "--output_dir", out_dir, *flags]) == 0
    if torch.distributed.get_rank():
        return None
    with open(os.path.join(out_dir, "tuneavideo_metrics.jsonl")) as f:
        losses = [json.loads(line)["train_loss"] for line in f]
    saved = torch.load(os.path.join(out_dir, "ckpt", "train_state_1.pt"), weights_only=False)
    return {"losses": losses, "params": {n: _np(v) for n, v in saved["params"].items()},
            "step": saved["step"], "files": sorted(os.listdir(out_dir)),
            "samples": sorted(os.listdir(os.path.join(out_dir, "samples")))}


# --- the pipeline and the semantic trainer on a mesh --------------------------

def _block(p, a):
    import torch

    return torch.relu(a @ p[0] + p[1])


def _gpipe_grads(inputs, world, n_micro, split):
    """``gpipe_apply`` of the world's stages on ``inputs["x"]``: the output,
    x's gradient and this stage's (w, b) gradients against the cotangent
    ``inputs["cot"]``; with ``split`` each rank consumes only its columns of
    the output (the column-split head)."""
    import torch
    import torch.distributed as dist

    from eeg2video_tpu_torch.parallel import gpipe_apply

    r = dist.get_rank()
    x = _t(inputs["x"]).clone().requires_grad_()
    w, b = (_t(inputs[n][r]).clone().requires_grad_() for n in ("w", "b"))
    out = gpipe_apply(_block, (w, b), x, dist.group.WORLD, n_micro, out_split=split)
    cot = _t(inputs["cot"])
    if split:
        out_r, cot = out.chunk(world, -1)[r], cot.chunk(world, -1)[r]
        (out_r * cot).sum().backward()
    else:
        (out * cot).sum().backward()
    return [_np(out), _np(x.grad), _np(w.grad), _np(b.grad)]


def pipeline_cases(rank, world, inputs):
    """gpipe_apply at pp = world for each n_micro of ``inputs["n_micro"][world]``,
    its head replicated and split; the refusal of an indivisible batch."""
    import torch
    import torch.distributed as dist

    from eeg2video_tpu_torch.parallel import gpipe_apply

    out = {(nm, split): _gpipe_grads(inputs, world, nm, split)
           for nm in inputs["n_micro"][world] for split in (False, True)}
    with torch.no_grad():
        out["no_grad"] = _np(gpipe_apply(_block, (_t(inputs["w"][rank]), _t(inputs["b"][rank])),
                                         _t(inputs["x"]), dist.group.WORLD, 2))
    out["batch_error"] = _raises(ValueError, lambda: gpipe_apply(
        _block, (_t(inputs["w"][rank]), _t(inputs["b"][rank])), _t(inputs["x"])[:7],
        dist.group.WORLD, 2))
    return out


def _semantic_model(inputs, out_dim):
    import torch

    from eeg2video_tpu_torch.models.semantic import SemanticPredictor

    model = SemanticPredictor(hidden=inputs["hidden"], out_dim=out_dim)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in inputs["init"][out_dim].items()},
                          strict=True)
    return model


def semantic_cases(rank, world, inputs):
    """``train_semantic`` at each run of ``inputs["runs"][world]``, (tp, pp,
    n_micro, 8-bit, out_dim): the losses, the returned state dict (None on an
    idle rank) and, with 8-bit Adam, m's row scales of this rank's leaves
    after the first step; then ``cli.train_semantic.main`` with ``inputs["cli"][world]``
    and the files each rank wrote."""
    import numpy as np
    import torch

    from eeg2video_tpu_torch.train import semantic as tsem

    out = {}
    for key in inputs["runs"][world]:
        tp, pp, n_micro, eight, out_dim = key
        cfg = tsem.SemanticTrainConfig(**{**inputs["cfg"], "out_dim": out_dim,
                                          "use_8bit_adam": eight})
        text = inputs["text"][:, :out_dim]
        model = _semantic_model(inputs, out_dim)
        scales = {}

        def first_scales(step, loss, opt):
            if step == 1 and eight:
                scales.update({n: _np(opt.state[p]["ms"]) for n, p in model.named_parameters()
                               if p in opt.state})

        sd, losses = tsem.train_semantic(inputs["eeg"], text, cfg, seed=0, tp=tp, pp=pp,
                                         n_micro=n_micro, model=model, device="cpu",
                                         on_step=first_scales)
        out[key] = (losses, None if sd is None else {k: _np(v) for k, v in sd.items()}, scales)
    if inputs["cli"].get(world):
        from eeg2video_tpu_torch.cli import train_semantic as cli

        written = []
        real = torch.save
        torch.save = lambda obj, path, *a, **k: written.append(os.fspath(path)) or real(
            obj, path, *a, **k)
        real_np = np.savez
        np.savez = lambda path, *a, **k: written.append(os.fspath(path)) or real_np(path, *a, **k)
        try:
            out["cli"] = cli.main(inputs["cli"][world])
        finally:
            torch.save, np.savez = real, real_np
        out["written"] = written
    return out


# --- serving on a mesh -------------------------------------------------------

class _Lines:
    """rank 0's stdin: the lines, each after its pause in seconds; then, with
    ``hold``, no end of input (a server that stays up until it is stopped)."""

    def __init__(self, lines, pauses=None, hold=False):
        self.lines, self.pauses, self.hold = lines, pauses or {}, hold

    def __iter__(self):
        import threading
        import time

        for i, line in enumerate(self.lines):
            time.sleep(self.pauses.get(i, 0.0))
            yield line + "\n"
        if self.hold:
            threading.Event().wait()


class _NoStdin:
    def __iter__(self):
        raise AssertionError("a follower read stdin")


def _listen_client(main, argv, lines):
    """``main(argv + --listen)`` on a thread with stdout on a pipe; one
    connection sends every line and reads one reply a line. Returns (rc,
    [ready line] + replies)."""
    import json
    import socket
    import threading

    out_r, out_w = os.pipe()
    out_file = os.fdopen(out_w, "w")
    real = sys.stdout
    sys.stdout = out_file
    rc = []

    def run():
        try:
            rc.append(main([*argv, "--listen", "127.0.0.1:0"]))
        finally:
            out_file.close()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    try:
        with os.fdopen(out_r) as r:
            ready = json.loads(r.readline())
            sock = socket.create_connection(("127.0.0.1", ready["port"]), timeout=60)
            rfile = sock.makefile("r", encoding="utf-8")
            assert json.loads(rfile.readline())["ready"]
            for line in lines:
                sock.sendall((line + "\n").encode())
            replies = [json.loads(rfile.readline()) for _ in lines]
            t.join(timeout=60)
            rest = r.read()
        sock.close()
    finally:
        sys.stdout = real
    assert rest == "", rest
    return rc[0], [ready] + replies


def _serve_main(inputs, run):
    """``cli.serve.main`` on this rank with the tiny pipeline: rank 0 reads
    ``run["lines"]`` from stdin (or over one connection with ``listen``).
    Returns the exit code, what this rank printed (rank 0: its replies), the
    arrays it handed to the GIF writer ({"<dir>/<gif>": array}) and the
    pipeline calls it ran. ``run`` may also hold ``pauses`` and ``hold`` (of
    ``_Lines``), ``sigterm_at`` (this process sends itself SIGTERM at that
    pipeline call), ``fail_rank`` (that rank's UNet raises) and
    ``mesh_timeout`` (seconds, the mesh groups' timeout)."""
    import datetime
    import io
    import json
    import signal

    import numpy as np
    import torch.distributed as dist

    from eeg2video_tpu_torch.cli import serve
    from eeg2video_tpu_torch.data import video
    from eeg2video_tpu_torch.diffusion.pipeline import EEG2VideoPipeline

    rank = dist.get_rank()
    seen, calls = {}, []
    real_save, real_call, real_mesh = video.save_videos_grid, EEG2VideoPipeline.__call__, \
        serve.make_mesh

    def record(videos, path, **kw):
        seen[os.path.join(os.path.basename(os.path.dirname(path)), os.path.basename(path))] = \
            np.array(videos, np.float32)
        real_save(videos, path, **kw)

    def counted(self, *a, **k):
        calls.append(1)
        if run.get("sigterm_at") == len(calls):
            os.kill(os.getpid(), signal.SIGTERM)
        return real_call(self, *a, **k)

    def pipeline(*a, **k):
        pipe = _tiny_pipeline(inputs)
        if run.get("fail_rank") == rank:
            def fail(*a, **k):
                raise RuntimeError("a fault inside the sharded forward")
            pipe.unet.forward = fail
        return pipe

    if "mesh_timeout" in run:
        timeout = datetime.timedelta(seconds=run["mesh_timeout"])
        serve.make_mesh = lambda *a, **k: real_mesh(*a, **k, timeout=timeout)
    serve.load_pipeline = pipeline
    video.save_videos_grid = record
    EEG2VideoPipeline.__call__ = counted
    real_in, real_out = sys.stdin, sys.stdout
    out = io.StringIO()
    sys.stdin = (_Lines(run["lines"], run.get("pauses"), run.get("hold")) if rank == 0
                 else _NoStdin())
    sys.stdout = out
    try:
        if run.get("listen") and rank == 0:
            sys.stdout = real_out
            rc, replies = _listen_client(serve.main, run["argv"], run["lines"])
        else:
            rc = serve.main(run["argv"])
            replies = [json.loads(line) for line in out.getvalue().splitlines() if line.strip()]
    finally:
        sys.stdin, sys.stdout = real_in, real_out
        video.save_videos_grid, EEG2VideoPipeline.__call__ = real_save, real_call
        serve.make_mesh = real_mesh
    return {"rc": rc, "printed": replies, "seen": seen, "calls": len(calls)}


def serving_cases(rank, world, inputs):
    """``cli.serve.main`` at each run of ``inputs["runs"][world]`` (name ->
    run, see ``_serve_main``), every rank."""
    return {name: _serve_main(inputs, run) for name, run in inputs["runs"][world].items()}


# --- EEG-VP's fold mesh -----------------------------------------------------------

def _folds(res):
    """A run_benchmark result as numpy (None on a rank past the mesh)."""
    if res is None:
        return None
    return [{k: ({n: _np(v) for n, v in f["params"].items()} if k == "params" else f[k])
             for k in f} for f in res["folds"]]


def fold_mesh_cases(rank, world, inputs):
    """``run_benchmark(fold_parallel=True)`` on a 7-rank fold mesh of this
    world (the port's draws, then JAX's passed in); at world 7 also the
    refusal of a fold mesh of 2 and ``eegvp_train_test.main --fold_parallel``
    (the files are compared by the caller)."""
    from eeg2video_tpu_torch.cli import eegvp_train_test
    from eeg2video_tpu_torch.parallel import make_fold_mesh
    from eeg2video_tpu_torch.train import eegvp

    cfg = eegvp.EEGVPConfig(**inputs["cfg"])
    feats, labels = inputs["feats"], inputs["labels"]
    mesh = make_fold_mesh(7, "cpu", timeout=TIMEOUT)
    run = lambda m, **k: eegvp.run_benchmark(feats, labels, cfg, seed=inputs["seed"],
                                             fold_parallel=True, mesh=m, device="cpu", **k)
    out = {"active": mesh.active, "own": _folds(run(mesh)),
           "jax_draws": _folds(run(mesh, draws=inputs["draws"]))}
    if world == 7:
        two = make_fold_mesh(2, "cpu", timeout=TIMEOUT)
        out["refused"] = _raises(ValueError, lambda: run(two))
        eegvp_train_test.main(inputs["cli_args"])
    return out


# --- train_glmnet --dp --------------------------------------------------------------

def _glmnet_run(inputs, mesh, **kw):
    """``train_glmnet`` on the mesh: (the state dict, the epochs' losses)."""
    from eeg2video_tpu_torch.cli import train_glmnet

    model, losses = train_glmnet.train_glmnet(inputs["train"], device="cpu", mesh=mesh,
                                              **inputs["train_kw"], **kw)
    return {k: _np(v) for k, v in model.state_dict().items()}, losses


def _glmnet_main(argv):
    """``train_glmnet.main(argv)``: (its return value or the SystemExit's code,
    what it wrote to stderr)."""
    import contextlib
    import io

    from eeg2video_tpu_torch.cli import train_glmnet

    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        try:
            ret = train_glmnet.main(argv)
        except SystemExit as e:
            ret = ("exit", e.code)
    return ret, err.getvalue()


def glmnet_dp_cases(rank, world, inputs):
    """``train_glmnet`` with dropout on at dp = world (the port's own draws),
    and with dropout off given JAX's draws at dp = 2 (world 2); then the CLI:
    ``--dp`` over the whole world, ``--dp world - 1`` (the last rank idle, the
    batch rounded down) and ``--dp world + 1`` (refused)."""
    from eeg2video_tpu_torch.models.layers import Dropout
    from eeg2video_tpu_torch.parallel import make_mesh

    mesh = make_mesh(dp=world, device="cpu", timeout=TIMEOUT)
    out = {"dropout": _glmnet_run(inputs, mesh)}
    if world == 2:
        forward = Dropout.forward
        Dropout.forward = lambda self, x: x
        try:
            out["jax_draws"] = _glmnet_run(inputs, mesh, init_params=inputs["jax_init"],
                                           perms=inputs["jax_perms"])
        finally:
            Dropout.forward = forward
    args = inputs["cli_args"]
    out["cli"] = {dp: _glmnet_main(args + ["--dp", str(dp), "--save_path",
                                           os.path.join(inputs["cli_dir"], f"w{world}_dp{dp}")])
                  for dp in (world, world - 1, world + 1)}
    return out


# --- fsdp's per-use gather ----------------------------------------------------------

def _working_bytes(state):
    return sum(p.numel() * p.element_size() for p in state.unet.parameters())


def fsdp_gather_cases(rank, world, inputs):
    """The fine-tune step with fsdp at each (dp, sp, tp) of
    ``inputs["fsdp_layouts"][world]``: the dp-mean loss, the model's
    parameter shapes and bytes between steps, the gathered whole weights
    still alive at each unit's exit and after the step, the gathers, and on
    rank 0 the parameters after the step and the checkpoint; a second step's
    loss and parameters. Then ``train_tuneavideo.main`` with each of
    ``inputs["cli"][world]``'s lists of flags."""
    from eeg2video_tpu_torch.parallel import make_mesh

    out = {}
    for dp, sp, tp in inputs["fsdp_layouts"][world]:
        mesh = make_mesh(dp=dp, sp=sp, tp=tp, device="cpu", timeout=TIMEOUT)
        state = _mesh_state(inputs, mesh, True, False, "float32")
        gather = state.gather
        at_exit = []
        for unit, items in gather.by_unit.items():
            if unit is not gather.root and items:
                unit.register_forward_hook(
                    lambda m, a, o: at_exit.append(gather.live_wholes(root=False)))
        res = {"shapes": {n: tuple(p.shape) for n, p in state.unet.named_parameters()},
               "bytes": _working_bytes(state)}
        res["loss"] = _mesh_step(state, inputs, 0)
        res.update(at_exit=list(at_exit), after=gather.live_wholes(), gathers=gather.gathers,
                   n_units=sum(1 for u, items in gather.by_unit.items()
                               if u is not gather.root and items),
                   n_pieces=sum(len(items) for items in gather.by_unit.values()),
                   n_gathering=sum(1 for items in gather.by_unit.values() if items),
                   bytes_after=_working_bytes(state),
                   grad_free=all(p.grad is None for p in state.unet.parameters()))
        res["params"] = {n: _np(v) for n, v in state.params_f32().items()}
        res["ckpt"] = state.state_dict()
        res["loss2"] = _mesh_step(state, inputs, 1)
        res["params2"] = {n: _np(v) for n, v in state.params_f32().items()}
        if rank:
            res = {k: v for k, v in res.items() if k not in ("params", "params2", "ckpt")}
        out[(dp, sp, tp)] = res
    out["cli"] = [_train_cli(inputs, flags) for flags in inputs["cli"].get(world, [])]
    return out
