"""Worker processes of the port's multi-process CPU tests
(tests/test_torch_parallel.py, test_torch_ring.py,
test_torch_sharded_generation.py).

``start(case, world, inputs, tmp_path)`` starts ``world`` processes with the
``spawn`` start method (the pytest process holds JAX's runtime, which a fork
would copy), each joins a gloo group on a file store in ``tmp_path`` with a
60 s timeout and runs ``case(rank, world, inputs)`` from this module, which
imports torch and the port only; the caller may compute JAX's side
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
import time
import traceback

TIMEOUT = datetime.timedelta(seconds=60)
DEADLINE = 120.0


def _entry(rank, world, case, store, inputs_path, out_dir):
    try:
        import torch
        import torch.distributed as dist

        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=world, timeout=TIMEOUT)
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
    def __init__(self, case, world, inputs, tmp_path, deadline):
        self.case, self.world = case, world
        self.out_dir = os.path.join(os.fspath(tmp_path), f"spawn_{case}_{world}")
        os.makedirs(self.out_dir)
        inputs_path = os.path.join(self.out_dir, "inputs.pkl")
        with open(inputs_path, "wb") as f:
            pickle.dump(inputs, f)
        ctx = multiprocessing.get_context("spawn")
        store = os.path.join(self.out_dir, "store")
        self.procs = [ctx.Process(target=_entry, daemon=True,
                                  args=(r, world, case, store, inputs_path, self.out_dir))
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


def start(case, world, inputs, tmp_path, deadline=DEADLINE):
    return Spawn(case, world, inputs, tmp_path, deadline)


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
    out["block_grad"] = _raises(RuntimeError, lambda: blk(x.requires_grad_(), ctx))
    return out


def ring_cases(rank, world, inputs):
    """Ring attention at world size 2: ring and replicated-KV mode with and
    without bias on a (1, 2, 1) mesh, sp = 1 on a (2, 1, 1) mesh against
    flash_attention_plain, the divisibility errors, the gradient refusal."""
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
    out["grad_error"] = _raises(RuntimeError, lambda: ring_attention_packed(
        q.clone().requires_grad_(), k, v, heads, sp_mesh))
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
