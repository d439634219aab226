"""The port's process group, mesh and parameter sharding (parallel/,
train.unet_tp_rules) against the JAX package's, on the CPU.

The mesh layout and its axis groups are held to JAX's ``make_mesh(...)
.devices`` on the virtual CPU devices; the live groups, ``local_batch_slice``,
``shard_params`` with ``unet_tp_rules`` on the tiny UNet and a tp = 2
transformer block run in one spawn of two gloo processes
(``tests/_torch_dist_worker.py``; 60 s group timeout, 120 s deadline). The
sharded parameters are checked against JAX's ``unet_tp_rules`` applied to the
flax tree that JAX's own converter (``eeg2video_tpu.convert.unet_params``)
makes of the same weights, carried back into the port's key space by
``convert.from_jax``.
"""

from collections import Counter

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax

from eeg2video_tpu.convert.unet_params import unet3d_params_from_torch_3d
from eeg2video_tpu.parallel import make_mesh as jmake_mesh
from eeg2video_tpu.train import unet_tp_rules as jrules
from eeg2video_tpu_torch.convert.from_jax import unet_state_dict_from_jax
from eeg2video_tpu_torch.models.attention3d import BasicTransformerBlock
from eeg2video_tpu_torch.models.unet3d import UNet3DConditionModel, UNet3DConfig
from eeg2video_tpu_torch.ops import geglu
from eeg2video_tpu_torch.parallel import (init_distributed, local_batch_slice, make_mesh,
                                          mesh as pmesh)
from eeg2video_tpu_torch.parallel.distributed import backend_for
from eeg2video_tpu_torch.train import unet_tp_rules

import _torch_dist_worker
from test_torch_models import capped_threads, random_state

_threads = capped_threads()

BLOCK_TOL = dict(rtol=2e-5, atol=2e-5)
LAYOUTS = [(2, 1, 1), (1, 2, 1), (1, 1, 2), (2, 2, 1), (1, 2, 2)]
LAUNCHER = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def _jax_lines(dp, sp, tp):
    """{axis: sorted lines of device ids} of JAX's mesh on dp*sp*tp devices."""
    m = jmake_mesh(dp=dp, tp=tp, sp=sp, devices=jax.devices()[:dp * sp * tp])
    ids = np.vectorize(lambda d: d.id)(m.devices)
    lines = {}
    for i, axis in enumerate(m.axis_names):
        moved = np.moveaxis(ids, i, -1)
        lines[axis] = sorted(map(list, moved.reshape(-1, moved.shape[-1]).tolist()))
    return ids.reshape(dp, sp, tp), lines


@pytest.mark.parametrize("dims", LAYOUTS)
def test_mesh_layout_and_groups_match_jax(dims):
    ids, lines = _jax_lines(*dims)
    ranks = pmesh.layout(*dims)
    np.testing.assert_array_equal(ranks, ids)
    for axis in pmesh.AXES:
        if ranks.shape[pmesh.AXES.index(axis)] > 1:
            assert sorted(pmesh.axis_lines(ranks, axis)) == lines[axis], axis


def test_mesh_size_must_be_the_world():
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match=r"dp\*sp\*tp = 8 != 1 devices"):
        make_mesh(dp=2, sp=2, tp=2, device="cpu")
    with pytest.raises(ValueError, match=r"dp\*sp\*tp = 4 != 8 devices"):
        jmake_mesh(dp=2, tp=2)
    assert not dist.is_initialized()


def test_init_distributed_is_a_no_op_without_a_launcher(monkeypatch):
    for k in LAUNCHER:
        monkeypatch.delenv(k, raising=False)
    assert init_distributed("cpu") is False and not dist.is_initialized()
    assert local_batch_slice(6) == slice(0, 6)
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="WORLD_SIZE"):
        init_distributed("cpu")
    assert (backend_for("cuda"), backend_for("cpu")) == ("nccl", "gloo")


def test_a_size_one_mesh_without_a_launcher():
    """``--dp 1`` on one GPU: a world of one on a local store (gloo here)."""
    assert not dist.is_initialized()
    try:
        mesh = make_mesh(device="cpu")
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        assert mesh.shape == {"dp": 1, "sp": 1, "tp": 1}
        assert mesh.coords == {"dp": 0, "sp": 0, "tp": 0}
        assert all(mesh.group(a) is None for a in pmesh.AXES)
        assert init_distributed("cpu") is False  # idempotent: the group stays
        assert dist.is_initialized()
        x = torch.arange(4.0)[:, None]
        assert torch.equal(pmesh.gather_batch(pmesh.shard_batch(x, mesh), mesh), x)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_shard_refuses_a_tp_that_cuts_heads():
    """tp = 8 divides every width of the tiny UNet (C = 32, 64) but not its 4
    heads: a rank's to_q/k/v shard would hold half a head. The pipeline
    refuses by name before it slices any parameter."""
    from eeg2video_tpu_torch.diffusion.pipeline import EEG2VideoPipeline
    from eeg2video_tpu_torch.models.vae import VAEConfig

    pipe = EEG2VideoPipeline.create(None, None, UNet3DConfig.tiny(), VAEConfig.tiny(),
                                    dtype=torch.float32, device="cpu")
    shapes = {k: v.shape for k, v in pipe.unet.state_dict().items()}
    mesh = pmesh.Mesh(1, 1, 8, torch.device("cpu"), dict.fromkeys(pmesh.AXES))
    with pytest.raises(ValueError, match=r"down_blocks\.0\.attentions\.0\.transformer_blocks"
                                         r"\.0\.attn1: heads=4 not divisible by tp=8"):
        pipe.shard(mesh, unet_tp_rules)
    assert {k: v.shape for k, v in pipe.unet.state_dict().items()} == shapes
    assert pipe.mesh is None


def _code_tree(jparams):
    """JAX's unet_tp_rules as numbers on every leaf of the flax tree: 0
    replicated, 1 P(None, "tp") (column), 2 P("tp", None) (row)."""
    codes = {(): 0, (None, "tp"): 1, ("tp", None): 2}

    def code(path, leaf):
        return np.full(leaf.shape, codes[tuple(jrules(path))], np.float32)

    return jax.tree_util.tree_map_with_path(code, jparams)


def _block_state(seed):
    """Random weights of BasicTransformerBlock(64, 4, 16, 16), every bias and
    norm offset far from 0, so that a bias added twice shows."""
    g = torch.Generator().manual_seed(seed)
    blk = BasicTransformerBlock(64, 4, 16, 16)
    sd = {}
    for name, p in blk.state_dict().items():
        r = torch.randn(p.shape, generator=g)
        sd[name] = (r / np.sqrt(p.shape[-1]) if p.dim() == 2 else 0.5 + 0.2 * r).numpy()
    return sd


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """One spawn of two ranks: the parallel cases of _torch_dist_worker. JAX's
    rules are read off its parameter tree, converted from the same weights by
    its own converter while the ranks run."""
    with torch.device("meta"):
        unet = random_state(UNet3DConditionModel(UNet3DConfig.tiny()), 3)
    rng = np.random.default_rng(4)
    inputs = {"unet": unet, "block": _block_state(5),
              "x": rng.standard_normal((2, 3, 8, 64)).astype(np.float32),
              "ctx": rng.standard_normal((2, 5, 16)).astype(np.float32)}
    handle = _torch_dist_worker.start("parallel_cases", 2, inputs,
                                      tmp_path_factory.mktemp("parallel"))
    jparams = unet3d_params_from_torch_3d(unet)["params"]
    codes = {k: np.unique(v.numpy()) for k, v in
             unet_state_dict_from_jax(_code_tree(jparams), UNet3DConfig.tiny()).items()}
    return inputs, codes, handle.join()


def test_live_groups_and_batch_slices_at_world_size_two(world2):
    """The groups of each axis, local_batch_slice, and the host-0 log filter
    (records below ERROR only on rank 0; without a group every record)."""
    _, _, results = world2
    assert _torch_dist_worker._host0_filter() == (True, True)
    for r, res in enumerate(results):
        assert res["slice"] == slice(3 * r, 3 * r + 3)
        assert res["log"] == (r == 0, True)
        for dims, (coords, groups) in res["meshes"].items():
            ranks = pmesh.layout(*dims)
            assert coords == dict(zip(pmesh.AXES, (int(c) for c in np.argwhere(ranks == r)[0])))
            for axis, members in groups.items():
                size = ranks.shape[pmesh.AXES.index(axis)]
                assert members == (None if size == 1 else [0, 1]), (dims, axis)


def test_shard_params_follows_jax_unet_tp_rules(world2):
    """Every parameter the port's rules split is one JAX's rules split, on
    the transposed dim; the GEGLU projection's weight and bias keep the same
    rows of the hidden and of the gate half on each rank; every other
    parameter stays whole."""
    inputs, codes, results = world2
    full = inputs["unet"]
    names = list(UNet3DConditionModel(UNet3DConfig.tiny()).state_dict())
    assert set(names) == set(full) == set(codes)
    kinds = Counter()
    for name in names:
        (code,) = codes[name]
        rule = unet_tp_rules(name)
        if ".ff.net.0.proj." in name:
            # split by halves; JAX column-splits the kernel and leaves the
            # bias to GSPMD (P()), which reshards the contiguous split for it
            assert rule == (0, "tp", 2) and code == (1 if name.endswith("weight") else 0)
        else:
            assert rule == {0: None, 1: (0, "tp"), 2: (1, "tp")}[int(code)], name
        for r, res in enumerate(results):
            got, want = res["params"][name], full[name]
            if rule is None:
                np.testing.assert_array_equal(got, want, err_msg=name)
                continue
            dim, groups = rule[0], (rule[2] if len(rule) > 2 else 1)
            pieces = [np.split(part, 2, axis=dim)[r] for part in np.split(want, groups, axis=dim)]
            np.testing.assert_array_equal(got, np.concatenate(pieces, axis=dim), err_msg=name)
            assert got.shape[dim] * 2 == want.shape[dim]
        if rule is not None:
            kinds["halves" if len(rule) > 2 else ("column", "row")[rule[0]]] += 1
    # 16 transformer blocks: 3 attentions' to_q/k/v, their to_out and the ff out, the ff proj
    assert kinds == {"column": 144, "row": 64, "halves": 32}
    assert all(res["unet_mesh"] for res in results)
    # the GEGLU halves by hand at one block: hidden rows 0..I/2 and gate rows I..I+I/2 on rank 0
    key = "down_blocks.0.attentions.0.transformer_blocks.0.ff.net.0.proj.weight"
    inner = full[key].shape[0] // 2
    for r, res in enumerate(results):
        h, g = np.split(res["params"][key], 2, axis=0)
        np.testing.assert_array_equal(h, full[key][r * inner // 2:(r + 1) * inner // 2])
        np.testing.assert_array_equal(g, full[key][inner + r * inner // 2:
                                                   inner + (r + 1) * inner // 2])


def test_tp_block_adds_residual_and_biases_once(world2):
    """A transformer block at tp = 2 (attn1, attn2, ff, attn_temp split)
    against the same block whole: to_out's and the feed-forward's biases and
    the residual enter once (each bias is ~0.5, so twice would show), and the
    split block refuses a gradient."""
    inputs, _, results = world2
    blk = BasicTransformerBlock(64, 4, 16, 16)
    blk.load_state_dict({k: torch.from_numpy(v) for k, v in inputs["block"].items()})
    with torch.no_grad():
        want = blk(torch.from_numpy(inputs["x"]), torch.from_numpy(inputs["ctx"])).numpy()
    for res in results:
        np.testing.assert_allclose(res["block"], want, **BLOCK_TOL)
        assert "not ported yet" in res["block_grad"]


# --- the feed-forward's route per level under tp ------------------------------

# UNet3DConfig(): C = 320, 640, 1280, 1280 (I = 4C); at tp > 1 the route
# ff_route and geglu_route take on the widths of this rank's shard (I / tp),
# on the CUDA kernels' own limits (I % 64), as the feed-forward's shard calls them
ROUTES = {
    1: ["ff_ln", "ff_ln", "ln_geglu/geglu_out", "ln_geglu/geglu_out"],
    2: ["ff_ln", "ff_ln", "ln_geglu/geglu_out", "ln_geglu/geglu_out"],
    4: ["ff_ln", "ff_ln", "ln_geglu/geglu_out", "ln_geglu/geglu_out"],
    8: ["ref", "ff_ln", "ln_geglu/geglu_out", "ln_geglu/geglu_out"],
}


def _route(c, inner, shard):
    route = geglu.ff_route(c, inner, shard)
    return route if route != "ln_geglu" else f"{route}/{geglu.geglu_route(inner, c, shard)}"


@pytest.mark.parametrize("tp", sorted(ROUTES))
def test_feed_forward_route_per_level_and_tp(tp):
    """A tp rank's shard routes on the kernels' I % 64: tp = 4 keeps level
    0's shard (I = 320, off JAX's inner % 128 grid) on ff_ln; at tp = 8 level
    0's (I = 160) takes the plain route. tp = 1, 2 and 4 keep every level of
    UNet3DConfig() on its kernels."""
    cfg = UNet3DConfig()
    assert cfg.attention_heads % tp == 0
    got = [_route(c, 4 * c // tp, tp > 1) for c in cfg.block_out_channels]
    assert got == ROUTES[tp]
    on_kernels = all(r != "ref" for r in got)
    assert on_kernels == (tp in (1, 2, 4))
    # JAX's grid would have sent tp = 4's level 0 to the plain route
    assert _route(320, 320, False) == "ref"


def test_tp_feed_forward_shard_takes_its_local_route(monkeypatch):
    """The sharded feed-forward decides on its shard's width and the
    kernel's grid: a C = 64 block at I = 256 (a tp = 1 width) reaches ff_ln
    with or without its residual; at I = 64 (a tp = 4 shard's, off JAX's
    128 grid) the whole block takes the plain route and the shard ff_ln; at
    I = 32 both take the plain route. Without its residual each gives the
    block's output less x."""
    seen = []
    for name in ("ff_ln", "ff_ref"):
        real = getattr(geglu, name)
        monkeypatch.setattr(geglu, name, lambda *a, _n=name, _r=real, **k:
                            seen.append((_n, a[5].shape[1])) or _r(*a, **k))
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, 5, 64)).astype(np.float32))
    for inner in (256, 64, 32):
        w = [torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.1)
             for s in ((64,), (64,), (2 * inner, 64), (2 * inner,), (64, inner), (64,))]
        full = geglu.feed_forward(x, *w, eps=1e-5)
        part = geglu.feed_forward(x, *w, eps=1e-5, residual=False)
        torch.testing.assert_close(part + x, full, rtol=1e-6, atol=1e-6)
    assert seen == [("ff_ln", 256), ("ff_ln", 256), ("ff_ref", 64), ("ff_ln", 64),
                    ("ff_ref", 32), ("ff_ref", 32)]
