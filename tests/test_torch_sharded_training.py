"""The port's fine-tune step across processes (train.videodiffusion on a
(dp, sp, tp) mesh, with and without fsdp; models.attention3d's tp and sp
gradients; parallel.fsdp_spec; the residual-free feed-forward backward;
cli.train_tuneavideo's mesh flags) against the JAX package, on the CPU.

One spawn of two gloo processes and one of four
(``tests/_torch_dist_worker.py``; 60 s group timeout, 120 s deadline) run
every mesh; both start before JAX's side so that they overlap with it. JAX
computes its UNSHARDED reference step once (``make_video_train_step`` on the
micro UNet, cross_attention_dim 768, remat on levels 0-1, the reference
freeze rule, f32; its Pallas kernels in interpret mode), and every port mesh
is held against that one step, given JAX's draws (the global batch's; each
dp rank takes its slice). The weights are numpy in the port's layout,
converted for JAX by ``eeg2video_tpu.convert.unet_params``.

Gates: the loss within 1e-5 relative, the parameters after the step within
rtol 2e-4 / atol 1e-5 (``tests/test_sp_product.py``'s), frozen ones bit for
bit. The CLI runs (bf16 compute) are held port against port, ``--dp 2 --sp
2`` against ``--dp 2``, at the gates of JAX's own
``tests/test_train_cli_mesh.py::test_train_cli_sp_matches_dp_only``.
"""

import dataclasses
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from eeg2video_tpu.convert.unet_params import unet3d_params_from_torch_3d
from eeg2video_tpu.models.unet3d import UNet3DConfig as JUNetConfig
from eeg2video_tpu.models.vae import VAEConfig as JVAEConfig
from eeg2video_tpu.ops import geglu as jg
from eeg2video_tpu.parallel.mesh import fsdp_spec as jfsdp_spec
from eeg2video_tpu.train import videodiffusion as jvd
from eeg2video_tpu_torch.convert import export_diffusion as ed
from eeg2video_tpu_torch.convert.from_jax import unet_state_dict_from_jax
from eeg2video_tpu_torch.models.attention3d import BasicTransformerBlock
from eeg2video_tpu_torch.models.unet3d import UNet3DConditionModel, UNet3DConfig
from eeg2video_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from eeg2video_tpu_torch.ops import geglu
from eeg2video_tpu_torch.parallel import fsdp_spec, shard_params_fsdp
from eeg2video_tpu_torch.parallel.mesh import jax_dim_order, split_piece
from eeg2video_tpu_torch.train import unet_tp_rules
from eeg2video_tpu_torch.train import videodiffusion as vd

import _torch_dist_worker
from test_torch_models import capped_threads, random_state
from test_torch_parallel import _block_state

_threads = capped_threads()

JCFG = dataclasses.replace(JUNetConfig.micro(), cross_attention_dim=768)
CFG = UNet3DConfig(**{f.name: getattr(JCFG, f.name) for f in dataclasses.fields(UNet3DConfig)})
B, F, HW, S = 2, 3, 8, 7  # 64 and 16 tokens a frame split over sp = 2; 7 context rows do not
TCFG = {"compute_dtype": "float32", "remat": True, "remat_min_hw": 16}
JTCFG = jvd.VideoDiffusionTrainConfig(**TCFG)
KEY = 7
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=2e-4, atol=1e-5)
BLOCK_TOL = 2e-5
# (dp, sp, tp, fsdp, 8-bit Adam, compute dtype) of each world size's spawn
F32, BF16 = "float32", "bfloat16"
LAYOUTS = {2: [(2, 1, 1, False, False, F32), (1, 2, 1, False, False, F32),
               (1, 1, 2, False, False, F32), (2, 1, 1, True, False, F32),
               (2, 1, 1, True, True, F32), (1, 1, 2, False, True, F32),
               (1, 1, 2, False, False, BF16)],
           4: [(2, 2, 1, False, False, F32), (2, 1, 2, True, False, F32)]}
STEP_LAYOUTS = [key for world in LAYOUTS.values() for key in world
                if not key[4] and key[5] == F32]
# the flags of each world size's CLI runs; four ranks without a mesh flag make dp = 4, which
# the batch of 2 clamps to 2 on ranks 0-1
CLI_FLAGS = {2: [["--dp", "2"]], 4: [["--dp", "2", "--sp", "2"], []]}


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _jax_draws(step, post_shape):
    """(t, noise, eps) as the JAX loss draws them at ``step``, for the
    global batch."""
    b, f = post_shape[:2]
    lat = post_shape[2:4] + (4,)
    k_t, k_eps, k_lat = jax.random.split(jax.random.fold_in(jax.random.key(KEY), step), 3)
    eps = jax.random.normal(k_lat, (b * f,) + lat, jnp.float32)
    t = jax.random.randint(k_t, (b,), 0, 1000)
    noise = jax.random.normal(k_eps, (b, f) + lat, jnp.float32)
    return tuple(np.asarray(a) for a in (t, noise, eps))


def _cli_files(tmp, unet_sd):
    """The CLI's inputs: four empty clip files (the clips themselves come
    from the worker's stand-in dataset), caption embeddings and a tiny VAE
    in the diffusers layout."""
    videos = os.path.join(tmp, "videos")
    os.makedirs(videos)
    for i in range(4):
        open(os.path.join(videos, f"{i + 1}.mp4"), "wb").close()
    rng = np.random.default_rng(31)
    np.save(os.path.join(tmp, "emb.npy"), _rand(rng, 4, 77, 768))
    with torch.device("meta"):
        vae = random_state(AutoencoderKL(VAEConfig.tiny()), 32)
    ed.save_diffusers_pipeline(os.path.join(tmp, "sd"),
                               {k: torch.from_numpy(v) for k, v in unet_sd.items()}, CFG,
                               {k: torch.from_numpy(v) for k, v in vae.items()},
                               VAEConfig.tiny())
    return ["--device", "cpu", "--video_dir", videos, "--text_embeddings",
            os.path.join(tmp, "emb.npy"), "--vae", os.path.join(tmp, "sd"), "--epochs", "1",
            "--train_batch_size", "2", "--checkpointing_epochs", "1",
            "--validation_epochs", "1", "--validation_steps", "1", "--gif_encoder", "imageio"]


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The inputs, and both spawns, started before JAX's side."""
    tmp = tmp_path_factory.mktemp("sharded_training")
    with torch.device("meta"):
        unet = random_state(UNet3DConditionModel(CFG), 30)
    rng = np.random.default_rng(33)
    post = np.concatenate([_rand(rng, B, F, HW, HW, 4), _rand(rng, B, F, HW, HW, 4, scale=0.3)],
                          axis=-1)
    inputs = {"unet": unet, "ucfg": dataclasses.asdict(CFG), "tcfg": TCFG, "post": post,
              "ctx": _rand(rng, B, S, 768),
              "draws": [_jax_draws(step, post.shape) for step in (0, 1)],
              "layouts": LAYOUTS, "block": _block_state(34), "x": _rand(rng, 2, 3, 8, 64),
              "ctx_block": _rand(rng, 2, 5, 16), "bias": _rand(rng, 2, 1, 8),
              "dout": _rand(rng, 2, 3, 8, 64), "clips": np.tanh(_rand(rng, 4, 3, 32, 32, 3)),
              "cli": CLI_FLAGS, "cli_dir": os.fspath(tmp / "cli"),
              "cli_args": _cli_files(os.fspath(tmp), unet)}
    return inputs, {w: _torch_dist_worker.start("training_cases", w, inputs, tmp)
                    for w in (2, 4)}


@pytest.fixture(scope="module")
def jax_step(started):
    """JAX's unsharded step from the same weights and draws: (loss, the
    parameters after it in the port's key space)."""
    inputs, _ = started
    params = jax.tree.map(jnp.asarray, unet3d_params_from_torch_3d(
        inputs["unet"], n_down=len(CFG.block_out_channels),
        layers_per_block=CFG.layers_per_block)["params"])
    state = jvd.init_video_train_state(params, JTCFG)
    step = jvd.make_video_train_step(JCFG, JVAEConfig.tiny(), JTCFG)
    state, loss = step(state, None, jnp.asarray(inputs["post"]), jnp.asarray(inputs["ctx"]),
                       jax.random.key(KEY))
    after = unet_state_dict_from_jax(jax.device_get(state.params), CFG)
    return float(loss), {k: v.numpy() for k, v in after.items()}


@pytest.fixture(scope="module")
def worlds(started, jax_step):
    _, handles = started
    return {w: h.join() for w, h in handles.items()}


def _state(inputs, **cfg):
    unet = UNet3DConditionModel(CFG)
    unet.load_state_dict({k: torch.from_numpy(v) for k, v in inputs["unet"].items()})
    return vd.init_video_train_state(unet, vd.VideoDiffusionTrainConfig(**{**TCFG, **cfg}), "cpu")


def _step(state, inputs, step):
    t, noise, eps = (torch.from_numpy(a.copy()) for a in inputs["draws"][step])
    return float(vd.train_step(state, None, torch.from_numpy(inputs["post"]),
                               torch.from_numpy(inputs["ctx"]), seed=0, t=t, noise=noise,
                               eps=eps))


def _result(worlds, key):
    world = 4 if key in LAYOUTS[4] else 2
    return [res[key] for res in worlds[world]]


# --- the tp block's gradients --------------------------------------------------

def test_tp_block_forward_and_gradients_match_the_whole_block(started, worlds):
    """A transformer block at tp = 2 with train=True (attn1 with an
    attention bias, attn2, the residual-free feed-forward, attn_temp): its
    output and the gradients of its input, context and bias (copy_to sums
    the ranks' partial ones) equal the whole block's; each rank's parameter
    gradients are the whole block's at its shard (to_out's bias and the
    feed-forward's out bias, replicated, whole on both)."""
    inputs, _ = started
    blk = BasicTransformerBlock(64, 4, 16, 16)
    blk.load_state_dict({k: torch.from_numpy(v) for k, v in inputs["block"].items()})
    x, ctx, bias = (torch.from_numpy(inputs[n]).requires_grad_()
                    for n in ("x", "ctx_block", "bias"))
    out = blk(x, ctx, bias, train=True)
    (out * torch.from_numpy(inputs["dout"])).sum().backward()
    want = {"out": out.detach().numpy(), "x": x.grad.numpy(), "ctx": ctx.grad.numpy(),
            "bias": bias.grad.numpy()}
    whole = {n: p.grad.numpy() for n, p in blk.named_parameters()}
    for r, res in enumerate(worlds[2]):
        got = res["block"]
        for name, w in want.items():
            assert np.abs(got[name] - w).max() <= BLOCK_TOL * max(1.0, np.abs(w).max()), name
        split = 0
        for name, w in whole.items():
            rule = unet_tp_rules(name)
            if rule is not None:
                w = split_piece(torch.from_numpy(w), 2, r, rule[0],
                                rule[2] if len(rule) > 2 else 1).numpy()
                split += 1
            g = got["params"][name]
            assert g.shape == w.shape, name
            assert np.abs(g - w).max() <= BLOCK_TOL * max(1.0, np.abs(w).max()), name
        # q/k/v and to_out of three attentions; the ff's projection (weight and
        # bias, by halves) and its out
        assert split == 3 * 4 + 3


# --- the residual-free feed-forward backward -----------------------------------

@pytest.mark.parametrize("t,c", [(256, 32), (130, 64)])
def test_residual_free_ff_backward_matches_jax(t, c):
    """``ff_ln_bwd_plain(residual=False)`` and the autograd.Function's
    gradients (``ff_ln_function(..., residual=False)``) against jax.grad of
    JAX's reference less its residual, ``_ff_ref(x, ...) - x``."""
    rng = np.random.default_rng(35)
    i = 4 * c
    o = dict(x=_rand(rng, t, c), g=_rand(rng, t, c), gamma=1.0 + _rand(rng, c, scale=0.1),
             beta=_rand(rng, c, scale=0.1), wp=_rand(rng, c, 2 * i, scale=c ** -0.5),
             bp=_rand(rng, 2 * i, scale=0.1), wo=_rand(rng, i, c, scale=i ** -0.5),
             bo=_rand(rng, c, scale=0.1))
    names = ("gamma", "beta", "wp", "bp", "wo", "bo")
    eps = 1e-5
    _, vjp = jax.vjp(lambda x, *p: jg._ff_ref(x, *p, eps) - x, o["x"], *(o[n] for n in names))
    jgrads = vjp(jnp.asarray(o["g"]))
    port = {n: torch.from_numpy(o[n].T.copy() if n in ("wp", "wo") else o[n]) for n in o}
    dx = geglu.ff_ln_bwd_plain(port["x"], port["g"], *(port[n] for n in names[:-1]), eps,
                               residual=False)
    with_res = geglu.ff_ln_bwd_plain(port["x"], port["g"], *(port[n] for n in names[:-1]), eps)
    tol = 5e-5 * np.abs(np.asarray(jgrads[0])).max()
    assert np.abs(dx.numpy() - np.asarray(jgrads[0])).max() <= tol
    assert np.abs((with_res - port["g"] - dx).numpy()).max() <= tol  # only g dropped
    x = port["x"].clone().requires_grad_()
    params = [port[n].clone().requires_grad_() for n in names]
    out = geglu.ff_ln_function(x, *params, eps, residual=False)
    grads = torch.autograd.grad(out, [x] + params, port["g"])
    for n, got, want in zip(("x",) + names, grads, jgrads):
        want = np.asarray(want).T if n in ("wp", "wo") else np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 5e-5 * max(np.abs(want).max(), 1e-6), n


# --- fsdp's dimension ------------------------------------------------------------

def _jax_fsdp_dims(unet, dp):
    """{port name: torch dim} of JAX's fsdp_spec on every leaf of the flax
    tree of the same weights, read back through JAX's converter: each leaf
    holds its index along the chosen dimension, and the torch dim along which
    the converted values vary is that dimension (-1: none chosen)."""
    params = unet3d_params_from_torch_3d(unet, n_down=len(CFG.block_out_channels),
                                         layers_per_block=CFG.layers_per_block)["params"]

    def code(path, leaf):
        spec = tuple(jfsdp_spec(leaf.shape, None, dp))
        if "dp" not in spec:
            return np.full(leaf.shape, -1.0, np.float32)
        d = spec.index("dp")
        shape = [1] * leaf.ndim
        shape[d] = leaf.shape[d]
        return np.broadcast_to(np.arange(leaf.shape[d], dtype=np.float32).reshape(shape),
                               leaf.shape).copy()

    codes = unet_state_dict_from_jax(jax.tree_util.tree_map_with_path(code, params), CFG)
    dims = {}
    for name, v in codes.items():
        v = v.numpy()
        if (v == -1).all():
            dims[name] = None
            continue
        varying = [d for d in range(v.ndim) if v.shape[d] > 1
                   and not (np.diff(v, axis=d) == 0).all()]
        assert len(varying) == 1, name
        dims[name] = varying[0]
    return dims


@pytest.mark.parametrize("dp", [2, 4])
def test_fsdp_spec_picks_jax_dimension_on_every_micro_unet_parameter(started, dp):
    """``fsdp_spec`` on the torch shape picks the dimension JAX's picks on the
    flax shape, for every parameter of the micro UNet, a square to_q (JAX:
    its input features, the first of two equal dims of (in, out); torch dim
    1) included; ``shard_params_fsdp``'s pieces are those dims' splits."""
    inputs, _ = started
    unet = inputs["unet"]
    want = _jax_fsdp_dims(unet, dp)
    assert set(want) == set(unet)
    for name, v in unet.items():
        assert fsdp_spec(v.shape, None, dp) == want[name], name
    square = "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.weight"
    assert unet[square].shape == (32, 32) and want[square] == 1
    assert sum(d is not None for d in want.values()) > 0.9 * len(want)
    tensors = {n: torch.from_numpy(v) for n, v in unet.items()}
    pieces = [shard_params_fsdp(tensors, types.SimpleNamespace(
        size=lambda axis: dp, rank=lambda axis, r=r: r)) for r in range(dp)]
    for name, t in tensors.items():
        dims = {p[name][1] for p in pieces}
        assert dims == {want[name]}, name
        if want[name] is None:
            assert all(p[name][0] is t for p in pieces)
        else:
            assert torch.equal(torch.cat([p[name][0] for p in pieces], dim=want[name]), t)


def test_fsdp_spec_rules_on_torch_layouts():
    """JAX's own cases (tests/test_fsdp.py::test_fsdp_spec_rules) in the torch
    layout: a Dense kernel (in, out) is torch (out, in); a tp split's dim stays
    out; no divisible dim gives None."""
    assert jax_dim_order(2) == [1, 0] and jax_dim_order(4) == [2, 3, 1, 0]
    assert jfsdp_spec((64, 128), None, dp=4) == P(None, "dp")
    assert fsdp_spec((128, 64), None, dp=4) == 0
    assert fsdp_spec((64, 128), None, dp=4) == 1
    assert jfsdp_spec((64, 128), P(None, "tp"), dp=4) == P("dp", "tp")
    assert fsdp_spec((128, 64), 0, dp=4) == 1
    assert fsdp_spec((3,), None, dp=4) is None
    assert fsdp_spec((8, 8, 3, 3), None, dp=2) == 1  # a square conv: its input channels


# --- one step on each mesh --------------------------------------------------------

@pytest.mark.parametrize("key", STEP_LAYOUTS, ids=lambda k: "dp{}_sp{}_tp{}{}".format(
    *k[:3], "_fsdp" if k[3] else ""))
def test_one_step_on_a_mesh_matches_jax_unsharded(started, jax_step, worlds, key):
    """The step at dp = 2, sp = 2, tp = 2, dp = 2 x sp = 2, dp = 2 with fsdp
    and dp = 2 x tp = 2 with fsdp (masters split over both): every rank's
    loss (the dp mean) is JAX's, and the parameters after it, gathered whole,
    are JAX's; the frozen ones are what was loaded."""
    inputs, _ = started
    jloss, jparams = jax_step
    results = _result(worlds, key)
    for res in results:
        assert abs(res["loss"] - jloss) <= LOSS_RTOL * abs(jloss), (res["loss"], jloss)
    params = results[0]["params"]
    assert set(params) == set(jparams)
    for name, v in params.items():
        if vd.trainable(name):
            np.testing.assert_allclose(v, jparams[name], err_msg=name, **PARAM_TOL)
            assert not np.array_equal(v, inputs["unet"][name]), name
        else:
            np.testing.assert_array_equal(v, inputs["unet"][name], err_msg=name)


def test_fsdp_splits_masters_and_moments_on_jax_dimension(started, worlds):
    """At dp = 2 with fsdp each master and both AdamW moments hold half of
    the whole tensor along JAX's fsdp dimension (whole where it picks none);
    with 8-bit Adam the codes likewise, and the scales, one a column of the
    first axis, split only where that dimension is not the first."""
    inputs, _ = started
    dims = _jax_fsdp_dims(inputs["unet"], 2)
    for key in ((2, 1, 1, True, False, F32), (2, 1, 1, True, True, F32)):
        res = _result(worlds, key)[0]
        assert list(res["masters"]) == [n for n in inputs["unet"] if vd.trainable(n)]
        for name, shape in res["masters"].items():
            whole = list(inputs["unet"][name].shape)
            want = list(whole)
            if dims[name] is not None:
                want[dims[name]] //= 2
            assert list(shape) == want, name
            moments = res["moments"][name]
            if key[4]:
                scale = [1] + (want[1:] if dims[name] != 0 else whole[1:])
                assert moments == {"mq": tuple(want), "ms": tuple(scale), "vq": tuple(want),
                                   "vs": tuple(scale)}, name
            else:
                assert moments == {"exp_avg": tuple(want), "exp_avg_sq": tuple(want)}, name


@pytest.mark.parametrize("key", [(2, 1, 1, True, True, F32), (1, 1, 2, False, True, F32)],
                         ids=["dp2_fsdp", "tp2"])
def test_8bit_adam_on_a_mesh_matches_the_unsharded_8bit_step(started, worlds, key):
    """``--use_8bit_adam`` at dp = 2 with fsdp and at tp = 2 against the
    port's unsharded 8-bit step: the parameters, and the stored scales,
    whose maxima over the first axis are all-reduced (MAX) where fsdp or a tp
    column split splits that axis."""
    inputs, _ = started
    state = _state(inputs, use_8bit_adam=True)
    loss = _step(state, inputs, 0)
    want = state.state_dict()
    res = _result(worlds, key)[0]
    assert abs(res["loss"] - loss) <= LOSS_RTOL * abs(loss)
    for name, v in want["params"].items():
        np.testing.assert_allclose(res["params"][name], v.numpy(), err_msg=name, **PARAM_TOL)
    got = res["ckpt"]["opt_state"]["state"]
    rows_split = 0
    for i, name in enumerate(state.masters):
        for k in ("ms", "vs"):
            np.testing.assert_allclose(got[i][k].numpy(), want["opt_state"]["state"][i][k].numpy(),
                                       rtol=1e-4, atol=0, err_msg=f"{name} {k}")
        rule = unet_tp_rules(name)
        rows_split += (fsdp_spec(inputs["unet"][name].shape, None, 2) == 0 if key[3]
                       else rule is not None and rule[0] == 0)
    assert rows_split > 0  # some leaves are split along the scales' axis


def test_tp_2_in_bf16_keeps_shards_of_masters_and_frozen_originals(started, worlds):
    """tp = 2 with the bf16 working copy (the trainer's default): the f32
    masters and the kept frozen originals are the tp shards of the model's
    parameters; gathered whole, the frozen ones are what was loaded, bit for
    bit, and the step is the port's unsharded bf16 step, to the gates of
    JAX's bf16 CLI test (2e-2 relative; rtol 2e-3 / atol 2e-4)."""
    inputs, _ = started
    state = _state(inputs, compute_dtype=BF16)
    loss = _step(state, inputs, 0)
    want = state.params_f32()
    for res in _result(worlds, (1, 1, 2, False, False, BF16)):
        assert abs(res["loss"] - loss) < 2e-2 * max(1.0, abs(loss)), (res["loss"], loss)
    got = _result(worlds, (1, 1, 2, False, False, BF16))[0]["params"]
    for name, v in want.items():
        if vd.trainable(name):
            np.testing.assert_allclose(got[name], v.numpy(), rtol=2e-3, atol=2e-4, err_msg=name)
        else:
            np.testing.assert_array_equal(got[name], inputs["unet"][name], err_msg=name)


def test_fsdp_checkpoint_resumes_without_a_mesh(started, worlds):
    """The train state written at dp = 2 with fsdp (whole tensors, gathered)
    loads into a state without a mesh, and its next step gives the mesh's
    next step; its masters and moments take at most 0.6 of the resident
    bytes per rank of the unsharded state's."""
    inputs, _ = started
    res = _result(worlds, (2, 1, 1, True, False, F32))
    sd = res[0]["ckpt"]
    assert sd["step"] == 1 and list(sd["params"]) == list(inputs["unet"])
    state = _state(inputs)
    state.load_state_dict(sd)
    assert state.step == 1
    loss2 = _step(state, inputs, 1)
    for r in res:
        assert abs(r["loss2"] - loss2) <= LOSS_RTOL * abs(loss2)
    for name, v in state.params_f32().items():
        np.testing.assert_allclose(res[0]["params2"][name], v.numpy(), err_msg=name,
                                   **PARAM_TOL)
    assert res[0]["resident"] <= 0.6 * state.resident_bytes()


# --- the CLI ------------------------------------------------------------------------

def test_train_cli_dp_2_sp_2_matches_dp_2(worlds):
    """``train_tuneavideo.main --dp 2 --sp 2`` (four ranks) against ``--dp 2``
    (two): the same batch split, ring attention instead of whole attention,
    under the CLI's bf16 compute, a validation sample after the epoch; the
    epoch's loss and the train state written by rank 0 agree to JAX's gates
    for its own such test (2e-2 relative; rtol 2e-3 / atol 2e-4)."""
    ref, sp = worlds[2][0]["cli"][0], worlds[4][0]["cli"][0]
    assert all(cli is None for res in worlds[2][1:] + worlds[4][1:] for cli in res["cli"])
    assert ref["step"] == sp["step"] == 2
    assert ref["files"] == sp["files"] and "tuneavideo_metrics.jsonl" in ref["files"]
    # every rank sampled the validation clips (the UNet's collectives need them all); rank 0
    # wrote the GIF
    assert ref["samples"] == sp["samples"] == ["sample-1.gif"]
    assert len(ref["losses"]) == len(sp["losses"]) == 1
    for a, b in zip(sp["losses"], ref["losses"]):
        assert np.isfinite(a) and abs(a - b) < 2e-2 * max(1.0, abs(b)), (a, b)
    moved = 0
    for name, v in ref["params"].items():
        np.testing.assert_allclose(sp["params"][name], v, rtol=2e-3, atol=2e-4, err_msg=name)
        moved += vd.trainable(name)
    assert moved > 0


def test_train_cli_clamps_dp_to_the_batch_and_leaves_the_other_ranks_idle(worlds):
    """``train_tuneavideo.main`` on four ranks with no mesh flag: dp defaults
    to 4, the batch of 2 clamps it to 2 (JAX's clamp), the mesh is ranks 0-1
    and ranks 2-3 return 0 without work. Ranks 0-1 then run what ``--dp 2``
    on two ranks runs, so the losses and the train state are bit-equal."""
    ref, clamped = worlds[2][0]["cli"][0], worlds[4][0]["cli"][1]
    assert clamped["step"] == ref["step"] == 2
    assert clamped["files"] == ref["files"] and clamped["samples"] == ref["samples"]
    assert clamped["losses"] == ref["losses"]
    for name, v in ref["params"].items():
        np.testing.assert_array_equal(clamped["params"][name], v, err_msg=name)


def test_mesh_step_times_each_mesh_against_one_gpu(worlds):
    """``utils.mesh_step`` (the step's timing on a mesh of GPUs) over two ranks:
    one JSON line from rank 0 for one GPU's steps, then one a mesh, each
    mesh's losses within the bf16 gate of one GPU's, fsdp halving the bytes
    of the masters and moments per rank."""
    assert worlds[2][1]["mesh_step"] == []
    lines = worlds[2][0]["mesh_step"]
    assert [ln["mesh"] for ln in lines] == [
        "none", {"dp": 2, "sp": 1, "tp": 1, "fsdp": False},
        {"dp": 2, "sp": 1, "tp": 1, "fsdp": True}]
    for ln in lines:
        assert ln["world"] == 2 and ln["card"] == "cpu" and len(ln["seconds"]) == 2
        assert ln["max_rel_gap_to_one_gpu"] < 2e-2 and all(np.isfinite(ln["losses"]))
    assert lines[2]["masters_and_optimizer_bytes_max_rank"] <= \
        0.6 * lines[1]["masters_and_optimizer_bytes_max_rank"]
