"""fsdp's per-use gather in the port's fine-tune step (``parallel.PerUseGather``
under ``train.videodiffusion.TrainState(fsdp=True)``) against JAX's
UNSHARDED step, on the CPU.

Under fsdp the model's own parameters, the working copy, hold only this
rank's dp piece of every tensor ``shard_params_fsdp`` splits (on tp's shard
where tp splits it); each resnet block, transformer and sampler, and the UNet
for its stem and head, gathers its pieces whole where it runs. The micro UNet
(tests/test_torch_sharded_training.py's: cross_attention_dim 768, remat on
levels 0-1, the reference freeze rule, f32; a batch of 4) runs at dp 2 (a world of 2) and at
dp 4 and dp 2 x tp 2 (a world of 4), spawned gloo processes
(``tests/_torch_dist_worker.py``; 60 s group timeout, 120 s deadline), both
started before JAX's side. JAX computes its unsharded step once
(``make_video_train_step``, its Pallas kernels in interpret mode), given the
same draws (the global batch's).

Gates, those of ``test_torch_sharded_training.py::
test_one_step_on_a_mesh_matches_jax_unsharded``: the loss within 1e-5
relative, the parameters after the step within rtol 2e-4 / atol 1e-5, frozen
ones bit for bit. The bytes a rank's model holds are the exact sum of its
pieces; no gathered whole weight of a unit is alive when the unit returns,
nor after the step.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eeg2video_tpu.convert.unet_params import unet3d_params_from_torch_3d
from eeg2video_tpu.models.vae import VAEConfig as JVAEConfig
from eeg2video_tpu.train import videodiffusion as jvd
from eeg2video_tpu_torch.convert.from_jax import unet_state_dict_from_jax
from eeg2video_tpu_torch.models.unet3d import UNet3DConditionModel
from eeg2video_tpu_torch.parallel import fsdp_spec
from eeg2video_tpu_torch.train import unet_tp_rules
from eeg2video_tpu_torch.train import videodiffusion as vd

import _torch_dist_worker
from test_torch_models import capped_threads, random_state
from test_torch_sharded_training import (CFG, F, HW, JCFG, JTCFG, KEY, LOSS_RTOL, PARAM_TOL, S,
                                         TCFG, _cli_files, _jax_draws, _rand)

_threads = capped_threads()

B = 4  # the global batch: one clip a rank at dp 4
LAYOUTS = {2: [(2, 1, 1)], 4: [(4, 1, 1), (2, 1, 2)]}
KEYS = [k for w in LAYOUTS.values() for k in w]
CLI_FLAGS = {2: [["--dp", "2"], ["--dp", "2", "--fsdp"]]}
IDS = ["dp{}_sp{}_tp{}".format(*k) for k in KEYS]


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp_gather")
    with torch.device("meta"):
        unet = random_state(UNet3DConditionModel(CFG), 40)
    rng = np.random.default_rng(41)
    post = np.concatenate([_rand(rng, B, F, HW, HW, 4), _rand(rng, B, F, HW, HW, 4, scale=0.3)],
                          axis=-1)
    inputs = {"unet": unet, "ucfg": dataclasses.asdict(CFG), "tcfg": TCFG, "post": post,
              "ctx": _rand(rng, B, S, 768),
              "draws": [_jax_draws(step, post.shape) for step in (0, 1)],
              "fsdp_layouts": LAYOUTS, "clips": np.tanh(_rand(rng, 4, 3, 32, 32, 3)),
              "cli": CLI_FLAGS, "cli_dir": str(tmp / "cli"), "cli_args": _cli_files(str(tmp), unet)}
    return inputs, {w: _torch_dist_worker.start("fsdp_gather_cases", w, inputs, tmp)
                    for w in LAYOUTS}


@pytest.fixture(scope="module")
def jax_step(started):
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


def _results(worlds, key):
    return [res[key] for res in worlds[4 if key in LAYOUTS[4] else 2]]


def _piece_shape(shape, name, dp, tp):
    """The shape of a rank's piece: tp's shard (unet_tp_rules), then fsdp's
    dp split of it on JAX's dimension."""
    shape = list(shape)
    rule = unet_tp_rules(name) if tp > 1 else None
    if rule is not None:
        shape[rule[0]] //= tp
    dim = fsdp_spec(tuple(shape), None if rule is None else rule[0], dp)
    if dim is not None:
        shape[dim] //= dp
    return tuple(shape)


@pytest.mark.parametrize("key", KEYS, ids=IDS)
def test_one_step_with_per_use_gather_matches_jax_unsharded(started, jax_step, worlds, key):
    """Every rank's loss (the dp mean) is JAX's, and the parameters after
    the step, gathered whole, are JAX's; the frozen ones are what was loaded."""
    inputs, _ = started
    jloss, jparams = jax_step
    results = _results(worlds, key)
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


@pytest.mark.parametrize("key", KEYS, ids=IDS)
def test_a_rank_holds_exactly_its_pieces_between_steps(started, worlds, key):
    """Before and after the step the model's parameters are this rank's
    pieces, trainable and frozen alike: their shapes, and their bytes the
    exact sum of the pieces (f32 compute: 4 bytes each), about 1/dp of the
    whole model's or less."""
    inputs, _ = started
    dp, _, tp = key
    want = {n: _piece_shape(v.shape, n, dp, tp) for n, v in inputs["unet"].items()}
    total = 4 * sum(math.prod(s) for s in want.values())
    whole = 4 * sum(v.size for v in inputs["unet"].values())
    for res in _results(worlds, key):
        assert res["shapes"] == want
        assert res["bytes"] == res["bytes_after"] == total
        assert res["grad_free"]
    assert total <= 1.05 * whole / dp


@pytest.mark.parametrize("key", KEYS, ids=IDS)
def test_no_unit_whole_weights_outlive_the_unit(worlds, key):
    """A hook at each unit's exit in the forward counts the gathered whole
    tensors of every unit still alive: none (the recomputed blocks' saved
    tensors are dropped by the checkpoint, the others' kept as where to
    gather again); after the step none of any unit or of the UNet's own is
    alive. (In the backward a recomputed block's units gather again, and
    their wholes live until the block's backward has read them.) A unit
    gathers all its pieces in one all-gather, once in the forward and again
    in its recomputation or where the backward first reads one of them:
    more than once and at most three times a step on the whole."""
    for res in _results(worlds, key):
        forward = res["at_exit"][:res["n_units"]]
        assert len(res["at_exit"]) > res["n_units"] > 0  # the recomputations exit too
        assert forward == [0] * res["n_units"]
        assert res["after"] == 0
        assert res["n_units"] + 1 == res["n_gathering"]  # the UNet's own pieces too
        assert res["n_gathering"] < res["gathers"] <= 3 * res["n_gathering"]


@pytest.mark.parametrize("key", KEYS, ids=IDS)
def test_checkpoint_of_a_per_use_gather_run_resumes_without_a_mesh(started, worlds, key):
    """The train state written on the mesh (whole tensors) loads into a state
    without a mesh, whose next step is the mesh's next step."""
    inputs, _ = started
    res = _results(worlds, key)
    sd = res[0]["ckpt"]
    assert sd["step"] == 1 and list(sd["params"]) == list(inputs["unet"])
    unet = UNet3DConditionModel(CFG)
    unet.load_state_dict({k: torch.from_numpy(v) for k, v in inputs["unet"].items()})
    state = vd.init_video_train_state(unet, vd.VideoDiffusionTrainConfig(**TCFG), "cpu")
    state.load_state_dict(sd)
    t, noise, eps = (torch.from_numpy(a.copy()) for a in inputs["draws"][1])
    loss2 = float(vd.train_step(state, None, torch.from_numpy(inputs["post"]),
                                torch.from_numpy(inputs["ctx"]), seed=0, t=t, noise=noise,
                                eps=eps))
    for r in res:
        assert abs(r["loss2"] - loss2) <= LOSS_RTOL * abs(loss2)
    for name, v in state.params_f32().items():
        np.testing.assert_allclose(res[0]["params2"][name], v.numpy(), err_msg=name,
                                   **PARAM_TOL)


def test_train_cli_fsdp_matches_dp_2(worlds):
    """``train_tuneavideo.main --dp 2 --fsdp`` (the per-use gather under the
    CLI's bf16 compute, a validation sample from the pieces after the epoch,
    the VAE off the steps' path) against ``--dp 2``: the epoch's loss and the
    train state written by rank 0 agree to JAX's gates for its own mesh CLI
    test (2e-2 relative; rtol 2e-3 / atol 2e-4)."""
    ref, fsdp = worlds[2][0]["cli"]
    assert worlds[2][1]["cli"] == [None, None]
    assert ref["step"] == fsdp["step"] == 2
    assert ref["files"] == fsdp["files"] and ref["samples"] == fsdp["samples"] == ["sample-1.gif"]
    for a, b in zip(fsdp["losses"], ref["losses"]):
        assert np.isfinite(a) and abs(a - b) < 2e-2 * max(1.0, abs(b)), (a, b)
    for name, v in ref["params"].items():
        np.testing.assert_allclose(fsdp["params"][name], v, rtol=2e-3, atol=2e-4, err_msg=name)
