"""The port's EEG encoders (models/encoders.py) against the JAX package's, on
the CPU in float32, with the same random weights carried across by
``convert.from_jax.encoder_state_dict_from_jax``.

Tolerances: the eval forward within rtol 1e-3 / atol 1e-4 (whole models); in
train mode with dropout off on both sides (flax's Dropout made an identity
inside the test, the port's at p = 0), the outputs, the BatchNorm running
statistics after one call and every parameter's gradient of a loss each
within 2e-3 of the tensor's largest entry (tests/test_torch_seq2seq_train.py's
rule). A convolution's bias that feeds a train-mode BatchNorm through linear
ops only (and EEGNet's first BatchNorm's shift, which feeds the second) has a
zero gradient in exact arithmetic, the BatchNorm subtracts it again; so has
the Conformer attention's key bias (it adds q . b to a whole row of logits,
which the softmax removes). Their float32 gradients are noise of either sign
on either side, held to 1e-4 of the largest gradient. The converter round trip is bit for bit.
"""

import collections

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eeg2video_tpu.convert.export_torch import encoder_to_torch as jexport
from eeg2video_tpu.convert.torch_params import encoder_params_from_torch
from eeg2video_tpu.models import encoders as je
from eeg2video_tpu_torch import models as tmodels
from eeg2video_tpu_torch.convert.from_jax import encoder_state_dict_from_jax
from eeg2video_tpu_torch.models import encoders as te
from eeg2video_tpu_torch.models.layers import Dropout

from test_torch_models import capped_threads, random_params

_threads = capped_threads()

MODEL_TOL = dict(rtol=1e-3, atol=1e-4)
TRAIN_RTOL = 2e-3
NOISE = 1e-4  # of the largest gradient: the parameters with no exact gradient
C, T = 62, 200
RAW, DE = (1, C, T), (C, 5)

# name: (JAX module, port module, input shapes without the batch, the
# converter's name, the port parameters with no gradient in exact arithmetic)
CASES = {
    "shallownet": (lambda: je.ShallowNet(out_dim=40, C=C, T=T), lambda: te.ShallowNet(40, C, T),
                   (RAW,), "shallownet", ("net.0.bias", "net.1.bias")),
    "deepnet": (lambda: je.DeepNet(out_dim=40, C=C, T=T), lambda: te.DeepNet(40, C, T), (RAW,),
                "deepnet", ("net.0.bias", "net.1.bias", "net.6.bias", "net.11.bias",
                            "net.16.bias")),
    "eegnet": (lambda: je.EEGNet(out_dim=40, C=C, T=T), lambda: te.EEGNet(40, C, T), (RAW,),
               "eegnet", ("net.0.bias", "net.1.bias", "net.2.bias", "net.7.bias")),
    "tsconv": (lambda: je.TSConv(out_dim=40, C=C, T=T), lambda: te.TSConv(40, C, T), (RAW,),
               "tsconv", ("net.0.bias", "net.4.bias")),
    "conformer": (lambda: je.Conformer(out_dim=40), lambda: te.Conformer(40), (RAW,),
                  "conformer", ("0.shallownet.0.bias", "0.shallownet.1.bias",
                                *(f"1.{d}.0.fn.1.keys.bias" for d in range(3)))),
    "glfnet": (lambda: je.GLFNet(out_dim=40, emb_dim=16, C=C, T=T),
               lambda: te.GLFNet(40, 16, C, T), (RAW,), "glfnet",
               ("globalnet.net.0.bias", "globalnet.net.1.bias",
                "occipital_localnet.net.0.bias", "occipital_localnet.net.1.bias")),
    "mlpnet": (lambda: je.MLPNet(out_dim=40), lambda: te.MLPNet(40), (DE,), "mlpnet", ()),
    "glfnet_mlp": (lambda: je.GLFNetMLP(out_dim=40, emb_dim=16), lambda: te.GLFNetMLP(40, 16),
                   (DE,), "glfnet_mlp", ()),
    "glmnet": (lambda: je.GLMNet(out_dim=40, emb_dim=16), lambda: te.GLMNet(40, 16),
               ((1, C, 100), DE), "glmnet", ("rawnet.net.0.bias", "rawnet.net.1.bias")),
    "shallownet_flexible": (lambda: je.ShallowNetFlexible(out_dim=16, C=C),
                            lambda: te.ShallowNetFlexible(16, C), ((1, C, 100),), "shallownet",
                            ("net.0.bias", "net.1.bias")),
}
# the converter of the JAX package (torch_params.encoder_params_from_torch) takes these
JAX_CONVERTIBLE = ("shallownet", "deepnet", "eegnet", "tsconv", "conformer", "glfnet", "mlpnet",
                   "glfnet_mlp")


def _inputs(name, batch, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((batch, *s)).astype(np.float32) for s in CASES[name][2]]


def _variables(name, seed):
    """Random params plus BatchNorm running statistics away from (0, 1)."""
    jmod = CASES[name][0]()
    args = _inputs(name, 2, 0)
    params = random_params(jmod, seed, *args, train=False)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.key(0), *args, train=False))
    out = {"params": params}
    if "batch_stats" in shapes:
        rng = np.random.default_rng(seed + 1000)
        out["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda p, leaf: ((0.5 + rng.random(leaf.shape)) if p[-1].key == "var"
                             else 0.3 * rng.standard_normal(leaf.shape)).astype(np.float32),
            shapes["batch_stats"])
    return jmod, out


def _port(name, variables):
    model = CASES[name][1]()
    model.load_state_dict(encoder_state_dict_from_jax(CASES[name][3], variables), strict=True)
    return model


@pytest.mark.parametrize("name", sorted(CASES))
def test_eval_forward_matches_jax(name):
    jmod, variables = _variables(name, 11)
    xs = _inputs(name, 4, 1)
    want = np.asarray(jax.jit(lambda v, *a: jmod.apply(v, *a, train=False))(variables, *xs))
    with torch.no_grad():
        got = _port(name, variables).eval()(*map(torch.from_numpy, xs)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **MODEL_TOL)


def test_glmnet_embedding_matches_jax():
    jmod, variables = _variables("glmnet", 12)
    xs = _inputs("glmnet", 3, 2)
    want = np.asarray(jmod.apply(variables, *xs, train=False, return_embedding=True))
    with torch.no_grad():
        got = _port("glmnet", variables).eval()(*map(torch.from_numpy, xs),
                                                return_embedding=True).numpy()
    assert got.shape == (3, 32)
    np.testing.assert_allclose(got, want, **MODEL_TOL)


@pytest.fixture
def no_jax_dropout(monkeypatch):
    """flax's Dropout as an identity, for this test only."""
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)


@pytest.mark.parametrize("name", sorted(CASES))
def test_train_forward_running_stats_and_gradients_match_jax(name, no_jax_dropout):
    jmod, variables = _variables(name, 21)
    xs = _inputs(name, 6, 3)
    stats = variables.get("batch_stats", {})
    target = np.random.default_rng(4).standard_normal(
        jax.eval_shape(lambda: jmod.apply(variables, *xs, train=False)).shape).astype(np.float32)

    def loss_fn(params):
        out, mut = jmod.apply({"params": params, "batch_stats": stats}, *xs, train=True,
                              mutable=["batch_stats"])
        return jnp.mean((out - target) ** 2), (out, mut.get("batch_stats", {}))

    (jloss, (jout, jstats)), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        variables["params"])
    model = _port(name, variables).train()
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    out = model(*map(torch.from_numpy, xs))
    loss = torch.mean((out - torch.from_numpy(target)) ** 2)
    loss.backward()
    jout = np.asarray(jout)
    assert np.abs(out.detach().numpy() - jout).max() <= TRAIN_RTOL * np.abs(jout).max()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4)

    conv = CASES[name][3]
    want = encoder_state_dict_from_jax(conv, jax.device_get(
        {"params": jgrads, **({"batch_stats": jstats} if stats else {})}))
    grads = {n: p.grad for n, p in model.named_parameters()}
    largest = max(float(g.abs().max()) for g in grads.values() if g is not None)
    compared = 0
    for key, g in grads.items():
        if key.startswith("2.clshead."):  # the Conformer's unused branch: no JAX parameter
            assert g is None
            continue
        w = want[key].numpy()
        if key in CASES[name][4]:
            assert max(float(g.abs().max()), np.abs(w).max()) <= NOISE * largest, key
            continue
        assert np.abs(g.numpy() - w).max() <= TRAIN_RTOL * np.abs(w).max(), key
        compared += 1
    assert compared >= 3
    buffers = dict(model.named_buffers())
    running = [k for k in buffers if "running" in k]
    assert len(running) == len(jax.tree.leaves(stats))
    for k in running:
        w = want[k].numpy()
        assert np.abs(buffers[k].numpy() - w).max() <= TRAIN_RTOL * np.abs(w).max(), k
    for k in buffers:
        if k.endswith("num_batches_tracked"):
            assert int(buffers[k]) == 1


@pytest.mark.parametrize("name", sorted(CASES))
def test_dropout_sites_and_rates_match_jax(name, monkeypatch):
    """Every dropout JAX's train-mode apply calls has a counterpart in the port
    at the same rate (whole feature maps where JAX broadcasts), each run once
    a call."""
    jmod, variables = _variables(name, 31)
    xs = _inputs(name, 2, 5)
    sites = collections.Counter()

    def record(self, x, *a, **k):
        sites[(self.rate, bool(self.broadcast_dims))] += 1
        return x

    monkeypatch.setattr(fnn.Dropout, "__call__", record)
    jmod.apply(variables, *xs, train=True, mutable=["batch_stats"])
    monkeypatch.undo()
    model = _port(name, variables).train()
    calls = collections.Counter()
    for m in model.modules():
        if isinstance(m, Dropout):
            m.register_forward_hook(
                lambda mod, i, o: calls.update([(mod.p, bool(mod.broadcast_dims))]))
    model(*map(torch.from_numpy, xs))
    assert calls == sites


def test_feature_map_dropout_drops_whole_maps():
    drop = Dropout(0.5, broadcast_dims=(2, 3)).train()
    drop.generator = torch.Generator().manual_seed(0)
    y = drop(torch.ones(8, 16, 1, 26))
    per_map = (y == 0).float().mean(dim=(2, 3))
    assert set(per_map.unique().tolist()) == {0.0, 1.0}
    assert set(y.unique().tolist()) == {0.0, 2.0}


@pytest.mark.parametrize("name", JAX_CONVERTIBLE)
def test_state_dict_round_trips_through_the_jax_converter_bit_for_bit(name):
    """port state dict -> ``encoder_params_from_torch`` -> the JAX variables
    the port's state dict came from, and the port's keys are the reference's
    (the JAX exporter's)."""
    _, variables = _variables(name, 41)
    sd = encoder_state_dict_from_jax(name, variables)
    model = CASES[name][1]()
    model.load_state_dict(sd, strict=True)
    assert set(model.state_dict()) == set(sd) == set(jexport(name, variables))
    back = encoder_params_from_torch(name, {k: v.numpy() for k, v in model.state_dict().items()})
    assert jax.tree.structure(back) == jax.tree.structure(variables)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(variables)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_make_encoder_names_and_error_text_match_jax():
    assert sorted(te._ENCODERS) == sorted(je._ENCODERS)
    with pytest.raises(ValueError) as jerr:
        je.make_encoder("nope", out_dim=40)
    with pytest.raises(ValueError) as terr:
        te.make_encoder("nope", out_dim=40)
    assert str(terr.value) == str(jerr.value)
    for name in ("shallownet", "mlpnet", "glfnet_mlp"):
        kwargs = dict(out_dim=40, **({"emb_dim": 8} if name == "glfnet_mlp" else {}))
        assert type(tmodels.make_encoder(name, **kwargs)).__name__ == \
            type(je.make_encoder(name, **kwargs)).__name__
    for cls in ("ShallowNet", "DeepNet", "EEGNet", "TSConv", "Conformer", "GLFNet", "MLPNet",
                "GLFNetMLP", "GLMNet", "ShallowNetFlexible"):
        assert getattr(tmodels, cls) is getattr(te, cls)
