"""Saved residuals of the port's recomputed UNet blocks (``ops.residuals``,
``remat_save_attn`` / ``remat_save_convs`` of ``models.unet3d``) on the CPU,
on the micro UNet of tests/test_torch_train.py with every block recomputed
(``remat_min_hw=0``).

Keeping a value instead of recomputing it changes which forwards run, not
what they compute: the loss, the trainable gradients and the parameters after
two optimizer steps are held bit for bit to the run that saves nothing, in
all four combinations. The loss with JAX's default policy (both saved) is
held to JAX's loss within the trainer's bound, 1e-4 relative
(tests/test_torch_train.py). ``residuals.forward_runs`` counts each saved
forward: once per call site and step with saving, twice without. A
per-weight count of the library's convolutions and matmuls shows which
convs are kept: no resnet conv1 or conv2 runs again in the backward, while
the samplers' convs and the 1x1 shortcuts do, as JAX's ``resnet_conv`` names
only the two.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import checkpoint

from eeg2video_tpu.models.unet3d import UNet3DConditionModel as JUNet
from eeg2video_tpu.models.vae import VAEConfig as JVAEConfig
from eeg2video_tpu.train import videodiffusion as jvd
from eeg2video_tpu_torch.ops import geglu, residuals
from eeg2video_tpu_torch.train import videodiffusion as vd

from test_torch_models import capped_threads
from test_torch_train import (B, F, HW, JCFG, S, TCFG, jax_draws, port_unet, rand,
                              random_params, tt)

_threads = capped_threads()

LOSS_RTOL = 1e-4  # the trainer's bound against JAX (tests/test_torch_train.py)
CFG0 = dataclasses.replace(TCFG, remat_min_hw=0)  # every block recomputed
COMBOS = [(True, True), (True, False), (False, True)]
# call sites of the micro UNet (4 transformer blocks of 3 frames: frames 0-1,
# frames 2.., cross-attention; one feed-forward and one temporal attention
# each; 8 resnets of two conv sites each)
SITES = {"flash_attention_fwd": 12, "ff_ln": 4, "temporal_attention_fwd": 4,
         "resnet_conv": 16}


@pytest.fixture(scope="module")
def params():
    return random_params(JUNet(JCFG), 1, np.zeros((1, F, HW, HW, 4), np.float32),
                         jnp.asarray([3]), np.zeros((1, S, JCFG.cross_attention_dim), np.float32))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(2)
    post = np.concatenate([rand(rng, B, F, HW, HW, 4), 0.3 * rand(rng, B, F, HW, HW, 4)],
                          axis=-1)
    return tt(post), tt(rand(rng, B, S, JCFG.cross_attention_dim))


def _steps(params, batch, save_attn, save_convs, n_steps):
    """``n_steps`` optimizer steps; the loss, the trainable gradients of the
    first step and the parameters after the last."""
    post, ctx = batch
    cfg = dataclasses.replace(CFG0, remat_save_attn=save_attn)
    state = vd.init_video_train_state(port_unet(params), cfg, "cpu")
    unet = functools.partial(state.unet, remat_save_convs=save_convs)
    g = torch.Generator().manual_seed(11)
    losses, grads = [], None
    for _ in range(n_steps):
        draws = dict(t=torch.randint(0, 1000, (B,), generator=g),
                     noise=torch.randn(B, F, HW, HW, 4, generator=g),
                     eps=torch.randn(B * F, HW, HW, 4, generator=g))
        loss = vd.video_loss(unet, None, post, ctx, cfg, **draws)
        loss.backward()
        if grads is None:
            grads = {n: p.grad.clone() for n, p in state.working.items()}
        state.apply_gradients()
        losses.append(loss.detach())
    return losses, grads, state.params_f32()


@pytest.fixture(scope="module")
def saving_nothing(params, batch):
    return _steps(params, batch, False, False, 2)


@pytest.mark.parametrize("save_attn,save_convs", COMBOS)
def test_saving_leaves_loss_gradients_and_two_steps_bit_equal(params, batch, saving_nothing,
                                                              save_attn, save_convs):
    losses, grads, after = _steps(params, batch, save_attn, save_convs, 2)
    want_losses, want_grads, want_after = saving_nothing
    assert all(torch.equal(a, b) for a, b in zip(losses, want_losses))
    assert grads.keys() == want_grads.keys() and len(grads) > 0
    for n in grads:
        assert torch.equal(grads[n], want_grads[n]), n
    for n in after:
        assert torch.equal(after[n], want_after[n]), n


@pytest.mark.parametrize("save_attn,save_convs", COMBOS + [(False, False)])
def test_each_saved_forward_runs_once_per_call_site(params, batch, save_attn, save_convs):
    residuals.forward_runs.clear()
    _steps(params, batch, save_attn, save_convs, 1)
    runs = dict(residuals.forward_runs)
    for op, sites in SITES.items():
        saved = save_convs if op == "resnet_conv" else save_attn
        assert runs.get(op, 0) == (1 if saved else 2) * sites, (op, runs)


class _WeightUse(TorchDispatchMode):
    """Counts the convolutions and matmuls of forwards and recomputations
    (grad mode on; a backward runs with it off) by the parameter whose
    storage their weight operand lies in."""

    def __init__(self, model):
        super().__init__()
        self.names = {p.untyped_storage().data_ptr(): n for n, p in model.named_parameters()
                      if n.endswith("weight")}
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if torch.is_grad_enabled() and func in (torch.ops.aten.convolution.default,
                                                torch.ops.aten.mm.default,
                                                torch.ops.aten.addmm.default):
            for a in args:
                name = (self.names.get(a.untyped_storage().data_ptr())
                        if isinstance(a, torch.Tensor) else None)
                if name is not None:
                    self.counts[name] = self.counts.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def test_resnet_convs_are_saved_and_sampler_and_shortcut_convs_are_not(params, batch):
    """What the recomputations run: with ``remat_save_convs`` no resnet
    conv1 or conv2 runs again, without it each does; the 1x1 shortcuts run
    again either way."""
    post, ctx = batch
    again = {}
    for save_convs in (True, False):
        state = vd.init_video_train_state(port_unet(params), CFG0, "cpu")
        draws = dict(t=torch.tensor([10, 700]), noise=torch.zeros(B, F, HW, HW, 4),
                     eps=torch.zeros(B * F, HW, HW, 4))
        with _WeightUse(state.unet) as use:
            loss = vd.video_loss(functools.partial(state.unet, remat_save_convs=save_convs),
                                 None, post, ctx, CFG0, **draws)
            forward = dict(use.counts)
            loss.backward()  # on the CPU the backward runs on this thread, under the mode
        again[save_convs] = {n: use.counts[n] - forward.get(n, 0) for n in use.counts}
        assert forward == again[save_convs] | forward  # every weight ran in the forward
    resnet = [n for n in again[False] if ".resnets." in n and (".conv1." in n or ".conv2." in n)]
    others = [n for n in again[False] if "samplers." in n or ".conv_shortcut." in n]
    assert len(resnet) == 16 and len(others) >= 4
    # a recomputation stops once it has every tensor the backward saves: the
    # mid block's last conv2 output is saved by nothing, so no recomputation
    # reaches it
    last = "mid_block.resnets.1.conv2.weight"
    for n in resnet:
        assert again[True].get(n, 0) == 0, n
        assert again[False][n] == (0 if n == last else 2 if ".up_blocks." in "." + n
                                   and ".conv1." in n else 1), n  # up blocks: two halves
    # the same either way: nothing keeps them. A recomputation that has what
    # the backward saves stops, so the ops at a block's tail (its sampler,
    # the last resnet's shortcut) are not reached in either mode; the up
    # blocks' shortcuts (two halves) run again in both
    for n in others:
        assert again[True][n] == again[False][n], n
        if n.startswith("up_blocks.") and ".conv_shortcut." in n:
            assert again[True][n] == 2, n


def test_default_policy_loss_matches_jax(params, batch):
    """Both kept (the defaults on both sides), every block recomputed: the
    port's loss against JAX's ``make_video_train_step`` at its default
    policy, from JAX's draws."""
    post, ctx = batch
    jcfg = jvd.VideoDiffusionTrainConfig(compute_dtype="float32", remat=True, remat_min_hw=0)
    assert jcfg.remat_save_attn and CFG0.remat_save_attn
    key = jax.random.key(7)
    jstate = jvd.init_video_train_state(jax.tree.map(jnp.asarray, params), jcfg)
    jstep = jvd.make_video_train_step(JCFG, JVAEConfig.tiny(), jcfg)
    _, jloss = jstep(jstate, None, jnp.asarray(post.numpy()), jnp.asarray(ctx.numpy()), key)
    t, noise, eps = jax_draws(key, 0, tuple(post.shape))
    state = vd.init_video_train_state(port_unet(params), CFG0, "cpu")
    loss = vd.train_step(state, None, post, ctx, seed=0, t=t, noise=noise, eps=eps)
    assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))


def _ff_out_block(h2, w, b):
    return torch.tanh(geglu.geglu(h2, w, b)).sum()


def test_geglu_out_is_an_ff_out_residual():
    """The 1280-channel feed-forward's gate GEMM (``geglu_out``, level 2 and
    the mid block, recomputed only below ``remat_min_hw`` 256): kept as
    ``ff_out`` it runs once, and the gradients are those of the unkept run,
    where it runs twice."""
    g = torch.Generator().manual_seed(4)
    h2 = torch.randn(2, 6, 256, generator=g, requires_grad=True)
    w = torch.randn(128, 128, generator=g, requires_grad=True)
    b = torch.randn(128, generator=g, requires_grad=True)
    assert geglu.geglu_route(128, 128) == "geglu_out"
    grads = []
    for kept, runs in (((residuals.FF_OUT,), 1), ((), 2)):
        residuals.forward_runs.clear()
        out = checkpoint(_ff_out_block, h2, w, b, use_reentrant=False,
                         context_fn=lambda: residuals.checkpoint_contexts(kept))
        grads.append(torch.autograd.grad(out, (h2, w, b)))
        assert residuals.forward_runs["geglu_out"] == runs, kept
    assert all(torch.equal(x, y) for x, y in zip(*grads))


def test_a_recomputation_that_strays_from_its_forward_is_refused():
    kept = (residuals.FF_OUT,)
    fwd, again = residuals.checkpoint_contexts(kept)
    with fwd:
        residuals.forward(residuals.FF_OUT, "ff_ln", lambda: torch.ones(2))
    with again, pytest.raises(RuntimeError, match="reached geglu_out where the forward "
                                                  "recorded ff_ln"):
        residuals.forward(residuals.FF_OUT, "geglu_out", lambda: torch.ones(2))
    fwd, again = residuals.checkpoint_contexts((residuals.RESNET_CONV,))
    x = torch.ones(3)
    with fwd, residuals.region(residuals.RESNET_CONV, "resnet_conv"):
        y = x + 1
    y.add_(1)
    with again, pytest.raises(RuntimeError, match="modified in place"):
        with residuals.region(residuals.RESNET_CONV, "resnet_conv"):
            x + 1


def test_a_region_refuses_an_op_whose_backward_reads_its_output():
    """A SiLU's backward reads its input, which a recomputed region would
    leave unfilled: it is refused in the forward, before any value is kept."""
    fwd, _ = residuals.checkpoint_contexts((residuals.RESNET_CONV,))
    x = torch.ones(3, requires_grad=True)
    with fwd, pytest.raises(RuntimeError, match="silu.* may not stand in a resnet_conv region"):
        with residuals.region(residuals.RESNET_CONV, "resnet_conv"):
            torch.nn.functional.silu(x + 1)
