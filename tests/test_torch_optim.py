"""The port's 8-bit Adam / AdamW (train/optim.py), gradient accumulation in the
fine-tune's train state, and the checkpoint session and preemption guard
(train/checkpoint.py), against the JAX package on the CPU.

Tolerances: int8 codes equal in at least 99.9% of entries and never more than
1 apart (both sides round the same float32 arithmetic, which XLA may contract
into other instruction sequences); scales rtol 1e-6 from the same state and
gradient; parameters within 1e-5 at lr 1e-3 (Adam's updates are about lr, and
the clip's scale differs by the ROADMAP's settled 1e-6: ``clip_grad_norm_``
divides by norm + 1e-6, optax by max(norm, max_norm)).
"""

import os
import signal
import threading

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from eeg2video_tpu.train import optim as joptim
from eeg2video_tpu_torch.train import checkpoint as ckpt
from eeg2video_tpu_torch.train import optim
from eeg2video_tpu_torch.train import videodiffusion as vd

from test_torch_models import capped_threads

_threads = capped_threads()

SHAPES = {"s": (), "b": (7,), "w": (33, 130), "t": (3, 5, 64)}
LR = 1e-3
PARAM_ATOL = 1e-5


def _grads(step, scale=1.0):
    """Seeded gradients of every leaf at ``step``; rows of different
    magnitudes, and at step 0 one all-zero row (its scales become 1)."""
    rng = np.random.default_rng(100 + step)
    out = {}
    for name, shape in SHAPES.items():
        g = rng.standard_normal(shape).astype(np.float32) * scale
        if len(shape) >= 2:
            g *= np.logspace(-3, 1, shape[-2], dtype=np.float32)[:, None]
            if step == 0:
                g[..., 0, :] = 0.0
        out[name] = np.asarray(g, np.float32)
    return out


def _params():
    rng = np.random.default_rng(7)
    return {k: np.asarray(0.1 * rng.standard_normal(s), np.float32) for k, s in SHAPES.items()}


def _codes_close(a, b, what):
    a, b = np.asarray(a).astype(np.int32), np.asarray(b).astype(np.int32)
    assert np.abs(a - b).max(initial=0) <= 1, what
    assert (a == b).mean() >= 0.999, (what, (a == b).mean())


def _torch_layout(a):
    """A flax leaf as a torch module keeps it: the output axis (flax's last,
    along which JAX's 8-bit rows run) first, as nn.Linear's (out, in)."""
    return np.ascontiguousarray(np.moveaxis(a, -1, 0)) if np.ndim(a) >= 2 else np.array(a)


def _flax_layout(t):
    a = t.detach().numpy()
    return np.moveaxis(a, 0, -1) if a.ndim >= 2 else a


def test_each_step_from_the_same_state_matches_scale_by_adam8bit():
    """Ten steps; at each one the port's update starts from JAX's state, in
    torch's layout (the rows along the first axis are JAX's rows along the
    last): the same codes and scales, bit for bit."""
    tx = joptim.scale_by_adam8bit()
    state = tx.init(_params())
    for step in range(10):
        grads = _grads(step)
        upd, new = tx.update(grads, state)
        for k in SHAPES:
            t = lambda a: torch.from_numpy(_torch_layout(np.asarray(a)))  # noqa: E731
            u, mq, ms, vq, vs = optim.adam8_update(
                t(grads[k]), t(state.mq[k]), t(state.ms[k]), t(state.vq[k]), t(state.vs[k]),
                step + 1, 0.9, 0.999, 1e-8)
            assert mq.dtype == vq.dtype == torch.int8 and mq.shape == t(grads[k]).shape
            _codes_close(_flax_layout(mq), new.mq[k], f"mq {k} step {step}")
            _codes_close(_flax_layout(vq), new.vq[k], f"vq {k} step {step}")
            np.testing.assert_allclose(_flax_layout(ms), np.asarray(new.ms[k]), rtol=1e-6,
                                       err_msg=k)
            np.testing.assert_allclose(_flax_layout(vs), np.asarray(new.vs[k]), rtol=1e-6,
                                       err_msg=k)
            np.testing.assert_allclose(_flax_layout(u), np.asarray(upd[k]), rtol=1e-5, atol=1e-6,
                                       err_msg=k)
        state = new


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_ten_steps_of_adam8bit_and_adamw8bit_match_jax(weight_decay):
    """The optimizer class against ``adam8bit`` / ``adamw8bit`` over ten
    steps, each side on its own trajectory."""
    params = _params()
    tx = (joptim.adamw8bit(LR, weight_decay=weight_decay) if weight_decay
          else joptim.adam8bit(LR))
    jstate = tx.init(params)
    jp = dict(params)
    tp = {k: nn.Parameter(torch.from_numpy(_torch_layout(v))) for k, v in params.items()}
    opt = optim.Adam8bit(list(tp.values()), lr=LR, weight_decay=weight_decay)
    for step in range(10):
        grads = _grads(step)
        upd, jstate = tx.update(grads, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(_torch_layout(grads[k]))
        opt.step()
    inner = jstate[0]
    for k, p in tp.items():
        np.testing.assert_allclose(_flax_layout(p), np.asarray(jp[k]), rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)
        st = opt.state[p]
        assert st["count"] == int(inner.count) == 10
        _codes_close(_flax_layout(st["mq"]), inner.mq[k], k)
        _codes_close(_flax_layout(st["vq"]), inner.vq[k], k)
        assert _flax_layout(st["ms"]).shape == inner.ms[k].shape


def test_round_is_half_to_even_on_both_sides():
    """The codes are rounded by torch.round and jnp.round: both take a half to
    the even neighbour."""
    halves = np.array([-126.5, -2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 126.5], np.float32)
    want = np.array([-126, -2, -2, 0, 0, 2, 2, 126], np.float32)
    np.testing.assert_array_equal(torch.round(torch.from_numpy(halves)).numpy(), want)
    np.testing.assert_array_equal(np.asarray(jnp.round(halves)), want)


def test_state_is_about_4x_smaller_than_adam():
    # the torch layout of JAX's (4096, 512) leaf
    p8, pf = nn.Parameter(torch.zeros(512, 4096)), nn.Parameter(torch.zeros(512, 4096))
    o8, of = optim.Adam8bit([p8]), torch.optim.Adam([pf])
    for p, o in ((p8, o8), (pf, of)):
        p.grad = torch.ones_like(p)
        o.step()
    b8, bf = optim.state_bytes(o8), optim.state_bytes(of)
    assert b8 < bf / 3.5
    # the JAX state's bytes, less its int32 count (a Python int here)
    jtx = joptim.scale_by_adam8bit()
    assert b8 == joptim.state_bytes(jtx.init({"w": jnp.zeros((4096, 512))})) - 4


def _problem(rng):
    x = torch.from_numpy(rng.standard_normal((256, 64)).astype(np.float32))
    w = rng.standard_normal((64, 32)).astype(np.float32)
    y = torch.from_numpy((np.tanh(x.numpy() @ w) @ rng.standard_normal((32, 8))).astype(
        np.float32))
    params = {"w1": nn.Parameter(torch.from_numpy((rng.standard_normal((64, 32)) * 0.1)
                                                  .astype(np.float32))),
              "b1": nn.Parameter(torch.zeros(32)),
              "w2": nn.Parameter(torch.from_numpy((rng.standard_normal((32, 8)) * 0.1)
                                                  .astype(np.float32))),
              "b2": nn.Parameter(torch.zeros(8))}
    return params, x, y


def _train(opt_fn, params, steps, x, y):
    params = {k: nn.Parameter(v.detach().clone()) for k, v in params.items()}
    opt = opt_fn(params)
    for _ in range(steps):
        loss = torch.mean((torch.tanh(x @ params["w1"] + params["b1"]) @ params["w2"]
                           + params["b2"] - y) ** 2)
        opt.zero_grad()
        loss.backward()
        opt.step()
    return float(loss.detach()), params


def test_adam8bit_converges_like_adam():
    params, x, y = _problem(np.random.default_rng(0))
    l8, _ = _train(lambda p: optim.Adam8bit(p.values(), lr=1e-2), params, 300, x, y)
    lf, _ = _train(lambda p: torch.optim.Adam(p.values(), lr=1e-2), params, 300, x, y)
    assert l8 < max(3.0 * lf, 1e-3)
    assert l8 < 0.05 * float(torch.mean(y ** 2))


def test_adamw8bit_on_a_masked_subset():
    """The fine-tune's shape: AdamW with decoupled decay on the trainable
    subset; the rest gets no state and stays as it was."""
    params, x, y = _problem(np.random.default_rng(1))
    loss, trained = _train(lambda p: optim.Adam8bit(
        [p["w1"], p["b1"], p["w2"]], lr=1e-2, weight_decay=1e-2), params, 100, x, y)
    assert np.isfinite(loss)
    assert torch.equal(trained["b2"], params["b2"])
    assert not torch.equal(trained["w1"], params["w1"])


def test_scalar_leaf_tracks_adam():
    rng = np.random.default_rng(3)
    init = {"w": torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32)),
            "s": torch.tensor(0.5)}
    p8 = {k: nn.Parameter(v.clone()) for k, v in init.items()}
    pf = {k: nn.Parameter(v.clone()) for k, v in init.items()}
    o8, of = optim.Adam8bit(p8.values(), lr=1e-2), torch.optim.Adam(pf.values(), lr=1e-2)
    for i in range(10):
        for ps in (p8, pf):
            for p in ps.values():
                p.grad = torch.cos(p.detach() + i)
        o8.step()
        of.step()
    assert o8.state[p8["s"]]["mq"].shape == () and o8.state[p8["s"]]["ms"].shape == (1,)
    assert abs(float(p8["s"]) - float(pf["s"])) < 5e-3


def test_cosine_schedule_matches_optax():
    ours, theirs = optim.cosine_decay_schedule(5e-4, 74), optax.cosine_decay_schedule(5e-4, 74)
    for count in (0, 1, 36, 37, 73, 74, 80):
        np.testing.assert_allclose(ours(count), float(theirs(count)), rtol=1e-6, atol=0)


def test_state_dict_round_trip_keeps_int8():
    p = nn.Parameter(torch.randn(5, 6))
    opt = optim.Adam8bit([p], lr=1e-3)
    p.grad = torch.randn(5, 6)
    opt.step()
    sd = opt.state_dict()
    q = nn.Parameter(p.detach().clone())
    opt2 = optim.Adam8bit([q], lr=1e-3)
    opt2.load_state_dict(sd)
    st = opt2.state[q]
    assert st["mq"].dtype == torch.int8 and st["vq"].dtype == torch.int8
    assert st["count"] == 1
    for k in ("mq", "ms", "vq", "vs"):
        assert torch.equal(st[k], opt.state[p][k])
    with pytest.raises(ValueError, match="8-bit"):
        opt2.load_state_dict(torch.optim.Adam([q]).state_dict() | {"state": {0: {"step": 1}}})


# --- gradient accumulation ---------------------------------------------------------

class _Leaves(nn.Module):
    """A module holding one parameter per SHAPES entry, in torch's layout."""

    def __init__(self, params):
        super().__init__()
        for k, v in params.items():
            setattr(self, k, nn.Parameter(torch.from_numpy(_torch_layout(v))))


@pytest.mark.parametrize("eight_bit", [False, True])
@pytest.mark.parametrize("k", [2, 3])
def test_accumulation_matches_optax_multisteps(k, eight_bit):
    """Six micro steps through ``TrainState.apply_gradients`` against
    ``optax.MultiSteps(chain(clip_by_global_norm, adamw), k)``: the
    parameters move only every k-th micro step and then agree. The module
    holds its weights in torch's layout (the 8-bit rows follow JAX's)."""
    params = _params()
    adamw = (joptim.adamw8bit(LR, weight_decay=1e-2) if eight_bit
             else optax.adamw(LR, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-2))
    tx = optax.MultiSteps(optax.chain(optax.clip_by_global_norm(1.0), adamw), k)
    jstate = tx.init(params)
    jp = dict(params)
    cfg = vd.VideoDiffusionTrainConfig(learning_rate=LR, compute_dtype="float32",
                                       train_all=True, gradient_accumulation_steps=k,
                                       use_8bit_adam=eight_bit)
    state = vd.TrainState(_Leaves(params), cfg, device="cpu")
    assert isinstance(state.optimizer, optim.Adam8bit if eight_bit else torch.optim.AdamW)
    before = {n: p.detach().clone() for n, p in state.masters.items()}
    for step in range(6):
        # global norms below the clip's 1.0 at the first emits, above it later
        grads = _grads(step, scale=0.002 if step < 3 else 0.3)
        upd, jstate = tx.update(grads, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for n, p in state.working.items():
            p.grad = torch.from_numpy(_torch_layout(grads[n]))
        state.apply_gradients()
        assert state.step == step + 1
        emitted = (step + 1) % k == 0
        assert state.mini_step == (step + 1) % k
        for n, p in state.masters.items():
            if emitted:
                np.testing.assert_allclose(_flax_layout(p), np.asarray(jp[n]), rtol=0,
                                           atol=PARAM_ATOL, err_msg=f"{n} step {step}")
            else:
                assert torch.equal(p.detach(), before[n]), (n, step)
        before = {n: p.detach().clone() for n, p in state.masters.items()}


# --- the checkpoint session and the preemption guard ---------------------------------

class _Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = nn.Linear(8, 4)


def _tiny_state(seed=0):
    torch.manual_seed(seed)
    cfg = vd.VideoDiffusionTrainConfig(learning_rate=LR, compute_dtype="float32",
                                       train_all=True, gradient_accumulation_steps=2,
                                       use_8bit_adam=True)
    return vd.TrainState(_Tiny(), cfg, device="cpu")


def _micro_step(state):
    """One micro step on data that depends on the step only."""
    g = torch.Generator().manual_seed(state.step)
    x, y = torch.randn(16, 8, generator=g), torch.randn(16, 4, generator=g)
    loss = torch.mean((state.unet.lin(x) - y) ** 2)
    loss.backward()
    state.apply_gradients()


def _flat(sd):
    """Every tensor of a (nested) state dict, by path."""
    out = {}

    def walk(prefix, obj):
        if torch.is_tensor(obj):
            out[prefix] = obj
        elif isinstance(obj, dict):
            for k, v in obj.items():
                walk(f"{prefix}/{k}", v)
        elif isinstance(obj, (list, tuple)):
            for i, v in enumerate(obj):
                walk(f"{prefix}/{i}", v)
        else:
            out[prefix] = obj

    walk("", sd)
    return out


def test_session_save_restore_resume_is_bit_exact_with_8bit_state(tmp_path):
    straight = _tiny_state()
    for _ in range(4):
        _micro_step(straight)
    first = _tiny_state()
    _micro_step(first)
    with ckpt.CheckpointSession(str(tmp_path)) as session:
        _micro_step(first)
        path = session.save(first.step, first)
        # the snapshot is taken at save time: a later step does not reach the file
        _micro_step(first)
    assert os.path.basename(path) == "train_state_2.pt"
    resumed = _tiny_state(seed=1)  # other weights, overwritten by the restore
    assert ckpt.restore_train_state(str(tmp_path), resumed) == 2
    assert resumed.optimizer.state[resumed.masters["lin.weight"]]["mq"].dtype == torch.int8
    for _ in range(2):
        _micro_step(resumed)
    want, got = _flat(straight.state_dict()), _flat(resumed.state_dict())
    assert want.keys() == got.keys() and any("mq" in k for k in want)
    for key, v in want.items():
        if torch.is_tensor(v):
            assert torch.equal(v, got[key]), key
        else:
            assert v == got[key], key


def test_session_keeps_max_to_keep_files_and_raises_write_errors(tmp_path):
    with ckpt.CheckpointSession(str(tmp_path / "a"), max_to_keep=2) as session:
        for step in range(1, 5):
            session.save(step, {"w": torch.full((3,), float(step)), "step": step})
    assert sorted(os.listdir(tmp_path / "a")) == ["train_state_3.pt", "train_state_4.pt"]
    assert torch.load(tmp_path / "a" / "train_state_4.pt")["w"].tolist() == [4.0] * 3
    (tmp_path / "b").write_text("a file where the directory should be")
    session = ckpt.CheckpointSession(str(tmp_path / "b"))
    session.save(1, {"w": torch.zeros(1)})
    with pytest.raises(OSError):
        session.close()


def test_guard_sets_the_flag_then_falls_through_and_restores_handlers():
    seen = []
    old = {s: signal.getsignal(s) for s in (signal.SIGUSR1, signal.SIGUSR2, signal.SIGTERM)}
    try:
        signal.signal(signal.SIGUSR1, lambda signum, frame: seen.append(signum))
        signal.signal(signal.SIGUSR2, signal.SIG_DFL)
        handler = signal.getsignal(signal.SIGUSR1)
        with ckpt.PreemptionGuard(signals=(signal.SIGUSR1, signal.SIGUSR2)) as guard:
            os.kill(os.getpid(), signal.SIGUSR1)
            assert guard.preempted and seen == []
            os.kill(os.getpid(), signal.SIGUSR1)  # the second one: the old handler's
            assert seen == [signal.SIGUSR1]
            with pytest.raises(KeyboardInterrupt):  # no old handler to call
                os.kill(os.getpid(), signal.SIGUSR2)
        assert signal.getsignal(signal.SIGUSR1) is handler
        assert signal.getsignal(signal.SIGUSR2) is signal.SIG_DFL
        with ckpt.PreemptionGuard() as guard:
            os.kill(os.getpid(), signal.SIGTERM)
            assert guard.preempted
        assert signal.getsignal(signal.SIGTERM) is old[signal.SIGTERM]
    finally:
        for s, h in old.items():
            signal.signal(s, h)


def test_guard_off_the_main_thread_never_trips():
    before = signal.getsignal(signal.SIGTERM)
    out = {}

    def run():
        with ckpt.PreemptionGuard() as guard:
            out["installed"] = signal.getsignal(signal.SIGTERM)
            out["preempted"] = guard.preempted

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    assert out == {"installed": before, "preempted": False}
    assert signal.getsignal(signal.SIGTERM) is before


# --- the fine-tune's CLI with 8-bit Adam, accumulation and preemption ---------------

def _micro_run(tmp_path, name, flags, on_step=None):
    """``cli.train`` on the micro UNet of tests/test_torch_train.py: 4 clips at
    batch 1, so an epoch is 4 micro steps."""
    import dataclasses

    from eeg2video_tpu.models.unet3d import UNet3DConditionModel as JUNet
    from eeg2video_tpu_torch.cli import train_tuneavideo as cli
    from eeg2video_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from test_torch_train import CFG, F, HW, JCFG, TCFG, port_unet, rand, random_params

    jcfg = dataclasses.replace(JCFG, cross_attention_dim=768)
    cfg = dataclasses.replace(CFG, cross_attention_dim=768)
    params = random_params(JUNet(jcfg), 12, np.zeros((1, F, HW, HW, 4), np.float32),
                           jnp.asarray([3]), np.zeros((1, 7, 768), np.float32))
    unet = port_unet(params, cfg)
    rng = np.random.default_rng(15)
    post = np.concatenate([rand(rng, 4, F, HW, HW, 4), 0.3 * rand(rng, 4, F, HW, HW, 4)], -1)
    contexts = rand(rng, 4, 77, 768)
    args = cli.build_parser().parse_args([
        "--device", "cpu", "--train_batch_size", "1", "--validation_epochs", "9",
        "--output_dir", str(tmp_path / name), *flags])
    tcfg = dataclasses.replace(TCFG, use_8bit_adam=args.use_8bit_adam,
                               gradient_accumulation_steps=args.gradient_accumulation_steps)
    state, losses = cli.train(unet, AutoencoderKL(VAEConfig.tiny()), post, contexts, args,
                              cfg=tcfg, on_step=on_step)
    return unet, state, losses


def test_cli_trains_with_8bit_adam_and_accumulation(tmp_path):
    """``--use_8bit_adam --gradient_accumulation_steps 2``: the trainable
    masters move only at micro steps 2 and 4, the optimizer holds int8
    moments for the trainable tensors only, and the written train state
    resumes."""
    seen = []

    def on_step(state, loss):
        seen.append((state.step, state.mini_step,
                     {n: p.detach().clone() for n, p in state.masters.items()}))

    _, state, losses = _micro_run(tmp_path, "run", ["--epochs", "1", "--use_8bit_adam",
                                                    "--gradient_accumulation_steps", "2"],
                                  on_step)
    assert isinstance(state.optimizer, optim.Adam8bit) and len(losses) == 1
    assert [(s, m) for s, m, _ in seen] == [(1, 1), (2, 0), (3, 1), (4, 0)]
    moved = [any(not torch.equal(p, seen[i - 1][2][n]) for n, p in snap.items())
             for i, (_, _, snap) in enumerate(seen) if i]
    assert moved == [True, False, True]
    held = {id(p) for p in state.optimizer.state}
    assert held == {id(p) for p in state.masters.values()}
    assert all(st["mq"].dtype == torch.int8 and st["count"] == 2
               for st in state.optimizer.state.values())
    saved = torch.load(tmp_path / "run" / "ckpt" / "train_state_1.pt", weights_only=False)
    assert saved["step"] == 4 and saved["mini_step"] == 0
    assert {v["mq"].dtype for v in saved["opt_state"]["state"].values()} == {torch.int8}
    _, resumed, _ = _micro_run(tmp_path, "resume", [
        "--epochs", "1", "--use_8bit_adam", "--gradient_accumulation_steps", "2",
        "--unet_ckpt", str(tmp_path / "run" / "ckpt")])
    assert resumed.step == 8


def test_sigterm_from_on_step_ends_the_epoch_with_a_resumable_save(tmp_path):
    def on_step(state, loss):
        if state.step == 1:
            os.kill(os.getpid(), signal.SIGTERM)

    before = signal.getsignal(signal.SIGTERM)
    _, state, losses = _micro_run(tmp_path, "run", ["--epochs", "3"], on_step)
    assert signal.getsignal(signal.SIGTERM) is before
    assert len(losses) == 1 and state.step == 4  # the epoch ran to its end
    ckpt_dir = tmp_path / "run" / "ckpt"
    assert os.listdir(ckpt_dir) == ["train_state_1.pt"]
    assert not os.path.exists(tmp_path / "run" / "unet")  # no diffusers layout: not an end
    _, resumed, _ = _micro_run(tmp_path, "resume", ["--epochs", "1", "--unet_ckpt",
                                                    str(ckpt_dir)])
    assert resumed.step == 8
