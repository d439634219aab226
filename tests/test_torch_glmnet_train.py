"""The port's GLMNet training loop (``cli.train_glmnet.train_glmnet``)
against two epochs of the JAX CLI's ``train_epoch`` on the CPU, on tiny data:
one window of one presentation a concept, (7, 40, 1, 1, 62, 100) raw and
(7, 40, 1, 1, 62, 5) DE features, batch 64, so 3 steps an epoch.

The port is given JAX's draws: the initial parameters of
``model.init(jax.random.key(seed))`` carried across, and the permutations
that ``np.random.default_rng(seed)`` gives JAX's epochs. Dropout is off on
both sides (flax's ``Dropout`` and the port's ``layers.Dropout`` made
identities inside the test), since the two draw their masks from different
generators.

Tolerances, those of EEG-VP with JAX's draws (tests/test_torch_eegvp.py):
after two epochs 99.99% of each tensor's entries within 1e-4 of the
tensor's largest magnitude and all within one learning rate (AdamW moves a
parameter by at most about one learning rate a step, so a sign flip of one
tiny update is the largest gap summation order can open); each epoch's
summed loss within 1e-5 relative.

Three tensors cannot be held so. The biases of the two convolutions in front
of the train-mode BatchNorm (``rawnet.net.0.bias``, ``rawnet.net.1.bias``)
have a gradient of exactly 0 in exact arithmetic, since the BatchNorm takes
out every channel's mean; in float32 it is rounding noise, which Adam's
normalisation turns into steps of about one learning rate in a direction of
the noise's choosing, on each side its own (about 1e-3 apart after 6 steps
where each bias is at most 1.6e-3). The running mean averages those biases
in. For these the test holds what does hold: each side moved each bias at
most one learning rate a step from the common start, and the two trained
models give the same logits in train mode (where the BatchNorm removes the
biases) within 1e-4 of their largest magnitude.

The JAX CLI's ``steplr`` schedule cannot run as it stands: it floors the
staircase with ``np.maximum`` (eeg2video_tpu/cli/train_glmnet.py:33), which
fails on the tracer of its jitted epoch. For that case the test hands JAX's
CLI the same staircase floored with ``jnp.maximum``; the two agree at every
concrete step (tests/test_torch_glmnet_cli.py holds the port's schedule to
JAX's there).
"""

import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eeg2video_tpu.cli import train_glmnet as jtrain
from eeg2video_tpu.models import make_encoder as jmake_encoder
from eeg2video_tpu.train import checkpoint as jckpt
from eeg2video_tpu_torch.cli import train_glmnet as ttrain
from eeg2video_tpu_torch.convert.from_jax import encoder_state_dict_from_jax
from eeg2video_tpu_torch.models.layers import Dropout

from test_torch_models import capped_threads

_threads = capped_threads()

PARAM_RTOL, PARAM_SHARE = 1e-4, 0.9999
LOSS_RTOL = 1e-5
LR, EPOCHS, BATCH, EMB, SEED = 1e-3, 2, 64, 16, 3
STEPS = EPOCHS * (240 // BATCH)  # 6 blocks x 40 concepts train samples
# gradient 0 in exact arithmetic (a train-mode BatchNorm follows), and the
# running mean that averages them in
BN_CANCELLED = ("rawnet.net.0.bias", "rawnet.net.1.bias")
BN_MEAN = "rawnet.net.2.running_mean"


@pytest.fixture
def tiny_subject(tmp_path):
    rng = np.random.default_rng(0)
    for name, last in (("raw", 100), ("de", 5)):
        (tmp_path / name).mkdir()
        np.save(tmp_path / name / "sub2.npy", rng.standard_normal((7, 40, 1, 1, 62, last)))
    return tmp_path


@pytest.fixture
def no_dropout(monkeypatch):
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    monkeypatch.setattr(Dropout, "forward", lambda self, x: x)


@pytest.fixture
def traceable_steplr(monkeypatch):
    make = jtrain.make_lr_schedule

    def make_traceable(name, lr, min_lr, total_steps):
        if name != "steplr":
            return make(name, lr, min_lr, total_steps)
        import optax

        sched = optax.exponential_decay(lr, total_steps // 3 or 1, 0.1, staircase=True)
        return lambda step: jnp.maximum(sched(step), min_lr)

    monkeypatch.setattr(jtrain, "make_lr_schedule", make_traceable)


@pytest.mark.parametrize("scheduler", ["steplr", "cosine", "reducelronplateau"])
def test_two_epochs_with_jax_draws_match_jax(tiny_subject, no_dropout, traceable_steplr,
                                             scheduler):
    jout = tiny_subject / "jax"
    jtrain.main(["--raw_dir", str(tiny_subject / "raw"), "--de_dir", str(tiny_subject / "de"),
                 "--sub", "2", "--save_path", str(jout), "--epochs", str(EPOCHS),
                 "--batch_size", str(BATCH), "--emb_dim", str(EMB), "--scheduler", scheduler,
                 "--lr", str(LR), "--seed", str(SEED)])
    want_losses = [json.loads(s)["train_loss"]
                   for s in (jout / "glmnet_metrics.jsonl").read_text().splitlines()]
    jstate, _ = jckpt.restore_checkpoint(str(jout / "ckpt"))
    want = encoder_state_dict_from_jax("glmnet", jax.device_get(jstate))

    # JAX's draws, as its main makes them
    raw = np.load(tiny_subject / "raw" / "sub2.npy")
    de = np.load(tiny_subject / "de" / "sub2.npy")
    data, _ = ttrain.prepare_glmnet_data(raw, de, list(range(6)), 6)
    xr, xf, y = data["train"]
    init = jmake_encoder("glmnet", out_dim=40, emb_dim=EMB).init(
        jax.random.key(SEED), xr[:2], xf[:2], train=False)
    rng = np.random.default_rng(SEED)
    perms = [rng.permutation(len(y)) for _ in range(EPOCHS)]

    model, losses = ttrain.train_glmnet(
        data["train"], emb_dim=EMB, epochs=EPOCHS, batch_size=BATCH, lr=LR, scheduler=scheduler,
        seed=SEED, device="cpu", perms=perms,
        init_params=encoder_state_dict_from_jax("glmnet", jax.device_get(init)))
    assert any(isinstance(m, Dropout) and m.p > 0 for m in model.modules())
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)

    got = model.state_dict()
    start = encoder_state_dict_from_jax("glmnet", jax.device_get(init))
    assert set(want) == set(got) == set(start)
    held = [k for k in want if not k.endswith("num_batches_tracked")
            and k not in BN_CANCELLED + (BN_MEAN,)]
    for k in held:
        w, g = want[k].numpy(), got[k].numpy()
        d = np.abs(g - w)
        assert (d <= PARAM_RTOL * np.abs(w).max()).mean() >= PARAM_SHARE, k
        assert d.max() <= LR, k
    for k in BN_CANCELLED:
        for side in (want, got):
            assert float((side[k] - start[k]).abs().max()) <= STEPS * LR * (1 + 1e-3), k
    # and something moved: the comparison is not of two untouched inits
    assert max(float((got[k] - start[k]).abs().max()) for k in held) > LR / 2

    # the BatchNorm removes the biases in train mode: the two trained models
    # agree there
    jmodel = ttrain.make_encoder("glmnet", out_dim=40, emb_dim=EMB)
    jmodel.load_state_dict(want)
    batch = [torch.as_tensor(a[:BATCH]) for a in (xr, xf)]
    with torch.no_grad():
        a, b = model.train()(*batch), jmodel.train()(*batch)
    assert float((a - b).abs().max()) <= PARAM_RTOL * float(b.abs().max())
