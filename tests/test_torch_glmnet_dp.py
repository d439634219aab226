"""``train_glmnet --dp`` in the port (``cli.train_glmnet``: the batch rules,
``train_glmnet(..., mesh=)``; ``models.layers.set_data_parallel``: the global
BatchNorm statistics and dropout masks) against the JAX CLI's ``--dp`` and
the port's one process, on the CPU, on tests/test_torch_glmnet_train.py's
tiny subject: (7, 40, 1, 1, 62, 100) raw and (7, 40, 1, 1, 62, 5) DE
features, 240 training samples, batch 64 (3 steps an epoch), 2 epochs.

The port runs in spawned gloo processes (``tests/_torch_dist_worker.py``;
60 s group timeout, 120 s deadline), worlds of 2 and 4, started before
JAX's side. JAX's ``--dp 2`` runs in the pytest process on two of its forced
CPU devices.

Tolerances:
- against JAX's ``--dp 2``, given JAX's initial parameters and permutations
  with dropout off on both sides: those tests/test_torch_glmnet_train.py
  holds one device to: the losses within 1e-5 relative; 99.99%
  of each tensor's entries within 1e-4 of its largest magnitude and all within
  one learning rate, but for the two conv biases in front of the BatchNorm and
  the running mean that averages them (their gradient is 0 in exact
  arithmetic): each moved at most one learning rate a step, and the train-mode
  logits within 1e-4 of their largest magnitude;
- with dropout on, ``dp`` 2 and 4 against the port's one process with the
  same draws: rtol 1e-3 / atol 1e-4 (whole models) on the losses and on the
  train-mode logits of the trained models; the parameters as above. Not the
  eval-mode logits: there the running mean does not take out the two conv
  biases, which rounding noise moves by up to a learning rate a step on
  each side (measured 1.4e-3 / 2.3e-3 at dp 2 / 4 against 1e-4);
- every rank's model, running statistics included, bit-equal to rank 0's.
"""

import json
import os

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from eeg2video_tpu.cli import train_glmnet as jtrain
from eeg2video_tpu.models import make_encoder as jmake_encoder
from eeg2video_tpu.train import checkpoint as jckpt
from eeg2video_tpu_torch.cli import train_glmnet as ttrain
from eeg2video_tpu_torch.convert.from_jax import encoder_state_dict_from_jax
from eeg2video_tpu_torch.models.layers import Dropout

import _torch_dist_worker
from test_torch_models import capped_threads

_threads = capped_threads()

PARAM_RTOL, PARAM_SHARE = 1e-4, 0.9999
LOSS_RTOL = 1e-5
MODEL_TOL = dict(rtol=1e-3, atol=1e-4)
LR, EPOCHS, BATCH, EMB, SEED = 1e-3, 2, 64, 16, 3
STEPS = EPOCHS * (240 // BATCH)
BN_CANCELLED = ("rawnet.net.0.bias", "rawnet.net.1.bias")
BN_MEAN = "rawnet.net.2.running_mean"
KW = dict(emb_dim=EMB, epochs=EPOCHS, batch_size=BATCH, lr=LR, scheduler="cosine", seed=SEED)


def _subject(root):
    rng = np.random.default_rng(0)
    for name, last in (("raw", 100), ("de", 5)):
        (root / name).mkdir()
        np.save(root / name / "sub2.npy", rng.standard_normal((7, 40, 1, 1, 62, last)))
    return ["--raw_dir", str(root / "raw"), "--de_dir", str(root / "de"), "--sub", "2"]


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("glmnet_dp")
    data_args = _subject(tmp)
    raw, de = np.load(tmp / "raw" / "sub2.npy"), np.load(tmp / "de" / "sub2.npy")
    data, _ = ttrain.prepare_glmnet_data(raw, de, list(range(6)), 6)
    xr, xf, y = data["train"]
    init = jmake_encoder("glmnet", out_dim=40, emb_dim=EMB).init(
        jax.random.key(SEED), xr[:2], xf[:2], train=False)
    rng = np.random.default_rng(SEED)
    inputs = {"train": data["train"], "train_kw": KW,
              "jax_init": {k: v.numpy() for k, v in encoder_state_dict_from_jax(
                  "glmnet", jax.device_get(init)).items()},
              "jax_perms": [rng.permutation(len(y)) for _ in range(EPOCHS)],
              "cli_args": data_args + ["--epochs", "1", "--batch_size", str(BATCH),
                                       "--emb_dim", str(EMB), "--device", "cpu"],
              "cli_dir": str(tmp / "cli")}
    handles = {w: _torch_dist_worker.start("glmnet_dp_cases", w, inputs, tmp) for w in (2, 4)}
    return inputs, handles, tmp, data_args


@pytest.fixture(scope="module")
def jax_dp2(started):
    """JAX's ``--dp 2``, dropout off (flax's Dropout an identity meanwhile):
    (its epochs' losses, its trained state in the port's keys)."""
    _, _, tmp, data_args = started
    out = tmp / "jax_dp2"
    call = fnn.Dropout.__call__
    fnn.Dropout.__call__ = lambda self, x, *a, **k: x
    try:
        jtrain.main(data_args + ["--save_path", str(out), "--epochs", str(EPOCHS),
                                 "--batch_size", str(BATCH), "--emb_dim", str(EMB),
                                 "--scheduler", "cosine", "--lr", str(LR), "--seed", str(SEED),
                                 "--dp", "2"])
    finally:
        fnn.Dropout.__call__ = call
    losses = [json.loads(s)["train_loss"]
              for s in (out / "glmnet_metrics.jsonl").read_text().splitlines()]
    state, _ = jckpt.restore_checkpoint(str(out / "ckpt"))
    return losses, {k: v.numpy() for k, v in encoder_state_dict_from_jax(
        "glmnet", jax.device_get(state)).items()}


@pytest.fixture(scope="module")
def worlds(started, jax_dp2):
    _, handles, _, _ = started
    return {w: h.join() for w, h in handles.items()}


def _model(state):
    m = ttrain.make_encoder("glmnet", out_dim=40, emb_dim=EMB)
    m.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return m


def _logits(state, inputs):
    """The logits of the first batch, the BatchNorm in train mode (it takes
    out the conv biases in front of it), dropout off."""
    batch = [torch.as_tensor(a[:BATCH]) for a in inputs["train"][:2]]
    model = _model(state).train()
    for m in model.modules():
        if isinstance(m, Dropout):
            m.eval()
    with torch.no_grad():
        return model(*batch).numpy()


def _held(got, want, start, inputs):
    """The one-device gates of a trained GLMNet against another (module
    docstring)."""
    assert set(got) == set(want)
    held = [k for k in want if not k.endswith("num_batches_tracked")
            and k not in BN_CANCELLED + (BN_MEAN,)]
    for k in held:
        d = np.abs(got[k] - want[k])
        assert (d <= PARAM_RTOL * np.abs(want[k]).max()).mean() >= PARAM_SHARE, k
        assert d.max() <= LR, k
    for k in BN_CANCELLED:
        for side in (want, got):
            assert np.abs(side[k] - start[k]).max() <= STEPS * LR * (1 + 1e-3), k
    assert max(np.abs(got[k] - start[k]).max() for k in held) > LR / 2  # something moved
    a, b = _logits(got, inputs), _logits(want, inputs)
    assert np.abs(a - b).max() <= PARAM_RTOL * np.abs(b).max()


def test_dp_2_with_jax_draws_matches_jax_dp_2(started, jax_dp2, worlds):
    """Dropout off, JAX's draws: the port's dp = 2 over two ranks against
    JAX's ``--dp 2`` on two devices (the batch sharded, its BatchNorm
    statistics the global batch's), at the one-device gates; the running
    statistics included."""
    inputs, _, _, _ = started
    want_losses, want = jax_dp2
    state, losses = worlds[2][0]["jax_draws"]
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    _held(state, want, inputs["jax_init"], inputs)
    np.testing.assert_allclose(state["rawnet.net.2.running_var"],
                               want["rawnet.net.2.running_var"], rtol=1e-4, atol=1e-6)
    assert int(state["rawnet.net.2.num_batches_tracked"]) == STEPS


@pytest.mark.parametrize("world", [2, 4])
def test_dp_with_dropout_matches_one_process(started, worlds, world):
    """Dropout on, the port's own draws: dp = 2 and 4 (each rank the global
    batch's dropout masks, its own rows) against the port's one process."""
    inputs, _, _, _ = started
    model, want_losses = ttrain.train_glmnet(inputs["train"], device="cpu", **KW)
    want = {k: v.numpy() for k, v in model.state_dict().items()}
    state, losses = worlds[world][0]["dropout"]
    np.testing.assert_allclose(losses, want_losses, **MODEL_TOL)
    np.testing.assert_allclose(_logits(state, inputs), _logits(want, inputs),
                               **MODEL_TOL)
    held = [k for k in want if k not in BN_CANCELLED + (BN_MEAN,)
            and not k.endswith("num_batches_tracked")]
    for k in held:
        d = np.abs(state[k] - want[k])
        assert (d <= PARAM_RTOL * np.abs(want[k]).max()).mean() >= PARAM_SHARE, k
        assert d.max() <= LR, k


@pytest.mark.parametrize("world", [2, 4])
def test_every_rank_holds_the_same_model_and_running_statistics(worlds, world):
    """The parameters are replicated and the BatchNorm running statistics
    come from the same gathered values: every rank's model is rank 0's, bit
    for bit, with dropout on."""
    ref, _ = worlds[world][0]["dropout"]
    stats = [k for k in ref if "running" in k]
    assert len(stats) == 2  # the ShallowNet's BatchNorm
    for res in worlds[world][1:]:
        state, _ = res["dropout"]
        for k, v in ref.items():
            np.testing.assert_array_equal(state[k], v, err_msg=k)


@pytest.mark.parametrize("n,batch,dp,want", [(240, 64, 2, 64), (240, 64, 3, 63),
                                             (240, 300, 7, 238), (240, 64, 1, 64),
                                             (240, 300, 0, 240), (6, 5, 4, 4)])
def test_batch_follows_jax_rounding(n, batch, dp, want):
    """Clamped to the data, then rounded down to a multiple of dp (JAX's CLI
    :124-141)."""
    assert ttrain.glmnet_batch_size(batch, n, dp) == want


def test_batch_smaller_than_dp_exits_as_jax(started):
    """batch 5 at dp 8: no positive multiple of 8 fits, and both CLIs exit
    with JAX's message (tests/test_glmnet_cli.py::
    test_train_glmnet_dp_rejects_batch_smaller_than_dp)."""
    _, _, tmp, data_args = started
    with pytest.raises(SystemExit, match="cannot shard") as jexit:
        jtrain.main(data_args + ["--save_path", str(tmp / "jax_bs5"), "--epochs", "1",
                                 "--batch_size", "5", "--dp", "8", "--emb_dim", str(EMB)])
    with pytest.raises(SystemExit, match="cannot shard") as texit:
        ttrain.glmnet_batch_size(5, 240, 8)
    assert str(texit.value) == str(jexit.value)


def test_cli_dp_writes_once_and_leaves_idle_ranks(worlds, tmp_path):
    """``main --dp N`` over N ranks: rank 0 writes norm_stats.npz, the
    metrics and the checkpoint and returns the block-6 top-1, the others
    return None; ``--dp`` world - 1 leaves the last rank idle (None) and
    rounds the batch down to a multiple of dp; ``--dp`` world + 1 is refused
    by name on every rank."""
    for world in (2, 4):
        results = [res["cli"] for res in worlds[world]]
        for dp in (world, world - 1):
            acc, _ = results[0][dp]
            assert 0.0 <= acc <= 1.0
            assert all(r[dp][0] is None for r in results[1:])
        refused = [r[world + 1] for r in results]
        for ret, err in refused:
            assert ret == ("exit", 2) and f"--dp {world + 1}" in err and "world" in err


def test_cli_files_of_a_dp_run(started, worlds):
    """What rank 0 of ``--dp 2`` / ``--dp 4`` / ``--dp 3`` (of 4) wrote: the
    one-process CLI's files, a checkpoint of the model trained, an epoch's
    metrics line."""
    inputs, _, _, _ = started
    for world, dp in ((2, 2), (4, 4), (4, 3)):
        out = os.path.join(inputs["cli_dir"], f"w{world}_dp{dp}")
        assert sorted(os.listdir(out)) == ["ckpt", "glmnet_metrics.jsonl", "norm_stats.npz"]
        assert os.listdir(os.path.join(out, "ckpt")) == ["train_state_1.pt"]
        lines = open(os.path.join(out, "glmnet_metrics.jsonl")).read().splitlines()
        assert len(lines) == 1 and np.isfinite(json.loads(lines[0])["train_loss"])
        sd = torch.load(os.path.join(out, "ckpt", "train_state_1.pt"), weights_only=True)
        steps = 240 // ttrain.glmnet_batch_size(BATCH, 240, dp)
        assert int(sd["rawnet.net.2.num_batches_tracked"]) == steps
