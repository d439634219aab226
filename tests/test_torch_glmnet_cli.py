"""The port's GLMNet CLIs (cli/train_glmnet.py, cli/inference_glmnet.py)
against the JAX package's, on the CPU, on tiny data: one window of one
presentation a concept, (7, 40, 1, 1, 62, 100) raw and (7, 40, 1, 1, 62, 5)
DE features.

Tolerances: the data preparation is the same numpy code: bit-equal; the
learning rate at every step within 1e-7 of optax's schedule (both in float32);
embeddings from a JAX checkpoint carried across within rtol 1e-3 / atol 1e-4
(whole models).
"""

import json

import jax
import numpy as np
import pytest
import torch

from eeg2video_tpu.cli import inference_glmnet as jinfer
from eeg2video_tpu.cli import train_glmnet as jtrain
from eeg2video_tpu.train import checkpoint as jckpt
from eeg2video_tpu_torch.cli import inference_glmnet as tinfer
from eeg2video_tpu_torch.cli import train_glmnet as ttrain
from eeg2video_tpu_torch.convert.from_jax import encoder_state_dict_from_jax
from eeg2video_tpu_torch.train.checkpoint import save_train_state

from test_torch_models import capped_threads

_threads = capped_threads()

LR_ATOL = 1e-7
MODEL_TOL = dict(rtol=1e-3, atol=1e-4)


@pytest.fixture
def tiny_subject(tmp_path):
    rng = np.random.default_rng(0)
    for name, last in (("raw", 100), ("de", 5)):
        (tmp_path / name).mkdir()
        np.save(tmp_path / name / "sub2.npy", rng.standard_normal((7, 40, 1, 1, 62, last)))
    return tmp_path


def test_prepare_glmnet_data_is_bit_equal_to_jax():
    rng = np.random.default_rng(1)
    raw, de = rng.standard_normal((7, 40, 2, 7, 62, 100)), rng.standard_normal((7, 40, 2, 7, 62, 5))
    want, wstats = jtrain.prepare_glmnet_data(raw, de, list(range(6)), 6)
    got, gstats = ttrain.prepare_glmnet_data(raw, de, list(range(6)), 6)
    for k in ("mean", "std"):
        assert np.array_equal(gstats[k], wstats[k])
    for split in ("train", "test"):
        for a, b in zip(got[split], want[split]):
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("name", ["cosine", "steplr", "reducelronplateau"])
@pytest.mark.parametrize("total", [1, 7, 300])
def test_lr_schedules_match_optax_at_every_step(name, total):
    want = jtrain.make_lr_schedule(name, 1e-3, 1e-5, total)
    got = ttrain.make_lr_schedule(name, 1e-3, 1e-5, total)
    for step in range(total + 3):
        assert abs(got(step) - float(want(step))) <= LR_ATOL, step


def test_unknown_schedule_is_refused_like_jax():
    for fn in (jtrain.make_lr_schedule, ttrain.make_lr_schedule):
        with pytest.raises(ValueError, match="unknown scheduler 'nope'"):
            fn("nope", 1e-3, 1e-5, 10)


@pytest.mark.parametrize("scheduler", ["cosine", "steplr", "reducelronplateau"])
def test_train_then_inference_on_the_cpu(tiny_subject, scheduler):
    out = tiny_subject / "out"
    acc = ttrain.main(["--raw_dir", str(tiny_subject / "raw"), "--de_dir", str(tiny_subject / "de"),
                       "--sub", "2", "--save_path", str(out), "--epochs", "2",
                       "--batch_size", "64", "--emb_dim", "16", "--scheduler", scheduler,
                       "--device", "cpu"])
    assert 0.0 <= acc <= 1.0
    stats = np.load(out / "norm_stats.npz")
    assert stats["mean"].shape == stats["std"].shape == (1, 62, 1)
    lines = [json.loads(s) for s in (out / "glmnet_metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in lines] == [0, 1] and all(np.isfinite(r["train_loss"]) for r in lines)
    sd = torch.load(out / "ckpt" / "train_state_2.pt", weights_only=True)
    assert int(sd["rawnet.net.2.num_batches_tracked"]) == 2 * (240 // 64)  # train mode, every step
    emb = tinfer.main(["--raw_dir", str(tiny_subject / "raw"), "--de_dir", str(tiny_subject / "de"),
                       "--sub", "2", "--ckpt", str(out / "ckpt"),
                       "--norm_stats", str(out / "norm_stats.npz"), "--emb_dim", "16",
                       "--out", str(out / "emb.npy"), "--device", "cpu"])
    saved = np.load(out / "emb.npy")
    assert saved.shape == (7, 40, 1, 1, 32) and saved.dtype == np.float32
    assert np.array_equal(saved, emb) and np.isfinite(saved).all()


def test_embeddings_from_a_jax_checkpoint_match_jax_inference(tiny_subject):
    """JAX trains one epoch and embeds; its checkpoint, carried across
    (encoder_state_dict_from_jax) into the port's format, embeds in the port
    with JAX's normalization statistics."""
    jout = tiny_subject / "jax"
    data = ["--raw_dir", str(tiny_subject / "raw"), "--de_dir", str(tiny_subject / "de"),
            "--sub", "2", "--emb_dim", "16"]
    jtrain.main(data + ["--save_path", str(jout), "--epochs", "1", "--batch_size", "64"])
    jinfer.main(data + ["--ckpt", str(jout / "ckpt"), "--norm_stats", str(jout / "norm_stats.npz"),
                        "--out", str(jout / "emb.npy")])
    variables, _ = jckpt.restore_checkpoint(str(jout / "ckpt"))
    ckpt_dir = tiny_subject / "port_ckpt"
    save_train_state(str(ckpt_dir), 1,
                     encoder_state_dict_from_jax("glmnet", jax.device_get(variables)))
    got = tinfer.main(data + ["--ckpt", str(ckpt_dir), "--norm_stats",
                              str(jout / "norm_stats.npz"), "--out",
                              str(tiny_subject / "port_emb.npy"), "--device", "cpu"])
    want = np.load(jout / "emb.npy")
    assert got.shape == want.shape == (7, 40, 1, 1, 32)
    np.testing.assert_allclose(got, want, **MODEL_TOL)


def test_dp_is_refused_by_name(tiny_subject, capsys):
    """``--dp 2`` in a world of one process (no launcher) is refused by name
    before anything is read: the mesh would need two ranks."""
    with pytest.raises(SystemExit):
        ttrain.main(["--raw_dir", str(tiny_subject / "raw"), "--de_dir", str(tiny_subject / "de"),
                     "--sub", "2", "--dp", "2", "--device", "cpu"])
    err = capsys.readouterr().err
    assert "--dp 2" in err and "world holds 1 rank" in err


def test_the_card_is_the_default(tiny_subject):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        ttrain.main(["--raw_dir", str(tiny_subject / "raw"), "--de_dir", str(tiny_subject / "de"),
                     "--sub", "2", "--save_path", str(tiny_subject / "x")])
