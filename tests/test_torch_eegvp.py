"""The port's EEG-VP benchmark (train/eegvp.py, cli/eegvp_train_test.py)
against the JAX package's, on the CPU in float32.

The two packages draw differently (torch generators keyed by (seed, fold,
epoch) against jax.random keys: ROADMAP §3), so the training comparison feeds
the port JAX's own initial parameters and permutations. glfnet_mlp has no
dropout, so the folds are then the same computation. Tolerances: the splits,
labels and scaled fold arrays bit-equal (the same numpy code); after 3 epochs
(18 AdamW steps) 99.99% of each parameter's entries within 1e-4 of its
tensor's largest entry and every entry within one learning rate, what one
Adam step can move a weight: Adam moves a weight by about the learning rate
whatever its gradient's size, so where a gradient is small against float32
noise the two sides move it differently (measured: 3 of 188,360 entries
beyond 1e-4, the largest 1.27e-4 absolute, 0.13 of the learning rate); and
the same validation curve, best epoch, test top-1 and predictions.
Fold-parallel against serial: top-1 within 1e-6 and predictions identical
(JAX's tests/test_eegvp.py::test_fold_parallel_matches_serial).
"""

import jax
import numpy as np
import pytest
import torch

from eeg2video_tpu.cli import eegvp_train_test as jcli
from eeg2video_tpu.models import make_encoder as jmake_encoder
from eeg2video_tpu.train import eegvp as jv
from eeg2video_tpu_torch.cli import eegvp_train_test as tcli
from eeg2video_tpu_torch.convert.from_jax import encoder_state_dict_from_jax
from eeg2video_tpu_torch.train import eegvp as tv

from test_torch_models import capped_threads

_threads = capped_threads()

PARAM_RTOL, PARAM_SHARE = 1e-4, 0.9999
REPS = 2  # presentations of each concept a block: 80 samples a block


def _separable(seed=0, noise=0.8):
    """(7, 80, 62, 5) features around one center a class, and their labels."""
    rng = np.random.default_rng(seed)
    labels = jv.block_labels(REPS)
    centers = rng.standard_normal((40, 62, 5))
    feats = centers[labels] + noise * rng.standard_normal((7, labels.shape[1], 62, 5))
    return feats.astype(np.float32), labels


def test_splits_labels_and_fold_arrays_equal_jax():
    for tb in range(7):
        assert tv.make_fold_splits(tb) == jv.make_fold_splits(tb)
    for reps in (1, 5, 10):
        assert np.array_equal(tv.block_labels(reps), jv.block_labels(reps))
    feats, labels = _separable(1)
    for tb in (0, 3, 6):
        want, got = jv._fold_arrays(feats, labels, tb), tv._fold_arrays(feats, labels, tb)
        assert want.keys() == got.keys()
        for k in want:
            for a, b in zip(got[k], want[k]):
                assert a.dtype == b.dtype and np.array_equal(a, b)


def _jax_draws(cfg, feats, labels, tb, seed):
    """What JAX's train_fold draws: its initial (Xavier re-initialized)
    parameters and each epoch's permutation (eegvp.py:207-227, :133-134)."""
    data = jv._fold_arrays(feats, labels, tb)
    model = jmake_encoder(cfg.encoder, out_dim=cfg.out_dim, emb_dim=cfg.emb_dim)
    key = jax.random.key(seed)
    params = model.init(key, data["train"][0][:2], train=False)["params"]
    params = jv._xavier_reinit(params, jax.random.fold_in(key, 1))
    fold_key = jax.random.fold_in(key, 1000)
    n = len(data["train"][1])
    perms = np.stack([np.asarray(jax.random.permutation(
        jax.random.fold_in(jax.random.fold_in(fold_key, e), 0), n)) for e in range(cfg.epochs)])
    return model, data, jax.device_get(params), perms


def test_train_fold_with_jax_draws_matches_jax():
    cfg_j = jv.EEGVPConfig(epochs=3, batch_size=64, emb_dim=16)
    cfg_t = tv.EEGVPConfig(epochs=3, batch_size=64, emb_dim=16)
    feats, labels = _separable(2)
    tb, seed = 4, 9
    model, data, init, perms = _jax_draws(cfg_j, feats, labels, tb, seed)
    want = jv.train_fold(feats, labels, tb, cfg_j, seed=seed)
    # JAX's validation curve, from the same fold program train_fold runs
    tx = jv._make_tx(cfg_j.lr, cfg_j.weight_decay)
    jparams = jax.tree.map(jax.numpy.asarray, init)
    _, _, _, jvals = jv._train_fold_scan(
        model, tx, jparams, tx.init(jparams), jax.random.fold_in(jax.random.key(seed), 1000),
        *(jax.numpy.asarray(a) for a in (*data["train"], *data["val"])),
        len(data["train"][1]) // cfg_j.batch_size, cfg_j.batch_size, cfg_j.epochs)
    jvals = np.asarray(jvals)

    got = tv.train_fold(feats, labels, tb, cfg_t, seed=seed, device="cpu",
                        init_params=encoder_state_dict_from_jax("glfnet_mlp", {"params": init}),
                        perms=perms)
    np.testing.assert_array_equal(got["val_curve"], jvals)
    assert int(np.argmax(got["val_curve"])) == int(np.argmax(jvals))
    assert got["val_top1"] == pytest.approx(want["val_top1"], abs=1e-6)
    assert got["test_top1"] == pytest.approx(want["test_top1"], abs=1e-6)
    assert got["test_top5"] == pytest.approx(want["test_top5"], abs=1e-6)
    np.testing.assert_array_equal(got["predictions"], want["predictions"])
    np.testing.assert_array_equal(got["confusion"], want["confusion"])
    assert got["predictions"].dtype == want["predictions"].dtype
    assert got["confusion"].dtype == want["confusion"].dtype
    wparams = encoder_state_dict_from_jax("glfnet_mlp", {"params": jax.device_get(want["params"])})
    assert wparams.keys() == got["params"].keys()
    for k, w in wparams.items():
        d = np.abs(got["params"][k].numpy() - w.numpy())
        assert (d <= PARAM_RTOL * np.abs(w.numpy()).max()).mean() >= PARAM_SHARE, k
        assert d.max() <= cfg_t.lr, k
    assert want["test_top1"] > 0.5  # the data are separable: the comparison is not of chance


def test_fold_parallel_matches_serial():
    cfg = tv.EEGVPConfig(epochs=3, batch_size=64, emb_dim=16)
    feats, labels = _separable(3)
    serial = tv.run_benchmark(feats, labels, cfg, seed=5, device="cpu")
    parallel = tv.run_benchmark(feats, labels, cfg, seed=5, device="cpu", fold_parallel=True)
    assert len(serial["folds"]) == len(parallel["folds"]) == 7
    for s, p in zip(serial["folds"], parallel["folds"]):
        assert abs(s["test_top1"] - p["test_top1"]) <= 1e-6
        assert abs(s["val_top1"] - p["val_top1"]) <= 1e-6
        np.testing.assert_array_equal(s["predictions"], p["predictions"])
        np.testing.assert_array_equal(s["confusion"], p["confusion"])
    for k in ("top1_mean", "top1_std", "top5_mean", "top5_std"):
        assert abs(serial[k] - parallel[k]) <= 1e-6


def test_draws_are_keyed_by_seed_and_fold():
    cfg = tv.EEGVPConfig(emb_dim=8)
    a = tv.init_fold_params(cfg, 62, 3, 1, "cpu")
    b = tv.init_fold_params(cfg, 62, 3, 1, "cpu")
    c = tv.init_fold_params(cfg, 62, 3, 2, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["out.weight"], c["out.weight"])
    assert torch.equal(a["out.bias"], torch.zeros_like(a["out.bias"]))
    bound = (6.0 / sum(a["out.weight"].shape)) ** 0.5  # Xavier-uniform
    assert float(a["out.weight"].abs().max()) <= bound


@pytest.mark.parametrize("name", ["shallownet", "deepnet", "eegnet", "tsconv", "conformer",
                                  "glfnet", "mlpnet", "glmnet"])
def test_encoders_jax_cannot_run_are_refused_by_name_before_any_step(name, monkeypatch):
    feats, labels = _separable(4)
    monkeypatch.setattr(tv, "_train_program", lambda *a, **k: pytest.fail("a step ran"))
    cfg = tv.EEGVPConfig(epochs=1, batch_size=64, encoder=name)
    with pytest.raises(ValueError, match=f"encoder '{name}'"):
        tv.run_benchmark(feats, labels, cfg, device="cpu")
    with pytest.raises(ValueError, match=f"encoder '{name}'"):
        tv.train_fold(feats, labels, 0, cfg, device="cpu")


@pytest.mark.parametrize("name", ["glfnet", "mlpnet"])
def test_jax_fails_on_the_refused_encoders_too(name):
    """glfnet (BatchNorm, raw-EEG input) and mlpnet (no emb_dim) do not run in
    JAX's EEG-VP trainer either."""
    feats, labels = _separable(4)
    with pytest.raises((TypeError, ValueError)):
        jv.train_fold(feats, labels, 0, jv.EEGVPConfig(epochs=1, batch_size=64, encoder=name))


@pytest.mark.parametrize("fold_parallel", [False, True])
def test_cli_writes_the_jax_cli_outputs(tmp_path, fold_parallel):
    """Per subject: sub{n}_top1 (7,), _preds (7, 400), _confusion (7, 40, 40),
    with the JAX CLI's shapes and dtypes, from DE_1per1s-shaped features."""
    rng = np.random.default_rng(6)
    (tmp_path / "de").mkdir()
    np.save(tmp_path / "de" / "sub3.npy", rng.standard_normal((7, 40, 5, 2, 62, 5)))
    flags = ["--feature_dir", str(tmp_path / "de"), "--epochs", "1", "--batch_size", "128"]
    jcli.main(flags + ["--out_dir", str(tmp_path / "jax")])
    tcli.main(flags + ["--out_dir", str(tmp_path / "port"), "--device", "cpu"]
              + (["--fold_parallel"] if fold_parallel else []))
    for name, shape in (("top1", (7,)), ("preds", (7, 400)), ("confusion", (7, 40, 40))):
        want = np.load(tmp_path / "jax" / f"sub3_{name}.npy")
        got = np.load(tmp_path / "port" / f"sub3_{name}.npy")
        assert got.shape == want.shape == shape and got.dtype == want.dtype
    assert np.load(tmp_path / "port" / "sub3_confusion.npy").sum() == 7 * 400
