"""EEG-VP's fold mesh in the port (``parallel.make_fold_mesh``,
``train.eegvp.run_benchmark(fold_parallel=True, mesh=...)``,
``cli.eegvp_train_test --fold_parallel`` under a launcher) against the port's
one-process paths and JAX's 7-device fold mesh, on the CPU.

The port runs in spawned gloo processes (``tests/_torch_dist_worker.py``;
60 s group timeout, 120 s deadline): one world of 7 (a fold a rank) and one
of 8 (rank 7 past the mesh), both started before JAX's side. The data are
``tests/test_eegvp.py``'s synthetic shape: 8 classes, 10 presentations each
a block, out_dim 8, emb_dim 16, batch 32, 4 epochs. Tolerances, those of the
one-process fold-parallel test (``tests/test_torch_eegvp.py``): top-1 /
top-5 / validation top-1 within 1e-6, predictions and confusion identical.
JAX's mesh is held to the port's mesh given JAX's draws (its initial
parameters and permutations, ``test_torch_eegvp._jax_draws``).
"""

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from eeg2video_tpu.train import eegvp as jv
from eeg2video_tpu_torch.cli import eegvp_train_test as tcli
from eeg2video_tpu_torch.convert.from_jax import encoder_state_dict_from_jax
from eeg2video_tpu_torch.train import eegvp as tv

import _torch_dist_worker
from test_torch_eegvp import _jax_draws
from test_torch_models import capped_threads

_threads = capped_threads()

CFG = dict(out_dim=8, emb_dim=16, batch_size=32, epochs=4)
SEED = 3
TOP_TOL = 1e-6


def _synthetic(rng, n_cls=8, reps=10):
    """tests/test_eegvp.py's separable features: (7, 80, 62, 5), labels (7, 80)."""
    n = n_cls * reps
    feats = np.zeros((7, n, 62, 5), np.float32)
    labels = np.zeros((7, n), np.int64)
    for b in range(7):
        y = rng.permutation(np.repeat(np.arange(n_cls), reps))
        labels[b] = y
        centers = np.linspace(-2, 2, n_cls)
        feats[b] = centers[y][:, None, None] + 0.1 * rng.standard_normal((n, 62, 5))
    return feats, labels


def _cli_flags(feature_dir):
    return ["--feature_dir", feature_dir, "--epochs", "1", "--batch_size", "128",
            "--device", "cpu", "--fold_parallel"]


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fold_mesh")
    feats, labels = _synthetic(np.random.default_rng(0))
    jcfg = jv.EEGVPConfig(**CFG)
    draws = [_jax_draws(jcfg, feats, labels, tb, SEED + tb) for tb in range(7)]
    inits = [{k: v.numpy() for k, v in encoder_state_dict_from_jax(
        "glfnet_mlp", {"params": d[2]}).items()} for d in draws]
    de = tmp / "de"
    de.mkdir()
    np.save(de / "sub3.npy", np.random.default_rng(6).standard_normal((7, 40, 5, 2, 62, 5)))
    inputs = {"cfg": CFG, "seed": SEED, "feats": feats, "labels": labels,
              "draws": (inits, [d[3] for d in draws]),
              "cli_args": _cli_flags(str(de)) + ["--out_dir", str(tmp / "mesh")]}
    handles = {w: _torch_dist_worker.start("fold_mesh_cases", w, inputs, tmp) for w in (7, 8)}
    return inputs, handles, tmp


@pytest.fixture(scope="module")
def jax_mesh(started):
    """JAX's run_benchmark on a 7-device fold mesh of its forced CPU devices."""
    inputs, _, _ = started
    mesh = Mesh(np.asarray(jax.devices()[:7]), ("fold",))
    return jv.run_benchmark(inputs["feats"], inputs["labels"], jv.EEGVPConfig(**CFG),
                            seed=SEED, fold_parallel=True, mesh=mesh)


@pytest.fixture(scope="module")
def worlds(started, jax_mesh):
    _, handles, _ = started
    return {w: h.join() for w, h in handles.items()}


@pytest.fixture(scope="module")
def one_process(started):
    inputs, _, _ = started
    cfg = tv.EEGVPConfig(**CFG)
    run = lambda **k: tv.run_benchmark(inputs["feats"], inputs["labels"], cfg, seed=SEED,
                                       device="cpu", **k)
    return {"serial": run(), "batched": run(fold_parallel=True)}


def _same_folds(got, want):
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        for k in ("test_top1", "test_top5", "val_top1"):
            assert abs(g[k] - w[k]) <= TOP_TOL, k
        np.testing.assert_array_equal(g["predictions"], w["predictions"])
        np.testing.assert_array_equal(g["confusion"], w["confusion"])
        assert g["predictions"].dtype == w["predictions"].dtype == np.int32


@pytest.mark.parametrize("world", [7, 8])
def test_every_rank_of_the_fold_mesh_returns_the_one_process_folds(worlds, one_process, world):
    """A fold a rank: every rank of the mesh returns all seven folds, equal to
    the port's one-process batched and serial paths; rank 7 of a world of 8
    is past the mesh and returns None."""
    results = worlds[world]
    mesh_ranks = results[:7]
    assert all(r["active"] for r in mesh_ranks)
    for r in mesh_ranks:
        _same_folds(r["own"], one_process["batched"]["folds"])
        _same_folds(r["own"], one_process["serial"]["folds"])
        for g, w in zip(r["own"], one_process["batched"]["folds"]):
            np.testing.assert_array_equal(g["val_curve"], w["val_curve"])
            assert set(g["params"]) == set(w["params"])
    # every rank holds the same seven folds, the parameters included
    for r in mesh_ranks[1:]:
        for g, w in zip(r["own"], mesh_ranks[0]["own"]):
            for k, v in w["params"].items():
                np.testing.assert_array_equal(g["params"][k], v)
    if world == 8:
        assert results[7] == {"active": False, "own": None, "jax_draws": None}


def test_fold_mesh_with_jax_draws_matches_jax_fold_mesh(worlds, jax_mesh):
    """Given JAX's draws, the port's 7-rank fold mesh gives the top-1 of every
    fold of JAX's run_benchmark on a 7-device fold mesh, and its predictions."""
    for r in worlds[7]:
        got = r["jax_draws"]
        for g, w in zip(got, jax_mesh["folds"]):
            assert abs(g["test_top1"] - w["test_top1"]) <= TOP_TOL
            assert abs(g["test_top5"] - w["test_top5"]) <= TOP_TOL
            np.testing.assert_array_equal(g["predictions"], w["predictions"])
    assert np.mean([f["test_top1"] for f in jax_mesh["folds"]]) > 0.5  # not chance


def test_a_fold_mesh_that_does_not_divide_7_is_refused_by_name(worlds, monkeypatch):
    """A fold mesh of 2 (JAX's placement of 7 folds fails there) is refused by
    name on every rank, before any step."""
    for r in worlds[7]:
        assert r["refused"] is not None and "mesh" in r["refused"] and "2 ranks" in r["refused"]

    class _Mesh:  # the refusal comes before a step, whatever the rank
        size = staticmethod(lambda axis: {"dp": 3, "sp": 1, "tp": 1}[axis])
    monkeypatch.setattr(tv, "_train_program", lambda *a, **k: pytest.fail("a step ran"))
    with pytest.raises(ValueError, match="fold mesh of 3 ranks"):
        tv.run_benchmark(np.zeros((7, 80, 62, 5), np.float32), np.zeros((7, 80), np.int64),
                         tv.EEGVPConfig(**CFG), fold_parallel=True, mesh=_Mesh(), device="cpu")


def test_cli_under_a_7_rank_launch_writes_the_one_process_files(started, worlds, tmp_path):
    """``eegvp_train_test --fold_parallel`` over 7 ranks: rank 0 writes the
    three files of one process (top-1 within 1e-6, predictions and confusion
    equal), once."""
    inputs, _, tmp = started
    flags = inputs["cli_args"][:inputs["cli_args"].index("--out_dir")]
    tcli.main(flags + ["--out_dir", str(tmp_path / "one")])
    mesh_dir = tmp / "mesh"
    assert sorted(p.name for p in mesh_dir.iterdir()) == sorted(
        p.name for p in (tmp_path / "one").iterdir()) == [
        "sub3_confusion.npy", "sub3_preds.npy", "sub3_top1.npy"]
    want = {n: np.load(tmp_path / "one" / f"sub3_{n}.npy") for n in ("top1", "preds", "confusion")}
    got = {n: np.load(mesh_dir / f"sub3_{n}.npy") for n in want}
    np.testing.assert_allclose(got["top1"], want["top1"], rtol=0, atol=TOP_TOL)
    for n in ("preds", "confusion"):
        assert got[n].dtype == want[n].dtype
        np.testing.assert_array_equal(got[n], want[n])
