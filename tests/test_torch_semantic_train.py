"""The port's semantic-predictor trainer (train/semantic.py), its CLIs
(train_semantic, inference_semantic) and ``inference_eeg2video --legacy``
against the JAX package, on the CPU.

The trainer starts from JAX's own initial weights (carried across by
convert.from_jax) and sees the same data and the same shuffles. Tolerances:
the data plumbing is bit-equal (the same numpy); per-epoch losses rtol 1e-4
and parameters atol 1e-5 after training (float32 products summed in another
order, Adam's update formed in another order, each update about the learning
rate); the f32 MLP's outputs rtol 1e-4 / atol 1e-5; the int8 MLP's within 2e-5
of the output's max (tests/test_torch_int8.py's bound).

The 8-bit optimizer is bit-exact with the JAX package's on equal gradients
(tests/test_torch_optim.py), but the trainer's gradients differ from JAX's in
the last bits (another summation order), and a code that lies within those
bits of a rounding boundary moves by one: there the parameter moves by a
fraction of the learning rate. So the 8-bit trainer holds 99.9% of the
model's entries to 1e-5 and every entry to a tenth of the learning rate.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eeg2video_tpu.cli import inference_eeg2video as jinference
from eeg2video_tpu.data import meta as jmeta
from eeg2video_tpu.data import video as jvideo
from eeg2video_tpu.models.semantic import SemanticPredictor as JSemantic
from eeg2video_tpu.train import semantic as jsem
from eeg2video_tpu_torch.cli import inference_eeg2video, inference_semantic
from eeg2video_tpu_torch.cli import train_semantic as train_cli
from eeg2video_tpu_torch.convert.from_jax import semantic_state_dict_from_jax
from eeg2video_tpu_torch.data import meta, video
from eeg2video_tpu_torch.models.semantic import SemanticPredictor
from eeg2video_tpu_torch.serving import runtimes
from eeg2video_tpu_torch.train import semantic as tsem

from test_torch_models import capped_threads, rand
from test_torch_raw import _SharedNoise
from test_torch_serving import HIDDEN, SIZE, _record_writes, world  # noqa: F401  (fixture)

_threads = capped_threads()

LOSS_RTOL, PARAM_ATOL = 1e-4, 1e-5
MLP_TOL = dict(rtol=1e-4, atol=1e-5)
INT8_BOUND = 2e-5


def _flax_tree(sd):
    """A port state dict (f32 tensors) -> flax ``{"params": ...}``."""
    names = sorted({k.split(".")[0] for k in sd})
    return {"params": {n: {"kernel": sd[f"{n}.weight"].detach().cpu().numpy().T,
                           "bias": sd[f"{n}.bias"].detach().cpu().numpy()} for n in names}}


def test_prepare_semantic_data_is_bit_equal_to_jax():
    rng = np.random.default_rng(1)
    de = rng.standard_normal((7, 40, 5, 62, 5))
    texts = [rand(rng, 200, 77, 8) for _ in range(6)]
    ours, theirs = tsem.prepare_semantic_data(de, texts), jsem.prepare_semantic_data(de, texts)
    for a, b in zip(ours[:2], theirs[:2]):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ours[2].mean, theirs[2].mean)
    np.testing.assert_array_equal(ours[2].std, theirs[2].std)


def test_prepare_semantic_data_legacy_is_bit_equal_to_jax():
    rng = np.random.default_rng(2)
    de = rng.standard_normal((7, 40, 5, 2, 62, 5))
    text = rand(rng, 1400, 77, 8)
    ours = tsem.prepare_semantic_data_legacy(de, text)
    theirs = jsem.prepare_semantic_data_legacy(de, text)
    assert ours[0].shape == (1200, 310) and ours[1].shape == (1200, 616)
    for a, b in zip(ours[:2], theirs[:2]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ours[2].std, theirs[2].std)


@pytest.mark.parametrize("eight_bit", [False, True])
def test_train_semantic_matches_jax(eight_bit):
    """2 epochs of 6 steps (24 rows, batch 4) at hidden 64, out_dim 96."""
    rng = np.random.default_rng(3)
    eeg = rand(rng, 24, 310)
    text = 0.5 * rand(rng, 24, 96)
    kw = dict(epochs=2, batch_size=4, lr=5e-4, hidden=64, out_dim=96, use_8bit_adam=eight_bit)
    jvars, jlosses = jsem.train_semantic(eeg, text, jsem.SemanticTrainConfig(**kw), seed=0)
    init = JSemantic(hidden=64, out_dim=96).init(jax.random.key(0), jnp.zeros((1, 310)))
    model = SemanticPredictor(hidden=64, out_dim=96)
    model.load_state_dict(semantic_state_dict_from_jax(jax.device_get(init)), strict=True)
    sd, losses = tsem.train_semantic(eeg, text, tsem.SemanticTrainConfig(**kw), seed=0,
                                     model=model, device="cpu")
    assert len(losses) == 2 and losses[1] < losses[0]
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL, atol=0)
    want = semantic_state_dict_from_jax(jax.device_get(jvars))
    assert sd.keys() == want.keys()
    within, entries = 0, 0
    for k, v in want.items():
        if not eight_bit:
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=0, atol=PARAM_ATOL,
                                       err_msg=k)
            continue
        err = np.abs(sd[k].numpy() - v.numpy())
        assert err.max() <= 0.1 * kw["lr"], (k, err.max())
        within += int((err <= PARAM_ATOL).sum())
        entries += err.size
    assert within >= 0.999 * entries, (within, entries)
    assert not torch.equal(sd["out.weight"], semantic_state_dict_from_jax(init)["out.weight"])


@pytest.mark.parametrize("kw", [dict(tp=2), dict(pp=3), dict(tp=2, pp=3)])
def test_multi_gpu_forms_are_refused_by_name(kw):
    """What is still refused: a tp or pp mesh that the world (here one
    process) does not hold, and tp with pp (JAX's ValueError), by the trainer
    before it builds a model and by the CLI before it reads anything.
    ``n_micro`` alone is accepted and ignored at pp 1, as in JAX
    (tests/test_torch_pipeline_parallel.py)."""
    name = "tp and pp" if len(kw) == 2 else next(iter(kw))
    with pytest.raises(ValueError, match=name):
        tsem.train_semantic(np.zeros((4, 310), np.float32), np.zeros((4, 8), np.float32),
                            device="cpu", **kw)
    argv = [a for k, v in kw.items() for a in (f"--{k}", str(v))]
    with pytest.raises(SystemExit):
        train_cli.main([*argv, "--device", "cpu"])


def test_default_init_is_flax_s_and_drawn_from_the_seed():
    """Without a built model the trainer starts from flax's initializers
    (lecun-normal kernels, zero biases), the same weights for the same seed
    (8 rows at batch 32: an epoch of no step returns the initial weights)."""
    rng = np.random.default_rng(4)
    eeg, text = rand(rng, 8, 310), rand(rng, 8, 32)
    cfg = tsem.SemanticTrainConfig(epochs=1, hidden=512, out_dim=32)
    a, _ = tsem.train_semantic(eeg, text, cfg, seed=5, device="cpu")
    b, _ = tsem.train_semantic(eeg, text, cfg, seed=5, device="cpu")
    c, _ = tsem.train_semantic(eeg, text, cfg, seed=6, device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a) and not torch.equal(a["fc1.weight"],
                                                                        c["fc1.weight"])
    w = a["fc1.weight"]
    assert not a["fc1.bias"].any()
    assert abs(float(w.std()) * 512 ** 0.5 - 1.0) < 0.05
    assert float(w.abs().max()) <= 2.0 / 0.87962566103423978 / 512 ** 0.5 + 1e-6


def test_train_semantic_cli_writes_what_serve_and_inference_semantic_read(tmp_path):
    """The CLI on DE features and per-block caption embeddings; its
    ``semantic.pt`` and ``scaler.npz`` then go through ``inference_semantic``
    (f32 and ``--int8``, against the JAX predictors on the same weights) and
    through the server's loader (bit-equal to the CLI's output)."""
    rng = np.random.default_rng(6)
    de = (3.0 * rng.standard_normal((7, 40, 5, 62, 5)) + 1.0).astype(np.float32)
    np.save(tmp_path / "de.npy", de)
    (tmp_path / "text").mkdir()
    for i in range(6):
        torch.save(torch.from_numpy(rand(rng, 200, 77, 768)).half(),
                   tmp_path / "text" / f"block{i}.pt")
    out = tmp_path / "sem"
    assert train_cli.main(["--features", str(tmp_path / "de.npy"), "--text_dir",
                           str(tmp_path / "text"), "--save_path", str(out), "--epochs", "1",
                           "--hidden", str(HIDDEN), "--seed", "3", "--device", "cpu"]) == 0
    sd = torch.load(out / "semantic.pt")
    assert sd["fc0.weight"].shape == (HIDDEN, 310) and sd["out.weight"].shape == (77 * 768, HIDDEN)
    texts = [torch.load(tmp_path / "text" / f"block{i}.pt").numpy() for i in range(6)]
    jscaler = jsem.prepare_semantic_data(de, texts)[2]
    z = np.load(out / "scaler.npz")
    np.testing.assert_array_equal(z["mean_z"], jscaler.mean)
    np.testing.assert_array_equal(z["std_z"], jscaler.std)

    block = jmeta.reorder_by_gt(de[6], 6).reshape(-1, 310)
    eeg = jscaler.transform(block)
    variables = _flax_tree(sd)
    common = ["--features", str(tmp_path / "de.npy"), "--ckpt", str(out / "semantic.pt"),
              "--scaler", str(out / "scaler.npz"), "--hidden", str(HIDDEN), "--device", "cpu"]
    assert inference_semantic.main([*common, "--out", str(tmp_path / "f32.npy")]) == 0
    got = np.load(tmp_path / "f32.npy")
    assert got.shape == (200, 77 * 768)
    np.testing.assert_allclose(got, jsem.predict_semantic(variables, eeg, hidden=HIDDEN),
                               **MLP_TOL)
    assert inference_semantic.main([*common, "--int8", "--out", str(tmp_path / "i8.npy")]) == 0
    got8, want8 = np.load(tmp_path / "i8.npy"), jsem.predict_semantic_int8(variables, eeg)
    assert np.abs(got8 - want8).max() / np.abs(want8).max() <= INT8_BOUND

    predict = runtimes._load_semantic(SimpleNamespace(
        device="cpu", torch_semantic=None, semantic_ckpt=str(out / "semantic.pt"),
        semantic_scaler=str(out / "scaler.npz"), semantic_int8=False, hidden=HIDDEN))
    np.testing.assert_array_equal(predict(meta.reorder_by_gt(de[6], 6)), got)
    with pytest.raises(ValueError, match="hidden width"):
        inference_semantic.main([*common[:-4], "--hidden", "32", "--device", "cpu"])
    with pytest.raises(ValueError, match="orbax"):
        inference_semantic.main([*common[:2], "--ckpt", str(out), *common[4:]])


def test_inference_eeg2video_legacy_matches_jax(monkeypatch, world, tmp_path):
    """``--legacy`` on the tiny pipeline: DE_1per1s window means, a scaler
    fitted on blocks 0-5, the semantic MLP in the same run; the embeddings and
    the clips against the JAX script's on the same weights and noise. (JAX
    gathers the block's 200 window means with the 40 class indices, so 40
    embeddings come out; the port keeps that.)"""
    rng = np.random.default_rng(7)
    np.save(tmp_path / "de.npy", (2.0 * rng.standard_normal((7, 40, 5, 2, 62, 5)) + 0.5)
            .astype(np.float32))
    want = jinference.legacy_embeddings(str(tmp_path / "de.npy"), str(world.tmp / "sem_jax"),
                                        None, HIDDEN)
    got = inference_eeg2video.legacy_embeddings(str(tmp_path / "de.npy"),
                                                str(world.tmp / "sem.pt"), None, HIDDEN, "cpu")
    assert got.shape == want.shape == (40, 77 * 768)
    np.testing.assert_allclose(got, want, **MLP_TOL)

    noise = rand(np.random.default_rng(8), 2, 2, 4, 4, 4)
    common = ["--legacy", "--raw_features", str(tmp_path / "de.npy"), "--hidden", str(HIDDEN),
              "--woSeq2Seq", "--limit", "2", "--batch", "2", "--dtype", "float32", *SIZE]
    jseen = _record_writes(monkeypatch, jvideo)
    monkeypatch.setattr(jinference, "load_pipeline",
                        lambda *a, **k: _SharedNoise(world.jpipe, jnp.asarray(noise)))
    jinference.main([*common, "--semantic_ckpt", str(world.tmp / "sem_jax"),
                     "--out_dir", str(tmp_path / "jax")])
    seen = _record_writes(monkeypatch, video)
    monkeypatch.setattr(inference_eeg2video, "load_pipeline",
                        lambda *a, **k: _SharedNoise(world.pipe, torch.from_numpy(noise)))
    inference_eeg2video.main([*common, "--semantic_ckpt", str(world.tmp / "sem.pt"),
                              "--out_dir", str(tmp_path / "port"), "--device", "cpu"])
    monkeypatch.undo()
    assert sorted(seen) == ["port/0.gif", "port/1.gif"]
    for i in range(2):
        np.testing.assert_allclose(seen[f"port/{i}.gif"], jseen[f"jax/{i}.gif"], rtol=0,
                                   atol=2e-3, err_msg=str(i))


def test_new_entry_points_default_to_the_card_and_raise_without_one(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    from eeg2video_tpu_torch.cli import generate_video_latents, train_seq2seq_v2
    from eeg2video_tpu_torch.train import seq2seq as tseq2seq

    match = "torch.cuda.is_available"
    x, y = np.zeros((4, 310), np.float32), np.zeros((4, 8), np.float32)
    sd = SemanticPredictor(hidden=8, out_dim=8).state_dict()
    for call in (lambda: tsem.train_semantic(x, y),
                 lambda: tsem.predict_semantic(sd, x),
                 lambda: tsem.predict_semantic_int8(sd, x),
                 lambda: tseq2seq.train_seq2seq(np.zeros((2, 7, 62, 100), np.float32),
                                                np.zeros((2, 6, 4, 36, 64), np.float32)),
                 lambda: inference_eeg2video.legacy_embeddings(str(tmp_path / "none.npy"))):
        with pytest.raises(RuntimeError, match=match):
            call()
    for main in (train_cli.main, inference_semantic.main, train_seq2seq_v2.main,
                 generate_video_latents.main):
        with pytest.raises(RuntimeError, match=match):
            main([])
    for parser in (train_cli.build_parser(), inference_semantic.build_parser(),
                   train_seq2seq_v2.build_parser(), generate_video_latents.build_parser()):
        assert parser.parse_args([]).device == "cuda"
