"""Raw-EEG requests of the port's server and the one-shot generation script
against the JAX package, on the CPU.

Both servers get the same tiny pipeline, the same small semantic MLP, the same
tiny Seq2Seq transformer (weights and BatchNorm statistics carried across by
convert.from_jax) and the same request lines. Replies must be equal (ids, clip
counts, GIF names, error texts). With DANA off the arrays handed to the GIF
writer must agree within 2e-3 (float32 summation order through DE features,
the semantic MLP, the rollout, the tiny UNet and the VAE). With DANA on the two
packages draw different noise from the same seed by construction, so shapes,
finiteness and the replies are compared. ``inference_eeg2video.main`` is held
to the JAX ``main`` for its three latent sources; fresh noise is replaced by
one shared array in both, for the same reason.
"""

import dataclasses
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eeg2video_tpu.cli import inference_eeg2video as jinference
from eeg2video_tpu.cli import serve as jserve
from eeg2video_tpu.data import video as jvideo
from eeg2video_tpu.diffusion.pipeline import EEG2VideoPipeline as JPipeline
from eeg2video_tpu.models import seq2seq as jseq
from eeg2video_tpu.models.semantic import SemanticPredictor as JSemantic
from eeg2video_tpu.models.unet3d import (UNet3DConditionModel as JUNet,
                                         UNet3DConfig as JUNetConfig)
from eeg2video_tpu.models.vae import AutoencoderKL as JVAE, VAEConfig as JVAEConfig
from eeg2video_tpu.train import checkpoint as jckpt
from eeg2video_tpu.train.seq2seq import windows_from_segments as jwindows
from eeg2video_tpu.utils import StandardScaler as JScaler
from eeg2video_tpu_torch.cli import inference_eeg2video, serve
from eeg2video_tpu_torch.convert.from_jax import (semantic_state_dict_from_jax,
                                                  seq2seq_state_dict_from_jax,
                                                  unet_state_dict_from_jax,
                                                  vae_state_dict_from_jax)
from eeg2video_tpu_torch.data import meta, video
from eeg2video_tpu_torch.diffusion.pipeline import EEG2VideoPipeline
from eeg2video_tpu_torch.models.unet3d import UNet3DConfig
from eeg2video_tpu_torch.models.vae import VAEConfig
from eeg2video_tpu_torch.serving import runtimes

from test_torch_models import capped_threads, rand, random_params
from test_torch_seq2seq import _variables
from test_torch_serving import (ARRAY_TOL, HIDDEN, SIZE, _comparable, _record_writes,
                                _run_listen, _run_stdin)

_threads = capped_threads()

S2S = ("--seq2seq_frames", "2", "--seq2seq_latent", "4,4,4")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Both pipelines, the semantic and Seq2Seq checkpoints of both packages,
    and the request files."""
    tmp = tmp_path_factory.mktemp("raw")
    rng = np.random.default_rng(51)
    jcfg = dataclasses.replace(JUNetConfig.tiny(), cross_attention_dim=768)
    cfg = dataclasses.replace(UNet3DConfig.tiny(), cross_attention_dim=768)
    uparams = random_params(JUNet(jcfg), 52, np.zeros((1, 2, 4, 4, 4), np.float32),
                            jnp.asarray([3]), np.zeros((1, 7, 768), np.float32))
    vparams = random_params(JVAE(JVAEConfig.tiny()), 53, np.zeros((1, 16, 16, 3), np.float32))
    jpipe = JPipeline.create(uparams, vparams, jcfg, JVAEConfig.tiny(), dtype=jnp.float32)
    pipe = EEG2VideoPipeline.create(
        unet_state_dict_from_jax(uparams, cfg),
        vae_state_dict_from_jax(vparams, VAEConfig.tiny()), cfg, VAEConfig.tiny(),
        dtype=torch.float32, device="cpu")

    sem = random_params(JSemantic(hidden=HIDDEN), 54, np.zeros((1, 310), np.float32))
    jckpt.save_checkpoint(str(tmp / "sem_jax"), 0, {"params": sem})
    torch.save(semantic_state_dict_from_jax(sem), tmp / "sem.pt")

    s2s = _variables(jseq.Seq2SeqTransformer(n_frames=2, latent_shape=(4, 4, 4)), 55,
                     np.zeros((1, 7, 62, 100), np.float32))
    jckpt.save_checkpoint(str(tmp / "s2s_jax"), 0, s2s)
    torch.save(seq2seq_state_dict_from_jax(s2s), tmp / "s2s.pt")

    seg = rand(rng, 3, 62, 400)
    np.save(tmp / "seg.npy", seg)
    win = np.asarray(jwindows(seg))
    np.save(tmp / "win.npy", win)
    JScaler().fit(win.reshape(len(win), -1)).save(str(tmp / "eeg_scaler.npz"))
    np.savez(tmp / "stats.npz", mean_z=np.float32(0.1), std_z=np.float32(1.7))
    np.save(tmp / "subject.npy", rand(rng, 7, 40, 5, 62, 400))
    np.save(tmp / "emb.npy", rand(rng, 3, 77 * 768))
    np.save(tmp / "lat.npy", rand(rng, 3, 2, 4, 4, 4))  # (B, F, C, H, W)
    np.save(tmp / "flow.npy", np.asarray([0.5, 2.5, 3.0], np.float32))
    np.save(tmp / "flow_short.npy", np.asarray([0.5, 2.5], np.float32))
    np.save(tmp / "flow_table.npy", (4.0 * rng.random((7, 200))).astype(np.float32))
    return SimpleNamespace(tmp=tmp, jpipe=jpipe, pipe=pipe)


def _server_args(w, jax_side):
    sem, s2s = ("sem_jax", "s2s_jax") if jax_side else ("sem.pt", "s2s.pt")
    return [*SIZE, *S2S, "--semantic_ckpt", str(w.tmp / sem), "--hidden", str(HIDDEN),
            "--seq2seq_ckpt", str(w.tmp / s2s),
            "--seq2seq_scaler", str(w.tmp / "eeg_scaler.npz"),
            "--seq2seq_stats", str(w.tmp / "stats.npz")]


def _serve_both(monkeypatch, w, run, lines, extra=()):
    jseen = _record_writes(monkeypatch, jvideo)
    monkeypatch.setattr(jserve, "load_pipeline", lambda *a, **k: w.jpipe)
    want = run(monkeypatch, jserve.main, [*_server_args(w, True), *extra], lines)
    seen = _record_writes(monkeypatch, video)
    monkeypatch.setattr(serve, "load_pipeline", lambda *a, **k: w.pipe)
    got = run(monkeypatch, serve.main, [*_server_args(w, False), "--device", "cpu", *extra],
              lines)
    assert [_comparable(r) for r in got] == [_comparable(r) for r in want]
    return {r["id"]: r for r in got if "id" in r}, seen, jseen


def _req(w, out, rid, **kw):
    for k in ("raw", "embeddings", "latents", "flow_scores"):
        if k in kw:
            kw[k] = str(w.tmp / kw[k])
    return json.dumps({"id": rid, "out_dir": str(w.tmp / out / rid), **kw})


@pytest.mark.parametrize("mode", ["stdin", "listen"])
def test_raw_requests_match_jax_server(monkeypatch, world, mode):
    """The three raw shapes, the two ablations and the refused combinations, with no
    flow scores configured (DANA off unless asked for)."""
    w, out = world, f"serve_{mode}"
    extra = () if mode == "stdin" else ("--coalesce", "--max_batch", "2")
    lines = [
        _req(w, out, "seg", raw="seg.npy", indices=[0, 2]),          # raw only, (N, 62, 400)
        _req(w, out, "win", raw="win.npy", embeddings="emb.npy", indices=[1]),  # pre-windowed
        _req(w, out, "woseq", raw="seg.npy", seq2seq=False, latents="lat.npy", indices=[0]),
        _req(w, out, "ambig", raw="seg.npy", latents="lat.npy"),
        _req(w, out, "noflow", raw="seg.npy", dana=True),
        _req(w, out, "short", raw="seg.npy", flow_scores="flow_short.npy"),
        _req(w, out, "winonly", raw="win.npy"),
        _req(w, out, "shape", raw="emb.npy", embeddings="emb.npy"),
        json.dumps({"cmd": "shutdown"}),
    ]
    run = _run_listen if mode == "listen" else _run_stdin
    by_id, seen, jseen = _serve_both(monkeypatch, w, run, lines, extra)
    assert by_id["seg"]["ok"] and by_id["seg"]["clips"] == 2
    assert by_id["win"]["ok"] and by_id["woseq"]["ok"]
    assert "ambiguous latent source" in by_id["ambig"]["error"]
    assert "no flow scores are configured" in by_id["noflow"]["error"]
    assert "2 flow scores for 3 clips" in by_id["short"]["error"]
    assert "deriving DE features needs 2 s raw segments" in by_id["winonly"]["error"]
    assert "unrecognized raw EEG shape" in by_id["shape"]["error"]
    assert seen.keys() == jseen.keys() and len(seen) == 4
    for name in seen:
        assert seen[name].shape == (1, 2, 32, 32, 3)
        np.testing.assert_allclose(seen[name], jseen[name], err_msg=name, **ARRAY_TOL)
    # the three latent sources of one segment are three different clips
    assert np.abs(seen["seg/0.gif"] - seen["woseq/0.gif"]).max() > 1e-2


def test_whole_subject_and_dana_requests_match_jax_server(monkeypatch, world):
    """A server with the (7, 200) flow table: the whole-subject file with DANA off
    (GT reorder, 200-clip rollout in four chunks, 200-row DE and semantic pass) equals
    the JAX server's; with DANA on (the default now) the replies are equal and the
    clips are finite, differ from the un-noised ones and depend on ``dana_seed``."""
    w, out = world, "serve_subject"
    lines = [
        _req(w, out, "subj", raw="subject.npy", block=4, indices=[3], dana=False),
        _req(w, out, "dana", raw="subject.npy", block=4, indices=[3]),
        _req(w, out, "seed", raw="subject.npy", block=4, indices=[3], dana_seed=7),
        _req(w, out, "segdana", raw="seg.npy", flow_scores="flow.npy", indices=[1]),
        _req(w, out, "count", raw="seg.npy"),  # the table has 1400 scores, not 3
        _req(w, out, "table", raw="subject.npy", flow_scores="flow.npy"),
        json.dumps({"cmd": "shutdown"}),
    ]
    by_id, seen, jseen = _serve_both(
        monkeypatch, w, _run_stdin, lines, ("--flow_scores", str(w.tmp / "flow_table.npy")))
    assert all(by_id[k]["ok"] and by_id[k]["clips"] == 1 for k in ("subj", "dana", "seed",
                                                                    "segdana"))
    assert "1400 flow scores for 3 clips" in by_id["count"]["error"]
    assert "3 flow scores, expected 200 for a whole-subject request" in by_id["table"]["error"]
    assert seen.keys() == jseen.keys() and len(seen) == 4
    np.testing.assert_allclose(seen["subj/3.gif"], jseen["subj/3.gif"], **ARRAY_TOL)
    for name in ("dana/3.gif", "seed/3.gif", "segdana/1.gif"):
        assert seen[name].shape == jseen[name].shape and np.isfinite(seen[name]).all()
    assert np.abs(seen["dana/3.gif"] - seen["subj/3.gif"]).max() > 1e-2
    assert np.abs(seen["dana/3.gif"] - seen["seed/3.gif"]).max() > 1e-3


def test_latents_from_raw_orders_the_subject_and_its_flow_labels(world):
    """The whole-subject form: segments and flow labels both go to class order for the
    requested block, DANA noises the whole decoded set before any selection, and the
    result is channels-last."""
    w = world
    raw = np.load(w.tmp / "subject.npy")
    flow = np.load(w.tmp / "flow_table.npy")
    lat = rand(np.random.default_rng(56), 200, 2, 1, 2, 2)
    seen = {}

    def fake_predict(windows):
        seen["windows"] = np.asarray(windows)
        return lat

    args = SimpleNamespace(seq2seq_predict=fake_predict, flow_scores=str(w.tmp / "flow_table.npy"),
                           dana_threshold=1.799, dana_seed=3407, dana_time_steps=500,
                           device="cpu")
    got = runtimes._latents_from_raw(args, {"raw": str(w.tmp / "subject.npy"), "block": 4})
    seg = meta.reorder_by_gt(raw[4], 4).reshape(-1, 62, 400)
    np.testing.assert_array_equal(seen["windows"], np.asarray(jwindows(seg)))
    labels = (flow[4] >= 1.799).reshape(40, 5)[meta.block_reorder_indices(4)].reshape(-1)
    betas = np.where(labels, 0.3, 0.2).astype(np.float32)
    want = runtimes.dana_mod.dana_add_noise(torch.Generator().manual_seed(3407),
                                            torch.from_numpy(lat), betas)
    np.testing.assert_array_equal(got, want.permute(0, 1, 3, 4, 2).numpy())
    assert got.shape == (200, 2, 2, 2, 1)
    again = runtimes._latents_from_raw(args, {"raw": str(w.tmp / "subject.npy"), "block": 4})
    np.testing.assert_array_equal(again, got)  # same seed, same bits


def test_load_seq2seq_reads_torch_files_only_and_defaults_to_the_card(world):
    w = world
    base = dict(seq2seq_frames=2, seq2seq_latent="4,4,4", seq2seq_scaler=None,
                seq2seq_stats=None)
    win = np.load(w.tmp / "win.npy")
    a = runtimes._load_seq2seq(SimpleNamespace(
        device="cpu", torch_seq2seq=None, seq2seq_ckpt=str(w.tmp / "s2s.pt"), **base))
    b = runtimes._load_seq2seq(SimpleNamespace(
        device="cpu", torch_seq2seq=str(w.tmp / "s2s.pt"), seq2seq_ckpt=None, **base))
    assert a(win).shape == (3, 2, 4, 4, 4)
    np.testing.assert_array_equal(a(win), b(win))
    with pytest.raises(ValueError, match="convert/from_jax.py"):
        runtimes._load_seq2seq(SimpleNamespace(
            device="cpu", torch_seq2seq=None, seq2seq_ckpt=str(w.tmp / "s2s_jax"), **base))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            runtimes._load_seq2seq(SimpleNamespace(
                device="cuda", torch_seq2seq=None, seq2seq_ckpt=str(w.tmp / "s2s.pt"), **base))
    jax_defaults = dict(seq2seq_ckpt=None, torch_seq2seq=None, seq2seq_scaler=None,
                        seq2seq_stats=None, seq2seq_frames=6, seq2seq_latent="4,36,64",
                        flow_scores=None, dana_threshold=1.799, dana_seed=3407,
                        dana_time_steps=500)
    ours = vars(serve.build_parser().parse_args([]))  # the JAX CLI's defaults
    assert {k: ours[k] for k in jax_defaults} == jax_defaults


# --- the one-shot script ----------------------------------------------------------

class _SharedNoise:
    """A pipeline whose fresh-noise calls (``latents`` None) get rows of one shared
    array instead: jax.random and a torch generator draw different noise."""

    def __init__(self, pipe, noise):
        self.pipe, self.noise, self.calls = pipe, noise, 0
        self.device = getattr(pipe, "device", None)
        self.mesh = None

    def __call__(self, emb, negative, *, latents=None, **kw):
        self.calls += 1
        for k in ("key", "generator"):
            kw.pop(k, None)
        if latents is None:
            latents = self.noise[:len(emb)]
        return self.pipe(emb, negative, latents=latents, **kw)


@pytest.mark.parametrize("source", ["woSeq2Seq", "woDANA", "Fullmodel"])
def test_inference_main_matches_jax_main(monkeypatch, world, tmp_path, source):
    """``--limit 2`` of 3 clips at ``--batch 1``: the negative is the mean over all
    three, the latent file is read in the reference layout, one GIF per clip."""
    w = world
    noise = rand(np.random.default_rng(57), 1, 2, 4, 4, 4)  # channels-last (B, F, H, W, C)
    torch.save(torch.from_numpy(np.load(w.tmp / "lat.npy")), tmp_path / "dana.pt")
    flags = {"woSeq2Seq": ["--woSeq2Seq"],
             "woDANA": ["--woDANA", "--seq2seq_latents", str(w.tmp / "lat.npy")],
             "Fullmodel": ["--dana_latents", str(tmp_path / "dana.pt")]}[source]
    common = ["--embeddings", str(w.tmp / "emb.npy"), "--limit", "2", "--batch", "1",
              "--num_inference_steps", "2", "--height", "32", "--width", "32",
              "--video_length", "2", "--gif_encoder", "fast", "--dtype", "float32", *flags]

    jseen = _record_writes(monkeypatch, jvideo)
    jpipe = _SharedNoise(w.jpipe, jnp.asarray(noise))
    monkeypatch.setattr(jinference, "load_pipeline", lambda *a, **k: jpipe)
    jinference.main([*common, "--out_dir", str(tmp_path / "jax")])

    seen = _record_writes(monkeypatch, video)
    pipe = _SharedNoise(w.pipe, torch.from_numpy(noise))
    monkeypatch.setattr(inference_eeg2video, "load_pipeline", lambda *a, **k: pipe)
    monkeypatch.chdir(tmp_path)
    inference_eeg2video.main([*common, "--device", "cpu"])  # out_dir from the source's tag
    monkeypatch.undo()

    assert pipe.calls == jpipe.calls == 2
    assert sorted(seen) == [f"40_Classes_{source}/{i}.gif" for i in range(2)]
    assert os.path.isdir(tmp_path / "outputs" / f"40_Classes_{source}")
    for i in range(2):
        got, want = seen[f"40_Classes_{source}/{i}.gif"], jseen[f"jax/{i}.gif"]
        assert got.shape == (1, 2, 32, 32, 3)
        np.testing.assert_allclose(got, want, err_msg=str(i), **ARRAY_TOL)


def test_inference_main_refuses_what_is_not_ported_and_defaults_to_the_card(world, tmp_path):
    base = ["--embeddings", str(world.tmp / "emb.npy"), "--woSeq2Seq",
            "--out_dir", str(tmp_path / "never")]
    for flags in (["--dp", "2"], ["--tp", "2"], ["--sp", "2"]):
        with pytest.raises(SystemExit):
            inference_eeg2video.main([*base, "--device", "cpu", *flags])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            inference_eeg2video.main(base)
    # the out_dir is made only after the pipeline has loaded
    with pytest.raises(FileNotFoundError):
        inference_eeg2video.main([*base, "--device", "cpu", "--unet", str(tmp_path / "nope"),
                                  "--vae", str(tmp_path / "nope")])
    assert not os.path.exists(tmp_path / "never")
    assert inference_eeg2video.build_parser().parse_args([]).device == "cuda"
