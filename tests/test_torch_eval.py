"""The port's evaluation (eval/metrics.py, data/optical_flow.py and the
compute_optical_flow / run_metrics CLIs) against the JAX package on the CPU,
on seeded numpy inputs.

Tolerances:
- SSIM within 5e-5 of JAX's per frame. The port sums its windows in
  float64, JAX in float32; JAX's own value is within 9e-6 of a float64
  oracle on smooth 288x512 frames, so the gap is JAX's rounding;
- MSE, PSNR and hue (mean and std over frames) within 1e-5 relative: the
  per-pixel math is float32 on both sides, the frame means differ in
  summation only;
- ``n_way_top_k_acc`` and the classifier accuracies equal for the same
  ``rng``; CLIP cosines within 1e-5;
- Horn-Schunck flow within 1e-5 of JAX's (absolute, pixels) and the motion
  scores within 1e-5 relative: JAX's float32 flow is 1.4e-7 from the same
  computation in float64, so a gap near 1e-5 would be a bug, not rounding;
- the CLIs: the flow table within 1e-5 relative, the metrics JSON within
  the bounds above.
"""

import json

import numpy as np
import pytest
import torch

from eeg2video_tpu.cli import compute_optical_flow as jflow_cli
from eeg2video_tpu.cli import run_metrics as jmetrics_cli
from eeg2video_tpu.data import meta as jmeta
from eeg2video_tpu.data import optical_flow as jflow
from eeg2video_tpu.eval import metrics as jm
from eeg2video_tpu_torch.cli import compute_optical_flow as tflow_cli
from eeg2video_tpu_torch.cli import run_metrics as tmetrics_cli
from eeg2video_tpu_torch.data import meta as tmeta
from eeg2video_tpu_torch.data import optical_flow as tflow
from eeg2video_tpu_torch.data.native import write_gif_native
from eeg2video_tpu_torch.eval import metrics as tm

from test_torch_models import capped_threads

_threads = capped_threads()

SSIM_ATOL = 5e-5
RTOL = 1e-5
FLOW_ATOL = 1e-5


def _smooth(rng, h, w, blur=6):
    """Low-pass random image in [0, 1] (tests/test_optical_flow.py's pattern)."""
    x = rng.standard_normal((h + 4 * blur, w + 4 * blur))
    k = np.ones(blur) / blur
    for axis in (0, 1):
        x = np.apply_along_axis(np.convolve, axis, x, k, mode="same")
    x = x[2 * blur: 2 * blur + h, 2 * blur: 2 * blur + w]
    return ((x - x.min()) / (np.ptp(x) + 1e-9)).astype(np.float32)


def _frames(rng, n, h, w):
    """n smooth RGB uint8 frames and a perturbed copy of each."""
    gt = np.stack([np.stack([_smooth(rng, h, w) for _ in range(3)], -1) for _ in range(n)])
    gt = (gt * 255).astype(np.uint8)
    noise = rng.normal(0, 12, gt.shape) + 30 * (_smooth(rng, h, w)[None, ..., None] - 0.5)
    pred = np.clip(gt + noise, 0, 255).astype(np.uint8)
    return pred, gt


def _shift(img, dx, dy):
    h, w = img.shape
    o = max(abs(dx), abs(dy), 1)
    pad = np.pad(img, o, mode="edge")
    return pad[o - dy: o - dy + h, o - dx: o - dx + w]


# --- pixel metrics ---------------------------------------------------------------

@pytest.mark.parametrize("n,h,w", [(4, 64, 96), (1, 288, 512)])
def test_ssim_per_frame_matches_jax(n, h, w):
    pred, gt = _frames(np.random.default_rng(h), n, h, w)
    got = tm.ssim_frames(torch.as_tensor(pred), torch.as_tensor(gt)).numpy()
    want = np.array([float(jm.ssim(p, g)) for p, g in zip(pred, gt)])
    assert 0.05 < want.min() and want.max() < 0.99  # neither trivial nor identical
    np.testing.assert_allclose(got, want, rtol=0, atol=SSIM_ATOL)
    assert tm.ssim(pred[0], gt[0]) == pytest.approx(want[0], abs=SSIM_ATOL)
    assert tm.ssim(gt[0], gt[0]) == pytest.approx(1.0, abs=1e-12)


def test_score_helpers_match_jax():
    pred, gt = _frames(np.random.default_rng(3), 6, 48, 80)
    pred[1] = gt[1]  # one identical pair: MSE 0, PSNR at its 1e-10 floor
    pf, gf = pred.astype(np.float32), gt.astype(np.float32)
    for port, jax_fn, tol in ((tm.ssim_score_only, jm.ssim_score_only, dict(atol=SSIM_ATOL)),
                              (tm.mse_score_only, jm.mse_score_only, dict(rtol=RTOL)),
                              (tm.psnr_score_only, jm.psnr_score_only, dict(rtol=RTOL)),
                              (tm.hue_score_only, jm.hue_score_only, dict(rtol=RTOL))):
        got, want = port(pf, gf, device="cpu"), jax_fn(pf, gf)
        np.testing.assert_allclose(got, want, **tol)


def test_hue_takes_the_floored_modulo():
    """Pixels whose red is the largest and whose green is below blue give a
    negative (g - b) / d: JAX's floored ``%`` maps it into [0, 6), a
    truncated one would not."""
    rng = np.random.default_rng(5)
    p = rng.uniform(0, 255, (3, 8, 8, 3)).astype(np.float32)
    p[..., 0] = 250.0
    p[..., 1] = rng.uniform(0, 100, (3, 8, 8))
    p[..., 2] = 120.0
    g = rng.uniform(0, 255, p.shape).astype(np.float32)
    hue = tm._rgb_to_hue(torch.as_tensor(p)).numpy()
    assert (hue >= 0).all()
    np.testing.assert_allclose(hue, np.asarray(jm._rgb_to_hue(p)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tm.hue_score_only(p, g, device="cpu"), jm.hue_score_only(p, g),
                               rtol=RTOL)


def test_n_way_top_k_acc_is_jax_for_the_same_rng():
    rng = np.random.default_rng(9)
    probs = rng.dirichlet(np.ones(40))
    for ids, n_way, k in ((7, 2, 1), ([3, 11, 20], 30, 5), (np.array([1, 2]), 10, 3)):
        assert (tm.n_way_top_k_acc(probs, ids, n_way, 50, k, rng=np.random.default_rng(4))
                == jm.n_way_top_k_acc(probs, ids, n_way, 50, k, rng=np.random.default_rng(4)))


# --- classifier metrics and CLIP score -----------------------------------------------

def _vit(tmp_path):
    from transformers import ViTConfig, ViTForImageClassification, ViTImageProcessor

    d = tmp_path / "vit"
    torch.manual_seed(0)
    ViTForImageClassification(ViTConfig(hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
                                         intermediate_size=64, image_size=32, patch_size=16,
                                         num_labels=50)).save_pretrained(d)
    ViTImageProcessor(size={"height": 32, "width": 32}).save_pretrained(d)
    return d


def _videomae(tmp_path):
    from transformers import (VideoMAEConfig, VideoMAEForVideoClassification,
                              VideoMAEImageProcessor)

    d = tmp_path / "videomae"
    torch.manual_seed(1)
    VideoMAEForVideoClassification(VideoMAEConfig(
        hidden_size=32, num_hidden_layers=1, num_attention_heads=2, intermediate_size=64,
        image_size=32, patch_size=16, num_frames=2, tubelet_size=2,
        num_labels=50)).save_pretrained(d)
    VideoMAEImageProcessor(size={"shortest_edge": 32},
                           crop_size={"height": 32, "width": 32}).save_pretrained(d)
    return d


@pytest.mark.parametrize("kind", ["image", "video"])
def test_classifier_metrics_match_jax(tmp_path, kind):
    rng = np.random.default_rng(6)
    if kind == "image":
        d, shape = _vit(tmp_path), (4, 32, 32, 3)
    else:
        d, shape = _videomae(tmp_path), (4, 2, 32, 32, 3)
    pred = rng.uniform(0, 255, shape).astype(np.uint8)
    gt = rng.uniform(0, 255, shape).astype(np.uint8)
    kw = dict(kind=kind, n_way=5, num_trials=20, model_path=str(d))
    want = jm.classifier_metrics(pred, gt, rng=np.random.default_rng(0), **kw)
    got = tm.classifier_metrics(pred, gt, rng=np.random.default_rng(0), device="cpu", **kw)
    assert got == want and len(got[0]) == 4
    assert len(set(want[0])) > 1  # the accuracies vary: the comparison is not of constants


def test_classifier_metrics_with_a_given_model_match_jax():
    from transformers import ViTConfig, ViTForImageClassification, ViTImageProcessor

    torch.manual_seed(2)
    model = ViTForImageClassification(ViTConfig(hidden_size=32, num_hidden_layers=1,
                                                num_attention_heads=2, intermediate_size=64,
                                                image_size=32, patch_size=16, num_labels=20))
    proc = ViTImageProcessor(size={"height": 32, "width": 32})
    rng = np.random.default_rng(8)
    pred, gt = (rng.uniform(0, 255, (3, 32, 32, 3)).astype(np.float32) for _ in range(2))
    kw = dict(kind="image", n_way=4, num_trials=15, model=model, processor=proc)
    assert (tm.classifier_metrics(pred, gt, rng=np.random.default_rng(1), device="cpu", **kw)
            == jm.classifier_metrics(pred, gt, rng=np.random.default_rng(1), **kw))


def test_clip_score_matches_jax(tmp_path):
    from transformers import (CLIPConfig, CLIPImageProcessor, CLIPModel, CLIPProcessor,
                              CLIPTextConfig, CLIPTokenizer, CLIPVisionConfig)

    d = tmp_path / "clip"
    d.mkdir()
    (d / "vocab.json").write_text(json.dumps({"<|startoftext|>": 0, "<|endoftext|>": 1}))
    (d / "merges.txt").write_text("#version: 0.2\n")
    CLIPProcessor(image_processor=CLIPImageProcessor(size={"shortest_edge": 32},
                                                     crop_size={"height": 32, "width": 32}),
                  tokenizer=CLIPTokenizer(str(d / "vocab.json"), str(d / "merges.txt"))
                  ).save_pretrained(d)
    torch.manual_seed(3)
    CLIPModel(CLIPConfig(
        text_config=CLIPTextConfig(vocab_size=4, hidden_size=32, num_hidden_layers=1,
                                   num_attention_heads=2, intermediate_size=64).to_dict(),
        vision_config=CLIPVisionConfig(hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
                                       intermediate_size=64, image_size=32,
                                       patch_size=16).to_dict(),
        projection_dim=16)).save_pretrained(d)
    rng = np.random.default_rng(7)
    a, b = (rng.uniform(0, 255, (3, 32, 32, 3)).astype(np.uint8) for _ in range(2))
    want = jm.clip_score(a, b, model_path=str(d))
    got = tm.clip_score(a, b, model_path=str(d), device="cpu")
    assert got.shape == (3,) and np.abs(want).max() < 0.999
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# --- Horn-Schunck -------------------------------------------------------------------

@pytest.fixture(scope="module")
def shifted_pairs():
    rng = np.random.default_rng(11)
    img = _smooth(rng, 72, 128)
    moves = [(2, 1), (-3, 2), (0, 0), (1, -1)]
    i1 = np.stack([img] * len(moves))
    i2 = np.stack([_shift(img, dx, dy) for dx, dy in moves])
    return img, i1, i2


def test_horn_schunck_matches_jax(shifted_pairs):
    _, i1, i2 = shifted_pairs
    ju, jv = (np.asarray(a) for a in jflow.horn_schunck(i1, i2, n_iter=100, levels=3))
    tu, tv = tflow.horn_schunck(torch.as_tensor(i1), torch.as_tensor(i2), n_iter=100, levels=3)
    assert np.abs(ju).max() > 1.0  # real motion was solved for
    np.testing.assert_allclose(tu.numpy(), ju, rtol=0, atol=FLOW_ATOL)
    np.testing.assert_allclose(tv.numpy(), jv, rtol=0, atol=FLOW_ATOL)


def _clips(img, speeds, frames=4):
    """(len(speeds), frames, H, W, 3) uint8 clips translating ``img``."""
    out = [np.stack([np.repeat(_shift(img, k * s, (k * s) // 2)[..., None] * 255, 3, axis=-1)
                     for k in range(frames)]) for s in speeds]
    return np.stack(out).astype(np.uint8)


def test_clip_motion_scores_match_jax(shifted_pairs):
    clips = _clips(shifted_pairs[0], (0, 1, 2, 3))
    want = np.asarray(jflow.clip_motion_scores(clips))
    got = tflow.clip_motion_scores(clips, device="cpu").numpy()
    assert want[0] < 1e-3 < want[1] < want[2] < want[3]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7)


def test_score_clips_in_chunks_with_a_padded_tail_equals_one_batch(shifted_pairs):
    clips = _clips(shifted_pairs[0], (0, 1, 2, 3, 2), frames=3)
    whole = tflow.clip_motion_scores(clips, n_iter=30, device="cpu").numpy()
    chunked = tflow.score_clips(clips, n_iter=30, chunk=2, device="cpu")  # 2 + 2 + (1 + 1 pad)
    assert chunked.shape == (5,) and chunked.dtype == np.float32
    np.testing.assert_array_equal(chunked, whole)
    np.testing.assert_allclose(chunked, jflow.score_clips(clips, n_iter=30, chunk=2),
                               rtol=RTOL, atol=1e-7)


def test_stencils_pad_as_xla_same():
    """The 2x2 stencils pad 0 before and 1 after (XLA "SAME"); the 3x3 one 1
    on each side: held to lax.conv_general_dilated on a ramp."""
    x = np.arange(30, dtype=np.float32).reshape(1, 5, 6) ** 1.5
    for k in ("_KX", "_KY", "_KT", "_AVG"):
        want = np.asarray(jflow._conv(x, getattr(jflow, k)))
        got = tflow._conv(torch.as_tensor(x), getattr(tflow, k)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


# --- the two CLIs --------------------------------------------------------------------

@pytest.fixture
def two_concepts(monkeypatch):
    for m in (jmeta, tmeta):
        monkeypatch.setattr(m, "N_CONCEPTS", 2)
        monkeypatch.setattr(m, "N_REPS", 2)


def test_compute_optical_flow_cli_matches_jax(tmp_path, two_concepts):
    """Two blocks of 4 GIFs written by the port: block 0 with a moving clip,
    a clip whose duplicate last frame collapsed (2 of 3 frames) and an
    all-static one (1 frame); block 1 all static (the CLI's zero branch)."""
    img = (_smooth(np.random.default_rng(12), 48, 64) * 255).astype(np.uint8)
    rgb = lambda a: np.repeat(a[..., None], 3, axis=-1)  # noqa: E731
    clips = {0: [[rgb(_shift(img, 2 * k, 0)) for k in range(3)],
                 [rgb(_shift(img, k, 1)) for k in range(2)],
                 [rgb(img)],
                 [rgb(_shift(img, 0, k)) for k in range(3)]],
             1: [[rgb(img)]] * 4}
    for b, cs in clips.items():
        d = tmp_path / f"Block{b}"
        d.mkdir()
        for i, frames in enumerate(cs):
            write_gif_native(str(d / f"{i}.gif"), np.stack(frames), 333)
    args = ["--gif_dir", str(tmp_path), "--blocks", "2", "--chunk", "3", "--iters", "40"]
    jflow_cli.main(args + ["--out", str(tmp_path / "jax.npy")])
    got = tflow_cli.main(args + ["--out", str(tmp_path / "port.npy"), "--device", "cpu"])
    want = np.load(tmp_path / "jax.npy")
    assert got.shape == want.shape == (2, 4) and got.dtype == np.float32
    np.testing.assert_array_equal(np.load(tmp_path / "port.npy"), got)
    assert want[0, 0] > want[0, 3] > 0 and (want[0, 2] == 0) and (want[1] == 0).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7)


def test_run_metrics_cli_matches_jax(tmp_path):
    rng = np.random.default_rng(13)
    order = tmetrics_cli.gt_order()
    idx = jmeta.block_reorder_indices(6)
    assert np.array_equal(order, (idx[:, None] * jmeta.N_REPS + np.arange(jmeta.N_REPS)).ravel())
    pred_dir, gt_dir = tmp_path / "pred", tmp_path / "gt"
    pred_dir.mkdir()
    gt_dir.mkdir()
    for i in range(3):
        p, g = _frames(rng, 3, 32, 48)
        write_gif_native(str(pred_dir / f"{i}.gif"), p, 333)
        write_gif_native(str(gt_dir / f"{int(order[i])}.gif"), g, 333)
    args = ["--pred_dir", str(pred_dir), "--gt_dir", str(gt_dir), "--n_clips", "3"]
    jmetrics_cli.main(args + ["--out", str(tmp_path / "jax.json")])
    got = tmetrics_cli.main(args + ["--out", str(tmp_path / "port.json"), "--device", "cpu"])
    want = json.loads((tmp_path / "jax.json").read_text())
    assert json.loads((tmp_path / "port.json").read_text()) == got
    assert got.keys() == want.keys() == {"ssim", "ssim_std", "mse", "mse_std", "psnr",
                                         "psnr_std", "hue", "hue_std"}
    for k, v in want.items():
        tol = dict(atol=SSIM_ATOL) if k.startswith("ssim") else dict(rtol=RTOL)
        np.testing.assert_allclose(got[k], v, **tol, err_msg=k)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    for cli in (tflow_cli, tmetrics_cli):
        args = cli.build_parser().parse_args(
            ["--pred_dir", "p", "--gt_dir", "g"] if cli is tmetrics_cli else [])
        assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tm.ssim_score_only(np.zeros((1, 8, 8, 3)), np.zeros((1, 8, 8, 3)))
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tflow.score_clips(np.zeros((1, 2, 8, 8, 3), np.uint8))
