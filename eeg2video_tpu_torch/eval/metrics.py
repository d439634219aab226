"""Evaluation metrics of generated clips, on the card.

Counterpart of ``eeg2video_tpu/eval/metrics.py``:

- pixel metrics (SSIM, MSE, PSNR, hue) as batched tensor ops on ``device``:
  one call scores many frames, each frame's value as JAX's per-frame call
  gives it, and ``*_score_only`` return the (mean, std) over frames that
  JAX's ``_per_clip`` returns. ``ssim`` has skimage's
  ``structural_similarity`` semantics (7-wide uniform window by
  cumulative-sum differences on reflect padding, K1 0.01, K2 0.03, sample
  covariance, the border cropped before the mean). SSIM runs wholly in
  float64, where JAX runs float32: a frame's value is then within JAX's own
  rounding of the exact one (on smooth 288x512 frames JAX's SSIM is 9e-6
  from a float64 oracle). MSE, PSNR and hue take their per-pixel terms in
  float32, as JAX does, and their means over a frame in float64;
- ``n_way_top_k_acc``, numpy with an explicit ``rng``, copied;
- ``classifier_metrics`` (ViT / VideoMAE n-way accuracy) and ``clip_score``,
  ``transformers`` models run on ``device``; they load Hugging Face
  checkpoints by name or path, or take ``model`` / ``processor``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.device import resolve_device

FRAME_BATCH = 50  # frames a pass of the pixel metrics keeps on the device


# --- SSIM (skimage structural_similarity semantics) ---------------------------

def _reflect(n, pad, device):
    """numpy 'reflect' padding indices (no edge repeat) of an axis of n."""
    i = torch.arange(-pad, n + pad, device=device).abs()
    return torch.where(i > n - 1, 2 * (n - 1) - i, i)


def _uniform_filter(x, size=7):
    """Separable ``size``-wide mean over the H and W axes of (..., H, W, C),
    reflect padding, by cumulative-sum differences (JAX ``_uniform_filter``,
    metrics.py:41-53)."""
    pad = size // 2
    for axis in (-3, -2):
        xp = x.index_select(axis, _reflect(x.shape[axis], pad, x.device))
        zero = torch.zeros_like(xp.narrow(axis, 0, 1))
        c = torch.cumsum(torch.cat([zero, xp], dim=axis), dim=axis)
        n = c.shape[axis]
        x = (c.narrow(axis, size, n - size) - c.narrow(axis, 0, n - size)) / size
    return x


def ssim_frames(img1, img2, data_range=255.0, win_size=7):
    """(N, H, W, C) frame pairs -> (N,) SSIM, channel-averaged; each value
    JAX ``ssim`` of that pair (metrics.py:56-83). Computed in float64."""
    x = torch.as_tensor(img1).double()
    y = torch.as_tensor(img2).double()
    k1, k2 = 0.01, 0.03
    c1, c2 = (k1 * data_range) ** 2, (k2 * data_range) ** 2
    np_ = win_size ** 2
    cov_norm = np_ / (np_ - 1)  # skimage's sample covariance
    ux, uy = _uniform_filter(x, win_size), _uniform_filter(y, win_size)
    uxx, uyy = _uniform_filter(x * x, win_size), _uniform_filter(y * y, win_size)
    uxy = _uniform_filter(x * y, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    a1, a2 = 2 * ux * uy + c1, 2 * vxy + c2
    b1, b2 = ux ** 2 + uy ** 2 + c1, vx + vy + c2
    s = (a1 * a2) / (b1 * b2)
    pad = (win_size - 1) // 2  # skimage crops the filter's radius before the mean
    return s[:, pad:-pad, pad:-pad].mean(dim=(1, 2, 3))


def ssim(img1, img2, data_range=255.0, win_size=7):
    """(H, W, C) single-image SSIM (JAX ``ssim``)."""
    return float(ssim_frames(torch.as_tensor(img1)[None], torch.as_tensor(img2)[None],
                             data_range, win_size)[0])


# --- per-frame metrics over many frames --------------------------------------

def _mse(p, g):
    return ((p / 255.0 - g / 255.0) ** 2).double().mean(dim=(1, 2, 3))


def _psnr(p, g):
    mse = ((p - g) ** 2).double().mean(dim=(1, 2, 3)).float()
    return 10.0 * torch.log10(255.0 ** 2 / torch.clamp(mse, min=1e-10))


def _rgb_to_hue(img):
    """(..., 3) 0-255 RGB -> hue angle in radians (JAX ``_rgb_to_hue``,
    metrics.py:113-121; its ``%`` is floored, so ``torch.remainder``)."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    d = torch.clamp(mx - mn, min=1e-6)
    h = torch.where(mx == r, torch.remainder((g - b) / d, 6.0),
                    torch.where(mx == g, (b - r) / d + 2.0, (r - g) / d + 4.0))
    return h * (np.pi / 3.0)


def _hue(p, g):
    return torch.cos(_rgb_to_hue(p) - _rgb_to_hue(g)).double().mean(dim=(1, 2))


def per_frame(fn, pred_videos, gt_videos, device="cuda"):
    """``fn`` over (N, H, W, C) frame pairs, FRAME_BATCH frames at a time on
    ``device`` as float32; (N,) float64 values on the host out."""
    device = resolve_device(device)
    pred, gt = np.asarray(pred_videos), np.asarray(gt_videos)
    if pred.shape != gt.shape:
        raise ValueError(f"predicted frames {pred.shape} and ground truth {gt.shape} differ")
    out = []
    for s in range(0, len(pred), FRAME_BATCH):
        p = torch.as_tensor(pred[s:s + FRAME_BATCH], device=device).float()
        g = torch.as_tensor(gt[s:s + FRAME_BATCH], device=device).float()
        out.append(fn(p, g).double().cpu())
    return torch.cat(out).numpy() if out else np.zeros((0,))


def _mean_std(values):
    values = np.asarray(values, np.float64)
    return float(np.mean(values)), float(np.std(values))


def ssim_score_only(pred_videos, gt_videos, device="cuda", **kw):
    """Mean / std SSIM over (H, W, C) uint8-range frames (data_range 255)."""
    return _mean_std(per_frame(ssim_frames, pred_videos, gt_videos, device))


def mse_score_only(pred_videos, gt_videos, device="cuda", **kw):
    """Mean / std pixel MSE on 0-1 values."""
    return _mean_std(per_frame(_mse, pred_videos, gt_videos, device))


def psnr_score_only(pred_videos, gt_videos, device="cuda", **kw):
    """Mean / std PSNR in dB (data range 255, MSE floored at 1e-10)."""
    return _mean_std(per_frame(_psnr, pred_videos, gt_videos, device))


def hue_score_only(pred_videos, gt_videos, device="cuda", **kw):
    """Mean / std of the mean cosine similarity of per-pixel hue angles."""
    return _mean_std(per_frame(_hue, pred_videos, gt_videos, device))


# --- classifier-based n-way metrics -------------------------------------------

def n_way_top_k_acc(pred, class_ids, n_way, num_trials=40, top_k=1, rng=None):
    """Random-distractor n-way top-k accuracy (JAX metrics.py:136-155): for
    each trial draw n_way-1 distractor classes and test whether the GT
    class's predicted probability ranks in the top-k."""
    pred = np.asarray(pred)
    if isinstance(class_ids, (int, np.integer)):
        class_ids = [int(class_ids)]
    class_ids = [int(c) for c in np.asarray(class_ids).reshape(-1)]
    rng = np.random.default_rng() if rng is None else rng
    pick_range = [i for i in range(len(pred)) if i not in class_ids]
    corrects = 0
    for _ in range(num_trials):
        picked = rng.choice(pick_range, n_way - 1, replace=False)
        for gt in class_ids:
            cand = np.concatenate([pred[gt:gt + 1], pred[picked]])
            if 0 in np.argsort(cand)[-top_k:]:
                corrects += 1
                break
    acc = corrects / num_trials
    return acc, float(np.sqrt(acc * (1 - acc) / num_trials))


def classifier_metrics(pred_videos, gt_videos, kind="image", n_way=50,
                       num_trials=100, top_k=1, cache_dir=".cache",
                       model_path: Optional[str] = None, rng=None,
                       model=None, processor=None, device="cuda"):
    """ViT-image / VideoMAE-video n-way classification accuracy (JAX
    metrics.py:158-199) with the classifier on ``device``. Loads
    'google/vit-base-patch16-224' / 'MCG-NJU/videomae-base-finetuned-kinetics'
    or ``model_path`` from local files, or takes ``model`` / ``processor``."""
    device = resolve_device(device)
    if kind == "image":
        if model is None:
            from transformers import ViTForImageClassification, ViTImageProcessor

            name = model_path or "google/vit-base-patch16-224"
            processor = ViTImageProcessor.from_pretrained(name, cache_dir=cache_dir)
            model = ViTForImageClassification.from_pretrained(name, cache_dir=cache_dir)
        prep = lambda clip: processor(images=clip.astype(np.uint8), return_tensors="pt")  # noqa: E731
    elif kind == "video":
        if model is None:
            from transformers import VideoMAEForVideoClassification, VideoMAEImageProcessor

            name = model_path or "MCG-NJU/videomae-base-finetuned-kinetics"
            processor = VideoMAEImageProcessor.from_pretrained(name, cache_dir=cache_dir)
            model = VideoMAEForVideoClassification.from_pretrained(
                name, num_frames=len(gt_videos[0]), cache_dir=cache_dir)
        prep = lambda clip: processor(list(clip), return_tensors="pt")  # noqa: E731
    else:
        raise ValueError(kind)
    model = model.eval().to(device)

    def logits(clip):
        return model(**{k: v.to(device) for k, v in prep(clip).items()}).logits.float().cpu()

    accs, stds = [], []
    with torch.no_grad():
        for pred, gt in zip(pred_videos, gt_videos):
            gt_ids = logits(gt).argsort(-1).flatten()[-3:].numpy()
            probs = logits(pred).softmax(-1).flatten().numpy()
            a, s = n_way_top_k_acc(probs, gt_ids, n_way, num_trials, top_k, rng=rng)
            accs.append(a)
            stds.append(s)
    return accs, stds


def clip_score(images1, images2, model_path: Optional[str] = None, cache_dir=".cache",
               device="cuda"):
    """CLIP image-embedding cosine similarity per image pair (JAX
    metrics.py:202-215), the model on ``device``; loads
    'openai/clip-vit-base-patch32' or ``model_path`` from local files."""
    from transformers import CLIPModel, CLIPProcessor

    device = resolve_device(device)
    name = model_path or "openai/clip-vit-base-patch32"
    model = CLIPModel.from_pretrained(name, cache_dir=cache_dir).eval().to(device)
    processor = CLIPProcessor.from_pretrained(name, cache_dir=cache_dir)

    def features(images):
        inputs = processor(images=list(images), return_tensors="pt")
        return model.get_image_features(**{k: v.to(device) for k, v in inputs.items()})

    with torch.no_grad():
        f1, f2 = features(images1), features(images2)
        return torch.nn.functional.cosine_similarity(f1, f2, dim=-1).float().cpu().numpy()
