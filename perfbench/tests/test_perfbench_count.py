"""The frozen work counts, pinned at the cells' shapes."""

import json
import os

import pytest

from perfbench.count import work

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(name):
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


E2V = _config("eeg2video-sd14-6f288x512")
TAV = _config("tuneavideo-sd14-24f512")


@pytest.mark.parametrize("cfg, shape, tflop", [
    (E2V, (2, 6, 36, 64), 5.764),     # the guidance pair of one served clip
    (E2V, (8, 6, 36, 64), 23.05),     # a 4-clip dispatch
    (E2V, (10, 6, 36, 64), 28.82),    # the EEG2Video fine-tune batch
    (TAV, (1, 24, 64, 64), 23.23),    # Tune-A-Video's 24 frames of 512x512
])
def test_unet_forward_flops(cfg, shape, tflop):
    assert work.unet_forward_flops(cfg["unet"], *shape)["total"] / 1e12 == pytest.approx(
        tflop, rel=5e-4)


def test_clip_flops():
    gen = E2V["generation"]
    flops = work.clip_flops(E2V["unet"], E2V["vae"], gen["num_inference_steps"],
                            gen["video_length"], gen["height"], gen["width"])
    assert flops / 1e12 == pytest.approx(123.7, rel=5e-4)
    assert work.vae_decoder_flops(E2V["vae"], 6, 36, 64) / 1e12 == pytest.approx(8.436, rel=5e-4)


@pytest.mark.parametrize("cfg, shape, tflop", [
    (E2V, (10, 6, 36, 64), 64.23),
    (TAV, (1, 24, 64, 64), 54.04),
])
def test_train_step_flops_count_model_work_only(cfg, shape, tflop):
    fwd = work.unet_forward_flops(cfg["unet"], *shape)
    step = work.train_step_flops(cfg["unet"], *shape)
    assert step / 1e12 == pytest.approx(tflop, rel=5e-4)
    # forward + backward (attention twice) + the mask's weight gradients, under 3x
    assert 2 * fwd["total"] < step < 3 * fwd["total"]


def test_attention_backward_is_twice_the_forward():
    u = E2V["unet"]
    fwd = work.attention_calls(u, 10, 6, 36, 64, temporal=True)
    both = work.attention_calls(u, 10, 6, 36, 64, train=True, temporal=True)
    assert len(both) == 2 * len(fwd)
    assert sum(c["flops"] for c in both) == pytest.approx(3 * sum(c["flops"] for c in fwd))
    spatial = work.attention_calls(u, 10, 6, 36, 64)
    walk = work.unet_forward_flops(u, 10, 6, 36, 64)["attn"]
    temporal = sum(c["flops"] for c in fwd) - sum(c["flops"] for c in spatial)
    assert sum(c["flops"] for c in spatial) + temporal == pytest.approx(walk)


def test_least_time_is_the_larger_bound():
    c = work.call(989e12, 3.35e12 / 2)
    assert c["least_s"] == pytest.approx(1.0)
    c = work.call(989e12 / 2, 3.35e12)
    assert c["least_s"] == pytest.approx(1.0)


def test_ff_calls_cover_the_fused_widths():
    u = E2V["unet"]
    calls = work.ff_calls(u, 10, 6, 36, 64, (320, 640), train=True)
    assert len(calls) == 2 * 10  # five blocks at each width, forward and backward
    t = 10 * 6 * 36 * 64
    assert calls[0]["flops"] == pytest.approx(24 * t * 320 * 320)
