"""The port's utilities (eeg2video_tpu_torch.utils) on the CPU: the analytic
FLOP walk against the JAX package's and against torch's own count, the
profiling helpers on a real ``torch.profiler`` trace, and the timers.

Tolerances: the FLOP walk is integer arithmetic on the same configs, so it
equals JAX's exactly; against ``torch.utils.flop_counter.FlopCounterMode`` on
the micro UNet's forward within 5% (JAX's test holds its walk to XLA's cost
analysis within 5%), and the difference is named term by term.
"""

import dataclasses
import json
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from eeg2video_tpu.models.unet3d import UNet3DConfig as JUNetConfig
from eeg2video_tpu.models.vae import VAEConfig as JVAEConfig
from eeg2video_tpu.utils import flops as jflops
from eeg2video_tpu_torch.models.unet3d import UNet3DConditionModel, UNet3DConfig
from eeg2video_tpu_torch.models.vae import VAEConfig
from eeg2video_tpu_torch.utils import Accumulator, Timer, flops, profiling
from eeg2video_tpu_torch.utils.timing import profile_trace

from test_torch_models import capped_threads

_threads = capped_threads()


def _port(jcfg, cls):
    return cls(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(cls)})


UNET_CASES = {"full": JUNetConfig(), "tiny": JUNetConfig.tiny(), "micro": JUNetConfig.micro()}
VAE_CASES = {"full": JVAEConfig(), "tiny": JVAEConfig.tiny()}


@pytest.mark.parametrize("case", list(UNET_CASES))
def test_flops_equal_jax(case):
    """At the bench shape (the CFG pair: batch 2, 6 frames of 36 x 64 latents,
    100 steps and the VAE decode per clip) and the train shape (batch 10)."""
    jcfg = UNET_CASES[case]
    cfg = _port(jcfg, UNet3DConfig)
    for batch in (2, 10):
        assert flops.unet3d_forward_flops(cfg, batch, 6, 36, 64) == \
            jflops.unet3d_forward_flops(jcfg, batch, 6, 36, 64)
    assert flops.train_step_flops(cfg, batch=10) == jflops.train_step_flops(jcfg, batch=10)
    for jvcfg in VAE_CASES.values():
        vcfg = _port(jvcfg, VAEConfig)
        assert (flops.vae_decoder_flops(vcfg, 6, 36, 64)
                == jflops.vae_decoder_flops(jvcfg, 6, 36, 64))
        assert flops.generation_clip_flops(cfg, vcfg) == jflops.generation_clip_flops(jcfg, jvcfg)
    assert flops.mfu(2e12, 0.5, peak=4e12) == jflops.mfu(2e12, 0.5, peak=4e12) == 1.0


def test_the_peak_is_the_h100s():
    assert flops.H100_BF16_PEAK == 989e12
    assert flops.mfu(989e12, 2.0) == 0.5
    text = open(flops.__file__).read()
    assert "V5E" not in text and "197" not in text and "TPU" not in text


def test_micro_unet_forward_flops_match_torch_count():
    """The walk against FlopCounterMode on the port's micro UNet forward
    (plain versions on the CPU): within 5%, and the whole difference is two
    terms the walk counts per frame where the port runs them once per sample,
    broadcasting over the frames: each resnet's time-embedding projection
    (temb -> Cout) and each cross-attention's K and V projections of the
    context (ctx_dim -> C over ctx_len tokens)."""
    jcfg = JUNetConfig.micro()
    cfg = _port(jcfg, UNet3DConfig)
    b, f, h, w, ctx_len = 2, 2, 12, 16, 7
    unet = UNet3DConditionModel(cfg).eval()
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        unet(torch.zeros(b, f, h, w, 4), torch.zeros(b, dtype=torch.long),
             torch.zeros(b, ctx_len, cfg.cross_attention_dim))
    counted = counter.get_total_flops()
    walk = flops.unet3d_forward_flops(cfg, b, f, h, w, ctx_len=ctx_len)["total"]
    assert abs(walk - counted) / counted < 0.05
    temb = 4 * cfg.block_out_channels[0]
    c0, c1 = cfg.block_out_channels
    resnet_couts = [c0, c1, c1, c1, c1, c1, c0, c0]  # down 2, mid 2, up 2 + 2
    transformer_widths = [c0, c1, c0, c0]  # down level 0, mid, up level 1 (two)
    extra_frames = b * (f - 1)
    per_frame_terms = (sum(2 * extra_frames * temb * c for c in resnet_couts)
                       + sum(2 * 2 * extra_frames * ctx_len * cfg.cross_attention_dim * c
                             for c in transformer_widths))
    assert walk - counted == per_frame_terms


# --- profiling --------------------------------------------------------------------------

def test_profile_fn_traces_a_cpu_function(tmp_path):
    """A Chrome trace of two calls of a small function: with no device work the
    events are the host's ops, with positive durations, and the summary
    attributes them per iteration."""
    x = torch.randn(128, 128, generator=torch.Generator().manual_seed(0))

    def f(a):
        return torch.tanh(a @ a).sum()

    out = profiling.profile_fn(f, x, logdir=str(tmp_path / "tr"), iters=2)
    assert "ms/iter" in out and "top ops" in out and "aten::mm" in out
    events = profiling.load_trace(str(tmp_path / "tr"))
    assert events and all(e.long_name == "cpu_op" for e in events)
    assert sum(e.dur_us for e in events) > 0
    assert any(e.name == "aten::mm" for e in events)
    assert profiling.bucket_of("aten::mm", "cpu_op") == "aten::mm"


def test_load_trace_keeps_device_work_when_there_is_some(tmp_path):
    """A trace with kernels: by default only the device's kernels and copies
    come back, with device_only=False the host's ops too."""
    trace = {"traceEvents": [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 5.0},
        {"ph": "X", "cat": "kernel", "name": "ff_ln_kernel<5>", "dur": 3.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)", "dur": 1.0},
        {"ph": "M", "name": "process_name", "args": {"name": "x"}}]}
    (tmp_path / "t.json").write_text(json.dumps(trace))
    device = profiling.load_trace(str(tmp_path))
    assert [e.name for e in device] == ["ff_ln_kernel<5>", "Memcpy HtoD (Pageable -> Device)"]
    assert len(profiling.load_trace(str(tmp_path), device_only=False)) == 3
    summary = profiling.summarize(device)
    assert "ff_ln" in summary and profiling.COPY_GROUP in summary
    with pytest.raises(FileNotFoundError):
        profiling.load_trace(str(tmp_path / "none"))


KERNEL_NAMES = {
    "void flash_fwd_kernel<64, 40, true>(FwdArgs)": "flash_attention_fwd",
    "flash_bwd_dq_kernel<40>": "flash_attention_bwd",
    "flash_bwd_dbias_kernel": "flash_attention_bwd",
    "flash_f32_fwd_kernel<40>": "flash_attention_fwd_f32",
    "flash_f32_dkv_kernel<80>": "flash_attention_bwd_f32",
    "ff_ln_kernel<5>": "ff_ln", "ff_ln_bwd_kernel<10>": "ff_ln_bwd",
    "ff_f32_gate_kernel": "ff_ln_f32", "ff_f32_bwd_dh2_kernel": "ff_ln_bwd_f32",
    "geglu_out_kernel": "geglu_out", "geglu_out_bwd_kernel": "geglu_out_bwd",
    "geglu_f32_sum_kernel": "geglu_out_f32", "geglu_f32_bwd_kernel": "geglu_out_bwd_f32",
    "temporal_fwd_kernel<6, 2, 5, 2>": "temporal_attention_fwd",
    "temporal_bwd_any_kernel<float>": "temporal_attention_bwd",
    "conv3x3_kernel": "conv3x3_gn_silu", "conv3x3_stats_kernel": "conv3x3_gn_silu",
    "int8_dense_kernel<104>": "int8_dense", "sos_filtfilt_kernel<float>": "sos_filtfilt",
    "sm90_xmma_gemm_bf16bf16_bf16f32": "library conv / GEMM",
    "cudnn::engines_precompiled::nchwToNhwcKernel": "library conv / GEMM",
    "void at::native::multi_tensor_apply_kernel<...>": "optimizer",
    "Memcpy DtoH (Device -> Pinned)": "memcpy / memset",
    "void at::native::vectorized_elementwise_kernel<4, ...>": profiling.OTHER_GROUP,
}


@pytest.mark.parametrize("name", list(KERNEL_NAMES))
def test_bucket_of_groups_the_port_kernels(name):
    assert profiling.bucket_of(name) == KERNEL_NAMES[name]


# --- timing ---------------------------------------------------------------------------

def test_timer_and_accumulator():
    acc = Accumulator(3)
    acc.add(1, 2.5, torch.tensor(3.0))
    acc.add(1, 0.5, 1)
    assert acc.data == [2.0, 3.0, 4.0] and acc[1] == 3.0
    acc.reset()
    assert acc.data == [0.0, 0.0, 0.0]
    timer = Timer()
    assert timer.avg() == 0.0
    time.sleep(0.01)
    first = timer.stop()
    timer.start()
    second = timer.stop()
    assert first >= 0.01 and second >= 0.0 and timer.times == [first, second]
    assert timer.sum() == first + second and timer.avg() == (first + second) / 2


def test_profile_trace_writes_a_trace_or_nothing(tmp_path):
    with profile_trace(None):
        torch.ones(4).sum()
    with profile_trace(str(tmp_path / "tr")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert profiling.load_trace(str(tmp_path / "tr"))
