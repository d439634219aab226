#!/usr/bin/env python3
"""Smoke check of the PyTorch + CUDA port (eeg2video_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA H100 and the
CUDA toolkit. It imports nothing of jax or of the JAX package. Phases, each
printed on its own line; any failure prints ``FAIL ...`` and exits 1:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compile every kernel from ``eeg2video_tpu_torch/csrc``;
3. kernels: each kernel, bf16, against its plain PyTorch version in f32 on
   the same inputs at the generation path's shapes, with both times;
4. UNet parity: a narrow UNet3D in bf16 with kernels on the card against the
   same weights through the plain versions in f32 on the CPU;
5. slice: two generation requests through ``EEG2VideoPipeline`` at full
   width (UNet3DConfig(), VAEConfig(), random weights from a seed), with
   per-UNet-forward launch counts of every kernel.

The second-to-last line is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
STEPS = 4                      # DDIM steps per request
KERNEL_BOUND = 1e-2            # max|kernel - plain_f32| / max|plain_f32|
UNET_BOUND = 5e-2              # ||bf16 card - f32 cpu|| / ||f32 cpu||
# per UNet forward at UNet3DConfig(), 6 frames of 36x64 latents (JAX trace):
# 16 transformers x (frames 0-1 + frames 2-5 + cross) attention calls;
# ff_ln at the 320/640 levels, geglu_out at 1280; 13 level-0 convs
EXPECTED_PER_FORWARD = {"flash_attention_fwd": 48, "ff_ln": 10,
                        "geglu_out": 6, "conv3x3_gn_silu": 13}
EXPECTED_CONV_STATS = 2
KERNEL_SOURCES = {
    "flash_attention_fwd": ("eeg2video_tpu_torch/csrc/flash_attention.cu",
                            "eeg2video_tpu/ops/attention.py:415 _packed_single_kernel, "
                            ":566 _packed_dual_kernel"),
    "ff_ln": ("eeg2video_tpu_torch/csrc/ff_ln.cu",
              "eeg2video_tpu/ops/geglu.py:213 _ff_kernel"),
    "geglu_out": ("eeg2video_tpu_torch/csrc/geglu_out.cu",
                  "eeg2video_tpu/ops/geglu.py:59 _geglu_kernel"),
    "conv3x3_gn_silu": ("eeg2video_tpu_torch/csrc/conv3x3.cu",
                        "eeg2video_tpu/ops/conv2d.py:48 _conv3x3_t_kernel"),
}


def fail(msg):
    print(f"FAIL {msg}", flush=True)
    sys.exit(1)


def say(msg):
    print(msg, flush=True)


def timed_ms(fn, torch, reps):
    """Median of ``reps`` synchronized runs, CUDA events, after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device(torch):
    if not torch.cuda.is_available():
        fail("device: torch.cuda.is_available() is false; this check needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0:
        fail(f"device: nvidia-smi failed: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    say(f"device: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}, "
        f"torch {torch.__version__}, cuda {torch.version.cuda}")
    say(line)
    return line


def phase_build(build):
    t0 = time.perf_counter()
    try:
        build.library()
    except RuntimeError as e:
        fail(f"build: {e}")
    say(f"build: ok, {time.perf_counter() - t0:.1f} s")


def kernel_cases(torch, dev):
    """(kernel, label, kernel call, plain call on f32 copies, primary?)."""
    from eeg2video_tpu_torch.ops import attention, conv2d, geglu

    g = torch.Generator(device=dev).manual_seed(0)

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).bfloat16()

    cases = []

    def attn(label, q, k0, v0, primary=False, k1=None, v1=None, bias0=None):
        def kern():
            return attention.flash_attention_fwd(q, k0, v0, 8, k1=k1, v1=v1, bias0=bias0)

        def plain(ts):
            return attention.flash_attention_plain(ts[0], ts[1], ts[2], 8, k1=ts[3],
                                                   v1=ts[4], bias0=bias0)
        cases.append(("flash_attention_fwd", label, kern, plain, [q, k0, v0, k1, v1],
                      primary))

    attn("self f0-1 (2,4608,320)x2304", r(2, 4608, 320), r(2, 2304, 320), r(2, 2304, 320))
    attn("self f0-1 +bias0 (2,4608,320)x2304", r(2, 4608, 320), r(2, 2304, 320),
         r(2, 2304, 320), bias0=torch.randn(2, 1, 2304, generator=g, device=dev) * 2)
    attn("cross (2,13824,320)x77", r(2, 13824, 320), r(2, 77, 320), r(2, 77, 320))
    attn("dual f2-5 (2,4,2304,320)x[2304|2304]", r(2, 4, 2304, 320), r(2, 2304, 320),
         r(2, 2304, 320), primary=True, k1=r(2, 4, 2304, 320), v1=r(2, 4, 2304, 320))
    attn("dual f2-5 (2,4,576,640)x[576|576]", r(2, 4, 576, 640), r(2, 576, 640),
         r(2, 576, 640), k1=r(2, 4, 576, 640), v1=r(2, 4, 576, 640))
    attn("cross (2,864,1280)x77", r(2, 864, 1280), r(2, 77, 1280), r(2, 77, 1280))

    for t, c, primary in ((27648, 320, True), (6912, 640, False)):
        i = 4 * c
        args = [r(t, c), 1.0 + 0.05 * r(c).float(), 0.02 * r(c).float(),
                r(2 * i, c, scale=c ** -0.5), 0.02 * r(2 * i).float(),
                r(c, i, scale=i ** -0.5), 0.02 * r(c).float()]
        cases.append(("ff_ln", f"T={t} C={c}", lambda a=args: geglu.ff_ln(*a),
                      lambda ts: geglu.ff_ln_plain(*ts), args, primary))

    for t, primary in ((1728, True), (480, False)):
        args = [r(t, 10240), r(1280, 5120, scale=5120 ** -0.5), 0.02 * r(1280).float()]
        cases.append(("geglu_out", f"T={t} I=5120 C=1280", lambda a=args: geglu.geglu_out(*a),
                      lambda ts: geglu.geglu_out_plain(*ts), args, primary))

    def conv(label, cin, stats, temb, primary=False):
        n = 12
        args = [r(n, 36, 64, cin), r(320, cin, 3, 3, scale=(9 * cin) ** -0.5),
                0.02 * r(320).float(), torch.rand(n, cin, generator=g, device=dev) + 0.5,
                torch.randn(n, cin, generator=g, device=dev) * 0.5,
                torch.randn(n, 320, generator=g, device=dev) if temb else None]
        cases.append(("conv3x3_gn_silu", label,
                      lambda: conv2d.conv3x3_gn_silu(*args, with_stats=stats),
                      lambda ts: conv2d.conv3x3_gn_silu_plain(*ts, with_stats=stats),
                      args, primary))

    conv("Cin=320 (12,36,64) +stats +temb", 320, True, True, primary=True)
    conv("Cin=320 (12,36,64)", 320, False, False)
    conv("Cin=640 (12,36,64) +temb", 640, False, True)
    return cases


def _outputs(res):
    return list(res) if isinstance(res, tuple) else [res]


def phase_kernels(torch):
    dev = torch.device("cuda")
    report = {k: {"max_abs_err": 0.0, "max_rel_err": 0.0} for k in KERNEL_SOURCES}
    for kernel, label, kern, plain, args, primary in kernel_cases(torch, dev):
        got = _outputs(kern())
        torch.cuda.synchronize()
        want = _outputs(plain([a.float() if a is not None else None for a in args]))
        abs_err = (got[0].float() - want[0]).abs().max().item()  # main output
        rel_err = max(((a.float() - b).abs().max() / b.abs().max()).item()
                      for a, b in zip(got, want))
        if not all(torch.isfinite(a).all().item() for a in got):
            fail(f"kernels: {kernel} {label}: non-finite output")
        ms = timed_ms(kern, torch, 10)
        plain_ms = timed_ms(lambda: plain(args), torch, 3)
        ok = rel_err < KERNEL_BOUND
        say(f"kernel {kernel} [{label}]: max_rel_err {rel_err:.3e} (bound {KERNEL_BOUND:.0e}) "
            f"max_abs_err {abs_err:.3e}, {ms:.3f} ms vs plain {plain_ms:.3f} ms "
            f"{'ok' if ok else 'FAILED'}")
        if not ok:
            fail(f"kernels: {kernel} [{label}] disagrees with its plain version")
        rep = report[kernel]
        rep["max_abs_err"] = max(rep["max_abs_err"], abs_err)
        rep["max_rel_err"] = max(rep["max_rel_err"], rel_err)
        if primary:
            rep.update(ms=ms, plain_ms=plain_ms, shape=label)
    return report


def phase_unet_parity(torch):
    import copy

    from eeg2video_tpu_torch.models.init import random_init_
    from eeg2video_tpu_torch.models.unet3d import UNet3DConditionModel, UNet3DConfig

    cfg = UNet3DConfig(block_out_channels=(64, 128, 128, 128), attention_heads=8)
    g = torch.Generator().manual_seed(1)
    cpu = random_init_(UNet3DConditionModel(cfg), g).to(torch.bfloat16).float().eval()
    card = copy.deepcopy(cpu).to("cuda", torch.bfloat16)
    sample = torch.randn(2, 6, 16, 16, 4, generator=g).bfloat16()
    ctx = torch.randn(2, 77, 768, generator=g).bfloat16()
    t = torch.tensor([10, 900])
    with torch.inference_mode():
        got = card(sample.cuda(), t.cuda(), ctx.cuda()).float().cpu()
        want = cpu(sample.float(), t, ctx.float())
    err = ((got - want).norm() / want.norm()).item()
    ok = bool(torch.isfinite(got).all()) and err < UNET_BOUND
    say(f"unet parity (64,128,128,128) 8 heads, 6 frames of 16x16, bf16 card vs f32 cpu: "
        f"rel_err {err:.3e} (bound {UNET_BOUND:.0e}) {'ok' if ok else 'FAILED'}")
    if not ok:
        fail("unet parity")


def phase_slice(torch, build):
    from eeg2video_tpu_torch.diffusion.pipeline import EEG2VideoPipeline
    from eeg2video_tpu_torch.models import resnet3d
    from eeg2video_tpu_torch.models.init import random_init_
    from eeg2video_tpu_torch.models.unet3d import UNet3DConfig
    from eeg2video_tpu_torch.models.vae import VAEConfig

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    pipe = EEG2VideoPipeline.create(None, None, UNet3DConfig(), VAEConfig(),
                                    dtype=torch.bfloat16, device=dev)
    random_init_(pipe.unet, g)
    random_init_(pipe.vae, g)
    n_params = sum(p.numel() for p in pipe.unet.parameters())
    say(f"slice: UNet3DConfig() {n_params} params, VAEConfig() "
        f"{sum(p.numel() for p in pipe.vae.parameters())} params, bf16, random weights")

    # count UNet forwards and time each one (synchronized at both ends)
    step_ms, t0 = [], []

    def pre(mod, args):
        torch.cuda.synchronize()
        t0.append(time.perf_counter())

    def post(mod, args, out):
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0[-1]) * 1e3)

    pipe.unet.register_forward_pre_hook(pre)
    pipe.unet.register_forward_hook(post)
    stats_calls = []
    real_conv = resnet3d.conv3x3_gn_silu

    def counted_conv(*a, with_stats=False, **k):
        stats_calls.append(with_stats)
        return real_conv(*a, with_stats=with_stats, **k)

    resnet3d.conv3x3_gn_silu = counted_conv

    requests = []
    for seed in (11, 12):
        rg = torch.Generator(device=dev).manual_seed(seed)
        requests.append((torch.randn(1, 77 * 768, generator=rg, device=dev),
                         torch.randn(77 * 768, generator=rg, device=dev), seed))
    build.reset_launches()
    videos, req_s = [], []
    for emb, neg, seed in requests:
        torch.cuda.synchronize()
        t_req = time.perf_counter()
        video = pipe(emb, neg, generator=torch.Generator(device=dev).manual_seed(seed),
                     video_length=6, height=288, width=512, num_inference_steps=STEPS,
                     guidance_scale=12.5)
        torch.cuda.synchronize()
        req_s.append(time.perf_counter() - t_req)
        videos.append(video)
    launches = dict(build.launches)
    resnet3d.conv3x3_gn_silu = real_conv
    forwards = len(step_ms)
    say(f"slice: 2 requests x {STEPS} DDIM steps, guidance 12.5, 6 frames 288x512: "
        f"{forwards} UNet forwards")

    for i, v in enumerate(videos):
        ok = (tuple(v.shape) == (1, 6, 288, 512, 3) and bool(torch.isfinite(v).all())
              and float(v.min()) >= 0.0 and float(v.max()) <= 1.0 and float(v.std()) > 0)
        say(f"slice: request {i}: shape {tuple(v.shape)}, range [{float(v.min()):.4f}, "
            f"{float(v.max()):.4f}], std {float(v.std()):.4f}, {req_s[i]:.3f} s "
            f"{'ok' if ok else 'FAILED'}")
        if not ok:
            fail(f"slice: request {i} output is malformed")
    if torch.equal(videos[0], videos[1]):
        fail("slice: two requests with different inputs gave the same video")

    per_fwd = {k: launches[k] / max(forwards, 1) for k in launches}
    stats_per_fwd = sum(stats_calls) / max(forwards, 1)
    ok = (forwards == 2 * STEPS
          and all(launches[k] == EXPECTED_PER_FORWARD[k] * forwards for k in launches)
          and sum(stats_calls) == EXPECTED_CONV_STATS * forwards)
    say(f"slice: launches per UNet forward {per_fwd} (expected {EXPECTED_PER_FORWARD}), "
        f"conv with stats {stats_per_fwd} (expected {EXPECTED_CONV_STATS}) "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        fail("slice: the main path did not launch the expected kernels")
    say(f"slice: per UNet forward (one DDIM step, CFG pair) median "
        f"{statistics.median(step_ms):.2f} ms, all {[round(s, 2) for s in step_ms]}; "
        f"per request {[round(s, 3) for s in req_s]} s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def main():
    try:
        import torch
    except ImportError:
        fail("device: torch is not installed")
    smi_line = phase_device(torch)
    if not os.path.isdir(os.path.join(REPO, "eeg2video_tpu_torch", "csrc")):
        fail("build: eeg2video_tpu_torch/ is not beside chip_smoke.py; run from a checkout")
    sys.path.insert(0, REPO)
    from eeg2video_tpu_torch.ops import _build as build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build(build)
    report = phase_kernels(torch)
    phase_unet_parity(torch)
    launches = phase_slice(torch, build)
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "flax", "eeg2video_tpu"))
    if leaked:
        fail(f"imports: jax or the JAX package was imported: {leaked[:5]}")

    kernels = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        rep = report[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": rep["max_abs_err"], "max_rel_err": rep["max_rel_err"],
                        "ms": rep["ms"], "plain_ms": rep["plain_ms"], "shape": rep["shape"]})
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
