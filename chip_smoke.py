#!/usr/bin/env python3
"""Smoke check of the PyTorch + CUDA port (eeg2video_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA H100 and the
CUDA toolkit. It imports nothing of jax or of the JAX package. Phases, each
printed on its own line; any failure prints ``FAIL ...`` and exits 1:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compile every kernel from ``eeg2video_tpu_torch/csrc`` (and the
   host-side GIF encoder, so that no request pays for its build);
3. kernels: each kernel against its plain PyTorch version in f32 on the
   same inputs at the main paths' shapes, with its time, the plain version's
   time, the least time the card could take for the same work (``bound_ms``:
   the larger of operations / 989 TFLOP/s and bytes / 3.35 TB/s, each input
   read once and each output written once) and, where one PyTorch call
   computes the same function, that call's time (``library_ms``, a yardstick
   the port never calls);
4. UNet parity: a narrow UNet3D in bf16 with kernels on the card against the
   same weights through the plain versions in f32 on the CPU;
5. slice: two generation requests through ``EEG2VideoPipeline`` at full
   width (UNet3DConfig(), VAEConfig(), random weights from a seed), 4 DDIM
   steps, with per-UNet-forward launch counts of every kernel;
6. serve: the port's server, in-process, on ``--listen 127.0.0.1:0 --coalesce
   --max_batch 2 --semantic_int8 --sampler dpm++ --num_inference_steps 20
   --gif_encoder native`` with the same pipeline and a hidden=10000 int8
   semantic MLP; two client connections send feature and embedding requests,
   ping, stats and shutdown; GIFs are read back and launch counts checked.

The third-to-last line is a JSON object with one entry per kernel, then the
``nvidia-smi`` line; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
STEPS = 4                      # DDIM steps per request of the slice phase
SERVE_STEPS = 20               # DPM-Solver++ steps per dispatch of the serve phase
PEAK_FLOPS = 989e12            # H100 SXM, bf16 dense (NVIDIA data sheet)
PEAK_BYTES = 3.35e12           # H100 SXM, HBM3 bytes/s
KERNEL_BOUND = 1e-2            # max|kernel - plain_f32| / max|plain_f32|
UNET_BOUND = 5e-2              # ||bf16 card - f32 cpu|| / ||f32 cpu||
# per UNet forward at UNet3DConfig(), 6 frames of 36x64 latents (JAX trace):
# 16 transformers x (frames 0-1 + frames 2-5 + cross) attention calls;
# ff_ln at the 320/640 levels, geglu_out at 1280; 13 level-0 convs
EXPECTED_PER_FORWARD = {"flash_attention_fwd": 48, "ff_ln": 10,
                        "geglu_out": 6, "conv3x3_gn_silu": 13}
EXPECTED_CONV_STATS = 2
INT8_LAYERS = 5                # int8_dense launches per 100-row chunk: fc0..fc3, out
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
    "int8_dense": ("eeg2video_tpu_torch/csrc/int8_dense.cu",
                   "eeg2video_tpu/ops/int8_dense.py:62 _int8_dense_kernel"),
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
    from eeg2video_tpu_torch.data import native

    t0 = time.perf_counter()
    try:
        build.library()
        t1 = time.perf_counter()
        native.gif_library()  # host C++ (g++), so that no request pays for its build
    except RuntimeError as e:
        fail(f"build: {e}")
    say(f"build: ok, kernels {t1 - t0:.1f} s (nvcc), GIF encoder {time.perf_counter() - t1:.1f} s "
        f"(g++)")


def kernel_cases(torch, dev):
    """One dict per case: kernel, label, the kernel call, the plain call on
    f32 copies of ``args``, operations, an optional library call, primary?"""
    import torch.nn.functional as F

    from eeg2video_tpu_torch.ops import attention, conv2d, geglu, int8_dense

    g = torch.Generator(device=dev).manual_seed(0)

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).bfloat16()

    cases = []

    def add(kernel, label, kern, plain, args, flops, library=None, primary=False,
            plain_takes_args=False):
        cases.append(dict(kernel=kernel, label=label, kern=kern, plain=plain, args=args,
                          flops=flops, library=library, primary=primary,
                          plain_takes_args=plain_takes_args))

    heads = 8

    def attn(label, q, k0, v0, primary=False, k1=None, v1=None, bias0=None):
        def kern():
            return attention.flash_attention_fwd(q, k0, v0, heads, k1=k1, v1=v1, bias0=bias0)

        def plain(ts):
            return attention.flash_attention_plain(ts[0], ts[1], ts[2], heads, k1=ts[3],
                                                   v1=ts[4], bias0=ts[5])

        # the yardstick: one scaled_dot_product_attention call on (n, H, L, D)
        # views; for two segments K0 is expanded per frame and concatenated
        # with K1 outside the timed region
        hd = q.shape[-1]
        m = q.shape[1] if q.dim() == 4 else 1
        q3 = q.flatten(0, 1) if q.dim() == 4 else q
        kk, vv = k0.repeat_interleave(m, dim=0), v0.repeat_interleave(m, dim=0)
        mask = None
        if bias0 is not None:
            mask = bias0.to(q.dtype).repeat_interleave(m, dim=0)[:, None]  # (n, 1, 1, Lkv)
        if k1 is not None:
            kk = torch.cat([kk, k1.flatten(0, 1)], dim=1)
            vv = torch.cat([vv, v1.flatten(0, 1)], dim=1)
        split = lambda t: t.unflatten(-1, (heads, hd // heads)).transpose(1, 2)
        qh, kh, vh = split(q3), split(kk), split(vv)
        lkv = k0.shape[1] + (0 if k1 is None else k1.shape[-2])
        add("flash_attention_fwd", label, kern, plain, [q, k0, v0, k1, v1, bias0],
            flops=4 * (q.numel() // hd) * lkv * hd,
            library=lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask),
            primary=primary)

    attn("self f0-1 (2,4608,320)x2304", r(2, 4608, 320), r(2, 2304, 320), r(2, 2304, 320))
    attn("self f0-1 +bias0 (2,4608,320)x2304", r(2, 4608, 320), r(2, 2304, 320),
         r(2, 2304, 320), bias0=torch.randn(2, 1, 2304, generator=g, device=dev) * 2)
    attn("cross (2,13824,320)x77", r(2, 13824, 320), r(2, 77, 320), r(2, 77, 320))
    attn("dual f2-5 (2,4,2304,320)x[2304|2304]", r(2, 4, 2304, 320), r(2, 2304, 320),
         r(2, 2304, 320), primary=True, k1=r(2, 4, 2304, 320), v1=r(2, 4, 2304, 320))
    attn("dual f2-5 (2,4,576,640)x[576|576]", r(2, 4, 576, 640), r(2, 576, 640),
         r(2, 576, 640), k1=r(2, 4, 576, 640), v1=r(2, 4, 576, 640))
    attn("cross (2,864,1280)x77", r(2, 864, 1280), r(2, 77, 1280), r(2, 77, 1280))

    # ff_ln, geglu_out and conv3x3_gn_silu fuse several PyTorch calls: no
    # single call computes the same function, so their library_ms is null
    for t, c, primary in ((27648, 320, True), (6912, 640, False)):
        i = 4 * c
        args = [r(t, c), 1.0 + 0.05 * r(c).float(), 0.02 * r(c).float(),
                r(2 * i, c, scale=c ** -0.5), 0.02 * r(2 * i).float(),
                r(c, i, scale=i ** -0.5), 0.02 * r(c).float()]
        add("ff_ln", f"T={t} C={c}", lambda a=args: geglu.ff_ln(*a),
            lambda ts: geglu.ff_ln_plain(*ts), args, flops=6 * t * c * i, primary=primary)

    for t, primary in ((1728, True), (480, False)):
        args = [r(t, 10240), r(1280, 5120, scale=5120 ** -0.5), 0.02 * r(1280).float()]
        add("geglu_out", f"T={t} I=5120 C=1280", lambda a=args: geglu.geglu_out(*a),
            lambda ts: geglu.geglu_out_plain(*ts), args, flops=2 * t * 5120 * 1280,
            primary=primary)

    def conv(label, cin, stats, temb, primary=False):
        n = 12
        args = [r(n, 36, 64, cin), r(320, cin, 3, 3, scale=(9 * cin) ** -0.5),
                0.02 * r(320).float(), torch.rand(n, cin, generator=g, device=dev) + 0.5,
                torch.randn(n, cin, generator=g, device=dev) * 0.5,
                torch.randn(n, 320, generator=g, device=dev) if temb else None]
        add("conv3x3_gn_silu", label,
            lambda: conv2d.conv3x3_gn_silu(*args, with_stats=stats),
            lambda ts: conv2d.conv3x3_gn_silu_plain(*ts, with_stats=stats),
            args, flops=2 * n * 36 * 64 * 9 * cin * 320, primary=primary)

    conv("Cin=320 (12,36,64) +stats +temb", 320, True, True, primary=True)
    conv("Cin=320 (12,36,64)", 320, False, False)
    conv("Cin=640 (12,36,64) +temb", 640, False, True)

    # int8_dense at the five layer shapes of the hidden=10000 semantic MLP,
    # one 100-row chunk, f32 activations; the yardstick is a dequantize to
    # bf16 and one F.linear (cuBLAS), with the same scale and bias epilogue
    def int8(label, m, k, n, primary=False):
        w = torch.randn(k, n, generator=g, device=dev) * k ** -0.5
        w_q, scale = int8_dense.quantize_int8(w)
        del w
        bias = 0.1 * torch.randn(n, generator=g, device=dev)
        x = torch.randn(m, k, generator=g, device=dev).relu()
        kp, np_ = w_q.shape

        def library():
            xb = F.pad(x, (0, kp - k)).bfloat16()
            y = F.linear(xb, w_q.to(torch.bfloat16).t())
            return y[:, :n].float() * scale[:n] + bias

        add("int8_dense", label, lambda: int8_dense.int8_dense(x, w_q, scale, bias, n),
            lambda ts: int8_dense.int8_dense_plain(*ts, n),
            [x, w_q, scale, bias], flops=2 * m * kp * np_, library=library, primary=primary,
            plain_takes_args=True)

    int8("fc0 M=100 (310->10000)", 100, 310, 10000)
    int8("fc1-3 M=100 (10000->10000)", 100, 10000, 10000, primary=True)
    int8("fc1-3 M=1 (10000->10000)", 1, 10000, 10000)
    int8("out M=100 (10000->59136)", 100, 10000, 77 * 768)
    return cases


def _outputs(res):
    return list(res) if isinstance(res, tuple) else [res]


def _nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def phase_kernels(torch):
    dev = torch.device("cuda")
    report = {k: {"max_abs_err": 0.0, "max_rel_err": 0.0} for k in KERNEL_SOURCES}
    for case in kernel_cases(torch, dev):
        kernel, label, kern, plain, args = (case[k] for k in
                                            ("kernel", "label", "kern", "plain", "args"))
        got = _outputs(kern())
        torch.cuda.synchronize()
        # the plain version on f32 copies of the bf16 operands (int8_dense
        # takes f32 activations and int8 weights as they are)
        want = _outputs(plain(args if case["plain_takes_args"] else
                              [a.float() if a is not None else None for a in args]))
        abs_err = (got[0].float() - want[0]).abs().max().item()  # main output
        rel_err = max(((a.float() - b).abs().max() / b.abs().max()).item()
                      for a, b in zip(got, want))
        if not all(torch.isfinite(a).all().item() for a in got):
            fail(f"kernels: {kernel} {label}: non-finite output")
        # least time for the same work: every input read once, every output
        # written once, against the operations at the bf16 tensor-core peak
        nbytes = _nbytes(args) + _nbytes(got)
        t_bytes, t_flops = nbytes / PEAK_BYTES * 1e3, case["flops"] / PEAK_FLOPS * 1e3
        bound_ms, bound_by = max(t_bytes, t_flops), "bytes" if t_bytes >= t_flops else "operations"
        ms = timed_ms(kern, torch, 10)
        plain_ms = timed_ms(lambda: plain(args), torch, 3)
        library_ms = timed_ms(case["library"], torch, 10) if case["library"] else None
        ok = rel_err < KERNEL_BOUND
        lib = "no single call" if library_ms is None else f"{library_ms:.3f} ms"
        say(f"kernel {kernel} [{label}]: max_rel_err {rel_err:.3e} (bound {KERNEL_BOUND:.0e}) "
            f"max_abs_err {abs_err:.3e}, {ms:.3f} ms, bound {bound_ms:.4f} ms by {bound_by} "
            f"({bound_ms / ms:.3f} of it; {nbytes} bytes, {case['flops']} operations), "
            f"library {lib}, plain {plain_ms:.3f} ms {'ok' if ok else 'FAILED'}")
        if not ok:
            fail(f"kernels: {kernel} [{label}] disagrees with its plain version")
        rep = report[kernel]
        rep["max_abs_err"] = max(rep["max_abs_err"], abs_err)
        rep["max_rel_err"] = max(rep["max_rel_err"], rel_err)
        if case["primary"]:
            rep.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                       library_ms=library_ms, shape=label)
    torch.cuda.empty_cache()
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

    hooks = [pipe.unet.register_forward_pre_hook(pre), pipe.unet.register_forward_hook(post)]
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
    torch.cuda.reset_peak_memory_stats()
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
    for h in hooks:
        h.remove()
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

    per_fwd = {k: launches[k] / max(forwards, 1) for k in EXPECTED_PER_FORWARD}
    stats_per_fwd = sum(stats_calls) / max(forwards, 1)
    ok = (forwards == 2 * STEPS
          and all(launches[k] == n * forwards for k, n in EXPECTED_PER_FORWARD.items())
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
    return pipe, launches


class _Client:
    """One JSONL-over-TCP connection to the server."""

    def __init__(self, port):
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=600)
        self.rfile = self.sock.makefile("r", encoding="utf-8")
        if not json.loads(self.rfile.readline()).get("ready"):
            fail("serve: a connection was not greeted with a ready line")

    def send(self, req):
        self.sock.sendall((json.dumps(req) + "\n").encode())

    def recv(self):
        line = self.rfile.readline()
        if not line:
            fail("serve: the server closed a connection before replying")
        return json.loads(line)

    def close(self):
        self.rfile.close()
        self.sock.close()

    def ask(self, req):
        t0 = time.perf_counter()
        self.send(req)
        reply = self.recv()
        return reply, time.perf_counter() - t0


def phase_serve(torch, build, pipe):
    """The port's server at full width, in-process, over its socket transport
    (the models live where ``pipe`` does)."""
    import numpy as np

    from eeg2video_tpu_torch.cli import serve
    from eeg2video_tpu_torch.data.video import load_gif
    from eeg2video_tpu_torch.models.semantic import HIDDEN, IN_DIM, Int8SemanticPredictor
    from eeg2video_tpu_torch.ops.int8_dense import quantize_int8
    from eeg2video_tpu_torch.serving.runtimes import PREDICT_CHUNK, make_semantic_predict

    dev = pipe.device
    g = torch.Generator(device=dev).manual_seed(3)
    # the hidden=10000 semantic MLP: each layer's f32 weight is drawn and
    # quantized on the card, one at a time (the host never holds them)
    dims = [IN_DIM] + [HIDDEN] * 4 + [77 * 768]
    layers = []
    for k, n in zip(dims[:-1], dims[1:]):
        w = torch.randn(k, n, generator=g, device=dev) * k ** -0.5
        w_q, scale = quantize_int8(w)
        del w
        layers.append((w_q, scale, 0.02 * torch.randn(n, generator=g, device=dev), n))
    semantic = Int8SemanticPredictor(layers)
    n_weights = sum(k * n for k, n in zip(dims[:-1], dims[1:]))
    say(f"serve: semantic MLP {dims[0]} -> 4 x {HIDDEN} -> {dims[-1]}, {n_weights} int8 weights "
        f"({sum(l[0].numel() for l in layers)} bytes padded), random from a seed")

    chunk_ms = []

    def timed_semantic(x):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = semantic(x)
        torch.cuda.synchronize()
        chunk_ms.append((time.perf_counter() - t0) * 1e3)
        return y

    step_ms, t_fwd = [], []

    def pre(mod, args):
        torch.cuda.synchronize()
        t_fwd.append(time.perf_counter())

    def post(mod, args, out):
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t_fwd[-1]) * 1e3)

    hooks = [pipe.unet.register_forward_pre_hook(pre), pipe.unet.register_forward_hook(post)]

    with tempfile.TemporaryDirectory(prefix="e2v_smoke_") as tmp:
        rng = np.random.default_rng(4)
        feats, emb = os.path.join(tmp, "de.npy"), os.path.join(tmp, "emb.npy")
        np.save(feats, rng.standard_normal((6, IN_DIM)).astype(np.float32))
        np.save(emb, rng.standard_normal((2, 77 * 768)).astype(np.float32))
        args = serve.build_parser().parse_args([
            "--listen", "127.0.0.1:0", "--coalesce", "--coalesce_wait", "1", "--max_batch", "2",
            "--semantic_int8", "--sampler", "dpm++", "--num_inference_steps", str(SERVE_STEPS),
            "--gif_encoder", "native", "--device", str(dev), "--out_dir", os.path.join(tmp, "out")])
        ready, box = threading.Event(), {}

        def on_ready(line):
            box["port"] = line["port"]
            ready.set()

        def run():
            try:
                box["rc"] = serve.serve(
                    pipe, args, make_semantic_predict(timed_semantic, dev), on_ready)
            except Exception as e:  # reported by the main thread, which fails the run
                box["error"] = e
            finally:
                ready.set()

        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        server = threading.Thread(target=run, name="serve", daemon=True)
        server.start()
        if not ready.wait(timeout=120) or "port" not in box:
            fail(f"serve: the server did not come up: {box.get('error')!r}")
        c1, c2 = _Client(box["port"]), _Client(box["port"])
        out = lambda name: os.path.join(tmp, name)
        replies = {}
        # a full dispatch from one request; then clip 2 alone (padded to a
        # pair after --coalesce_wait); then, sent together from two
        # connections, an embeddings clip and clip 2 again: one shared dispatch
        replies["a"] = c1.ask({"id": "a", "features": feats, "indices": [0, 1],
                               "out_dir": out("a")})
        replies["b"] = c2.ask({"id": "b", "features": feats, "indices": [2],
                               "out_dir": out("b")})
        t0 = time.perf_counter()
        c1.send({"id": "c", "embeddings": emb, "indices": [0], "out_dir": out("c")})
        c2.send({"id": "b2", "features": feats, "indices": [2], "out_dir": out("b2")})
        replies["c"] = (c1.recv(), time.perf_counter() - t0)
        replies["b2"] = (c2.recv(), time.perf_counter() - t0)
        pong, _ = c1.ask({"cmd": "ping"})
        stats, _ = c2.ask({"cmd": "stats", "id": "s"})
        bye, _ = c1.ask({"cmd": "shutdown"})
        c1.close()
        c2.close()
        server.join(timeout=120)
        launches = dict(build.launches)
        for h in hooks:
            h.remove()
        if "error" in box:
            fail(f"serve: the server thread raised {box['error']!r}")
        if server.is_alive() or box.get("rc") != 0:
            fail(f"serve: the server did not stop cleanly (rc {box.get('rc')})")

        clips = {"a": [0, 1], "b": [2], "c": [0], "b2": [2]}
        for rid, (reply, secs) in replies.items():
            want = [os.path.join(out(rid), f"{i}.gif") for i in clips[rid]]
            ok = (reply.get("ok") is True and reply.get("id") == rid
                  and reply.get("clips") == len(want) and reply.get("gifs") == want)
            say(f"serve: request {rid}: {json.dumps(reply)}, {secs:.3f} s at the client "
                f"{'ok' if ok else 'FAILED'}")
            if not ok:
                fail(f"serve: request {rid} got a wrong reply")
            for path in want:
                with open(path, "rb") as f:
                    head = f.read(6)
                frames = load_gif(path)
                if head != b"GIF89a" or frames.shape != (6, 288, 512, 3) or frames.std() == 0:
                    fail(f"serve: {path} is not a 6-frame 288x512 GIF: {head!r} {frames.shape}")
        say("serve: 5 GIFs start with GIF89a and decode to (6, 288, 512, 3) with content")
        if replies["c"][0].get("coalesced") != 2 or replies["b2"][0].get("coalesced") != 2:
            fail("serve: requests c and b2 did not share one dispatch group")
        with open(os.path.join(out("b"), "2.gif"), "rb") as f1, \
                open(os.path.join(out("b2"), "2.gif"), "rb") as f2:
            alone, paired = f1.read(), f2.read()
        say(f"serve: clip 2 alone (padded dispatch) vs beside another request's clip: "
            f"{len(alone)} and {len(paired)} GIF bytes {'equal' if alone == paired else 'DIFFER'}")
        if alone != paired:
            fail("serve: a clip's GIF depends on what shared its dispatch")
        with open(os.path.join(out("a"), "0.gif"), "rb") as f1:
            if f1.read() == alone:
                fail("serve: two different clips gave the same GIF")
        if not (pong.get("ok") and pong.get("pong", 0) > 0 and bye == {"ok": True, "bye": True}):
            fail(f"serve: ping or shutdown reply is wrong: {pong} {bye}")
        ok = (stats.get("id") == "s" and stats.get("requests") == 4 and stats.get("clips") == 5
              and stats.get("errors") == 0)
        say(f"serve: stats {json.dumps(stats)} {'ok' if ok else 'FAILED'}")
        if not ok:
            fail("serve: stats do not count 4 requests, 5 clips, 0 errors")

    dispatches, chunks = 3, 3  # [a0 a1] [b b] [c b2]; one 100-row chunk per features request
    forwards = len(step_ms)
    expected = {k: n * SERVE_STEPS * dispatches for k, n in EXPECTED_PER_FORWARD.items()}
    expected["int8_dense"] = INT8_LAYERS * chunks
    ok = forwards == SERVE_STEPS * dispatches and launches == expected and len(chunk_ms) == chunks
    say(f"serve: {forwards} UNet forwards in {dispatches} dispatches of {SERVE_STEPS} DPM++ steps, "
        f"{len(chunk_ms)} semantic chunks of {PREDICT_CHUNK} rows; launches {launches} "
        f"(expected {expected}) {'ok' if ok else 'FAILED'}")
    if not ok:
        fail("serve: the serving path did not launch the expected kernels")
    say(f"serve: semantic predictor ms per {PREDICT_CHUNK}-row chunk (5 int8_dense launches, "
        f"synchronized) {[round(t, 3) for t in chunk_ms]}")
    say(f"serve: per UNet forward at batch 2 (CFG: 4 samples) median "
        f"{statistics.median(step_ms):.2f} ms, first {step_ms[0]:.2f} ms")
    say(f"serve: request latency at the client (requests b, c and b2 include up to 1 s of "
        f"--coalesce_wait) {({k: round(v[1], 3) for k, v in replies.items()})} s; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
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
    pipe, ddim_launches = phase_slice(torch, build)
    launches = phase_serve(torch, build, pipe)
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "flax", "eeg2video_tpu"))
    if leaked:
        fail(f"imports: jax or the JAX package was imported: {leaked[:5]}")

    kernels = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        rep = report[name]
        # launches: of the serve phase's run (all five kernels);
        # launches_ddim_path: of the slice phase's run (the UNet's four)
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "launches_ddim_path": ddim_launches[name],
                        "max_abs_err": rep["max_abs_err"], "max_rel_err": rep["max_rel_err"],
                        "ms": rep["ms"], "plain_ms": rep["plain_ms"],
                        "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
                        "library_ms": rep["library_ms"], "shape": rep["shape"]})
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    # every check has passed and every line is out: leave without the
    # interpreter's teardown, which has nothing left to do here
    sys.stderr.flush()
    os._exit(0)


if __name__ == "__main__":
    main()
