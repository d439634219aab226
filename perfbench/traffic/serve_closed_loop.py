"""Closed-loop clients against the port's server, in process.

The server is ``cli/serve.serve`` on the socket transport (``--listen
127.0.0.1:0``) with the flags of the cell's ``server_flags``, over a
pipeline and an int8 semantic predictor whose weights are made from the seed
on the card. ``clients`` threads each hold one connection and send one-clip
feature requests ``{"features": <file>, "indices": [k], "seed": s_k}``: the
file holds seeded DE features of one block of ``clips`` clips in the layout
serve reads, the indices follow a permutation drawn from the seed (client c
takes every ``clients``-th), and s_k is a function of (seed, k), so every
seed sends the same sizes in another order and a clip is known by its k.

Phases: the ramp (every client sends one request and waits for its reply,
which warms the semantic path and the transport), then the window: all
clients send at once at T0 and keep sending, each its next request once its
reply is in, until ``--seconds`` have passed; the window ends at T1, the last
reply of the requests sent before the deadline. ``clips_per_s`` is the clips
of those replies over T1 - T0. With ``--trace 1`` the clients start again and
the profiler covers ``trace_dispatches`` whole dispatches after
``trace_skip`` of them.

The harness wraps what it hands the server in ``record_function`` spans:
``perfbench.dispatch`` around each pipeline call, ``perfbench.unet`` around
each UNet forward, ``perfbench.decode`` around each frame's decode and
``perfbench.semantic`` around each semantic predict. The wrappers also keep
references to the outputs of the clips the check samples (drawn from the
seed among the clients' first requests of the window, which are always
served); nothing is copied or synchronized
in the timed path for it.

The check, once the window has closed and the program's state is freed: for
each sampled clip the reference recomputes the embeddings from the features
file, the clip's initial noise, its 20 DPM-Solver++ steps and its decode,
and compares the served embedding (and negative), the latents the decoder
received and the frames the pipeline returned.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time

import numpy as np
import torch

from perfbench.harness import context as hctx
from perfbench.harness.context import Run
from perfbench.harness.trace import Tracer
from perfbench.harness.weights import generator, make_state, sub_seed
from perfbench.reference import sampler as ref_sampler
from perfbench.reference import semantic as ref_sem
from perfbench.reference import unet3d as ref_unet
from perfbench.reference import vae as ref_vae
from perfbench.reference.numerics import Numerics, exact_f32

FP_VALUES = 16  # leading values of an embedding row that identify its clip


def _fp(row):
    return np.ascontiguousarray(row[:FP_VALUES], dtype=np.float32).tobytes()


class Recorder:
    """The pipeline the server gets: the program's pipeline inside spans,
    with the outputs of the watched clips kept."""

    def __init__(self, pipe, watch, frames):
        self.pipe, self.watch, self.frames = pipe, set(watch), frames
        self.fp2k, self.kept, self.clips = {}, {}, []
        self.calls, self.semantic_calls = 0, 0
        self.times = []  # host time at each dispatch's call
        self.on_dispatch = None
        self._decoded = []
        unet_forward, decode = pipe.unet.forward, pipe.vae.decode

        def unet(*a, **k):
            with torch.autograd.profiler.record_function("perfbench.unet"):
                return unet_forward(*a, **k)

        def dec(z):
            self._decoded.append(z)
            with torch.autograd.profiler.record_function("perfbench.decode"):
                return decode(z)

        pipe.unet.forward, pipe.vae.decode = unet, dec

    @property
    def device(self):
        return self.pipe.device

    def semantic(self, predict):
        def wrapped(eeg):
            with torch.autograd.profiler.record_function("perfbench.semantic"):
                out = predict(eeg)
            self.semantic_calls += 1
            self.fp2k.update((_fp(row), k) for k, row in enumerate(out))
            return out
        return wrapped

    def __call__(self, emb, negative, **kw):
        if self.on_dispatch is not None:
            self.on_dispatch(self.calls)
        self.calls += 1
        self.times.append(time.perf_counter())
        ks = [self.fp2k.get(_fp(row)) for row in np.asarray(emb)]
        self._decoded = []
        with torch.autograd.profiler.record_function("perfbench.dispatch"):
            out = self.pipe(emb, negative, **kw)
        self.clips.append(len({k for k in ks if k is not None}))
        f = self.frames
        neg = np.asarray(negative)
        for r, k in enumerate(ks):
            if k in self.watch and k not in self.kept:
                self.kept[k] = {"emb": np.array(emb[r]),
                                "neg": np.array(neg[r] if neg.ndim > 1 else neg),
                                "video": out, "row": r,
                                "latents": self._decoded[r * f:(r + 1) * f]}
        return out


class Client(threading.Thread):
    """One connection; sends its next request once the last reply is in,
    while the loop's phase lets it; records (sent, replied, ok, clips,
    phase) of each request."""

    def __init__(self, port, requests, loop):
        super().__init__(daemon=True)
        self.sock = socket.create_connection(("127.0.0.1", port))
        self.rfile = self.sock.makefile("r", encoding="utf-8")
        self.wfile = self.sock.makefile("w", encoding="utf-8")
        json.loads(self.rfile.readline())  # the connection's ready line
        self.requests, self.loop = requests, loop
        self.log, self.error = [], None

    def run(self):
        try:
            j = 0
            while True:
                phase = self.loop.next_phase(self)
                if phase is None:
                    return
                req = self.requests[j % len(self.requests)]
                j += 1
                sent = time.perf_counter()
                self.wfile.write(json.dumps(req) + "\n")
                self.wfile.flush()
                reply = json.loads(self.rfile.readline())
                self.log.append((sent, time.perf_counter(), bool(reply.get("ok")),
                                 int(reply.get("clips", 0)), phase))
        except Exception as e:  # reported by the main thread
            self.error = e

    def close(self):
        self.sock.close()


class Loop:
    """Phases of the closed loop, set by the main thread: each client asks
    before every request whether, and in which phase, to send it, and waits
    ("parks") while the answer is no."""

    def __init__(self, n):
        self.cond = threading.Condition()
        self.phase, self.deadline, self.n = "ramp", None, n
        self.parked, self.ramped = 0, set()

    def next_phase(self, client):
        with self.cond:
            while True:
                if self.phase == "ramp" and client not in self.ramped:
                    self.ramped.add(client)
                    return "ramp"
                if self.phase == "window" and time.perf_counter() < self.deadline:
                    return "window"
                if self.phase == "trace":
                    return "trace"
                if self.phase == "stop":
                    return None
                self.parked += 1
                self.cond.notify_all()
                self.cond.wait()
                self.parked -= 1

    def set(self, phase, deadline=None):
        with self.cond:
            self.phase, self.deadline = phase, deadline
            self.cond.notify_all()

    def wait_parked(self, failed):
        """Until every client waits: all its requests so far are answered."""
        with self.cond:
            while self.parked < self.n:
                failed()
                self.cond.wait(0.05)


def plan(ctx):
    """The features file, the order of the clips, each clip's request seed,
    and the clips the check samples: all from the seed."""
    p, seed, dev = ctx.params, ctx.seed, ctx.device
    feats = torch.randn((p["clips"], ctx.config["semantic"]["in_dim"]),
                        generator=generator(seed, "features", dev), device=dev)
    feature_file = os.path.join(ctx.scratch, "features.npy")
    np.save(feature_file, feats.cpu().numpy())
    perm = np.random.default_rng(sub_seed(seed, "requests")).permutation(p["clips"])
    clip_seed = {int(k): sub_seed(seed, f"clip{int(k)}") % (1 << 31) for k in perm}
    rng = np.random.default_rng(sub_seed(seed, "sample"))
    sampled = [int(k) for k in rng.choice(perm[:p["clients"]], p["check_clips"], replace=False)]
    return feature_file, perm, clip_seed, sampled


def run(ctx):
    from eeg2video_tpu_torch.cli import serve as serve_cli
    from eeg2video_tpu_torch.diffusion.pipeline import EEG2VideoPipeline
    from eeg2video_tpu_torch.models.semantic import Int8SemanticPredictor
    from eeg2video_tpu_torch.models.unet3d import UNet3DConfig
    from eeg2video_tpu_torch.models.vae import VAEConfig
    from eeg2video_tpu_torch.serving.runtimes import make_semantic_predict

    p, cfg, dev, seed = ctx.params, ctx.config, ctx.device, ctx.seed
    ucfg, vcfg, scfg, gen = cfg["unet"], cfg["vae"], cfg["semantic"], cfg["generation"]
    frames, height, width = gen["video_length"], gen["height"], gen["width"]
    n_clients = p["clients"]
    bf16 = torch.bfloat16

    pipe = EEG2VideoPipeline.create(
        make_state(ref_unet.param_shapes(ucfg), seed, "unet", dev, bf16),
        make_state(ref_vae.param_shapes(vcfg), seed, "vae", dev, bf16),
        unet_config=hctx.dataclass_of(UNet3DConfig, ucfg),
        vae_config=hctx.dataclass_of(VAEConfig, vcfg),
        dtype=bf16, device=dev)
    runtime = Int8SemanticPredictor.from_state_dict(
        make_state(ref_sem.param_shapes(scfg), seed, "semantic", dev), dev)
    hctx.free_device_memory()
    ctx.log(f"program built {time.time() - ctx.started:.1f} s after start")
    feature_file, perm, clip_seed, sampled = plan(ctx)
    recorder = Recorder(pipe, sampled, frames)

    argv = ["--listen", "127.0.0.1:0", "--out_dir", os.path.join(ctx.scratch, "gifs"),
            "--device", dev, "--video_length", str(frames), "--height", str(height),
            "--width", str(width), "--guidance_scale", str(gen["guidance_scale"]),
            "--num_inference_steps", str(gen["num_inference_steps"]), "--sampler", gen["sampler"]]
    args = serve_cli.build_parser().parse_args(argv + list(p["server_flags"]))
    ready, server_error = threading.Event(), []
    port = []

    semantic = recorder.semantic(make_semantic_predict(runtime, dev))

    def serve():
        try:
            serve_cli.serve(recorder, args, semantic_predict=semantic,
                            on_ready=lambda r: (port.append(r["port"]), ready.set()))
        except Exception as e:  # reported by the main thread
            server_error.append(e)
            ready.set()

    server = threading.Thread(target=serve, name="perfbench-server")
    server.start()
    ready.wait()
    ctx.log(f"server ready {time.time() - ctx.started:.1f} s after start")
    if server_error:
        raise server_error[0]

    def request(k):
        return {"features": feature_file, "indices": [int(k)], "seed": clip_seed[int(k)]}

    loop = Loop(n_clients)
    clients = [Client(port[0], [request(k) for k in [ramp] + list(perm[c::n_clients])], loop)
               for c, ramp in zip(range(n_clients), perm[-n_clients:])]

    def failed():
        for c in clients:
            if c.error is not None:
                raise RuntimeError(f"a client failed: {c.error!r}")
        if server_error:
            raise RuntimeError(f"the server failed: {server_error[0]!r}")

    tracer, counters = None, {}
    try:
        for c in clients:
            c.start()
        loop.wait_parked(failed)  # the ramp: one request each, answered
        setup_peak = hctx.reset_peak(dev)
        setup_s = time.time() - ctx.started
        t0 = time.perf_counter()
        loop.set("window", deadline=t0 + ctx.seconds)
        time.sleep(ctx.seconds)
        loop.wait_parked(failed)
        window_peak = hctx.peak(dev)
        counters["window_dispatches"] = sum(1 for t in recorder.times if t >= t0)
        ctx.log(f"window closed {time.perf_counter() - t0:.3f} s after it opened")
        ctx.log("dispatches (s after the window opened, clips): " + " ".join(
            f"{t - t0:.2f}:{c}" for t, c in zip(recorder.times, recorder.clips) if t >= t0))
        replies = sorted((e[0] - t0, e[1] - t0) for c in clients for e in c.log if e[4] == "window")
        ctx.log("requests (sent, replied): " + " ".join(f"{a:.2f}/{b:.2f}" for a, b in replies))
        if ctx.trace:
            tracer = Tracer(ctx.scratch, dev)
            start = recorder.calls + p["trace_skip"]
            stop = start + p["trace_dispatches"]
            done = threading.Event()

            def on_dispatch(i):
                if i == start:
                    tracer.start()
                elif i == stop:
                    t = time.perf_counter()
                    tracer.stop()
                    ctx.log(f"profiler stopped in {time.perf_counter() - t:.1f} s")
                    loop.set("stop")
                    done.set()

            recorder.on_dispatch = on_dispatch
            loop.set("trace")
            while not done.wait(0.05):
                failed()
            counters["traced_clips"] = sum(recorder.clips[start:stop])
            counters["traced_dispatches"] = stop - start
        loop.set("stop")
        for c in clients:
            c.join(timeout=600)
    finally:
        loop.set("stop")
        _shutdown(port[0])
        server.join(timeout=600)
        for c in clients:
            c.close()
    errors = [c.error for c in clients if c.error is not None] + server_error
    if errors:
        raise RuntimeError(f"the closed loop failed: {errors[0]!r}")
    trace = None
    if tracer is not None:
        t = time.perf_counter()
        trace = tracer.read()
        ctx.log(f"trace read in {time.perf_counter() - t:.1f} s")
    window = [e for c in clients for e in c.log if e[4] == "window"]
    t1 = max(e[1] for e in window)
    clips = sum(e[3] for e in window if e[2])
    counters.update(window_s=t1 - t0, window_clips=clips, semantic_calls=recorder.semantic_calls,
                    setup_s=setup_s, last_sent_s=max(e[0] for e in window) - t0,
                    unet_batch=2 * args.max_batch, frames=frames, height=height, width=width,
                    steps=args.num_inference_steps)
    e2e = {"clips_per_s": clips / (t1 - t0), "setup_s": setup_s,
           "peak_gib": window_peak / 2 ** 30}
    kept = recorder.kept
    del recorder, pipe, runtime, serve_cli
    hctx.free_device_memory()
    t = time.perf_counter()
    checks = check(ctx, feature_file, sampled, kept, clip_seed)
    ctx.log(f"reference check in {time.perf_counter() - t:.1f} s")
    return Run(e2e=e2e, attempted=len(window), failed=sum(1 for e in window if not e[2]),
               checks=checks, memory_peak_bytes=max(setup_peak, window_peak),
               counters=counters, trace=trace, config=cfg, params=p)


def _shutdown(port):
    try:
        with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
            f = s.makefile("rw", encoding="utf-8")
            f.readline()
            f.write(json.dumps({"cmd": "shutdown"}) + "\n")
            f.flush()
            f.readline()
    except OSError:
        pass


def reference_clips(ctx, feature_file, ks, clip_seed, num):
    """{k: (embedding, negative, final latents / 0.18215, frames)} of the
    reference at ``num``'s precision."""
    cfg, dev, seed = ctx.config, ctx.device, ctx.seed
    ucfg, vcfg, scfg, gen = cfg["unet"], cfg["vae"], cfg["semantic"], cfg["generation"]
    steps = gen["num_inference_steps"]
    bits = "int8" if num.kind == "f32" else "int4"
    out = {}
    with exact_f32():
        sem = make_state(ref_sem.param_shapes(scfg), seed, "semantic", dev)
        emb = ref_sem.predict(sem, scfg, torch.from_numpy(np.load(feature_file)).to(dev), bits)
        del sem
        neg = emb.mean(dim=0)
        bf16 = torch.bfloat16
        up = {k: v.float() for k, v in make_state(ref_unet.param_shapes(ucfg), seed, "unet", dev,
                                                  bf16).items()}
        vp = {k: v.float() for k, v in make_state(ref_vae.param_shapes(vcfg), seed, "vae", dev,
                                                  bf16).items()}
        unet = ref_unet.UNet3D(up, ucfg, num)
        decoder = ref_vae.Decoder(vp, vcfg, num)
        shape = (gen["video_length"], gen["height"] // 8, gen["width"] // 8, 4)
        for k in ks:
            noise = ref_sampler.clip_noise(clip_seed[k], k, shape, dev)
            lat = ref_sampler.denoise(unet, emb[k].reshape(77, 768), neg.reshape(77, 768), noise,
                                      steps, gen["guidance_scale"])
            out[k] = (emb[k].cpu(), neg.cpu(), (lat / ref_vae.SD_VAE_SCALE).cpu(),
                      ref_sampler.decode(decoder, lat).cpu())
    return out


def gaps(served, ref):
    """The three numbers compared for one clip: served against reference."""
    emb, neg, lat, video = served
    r_emb, r_neg, r_lat, r_video = ref
    return {"embedding_gap": max(hctx.rel_gap(emb, r_emb), hctx.rel_gap(neg, r_neg)),
            "latent_gap": hctx.rel_gap(lat, r_lat), "frame_gap": hctx.rel_gap(video, r_video)}


def check(ctx, feature_file, sampled, kept, clip_seed):
    missing = [k for k in sampled if k not in kept]
    if missing:
        raise RuntimeError(f"sampled clips {missing} were not served in the window")
    served = {}
    for k in sampled:
        e = kept[k]
        served[k] = (torch.from_numpy(e["emb"]), torch.from_numpy(e["neg"]),
                     torch.cat([z.float().cpu() for z in e["latents"]]),
                     e["video"][e["row"]].float().cpu())
    del kept
    ref = reference_clips(ctx, feature_file, sampled, clip_seed, Numerics("f32"))
    worst = {}
    for k in sampled:
        for name, v in gaps(served[k], ref[k]).items():
            worst[name] = max(worst.get(name, 0.0), v)
    limits = ctx.workload["limits"]
    return [(name, worst[name], limits[name]) for name in ("embedding_gap", "latent_gap",
                                                           "frame_gap")]


def control(ctx, kind):
    """The check's numbers of the control, the reference at the precision
    below the configuration's (fp8 models, int4 semantic weights) put in the
    program's place, on the clips a run with this seed samples."""
    if kind != "fp8":
        raise ValueError(f"no {kind!r} control for serving")
    feature_file, _, clip_seed, sampled = plan(ctx)
    low = reference_clips(ctx, feature_file, sampled, clip_seed, Numerics("fp8"))
    ref = reference_clips(ctx, feature_file, sampled, clip_seed, Numerics("f32"))
    worst = {}
    for k in sampled:
        for name, v in gaps(low[k], ref[k]).items():
            worst[name] = max(worst.get(name, 0.0), v)
    return worst
