"""Batch assembly + dispatch for the serving surface.

Counterpart of ``eeg2video_tpu/serving/batching.py``. ``handle`` is the
one-request path; ``_process_group`` the coalesced path (identical-knob
requests share padded device dispatches, replies stream in arrival order).
Transport-free: callers supply an ``emit`` callback.

One deliberate difference: every path draws a clip's initial noise through
``_noise_batch``, from a generator seeded by (request seed, clip name) alone.
The JAX server's plain-stdin path keys a dispatch's noise by its first clip
only at ``--max_batch`` > 1; here a clip's noise never depends on the
transport, on ``--max_batch`` or on which clips share its dispatch.
"""

import hashlib
import os
import threading
import time

import numpy as np
import torch

from ..data.video import AsyncVideoWriter, dispatch_ahead
from ..utils import get_logger
from .runtimes import _load_request

log = get_logger(__name__)


def _clip_seed(seed, name):
    """The generator seed of one clip: a fixed function of (request seed,
    clip name), 63 bits of a BLAKE2 digest."""
    digest = hashlib.blake2b(f"{int(seed)}:{int(name)}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def _noise_batch(seeds, names, shape, device):
    """Stacked per-clip initial noise, (len(names),) + shape float32 on
    ``device``: row i comes from its own ``torch.Generator`` on that device,
    seeded by ``_clip_seed(seeds[i], names[i])``."""
    rows = []
    for seed, name in zip(seeds, names):
        g = torch.Generator(device=device).manual_seed(_clip_seed(seed, name))
        rows.append(torch.randn(shape, generator=g, device=device, dtype=torch.float32))
    return torch.stack(rows)


def _to_host(videos):
    """The pipeline's output tensor -> numpy (this is where the host waits
    for the device)."""
    return videos.detach().float().cpu().numpy()


def _generate(pipe, seed, emb, negative, latents, out_dir, args, req,
              names=None):
    g = lambda name: req.get(name, getattr(args, name))
    os.makedirs(out_dir, exist_ok=True)
    gifs = []
    n = len(emb)
    if names is None:
        names = list(range(n))
    bs = args.max_batch
    f, h8, w8 = g("video_length"), g("height") // 8, g("width") // 8
    # encode on writer threads, dispatch batch s+1 before transferring batch
    # s: request latency is device time + the last batch's encode only
    writer = AsyncVideoWriter(encoder=g("gif_encoder"))

    def run(s):
        e = emb[s:s + bs]
        if latents is None:  # per clip: see the module docstring
            lat = _noise_batch([seed] * len(e), names[s:s + bs], (f, h8, w8, 4), pipe.device)
        else:
            lat = latents[s:s + bs]
        return pipe(
            e, negative, latents=lat,
            video_length=f, height=g("height"),
            width=g("width"), num_inference_steps=g("num_inference_steps"),
            guidance_scale=g("guidance_scale"), sampler=g("sampler")), len(e)

    def flush(out, s):
        videos, m = out
        videos = _to_host(videos)
        for j in range(m):
            path = os.path.join(out_dir, f"{names[s + j]}.gif")
            writer.submit(videos[j:j + 1], path)
            gifs.append(path)

    try:
        dispatch_ahead(range(0, n, bs), run, flush)
    finally:
        writer.close()
    return gifs


def handle(pipe, args, req):
    if req.get("cmd") == "ping":
        return {"ok": True, "pong": time.time()}
    r = _load_request(args, req)
    t0 = time.time()
    # GIFs are named by the requested embedding index (clip identity), so
    # two requests sharing an out_dir write distinct files; r["names"] is
    # the one naming rule (runtimes._load_request) for every path
    gifs = _generate(pipe, r["seed"], r["emb"], r["negative"], r["latents"],
                     r["out_dir"], args, req, names=r["names"])
    return {"ok": True, "gifs": gifs, "clips": len(gifs),
            "latency_s": round(time.time() - t0, 3)}


def _process_group(pipe, args, group, emit):
    """Run one coalesced batch of requests (identical knobs). Every request
    gets exactly one reply, streamed in arrival order as soon as its own GIFs
    are written: an early request in a deep queue replies after its dispatch
    lands, not after the whole group.

    ``group`` entries are (req, t0, client); ``emit(resp, req, client)``
    routes each reply to the connection the request arrived on (all replies
    go to stdout in stdin mode)."""
    g0 = group[0][0]
    g = lambda name: g0.get(name, getattr(args, name))
    f, h, w = g("video_length"), g("height"), g("width")
    h8, w8 = h // 8, w // 8

    lock = threading.Lock()
    ready = {}  # slot -> reply, awaiting ordered emission
    next_emit = [0]

    def finish(slot, reply):
        # main thread or a GIF-writer callback thread; replies leave in
        # arrival order (a later slot's reply waits for earlier slots)
        with lock:
            ready[slot] = reply
            while next_emit[0] < len(group) and next_emit[0] in ready:
                i = next_emit[0]
                emit(ready.pop(i), group[i][0], group[i][2])
                next_emit[0] += 1

    try:
        loaded = []  # (slot, parsed)
        for slot, (req, _t0, _client) in enumerate(group):
            try:
                loaded.append((slot, _load_request(args, req)))
            except Exception as e:  # reply per-request, keep the batch going
                finish(slot, {"ok": False,
                              "error": f"{type(e).__name__}: {e}"})
        clips = []  # (emb_row, negative, latent_row|None, seed, name, out_dir, slot)
        slot_clips = {}
        for slot, r in loaded:
            # validate per slot so one request's malformed data (wrong-shape
            # latents/negative) error-replies THAT request instead of
            # poisoning the shared batch assembly below
            try:
                neg = np.asarray(r["negative"], np.float32).reshape(-1)
                if neg.shape != (77 * 768,):
                    raise ValueError(
                        f"negative has {neg.size} values, expected {77 * 768}")
                rows = []
                for j in range(len(r["emb"])):
                    lat = None
                    if r["latents"] is not None:
                        lat = np.asarray(r["latents"][j], np.float32)
                        if lat.shape != (f, h8, w8, 4):
                            raise ValueError(
                                f"latents clip shape {lat.shape} != "
                                f"{(f, h8, w8, 4)}")
                    rows.append((r["emb"][j], neg, lat, r["seed"],
                                 int(r["names"][j]), r["out_dir"], slot))
            except Exception as e:
                finish(slot, {"ok": False,
                              "error": f"{type(e).__name__}: {e}"})
                continue
            if not rows:
                finish(slot, {"ok": True, "gifs": [], "clips": 0,
                              "latency_s": 0.0, "coalesced": len(group)})
                continue
            slot_clips[slot] = len(rows)
            clips.extend(rows)
        n = len(clips)
        if not n:
            return
        dev = pipe.device
        emb_all = np.stack([c[0] for c in clips])
        neg_all = np.stack([c[1] for c in clips])
        lat_all = torch.zeros((n, f, h8, w8, 4), dtype=torch.float32, device=dev)
        need = [i for i, c in enumerate(clips) if c[2] is None]
        for i, c in enumerate(clips):
            if c[2] is not None:
                lat_all[i] = torch.from_numpy(c[2]).to(dev)
        if need:
            lat_all[need] = _noise_batch([clips[i][3] for i in need],
                                         [clips[i][4] for i in need], (f, h8, w8, 4), dev)
        bs = max(1, args.max_batch)
        pad = (-n) % bs
        if pad:  # repeat the last clip: every dispatch has the one shape;
            # pad rows are computed but never flushed
            emb_all = np.concatenate([emb_all, np.repeat(emb_all[-1:], pad, 0)])
            neg_all = np.concatenate([neg_all, np.repeat(neg_all[-1:], pad, 0)])
            lat_all = torch.cat([lat_all, lat_all[-1:].expand(pad, -1, -1, -1, -1)])
        gifs = [[] for _ in group]
        slot_futs = {slot: [] for slot, _ in loaded}
        writer = AsyncVideoWriter(encoder=g("gif_encoder"))

        def arm(slot):
            # the slot's last clip is submitted: when its last GIF write
            # resolves, build and stream the reply
            futs = list(slot_futs[slot])
            remaining = [len(futs)]

            def cb(_):
                with lock:
                    remaining[0] -= 1
                    if remaining[0]:
                        return
                errs = [e for e in (fu.exception() for fu in futs)
                        if e is not None]
                if errs:
                    finish(slot, {"ok": False,
                                  "error": f"{type(errs[0]).__name__}: "
                                           f"{errs[0]}"})
                else:
                    finish(slot, {
                        "ok": True, "gifs": gifs[slot],
                        "clips": len(gifs[slot]),
                        "latency_s": round(time.time() - group[slot][1], 3),
                        "coalesced": len(group)})

            for fu in futs:
                fu.add_done_callback(cb)

        def run(s):
            return pipe(
                emb_all[s:s + bs], neg_all[s:s + bs],
                latents=lat_all[s:s + bs],
                video_length=f, height=h, width=w,
                num_inference_steps=g("num_inference_steps"),
                guidance_scale=g("guidance_scale"), sampler=g("sampler"))

        path_last = {}  # GIF path -> last submitted write future

        def flush(videos, s):
            videos = _to_host(videos)
            for j in range(min(bs, n - s)):
                _, _, _, _, name, out_dir, slot = clips[s + j]
                os.makedirs(out_dir, exist_ok=True)
                path = os.path.join(out_dir, f"{name}.gif")
                # two coalesced requests can name the same path (same
                # out_dir + clip index); serialize those writes: concurrent
                # writer threads would interleave
                prev = path_last.get(path)
                if prev is not None:
                    prev.exception()  # wait; its error stays with ITS slot
                fu = writer.submit(videos[j:j + 1], path)
                path_last[path] = fu
                slot_futs[slot].append(fu)
                gifs[slot].append(path)
                if len(slot_futs[slot]) == slot_clips[slot]:
                    arm(slot)

        try:
            dispatch_ahead(range(0, n, bs), run, flush)
        finally:
            writer.close()  # all futures resolved -> all callbacks fired
    except Exception as e:  # batch-level failure: err-reply unfinished slots
        log.exception("dispatch group failed")
        err = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        with lock:
            missing = [s for s in range(len(group))
                       if s >= next_emit[0] and s not in ready]
        for slot in missing:
            finish(slot, dict(err))
