"""CLI: warm-pipeline generation service (JSONL over stdin/stdout or TCP).

Counterpart of ``eeg2video_tpu/cli/serve.py``: checkpoints load once onto the
card, and every request runs against warm models. The reference has no
serving surface; its inference script reloads the full pipeline per run
(EEG2Video_New/Generation/inference_eeg2video.py:50-53).

Protocol — one JSON object per line on stdin, one JSON reply per line on
stdout (logs go to stderr):

  {"id": "r1", "embeddings": "emb.npy", "out_dir": "gifs"}
  {"id": "r2", "embeddings": "emb.npy", "indices": [3, 7],
   "latents": "dana.pt", "seed": 114514, "guidance_scale": 12.5}
  {"id": "r3", "features": "DE_1per2s/sub1.npy", "block": 6}
  {"id": "r4", "raw": "Segmented_Rawf_200Hz_2s/sub1.npy", "block": 6,
   "indices": [0, 1]}
  {"cmd": "ping"}
  {"cmd": "stats"}
  {"cmd": "shutdown"}

With ``--semantic_ckpt`` (or ``--torch_semantic``) a request may carry DE
features instead of precomputed embeddings: the warm in-process semantic
predictor (f32, or weight-only int8 with ``--semantic_int8``) encodes them,
and the CFG negative is their embedding mean, exactly as the two-script
reference chain (inference_semantic -> inference_eeg2video via an .npy on
disk) would produce.

With ``--seq2seq_ckpt`` (or ``--torch_seq2seq``) a request may carry ``raw``
EEG: the per-subject segmented (7, 40, 5, 62, 400) file, a caller-ordered
(N, 62, 400) segment stack, or pre-windowed (N, 7, 62, 100) arrays. The warm
Seq2Seq transformer rolls the latents out and, when flow scores are configured
(``--flow_scores`` or the request's ``flow_scores``), DANA noises them: the
reference's full-model latent source (three chained scripts and two disk
artifacts there). A request carrying only ``raw`` also derives its embeddings
from it: DE features of the 2 s segments (``dsp.de_psd``) through the semantic
predictor. ``{"dana": false}`` and ``{"seq2seq": false}`` select the woDANA and
woSeq2Seq ablations; ``dana_seed`` and ``flow_scores`` override per request.

Replies: {"id": "r1", "ok": true, "gifs": ["gifs/0.gif", ...],
          "latency_s": ..., "clips": 1} or {"id": ..., "ok": false,
          "error": "..."}.  Generation knobs (num_inference_steps,
          guidance_scale, height, width, video_length, seed, negative,
          gif_encoder) default to the CLI flags and can be overridden per
          request (shape knobs only with --allow_request_knobs).  GIF encodes
          overlap with device compute on writer threads; the default encoder
          is the native C++ one (csrc/gif_encoder.cpp, built at first use).

Throughput mode — ``--coalesce --max_batch N`` batches clips ACROSS queued
requests into N-clip device dispatches.  Requests with identical generation
knobs that are already waiting join the running batch; partial batches are
padded to N (pad outputs discarded) so every dispatch has one shape.  Each
clip's initial noise comes from a generator seeded by (request seed, clip
identity) and its CFG negative rides per-clip through the batch, so a clip's
output does not depend on which requests it shares a dispatch with, on the
transport or on --max_batch.  Replies stream in arrival order as each
request's own GIFs finish.

Network transport — ``--listen HOST:PORT`` serves the same JSONL protocol
over TCP to CONCURRENT clients (port 0 binds ephemerally; the bound port is
reported on stdout and each connection greets with a ready line).  All
connections feed one shared queue, so ``--coalesce`` batches clips across
clients; replies route back to the connection that asked, and GIFs are
written server-side to ``out_dir`` (the reply carries the paths).
``{"cmd": "stats"}`` returns served-request counters (requests/clips/errors/
mean latency/uptime; in the queue-loop modes also the live queue depth and
drain state) on every transport.

Shutdown — in the queue-loop modes (--coalesce / --listen), SIGTERM drains:
readers stop admitting new lines (immediate ``shutting_down`` error
replies, cmds included), every request already queued is processed and
replied to, and the process exits 0 once the queue runs dry.  A
``{"cmd": "shutdown"}`` from any client replies ``bye``, answers every line
still queued behind it with the ``shutting_down`` refusal, and stops the
server; client disconnects don't.  Ctrl-C (SIGINT) hard-stops.
"""

import argparse
import json
import sys
import time

import numpy as np

from ..serving.batching import handle
from ..serving.runtimes import _load_semantic, _load_seq2seq
from ..serving.transport import _Stats, _serve_coalesced, _serve_socket
from ..utils import get_logger, resolve_device
from .inference_eeg2video import load_pipeline

log = get_logger(__name__)


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--unet", default="./outputs/tuneavideo")
    p.add_argument("--vae", default="./checkpoints/vae/ckpt")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--device", default="cuda",
                   help="where the models live: the card by default (fails "
                        "where there is none); 'cpu' for a dry run")
    p.add_argument("--negative", default=None)
    p.add_argument("--out_dir", default="./outputs/served")
    p.add_argument("--num_inference_steps", type=int, default=100)
    p.add_argument("--sampler", default="ddim", choices=("ddim", "dpm++"),
                   help="dpm++ = DPM-Solver++(2M): the same ODE solved in a "
                        "fraction of DDIM's steps (e.g. "
                        "--num_inference_steps 20)")
    p.add_argument("--guidance_scale", type=float, default=12.5)
    p.add_argument("--height", type=int, default=288)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--video_length", type=int, default=6)
    p.add_argument("--seed", type=int, default=114514)
    p.add_argument("--gif_encoder", default="native",
                   choices=("native", "fast", "imageio"),
                   help="native = C++ shared-palette encoder (csrc/"
                        "gif_encoder.cpp, GIL-free, the serving default; "
                        "built with g++ at first use, fails if it cannot "
                        "be); fast = shared-palette Pillow encode; imageio "
                        "= the reference's mimsave path; overridable per "
                        "request")
    p.add_argument("--max_batch", type=int, default=1,
                   help="clips per device dispatch (with --coalesce, "
                        "partial batches are padded so every dispatch has "
                        "this one shape)")
    p.add_argument("--max_queue", type=int, default=256,
                   help="backpressure: past this many pending request "
                        "lines, new work requests get an immediate "
                        "queue_full error reply instead of growing the "
                        "queue without bound (0 = unbounded; cmd lines "
                        "like shutdown/ping/stats are always admitted)")
    p.add_argument("--allow_request_knobs", action="store_true",
                   help="let requests override shape knobs "
                        "(num_inference_steps/height/width/video_length/"
                        "sampler); OFF by default because a new shape "
                        "changes the device work, and its memory, for all "
                        "clients (requests sending the server's own values "
                        "are always accepted)")
    p.add_argument("--coalesce_wait", type=float, default=0.0,
                   help="with --coalesce: seconds to wait for additional "
                        "requests to fill one --max_batch dispatch before "
                        "running (0 = only batch what is already queued; "
                        "never delays once a full dispatch is gathered)")
    p.add_argument("--coalesce", action="store_true",
                   help="throughput mode: batch clips across queued "
                        "requests into --max_batch-clip dispatches; "
                        "per-clip noise seeds and per-clip CFG negatives "
                        "keep each clip's output independent of batch "
                        "composition; replies stream in arrival order as "
                        "each request's GIFs finish")
    p.add_argument("--warmup", action="store_true",
                   help="run one dummy dispatch of the shape the chosen "
                        "transport uses before reading requests (builds "
                        "the kernels, warms the allocator)")
    p.add_argument("--semantic_ckpt", default=None,
                   help="semantic-predictor .pt state dict (the port's "
                        "keys): loads the EEG->CLIP MLP once so requests "
                        "can send {'features': de.npy} instead of "
                        "precomputed embeddings")
    p.add_argument("--torch_semantic", default=None,
                   help="reference eeg2text .pt checkpoint instead of "
                        "--semantic_ckpt")
    p.add_argument("--semantic_scaler", default=None,
                   help="train-split stats.npz (mean_z/std_z) applied to "
                        "feature requests; omit if features arrive "
                        "pre-scaled")
    p.add_argument("--hidden", type=int, default=10000,
                   help="semantic MLP hidden width")
    p.add_argument("--seq2seq_ckpt", default=None,
                   help="Seq2Seq .pt state dict (reference keys, e.g. from "
                        "convert.from_jax.seq2seq_state_dict_from_jax): loads "
                        "the EEG->latent transformer once so requests can "
                        "send {'raw': eeg.npy} instead of precomputed latent "
                        "artifacts (with --flow_scores this is the "
                        "reference's FULL model path, Seq2Seq + DANA, served "
                        "warm)")
    p.add_argument("--torch_seq2seq", default=None,
                   help="reference seq2seqmodel.pt instead of "
                        "--seq2seq_ckpt")
    p.add_argument("--seq2seq_scaler", default=None,
                   help="eeg_scaler.npz of the Seq2Seq training (train-"
                        "split EEG z-score stats); omit if raw requests "
                        "arrive pre-scaled")
    p.add_argument("--seq2seq_stats", default=None,
                   help="stats.npz from --normalize training: predicted "
                        "latents are de-normalized mean_z/std_z")
    p.add_argument("--seq2seq_frames", type=int, default=6,
                   help="Seq2Seq rollout length (must match the diffusion "
                        "--video_length)")
    p.add_argument("--seq2seq_latent", default="4,36,64",
                   help="C,H,W of one predicted latent frame (must match "
                        "--height/--width // 8)")
    p.add_argument("--flow_scores", default=None,
                   help="optical-flow score table (the shipped (7, 200) "
                        "All_video_optical_flow_score.npy, or (N,) per-"
                        "clip scores for segment-form requests): raw "
                        "requests then default to DANA noising "
                        "(reference add_noise.py:100-129); per-request "
                        "'flow_scores'/'dana'/'dana_seed' override")
    p.add_argument("--dana_threshold", type=float, default=1.799,
                   help="fast-motion flow cut (reference add_noise.py:107)")
    p.add_argument("--dana_seed", type=int, default=3407,
                   help="DANA noising seed (reference add_noise.py:81)")
    p.add_argument("--dana_time_steps", type=int, default=500)
    p.add_argument("--semantic_int8", action="store_true",
                   help="weight-only-int8 semantic serving (ops/"
                        "int8_dense): weights quantize once at startup, a "
                        "quarter of the f32 weight bytes per request")
    p.add_argument("--listen", default=None, metavar="HOST:PORT",
                   help="serve the JSONL protocol over TCP instead of "
                        "stdin/stdout: concurrent clients share one queue "
                        "(with --coalesce their clips batch into shared "
                        "dispatches), replies route per connection, port 0 "
                        "binds an ephemeral port (reported on stdout)")
    for flag, default in (("dp", 0), ("tp", 1), ("sp", 1)):
        p.add_argument(f"--{flag}", type=_not_ported_yet, default=default,
                       help="(not ported yet: refused) a mesh of GPUs under the server")
    return p


def _not_ported_yet(value):
    raise argparse.ArgumentTypeError(
        "multi-GPU serving is not ported yet (ROADMAP.md §1 item 7: rank 0's transport "
        "broadcasting each dispatch to the other ranks); the server runs on one GPU")


def warmup(pipe, args):
    """One dummy dispatch of the shape the chosen transport uses."""
    log.info("warmup: one dummy dispatch")
    t0 = time.time()
    b = args.max_batch
    if args.coalesce or args.listen is not None:
        # the queue-loop paths always pass stacked per-clip negatives
        neg = np.zeros((b, 77 * 768), np.float32)
    else:
        neg = np.zeros((77 * 768,), np.float32)
    lat = np.zeros((b, args.video_length, args.height // 8,
                    args.width // 8, 4), np.float32)
    out = pipe(np.zeros((b, 77 * 768), np.float32), neg, latents=lat,
               video_length=args.video_length,
               height=args.height, width=args.width,
               num_inference_steps=args.num_inference_steps,
               guidance_scale=args.guidance_scale, sampler=args.sampler)
    float(out.sum())  # wait for the device
    log.info("warmup done in %.1fs", time.time() - t0)


def serve(pipe, args, semantic_predict=None, on_ready=None, seq2seq_predict=None):
    """Serve requests against an already-built pipeline (and, optionally, a
    warm semantic predictor from ``runtimes.make_semantic_predict`` and a warm
    Seq2Seq from ``runtimes.make_seq2seq_predict``) until a shutdown; ``main``
    calls this after loading. ``args`` is a namespace from ``build_parser``.
    ``on_ready`` (optional) is called with the ready line of the socket
    transport, which carries the bound port."""
    if semantic_predict is not None:
        args.semantic_predict = semantic_predict
    if seq2seq_predict is not None:
        args.seq2seq_predict = seq2seq_predict
    if args.warmup:
        warmup(pipe, args)
    stats = _Stats()
    if args.listen is not None:
        # socket transport prints its own ready line (with the bound port)
        return _serve_socket(pipe, args, stats, on_ready)
    print(json.dumps({"ok": True, "ready": True}), flush=True)

    if args.coalesce:
        return _serve_coalesced(pipe, args, stats)

    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
            if not isinstance(req, dict):
                raise ValueError(f"expected a JSON object, got "
                                 f"{type(req).__name__}")
        except (json.JSONDecodeError, ValueError) as e:
            print(json.dumps({"ok": False, "error": f"bad json: {e}"}),
                  flush=True)
            continue
        if req.get("cmd") == "shutdown":
            print(json.dumps({"ok": True, "bye": True}), flush=True)
            return 0
        if req.get("cmd") == "stats":
            resp = stats.snapshot()
            if "id" in req:
                resp["id"] = req["id"]
            print(json.dumps(resp), flush=True)
            continue
        try:
            resp = handle(pipe, args, req)
        except Exception as e:  # keep serving on per-request failure
            resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        if "id" in req:
            resp["id"] = req["id"]
        stats.reply(resp)
        print(json.dumps(resp), flush=True)
    return 0


def main(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    if args.max_batch < 1:
        p.error(f"--max_batch must be >= 1, got {args.max_batch}")
    resolve_device(args.device)  # fail before loading anything

    pipe = load_pipeline(args.unet, args.vae, dtype=args.dtype, device=args.device)
    semantic_predict = None
    if args.semantic_ckpt or args.torch_semantic:
        log.info("loading semantic predictor (hidden=%d%s)", args.hidden,
                 ", int8" if args.semantic_int8 else "")
        semantic_predict = _load_semantic(args)
    seq2seq_predict = None
    if args.seq2seq_ckpt or args.torch_seq2seq:
        log.info("loading seq2seq predictor (frames=%d, latent=%s)",
                 args.seq2seq_frames, args.seq2seq_latent)
        seq2seq_predict = _load_seq2seq(args)
    return serve(pipe, args, semantic_predict, seq2seq_predict=seq2seq_predict)


if __name__ == "__main__":
    sys.exit(main())
