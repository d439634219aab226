"""Time the server at the client on (dp, sp, tp) meshes of the world's GPUs.

    torchrun --nproc_per_node 4 -m eeg2video_tpu_torch.utils.mesh_serve \\
        --mesh 4,1,1 --mesh 1,1,4 --mesh 1,4,1 --mesh 2,1,2

Every rank of a run builds the pipeline at ``UNet3DConfig()`` /
``VAEConfig()`` in bf16 with random weights from a seed. First rank 0 serves
alone without a mesh (one GPU: the reference) while the others wait; then,
for each ``--mesh dp,sp,tp`` (dp * sp * tp = the world size), every rank
serves on the mesh (``cli.serve.serve_on_mesh``: rank 0 owns the transport
and sends each dispatch to the others). Rank 0's server listens on
127.0.0.1:0 with ``--coalesce --max_batch 4 --sampler dpm++
--num_inference_steps 20`` (``--max_batch``, ``--steps``); a client thread on
rank 0 sends ``--warmup`` then ``--requests`` requests of ``--max_batch``
clips of one embedding file, one at a time (the noise drawn on rank 0), and
times each from its send to its reply, GIFs written.

Rank 0 prints one JSON line per run: the mesh, the seconds of every request
at the client and the median of the timed ones, and per rank the kernels'
launches and the peak device memory of the run (the model's weights
included); with the card's name and power limit. ``--device cpu --tiny``
rehearses it over gloo with the tiny pipeline at 64 x 64.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import socket
import statistics
import tempfile
import threading
import time

from .mesh_step import _card


def _parse_mesh(text):
    parts = text.split(",")
    if len(parts) != 3:
        raise argparse.ArgumentTypeError(f"--mesh dp,sp,tp, got {text!r}")
    return tuple(int(x) for x in parts)


def _pipeline(torch, dev, tiny):
    from ..diffusion.pipeline import EEG2VideoPipeline
    from ..models.init import random_init_
    from ..models.unet3d import UNet3DConfig
    from ..models.vae import VAEConfig

    ucfg, vcfg = UNet3DConfig(), VAEConfig()
    if tiny:
        ucfg, vcfg = dataclasses.replace(UNet3DConfig.tiny(), cross_attention_dim=768), \
            VAEConfig.tiny()
    pipe = EEG2VideoPipeline.create(None, None, ucfg, vcfg,
                                    dtype=torch.float32 if tiny else torch.bfloat16, device=dev)
    g = torch.Generator(device=dev).manual_seed(16)
    random_init_(pipe.unet, g)
    random_init_(pipe.vae, g)
    return pipe


def _client(port_box, args, emb, out_dir):
    """Rank 0's client: the requests one at a time, each timed from its send
    to its reply; then shutdown."""
    port = port_box.get()
    secs = []
    with socket.create_connection(("127.0.0.1", port), timeout=3600) as sock:
        rfile = sock.makefile("r", encoding="utf-8")
        json.loads(rfile.readline())  # the connection's ready line
        req = {"embeddings": emb, "indices": list(range(args.max_batch)), "out_dir": out_dir}
        for i in range(args.warmup + args.requests):
            t0 = time.perf_counter()
            sock.sendall((json.dumps({**req, "id": str(i)}) + "\n").encode())
            reply = json.loads(rfile.readline())
            secs.append(time.perf_counter() - t0)
            if not reply.get("ok"):
                raise RuntimeError(f"request {i}: {reply}")
        sock.sendall(b'{"cmd": "shutdown"}\n')
        rfile.readline()
    return secs


def _run(torch, args, dev, spec, emb, tmp):
    """One run on this rank: (seconds of each request or None, launches,
    peak bytes)."""
    import queue

    import torch.distributed as dist

    from ..cli import serve
    from ..ops import _build
    from ..parallel import make_mesh
    from ..parallel.distributed import rank
    from ..serving.mesh import ControlPlane
    from ..train import unet_tp_rules

    sargs = serve.build_parser().parse_args([
        "--device", dev.type, "--listen", "127.0.0.1:0", "--coalesce", "--max_batch",
        str(args.max_batch), "--sampler", "dpm++", "--num_inference_steps", str(args.steps),
        "--gif_encoder", "native", *(["--height", "64", "--width", "64"] if args.tiny else [])])
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    mesh = plane = None
    if spec is not None:
        dp, sp, tp = spec
        mesh = make_mesh(dp=dp, sp=sp, tp=tp, device=dev)
        plane = ControlPlane(mesh)
    secs = None
    if spec is not None or rank() == 0:
        pipe = _pipeline(torch, dev, args.tiny)
        if mesh is not None:
            pipe.shard(mesh, unet_tp_rules if mesh.size("tp") > 1 else None)
        _build.reset_launches()
        if rank() == 0:
            port_box, out = queue.Queue(), {}
            out_dir = os.path.join(tmp, "none" if spec is None else "_".join(map(str, spec)))
            client = threading.Thread(
                target=lambda: out.update(secs=_client(port_box, args, emb, out_dir)),
                daemon=True)
            client.start()
            on_ready = lambda ready: port_box.put(ready["port"])  # noqa: E731
            with contextlib.redirect_stdout(io.StringIO()):  # the ready line
                if mesh is None:
                    serve.serve(pipe, sargs, on_ready=on_ready)
                else:
                    serve.serve_on_mesh(pipe, sargs, plane, on_ready=on_ready)
            client.join()
            secs = out["secs"]
        else:
            serve.serve_on_mesh(pipe, sargs, plane)
        del pipe
    if spec is None and dist.is_initialized():
        dist.barrier()
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    return secs, {k: n for k, n in _build.launches.items() if n}, peak


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--mesh", type=_parse_mesh, action="append", required=True,
                   help="dp,sp,tp (repeatable); dp * sp * tp = the world size")
    p.add_argument("--max_batch", type=int, default=4, help="clips a request and a dispatch")
    p.add_argument("--steps", type=int, default=20, help="DPM-Solver++ steps")
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--requests", type=int, default=5)
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true",
                   help="the tiny pipeline at 64 x 64 (a rehearsal)")
    args = p.parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist

    from ..parallel import init_distributed, is_host0
    from ..utils import resolve_device

    owned = not dist.is_initialized()
    init_distributed(args.device)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        from ..ops import _build

        dev = torch.device("cuda", torch.cuda.current_device())
        _build.library()  # the kernels' build is not timed
    card = _card() if dev.type == "cuda" else "cpu"
    world = dist.get_world_size() if dist.is_initialized() else 1
    with tempfile.TemporaryDirectory(prefix="e2v_mesh_serve_") as tmp:
        emb = os.path.join(tmp, "embeddings.npy")
        np.save(emb, np.random.default_rng(17).standard_normal(
            (args.max_batch, 77 * 768)).astype(np.float32))
        for spec in [None, *args.mesh]:
            secs, launches, peak = _run(torch, args, dev, spec, emb, tmp)
            every = [(launches, peak)]
            if world > 1:
                every = [None] * world
                dist.all_gather_object(every, (launches, peak))
            if is_host0():
                timed = secs[args.warmup:]
                print(json.dumps({
                    "mesh": "one GPU" if spec is None else dict(zip(("dp", "sp", "tp"), spec)),
                    "world": world, "clips_per_request": args.max_batch,
                    "steps": args.steps, "seconds_per_request": secs,
                    "median_s_per_request": statistics.median(timed),
                    "launches_per_rank": [e[0] for e in every],
                    "peak_gib_per_rank": [e[1] / 2**30 for e in every], "card": card}),
                    flush=True)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    if owned and dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
