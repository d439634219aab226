"""Time the fine-tune step on (dp, sp, tp) meshes of the world's GPUs.

    torchrun --nproc_per_node 4 -m eeg2video_tpu_torch.utils.mesh_step \\
        --mesh 2,2,1 --mesh 2,1,2 --mesh 1,4,1 --mesh 1,1,4 --mesh 2,2,1,fsdp

Every rank builds ``UNet3DConfig()`` with random weights from a seed, and
posteriors and contexts of the global batch (``--batch``, default 10) from a
seed, as chip_smoke.py's train phase does: every rank the same. First each
rank takes ``--steps`` steps alone, without a mesh (one GPU's step, no
collective: the reference); then, for each ``--mesh`` ``dp,sp,tp[,fsdp]``
(dp * sp * tp = the world size), the same steps from the same weights on the
mesh, each rank on its dp slice of the batch. A step's draws are the global
batch's (``train.videodiffusion.train_step``), so every mesh computes the
reference's losses up to the rounding of its split sums (bf16 compute, the
trainer's default).

Rank 0 prints one JSON line per run: the mesh, the loss of each step and its
largest relative gap to the reference's, the seconds of each step on the
host clock between two synchronizations (the first step includes the first
calls' set-up) and the median of the later ones, and, as the largest over the
ranks, the peak device memory of the steps, the bytes of the f32 masters
and the optimizer's state, and the bytes of the model's own parameters (the
compute-dtype working copy: this rank's fsdp pieces under fsdp); with the
card's name and power limit. ``--device cpu --tiny`` rehearses it over gloo
with the micro UNet at 8 x 8 latents.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time


def _parse_mesh(text):
    parts = text.split(",")
    if len(parts) not in (3, 4) or (len(parts) == 4 and parts[3] != "fsdp"):
        raise argparse.ArgumentTypeError(f"--mesh dp,sp,tp[,fsdp], got {text!r}")
    return tuple(int(x) for x in parts[:3]) + (len(parts) == 4,)


def _card():
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read (no nvidia-smi)"


def _model(torch, dev, tiny):
    from ..models.init import random_init_
    from ..models.unet3d import UNet3DConditionModel, UNet3DConfig

    cfg = UNet3DConfig()
    if tiny:
        cfg = UNet3DConfig(block_out_channels=(32, 64), layers_per_block=1, attention_heads=4,
                           cross_attention_dim=768, norm_num_groups=8)
    g = torch.Generator(device=dev).manual_seed(14)
    with torch.device("meta"):
        unet = UNet3DConditionModel(cfg)
    return random_init_(unet.to_empty(device=dev), g)


def _data(torch, dev, batch, tiny):
    frames, h, w = (3, 8, 8) if tiny else (6, 36, 64)
    g = torch.Generator(device=dev).manual_seed(15)
    post = torch.cat([torch.randn(batch, frames, h, w, 4, generator=g, device=dev),
                      -4.0 + 0.1 * torch.randn(batch, frames, h, w, 4, generator=g, device=dev)],
                     dim=-1)
    return post, torch.randn(batch, 77, 768, generator=g, device=dev)


def _run(torch, args, dev, spec):
    """One run: (losses, seconds, peak bytes, resident bytes, working-copy
    bytes) on this rank."""
    from ..models.attention3d import check_tp_heads
    from ..parallel import make_mesh, shard_batch, shard_params
    from ..train import videodiffusion as vd

    mesh = None
    unet = _model(torch, dev, args.tiny)
    if spec is not None:
        dp, sp, tp, fsdp = spec
        mesh = make_mesh(dp=dp, sp=sp, tp=tp, device=dev)
        if tp > 1:
            check_tp_heads(unet, tp, vd.unet_tp_rules)
            shard_params(unet, mesh, vd.unet_tp_rules)
    state = vd.init_video_train_state(unet, vd.VideoDiffusionTrainConfig(), dev, mesh=mesh,
                                      fsdp=spec is not None and spec[3])
    del unet
    post, ctx = _data(torch, dev, args.batch, args.tiny)
    if mesh is not None:
        post, ctx = shard_batch(post, mesh), shard_batch(ctx, mesh)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    for _ in range(args.steps):
        sync()
        t0 = time.perf_counter()
        losses.append(float(vd.train_step(state, None, post, ctx, seed=5)))
        sync()
        secs.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    working = sum(p.numel() * p.element_size() for p in state.unet.parameters())
    return losses, secs, peak, state.resident_bytes(), working


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--mesh", type=_parse_mesh, action="append", required=True,
                   help="dp,sp,tp[,fsdp] (repeatable); dp * sp * tp = the world size")
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--batch", type=int, default=10)
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true",
                   help="the micro UNet at 8 x 8 latents and 3 frames (a rehearsal)")
    args = p.parse_args(argv)

    import torch
    import torch.distributed as dist

    from ..parallel import init_distributed, is_host0
    from ..utils import resolve_device

    owned = not dist.is_initialized()  # a launcher's group, or one of the caller's
    init_distributed(args.device)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        from ..ops import _build

        dev = torch.device("cuda", torch.cuda.current_device())
        _build.library()  # the kernels' build is not timed
    card = _card() if dev.type == "cuda" else "cpu"
    reference = None
    for spec in [None, *args.mesh]:
        losses, secs, peak, resident, working = _run(torch, args, dev, spec)
        if dist.is_initialized() and dist.get_world_size() > 1:
            every = [None] * dist.get_world_size()
            dist.all_gather_object(every, (peak, resident, working))
            peak, resident, working = (max(x[i] for x in every) for i in (0, 1, 2))
        if reference is None:
            reference = losses
        if is_host0():
            print(json.dumps({
                "mesh": "none" if spec is None else dict(zip(("dp", "sp", "tp", "fsdp"), spec)),
                "world": dist.get_world_size() if dist.is_initialized() else 1,
                "losses": losses,
                "max_rel_gap_to_one_gpu": max(abs(a - b) / abs(b)
                                              for a, b in zip(losses, reference)),
                "seconds": secs, "median_after_first": statistics.median(secs[1:] or secs),
                "peak_gib_max_rank": peak / 2**30, "masters_and_optimizer_bytes_max_rank":
                    resident, "working_copy_bytes_max_rank": working, "card": card}),
                  flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if owned and dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
