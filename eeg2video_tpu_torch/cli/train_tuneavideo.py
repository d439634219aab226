"""CLI: fine-tune the video-diffusion UNet on block-0 clips + BLIP captions.

Counterpart of ``eeg2video_tpu/cli/train_tuneavideo.py``: the contract of
the reference's Generation/train_finetune_videodiffusion.py:66-405 with its
configs/all_40_video.yaml schema (same keys honoured via ``--config``):
trainable attn1.to_q / attn2.to_q / attn_temp, AdamW 3e-5, grad clip 1.0,
200 epochs, batch 10, bf16 compute with f32 parameters, gradient
checkpointing, ``--use_8bit_adam`` (int8 Adam moments) and
``--gradient_accumulation_steps``, periodic validation sampling and
checkpoints (the train state as a torch file, written on a background thread,
and the diffusers directory layout the reference writes). SIGTERM or SIGINT
ends the run after the current epoch with a resumable train state
(``--unet_ckpt`` resumes from it); a second signal ends it at once.

The clip set is VAE-encoded once into posteriors and stays resident on the
card; each step gathers its shuffled batch by index. ``--device`` defaults to
``cuda`` and the run fails without a card; ``--device cpu`` is a dry run.

Several GPUs, one process each (``torchrun --nproc_per_node N``; on the CPU,
gloo): ``--dp/--tp/--sp/--fsdp`` make the JAX trainer's (dp, sp, tp) mesh
(``parallel.make_mesh``; JAX :189-221): the batch split over dp, ring
attention over sp, Megatron tp of the attention and feed-forward projections,
and with ``--fsdp`` the f32 masters, the optimizer's moments and the working
copy split over dp, each block's weights gathered where it runs
(``train.videodiffusion.TrainState``); the VAE then waits on the host
between its uses (the clip set's encoding, the validation samples).
``--dp`` defaults to the world size over tp * sp, clamped to a divisor of ``--train_batch_size``; the mesh is the
world's first dp*sp*tp ranks and the rest idle, as in JAX; ``--dp 1``
without a launcher is a mesh of one. Rank 0 writes the metrics, checkpoints
and validation GIFs; every rank joins the collectives of each step, of each
checkpoint's gathers and of the validation sample. A checkpoint holds whole
tensors, so it resumes on any mesh or on none.
"""

import argparse
import os

import numpy as np
import torch

from ..convert.export_diffusion import save_diffusers_pipeline, unet3d_from_torch_2d
from ..data import meta
from ..data.io import load_array
from ..data.video import VideoClipDataset, save_videos_grid
from ..diffusion.pipeline import EEG2VideoPipeline
from ..models.unet3d import UNet3DConditionModel, UNet3DConfig
from ..models.attention3d import check_tp_heads, sp_scope
from ..models.vae import AutoencoderKL
from ..parallel import init_distributed, is_host0, make_mesh, shard_params
from ..parallel.distributed import rank, world_size
from ..train import checkpoint as ckpt
from ..train.videodiffusion import (VideoDiffusionTrainConfig, encode_posteriors,
                                    init_video_train_state, train_epoch, unet_tp_rules)
from ..utils import get_logger, resolve_device
from ..utils.metrics_logger import MetricsLogger
from .inference_eeg2video import load_vae_state

log = get_logger(__name__)


def apply_reference_config(args, cfg_yaml):
    """Map a reference-schema YAML (configs/all_40_video.yaml; the
    reference's own file also loads) onto the CLI args; returns the
    gradient-checkpointing flag.

    The reference ignores several of these keys: ``max_train_steps`` is dead
    (train_finetune_videodiffusion.py:229 hardcodes ``num_train_epochs=200``)
    and both validation sampling and checkpointing gate on a hardcoded
    ``epoch % 100 == 0`` (L343) whatever ``checkpointing_steps`` /
    ``validation_steps`` say. A reference-schema config therefore maps those
    keys to the reference's effective values (200 epochs, 100-epoch
    cadence), not their literal ones."""
    # pyyaml (YAML 1.1) reads the reference's "3e-5" as a string
    coerce = {"learning_rate": float, "train_batch_size": int, "seed": int,
              "output_dir": str}
    for k, fn in coerce.items():
        if k in cfg_yaml:
            setattr(args, k, fn(cfg_yaml[k]))
    if "max_train_steps" in cfg_yaml:
        log.info("max_train_steps=%s ignored: the reference hardcodes 200 "
                 "epochs (train L229)", cfg_yaml["max_train_steps"])
        args.epochs = 200
    for yaml_key, arg_key in (("checkpointing_steps", "checkpointing_epochs"),
                              ("validation_steps", "validation_epochs")):
        if yaml_key in cfg_yaml:
            log.info("%s=%s ignored: the reference gates on epoch%%100 "
                     "(train L343)", yaml_key, cfg_yaml[yaml_key])
            setattr(args, arg_key, 100)
    vd = cfg_yaml.get("validation_data") or {}
    if "num_inference_steps" in vd:
        args.validation_steps = int(vd["num_inference_steps"])
    td = cfg_yaml.get("train_data") or {}
    if "video_dir" in td:
        args.video_dir = td["video_dir"]
    tm = cfg_yaml.get("trainable_modules")
    if tm is not None and sorted(tm) != sorted(
            ["attn1.to_q", "attn2.to_q", "attn_temp"]):
        raise SystemExit(
            "trainable_modules must be the reference mask "
            "attn1.to_q/attn2.to_q/attn_temp (train L72-76)")
    if cfg_yaml.get("enable_xformers_memory_efficient_attention"):
        log.info("enable_xformers_memory_efficient_attention is implicit: "
                 "attention always runs the flash kernels")
    if "use_8bit_adam" in cfg_yaml:
        args.use_8bit_adam = bool(cfg_yaml["use_8bit_adam"])
    return bool(cfg_yaml.get("gradient_checkpointing", True))


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", default=None, help="YAML config (reference schema)")
    p.add_argument("--video_dir", default="./data/Video_mp4/Block0")
    p.add_argument("--captions", default="./data/BLIP/1st_10min.txt",
                   help="accepted for the JAX CLI's command lines and unused, as there: "
                        "the captions reach training as --text_embeddings")
    p.add_argument("--text_embeddings", default="./data/Text_embeddings/block0.pt",
                   help="precomputed CLIP caption embeddings (200, 77, 768)")
    p.add_argument("--unet_torch", default=None,
                   help="diffusers 2D UNet state dict to inflate (from_pretrained_2d)")
    p.add_argument("--unet_ckpt", default=None,
                   help="resume from a train-state file or the newest one of a directory")
    p.add_argument("--vae", default="./checkpoints/vae/ckpt",
                   help="diffusers vae directory or a state-dict file of the port")
    p.add_argument("--output_dir", default="./outputs/tuneavideo")
    p.add_argument("--device", default="cuda",
                   help="where training runs: the card by default (fails where "
                        "there is none); 'cpu' for a dry run")
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--train_batch_size", type=int, default=10)
    p.add_argument("--learning_rate", type=float, default=3e-5)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--use_8bit_adam", action="store_true")
    p.add_argument("--checkpointing_epochs", type=int, default=100)
    p.add_argument("--validation_epochs", type=int, default=100,
                   help="sample clips with the current weights every N epochs "
                        "(the reference validates every 100 epochs, train L343)")
    p.add_argument("--validation_steps", type=int, default=50)
    p.add_argument("--gif_encoder", default="native", choices=("native", "fast", "imageio"),
                   help="encoder of the validation GIFs, as in cli.serve: native = "
                        "csrc/gif_encoder.cpp (built with g++ at first use)")
    p.add_argument("--seed", type=int, default=33)
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel mesh size, one GPU a rank (0 = the world size over "
                        "tp * sp)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel mesh size (Megatron-split attention and "
                        "feed-forward projections)")
    p.add_argument("--fsdp", action="store_true",
                   help="split the f32 masters, the optimizer's moments and the working copy "
                        "over the dp axis (parallel.fsdp_spec); each block gathers its "
                        "weights where it runs")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel mesh size: spatial attention, forward and "
                        "backward, through ring attention over an sp axis (ops.ring); "
                        "composes with --tp")
    return p


def mesh_from_args(args, device):
    """The (dp, sp, tp) mesh the flags ask for, or None for one GPU without
    a mesh (no mesh flag and a world of one). ``--dp`` 0 is the world size
    over tp * sp; a dp that does not divide the batch is clamped to its
    largest divisor that does, as JAX clamps it (:196-205). As there, the
    mesh is the world's first dp*sp*tp ranks, and a rank past them gets a
    mesh that is not ``active`` and does no work. Every rank calls it, after
    ``init_distributed``."""
    tp, sp = max(args.tp, 1), max(args.sp, 1)
    if not (args.dp or tp > 1 or sp > 1 or args.fsdp or world_size() > 1):
        return None
    dp = args.dp if args.dp > 0 else max(world_size() // (tp * sp), 1)
    if args.train_batch_size % dp:
        dp = max(d for d in range(1, dp + 1) if args.train_batch_size % d == 0)
        log.warning("train_batch_size %d not divisible by dp: clamped dp to %d",
                    args.train_batch_size, dp)
    mesh = make_mesh(dp=dp, tp=tp, sp=sp, device=device, leave_idle=True)
    if mesh.active:
        log.info("mesh: dp=%d tp=%d sp=%d fsdp=%s on %s", dp, tp, sp, args.fsdp, mesh.device)
    else:
        log.warning("rank %d idle: the mesh holds the first %d of %d ranks", rank(),
                    dp * tp * sp, world_size())
    return mesh


def _agree(flag, mesh):
    """Whether any rank of the world has ``flag`` set (a signal may reach some
    ranks only; they all stop after the same epoch)."""
    if mesh is None or world_size() == 1:
        return flag
    t = torch.tensor([float(flag)], device=mesh.device)
    torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX, group=mesh.members)
    return bool(t.item())


def train(unet, vae, data, contexts, args, cfg=None, on_step=None, mesh=None):
    """Fine-tune ``unet`` and return ``(state, epoch_losses)``.

    unet:     ``UNet3DConditionModel`` with f32 parameters (the stored truth)
    vae:      ``AutoencoderKL``; moved to the device in the compute dtype
    data:     (N, F, H, W, 3) pixels in [-1, 1] (VAE-encoded once, here) or
              precomputed (N, F, H/8, W/8, 8) posteriors
    contexts: (N, 77, cross_attention_dim) caption embeddings, one per clip
    args:     a namespace from ``build_parser``
    cfg:      the ``VideoDiffusionTrainConfig``; by default the reference
              recipe at ``args.learning_rate``, ``args.use_8bit_adam`` and
              ``args.gradient_accumulation_steps``
    on_step:  ``on_step(state, loss)`` after every micro step (every
              optimizer step without gradient accumulation)
    mesh:     the mesh ``main`` made already; None makes the one the flags
              ask for (``mesh_from_args``). A rank the mesh leaves idle
              returns ``(None, [])`` at once.

    The epochs run inside a ``CheckpointSession`` and a ``PreemptionGuard``:
    after an epoch in which SIGTERM or SIGINT arrived, the train state is
    saved and the run returns.
    """
    init_distributed(args.device)  # a launcher's group, if any, before anything else
    device = resolve_device(args.device)
    if mesh is None:
        mesh = mesh_from_args(args, device)
    if mesh is not None and not mesh.active:
        return None, []
    tcfg = cfg or VideoDiffusionTrainConfig(
        learning_rate=args.learning_rate, use_8bit_adam=args.use_8bit_adam,
        gradient_accumulation_steps=args.gradient_accumulation_steps)
    resume = None
    if args.unet_ckpt:
        file = ckpt.latest_checkpoint(args.unet_ckpt)
        if file is None:
            raise FileNotFoundError(f"no train-state checkpoint at {args.unet_ckpt}")
        resume = torch.load(file, map_location="cpu", weights_only=False)
        if set(resume["params"]) == set(unet.state_dict()):
            unet.load_state_dict(resume["params"], strict=True)  # a full checkpoint
    if mesh is not None and mesh.size("tp") > 1:
        check_tp_heads(unet, mesh.size("tp"), unet_tp_rules)
        shard_params(unet, mesh, unet_tp_rules)
    state = init_video_train_state(unet, tcfg, device, mesh=mesh, fsdp=args.fsdp)
    if resume is not None:
        state.load_state_dict(resume)
        log.info("resumed from %s (step %d)", args.unet_ckpt, state.step)
    vae = vae.to(device=device, dtype=state.dtype).requires_grad_(False).eval()
    n_train = sum(p.numel() for p in state.masters.values())
    log.info("trainable: %d parameters in %d tensors of %d", n_train, len(state.masters),
             sum(1 for _ in unet.parameters()))

    data = torch.as_tensor(data)
    if data.shape[-1] == 8:
        post_all = data.float().to(device)
    else:
        post_all = encode_posteriors(vae, data)
    if args.fsdp:  # the steps do not read it: it waits on the host (JAX splits it over dp)
        vae.to("cpu")
    context_all = torch.as_tensor(contexts).float().to(device)
    n = post_all.shape[0]
    bsz = args.train_batch_size
    steps_per_epoch = max(n // bsz, 1)
    host0 = is_host0()
    metrics = MetricsLogger(args.output_dir, "tuneavideo") if host0 else None
    rng = np.random.default_rng(args.seed)
    losses = []
    ckpt_dir = os.path.join(args.output_dir, "ckpt")
    try:
        with ckpt.CheckpointSession(ckpt_dir) as session, ckpt.PreemptionGuard() as guard:
            for epoch in range(1, args.epochs + 1):
                order = rng.permutation(n)[: steps_per_epoch * bsz]
                perm = order.reshape(steps_per_epoch, -1)
                ep_loss = train_epoch(state, vae, post_all, context_all, perm, args.seed,
                                      on_step)
                losses.append(ep_loss)
                log.info("epoch %d train_loss %.5f", epoch, ep_loss)
                if host0:
                    metrics.log(epoch * steps_per_epoch, train_loss=ep_loss, epoch=epoch)
                if _agree(guard.preempted, mesh):
                    sd = state.state_dict()  # every rank gathers; rank 0 writes
                    if host0:
                        file = session.save(epoch, sd)
                        log.warning("preemption signal: resumable train state %s saved "
                                    "after epoch %d (resume with --unet_ckpt %s)", file, epoch,
                                    ckpt_dir)
                    break
                if epoch % args.validation_epochs == 0:
                    path = os.path.join(args.output_dir, "samples", f"sample-{epoch}.gif")
                    _validate(state, vae, context_all, args, epoch, path, post_all.shape[1:4])
                    log.info("validation samples -> %s", path)
                if epoch % args.checkpointing_epochs == 0 or epoch == args.epochs:
                    # the train state is written on the session's thread while
                    # the next epoch trains; the diffusers layout here
                    sd = state.state_dict()
                    if host0:
                        file = session.save(epoch, sd)
                        save_diffusers_pipeline(args.output_dir, sd["params"], unet.config,
                                                vae.state_dict(), vae.config)
                        log.info("checkpoint @ epoch %d -> %s and the diffusers layout in %s",
                                 epoch, file, args.output_dir)
    finally:
        if metrics is not None:
            metrics.close()
    return state, losses


def _validate(state, vae, context_all, args, epoch, path, latent_fhw):
    """Sample the first two clips' captions with the current weights
    (reference L343-369), at the training clips' length and size, and write
    them as one grid GIF. On a mesh every rank samples the same two clips
    (the tp and sp collectives of the UNet need every rank), rank 0 writes.
    A VAE waiting on the host comes to the device for the sample and goes
    back."""
    on_host = state.device.type != next(vae.parameters()).device.type
    if on_host:
        vae.to(state.device)
    try:
        pipe = EEG2VideoPipeline(unet=state.unet, vae=vae, dtype=state.dtype)
        emb = context_all[:2].reshape(min(2, context_all.shape[0]), -1)
        gen = torch.Generator(device=state.device).manual_seed(args.seed + 10_000 + epoch)
        frames, h8, w8 = latent_fhw
        with sp_scope(state.mesh):
            vids = pipe(emb, emb.mean(dim=0), generator=gen, video_length=frames,
                        height=8 * h8, width=8 * w8, num_inference_steps=args.validation_steps,
                        guidance_scale=12.5)
    finally:
        if on_host:
            vae.to("cpu")
    if is_host0():
        save_videos_grid(vids.cpu().numpy(), path, encoder=args.gif_encoder)


def main(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    remat = True
    if args.config:
        import yaml

        with open(args.config) as f:
            remat = apply_reference_config(args, yaml.safe_load(f))
    init_distributed(args.device)  # a launcher's group, if any, before anything else
    device = resolve_device(args.device)  # fail before loading anything
    mesh = mesh_from_args(args, device)
    if mesh is not None and not mesh.active:
        return 0

    ucfg = UNet3DConfig()
    # dataset: block-0 clips in presentation order + caption embeddings
    # (reference L185-214; one embedding per clip)
    paths = [os.path.join(args.video_dir, f"{i + 1}.mp4")
             for i in range(meta.N_CONCEPTS * meta.N_REPS)]
    paths = [p_ for p_ in paths if os.path.exists(p_)]
    text_emb = load_array(args.text_embeddings).reshape(-1, 77, 768).astype(np.float32)
    ds = VideoClipDataset(paths, np.arange(len(paths)))
    log.info("dataset: %d clips", len(ds))
    if len(ds) == 0:
        raise SystemExit(f"no clips ({{1..}}.mp4) under {args.video_dir}")

    # the initial weights are a function of --seed, as JAX's init key makes
    # them: every rank of a mesh starts from the same ones
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        unet = UNet3DConditionModel(ucfg)
    gen = torch.Generator().manual_seed(args.seed)
    if args.unet_torch:
        unet.load_state_dict(unet3d_from_torch_2d(
            ckpt.load_torch_state_dict(args.unet_torch), unet, gen), strict=True)
    elif not args.unet_ckpt:
        log.warning("training from random init (no --unet_torch/--unet_ckpt)")

    vcfg, vae_sd = load_vae_state(args.vae)
    vae = AutoencoderKL(vcfg)
    vae.load_state_dict(vae_sd, strict=True)

    pixels_all, prompt_idx = ds.load_all()
    train(unet, vae, pixels_all, text_emb[prompt_idx], args,
          cfg=VideoDiffusionTrainConfig(
              learning_rate=args.learning_rate, remat=remat, use_8bit_adam=args.use_8bit_adam,
              gradient_accumulation_steps=args.gradient_accumulation_steps), mesh=mesh)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
