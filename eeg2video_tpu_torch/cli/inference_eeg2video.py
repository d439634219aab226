"""CLI: end-to-end EEG -> video generation in one shot, and the pipeline
loading that ``cli.serve`` shares.

Counterpart of ``eeg2video_tpu/cli/inference_eeg2video.py``. Contract of
reference EEG2Video_New/Generation/inference_eeg2video.py: semantic-embedding
file (200, 77*768); negative = its mean (L45); latent source ablations
--woSeq2Seq (fresh noise) / --woDANA (Seq2Seq latents) / default full model
(DANA latents); 100 DDIM steps, guidance 12.5, 6 frames @ 288x512 (L74-86);
GIFs via save_videos_grid. Clips are processed in batches (default 8 per
call) on one GPU instead of the reference's one-clip-per-call loop.
``--legacy`` encodes the EEG in the same run instead of reading
``--embeddings`` (reference EEG2Video/inference_eeg2video.py:38-65; see
``legacy_embeddings``).
"""

import argparse
import os

import numpy as np
import torch

from ..data import meta
from ..data.io import load_array
from ..data.video import AsyncVideoWriter, dispatch_ahead

from ..convert.export_diffusion import (load_diffusers_unet, load_diffusers_vae,
                                        load_torch_state_dict)
from ..diffusion.pipeline import EEG2VideoPipeline, latents_from_torch_layout
from ..models.unet3d import UNet3DConfig
from ..models.vae import VAEConfig
from ..serving.runtimes import load_semantic_state
from ..train.semantic import predict_semantic
from ..utils import StandardScaler, get_logger, resolve_device

log = get_logger(__name__)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _is_diffusers_dir(path, sub):
    return (os.path.exists(os.path.join(path, sub, "config.json"))
            or os.path.exists(os.path.join(path, "config.json")))


def _load_component(path, sub, default_config, load_dir):
    """(config, state dict) of one model: a diffusers ``save_pretrained``
    directory (read from its torch ``.bin``, by sub-folder as the reference's
    inference does), or a torch file holding a state dict in the port's key
    space at the default config."""
    if os.path.isdir(path):
        if _is_diffusers_dir(path, sub):
            return load_dir(path)
        raise ValueError(
            f"{path} is a directory without a diffusers config.json (an orbax "
            "checkpoint of the JAX package?): the port reads diffusers "
            "directories and torch state-dict files; carry a JAX tree across "
            "with eeg2video_tpu_torch/convert/from_jax.py and torch.save the result")
    if os.path.isfile(path):
        return default_config, load_torch_state_dict(path)
    raise FileNotFoundError(f"{sub} checkpoint not found: {path}")


def load_vae_state(vae_ckpt):
    """(VAEConfig, state dict) of a VAE checkpoint: a diffusers directory or
    a state-dict file of the port's ``AutoencoderKL``."""
    return _load_component(vae_ckpt, "vae", VAEConfig(), load_diffusers_vae)


def load_pipeline(unet_dir, vae_ckpt, dtype="bfloat16", device="cuda"):
    """Build the pipeline on ``device`` (the card unless the caller names the
    CPU) from checkpoints. Each of ``unet_dir`` and ``vae_ckpt`` may be a
    diffusers directory (the reference fine-tune's output,
    train_finetune_videodiffusion.py:376-382, or the JAX package's export) or
    a ``.pt`` state dict written from the port's own modules."""
    device = resolve_device(device)  # fail before reading anything
    ucfg, unet_sd = _load_component(unet_dir, "unet", UNet3DConfig(), load_diffusers_unet)
    vcfg, vae_sd = load_vae_state(vae_ckpt)
    return EEG2VideoPipeline.create(unet_sd, vae_sd, ucfg, vcfg,
                                    dtype=_DTYPES.get(dtype, dtype), device=device)


def legacy_embeddings(features_path, semantic_ckpt=None, torch_semantic=None,
                      hidden=10000, device="cuda"):
    """The legacy in-run EEG encoding -> (40, 77*768) embeddings.

    Reference EEG2Video/inference_eeg2video.py:38-65: every block
    GT-reordered, each clip's DE_1per1s windows averaged (the 310-dim
    features of ``train_semantic --legacy``), a StandardScaler fitted on the
    train blocks 0-5 at inference time (L61) and applied to the test block
    (L64), then the semantic MLP (the pipeline's ``_encode_eeg``, legacy
    pipeline_tuneeeg2video.py:149-150). As in the JAX package, the 200 window
    means of the test block are gathered with its 40 class indices, so 40
    rows come out. ``semantic_ckpt`` is the ``.pt`` that
    ``cli.train_semantic`` writes, ``torch_semantic`` the reference's."""
    device = resolve_device(device)  # fail before reading anything
    feats = load_array(features_path)  # (7, 40, 5, W, 62, 5)
    flat = feats.reshape(feats.shape[0], 40 * 5, -1, meta.N_CHANNELS * meta.N_BANDS)
    per_block = np.stack([meta.reorder_by_gt(flat[b].mean(axis=1), b)
                          for b in range(meta.N_BLOCKS)])
    scaler = StandardScaler().fit(per_block[:6].reshape(-1, per_block.shape[-1]))
    eeg = scaler.transform(per_block[6])
    sd = load_semantic_state(torch_semantic or semantic_ckpt, hidden)
    return predict_semantic(sd, eeg, device=device)


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--embeddings", default="./outputs/semantic/semantic_embeddings.npy")
    p.add_argument("--legacy", action="store_true",
                   help="legacy variant: run scaler -> CLIP MLP in this run on raw "
                        "DE features instead of loading precomputed embeddings "
                        "(reference EEG2Video/inference_eeg2video.py:38-65)")
    p.add_argument("--raw_features", default="./data/Preprocessing/DE_1per1s/sub1.npy",
                   help="(--legacy) per-subject DE_1per1s features")
    p.add_argument("--semantic_ckpt", default="./outputs/semantic/semantic.pt",
                   help="(--legacy) the semantic predictor's .pt (the port's keys, "
                        "as cli.train_semantic writes it)")
    p.add_argument("--torch_semantic", default=None,
                   help="(--legacy) the reference's eeg2text .pt instead of --semantic_ckpt")
    p.add_argument("--hidden", type=int, default=10000,
                   help="(--legacy) semantic MLP hidden width")
    p.add_argument("--limit", type=int, default=0,
                   help="generate only the first N clips (0 = all)")
    p.add_argument("--unet", default="./outputs/tuneavideo")
    p.add_argument("--vae", default="./checkpoints/vae/ckpt")
    p.add_argument("--seq2seq_latents", default="./outputs/seq2seq/latent_out_block7_40_classes.npy")
    p.add_argument("--dana_latents", default="./outputs/dana/40_classes_latent_add_noise.pt")
    p.add_argument("--woSeq2Seq", action="store_true", help="fresh-noise latents")
    p.add_argument("--woDANA", action="store_true", help="raw Seq2Seq latents")
    p.add_argument("--negative", default=None,
                   help="negative.npy CFG embedding; note the reference "
                        "pipeline's CFG negative is the committed "
                        "negative.npy artifact (pipeline_tuneeeg2video.py:167); "
                        "the default falls back to the embeddings' mean "
                        "(as the reference script does, inference_eeg2video.py:45)")
    p.add_argument("--out_dir", default=None)
    p.add_argument("--num_inference_steps", type=int, default=100)
    p.add_argument("--sampler", default="ddim", choices=("ddim", "dpm++"),
                   help="ddim = reference semantics (100 steps, "
                        "inference_eeg2video.py:74-86); dpm++ = "
                        "DPM-Solver++(2M) fast path (try "
                        "--num_inference_steps 20)")
    p.add_argument("--guidance_scale", type=float, default=12.5)
    p.add_argument("--height", type=int, default=288)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--video_length", type=int, default=6)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"],
                   help="compute dtype (reference inference is fp16, "
                        "inference_eeg2video.py:50-51; float32 is the parity "
                        "mode)")
    p.add_argument("--device", default="cuda",
                   help="where the models live: the card by default (fails "
                        "where there is none); 'cpu' for a dry run")
    p.add_argument("--seed", type=int, default=114514)
    p.add_argument("--gif_encoder", default="imageio",
                   choices=("imageio", "fast", "native"),
                   help="imageio = reference mimsave encode (parity default); "
                        "fast = shared-palette PIL encode; native = C++ "
                        "encoder (csrc/gif_encoder.cpp)")
    p.add_argument("--dp", type=int, default=0, help="(not ported: refused) multi-GPU")
    p.add_argument("--tp", type=int, default=1, help="(not ported: refused) multi-GPU")
    p.add_argument("--sp", type=int, default=1, help="(not ported: refused) multi-GPU")
    return p


def main(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    if args.dp or args.tp > 1 or args.sp > 1:
        p.error("--dp/--tp/--sp: multi-GPU generation is not ported; this entry "
                "point runs on one GPU")
    device = resolve_device(args.device)  # fail before reading anything

    if args.legacy:
        emb = legacy_embeddings(args.raw_features, args.semantic_ckpt, args.torch_semantic,
                                args.hidden, device)
        emb = emb.reshape(-1, 77 * 768).astype(np.float32)
    else:
        emb = load_array(args.embeddings).reshape(-1, 77 * 768).astype(np.float32)
    if args.negative:
        negative = load_array(args.negative).reshape(-1).astype(np.float32)
    else:
        # reference script L45: mean over ALL clips, computed before --limit
        # so a limited run reproduces the corresponding clips of a full run
        # (and --limit 1 doesn't collapse CFG to a no-op)
        negative = emb.mean(axis=0)
    if args.limit:
        emb = emb[:args.limit]

    if args.woSeq2Seq:
        latents, tag = None, "40_Classes_woSeq2Seq"
    elif args.woDANA:
        latents = latents_from_torch_layout(load_array(args.seq2seq_latents),
                                            frames=args.video_length)
        tag = "40_Classes_woDANA"
    else:
        latents = latents_from_torch_layout(load_array(args.dana_latents),
                                            frames=args.video_length)
        tag = "40_Classes_Fullmodel"
    out_dir = args.out_dir or f"./outputs/{tag}"

    pipe = load_pipeline(args.unet, args.vae, dtype=args.dtype, device=device)
    # created only after the pipeline loads: a failed load leaves no (empty)
    # out_dir for a make-style resume to mistake for a completed stage
    os.makedirs(out_dir, exist_ok=True)
    generate(pipe, emb, negative, latents, out_dir, args)


def generate(pipe, emb, negative, latents, out_dir, args):
    """Run ``emb`` (N, 77*768) through an already-built pipeline in batches of
    ``args.batch`` and write ``out_dir/<i>.gif``. GIF encodes run on writer
    threads, and each batch's device work is issued before the previous
    batch's transfer and encode. Fresh-noise latents (``latents`` None) come
    from a generator on the pipeline's device seeded by (seed, batch start)."""
    writer = AsyncVideoWriter(encoder=args.gif_encoder)

    def run(s):
        e = emb[s:s + args.batch]
        lat = None if latents is None else latents[s:s + args.batch]
        gen = torch.Generator(device=pipe.device).manual_seed(args.seed * 1000003 + s)
        return pipe(e, negative, latents=lat, generator=gen,
                    video_length=args.video_length, height=args.height,
                    width=args.width, num_inference_steps=args.num_inference_steps,
                    guidance_scale=args.guidance_scale, sampler=args.sampler), len(e)

    def flush(out, s):
        videos, m = out
        videos = videos.detach().float().cpu().numpy()
        for j in range(m):
            writer.submit(videos[j:j + 1], os.path.join(out_dir, f"{s + j}.gif"))
        log.info("clips %d..%d -> %s", s, s + m - 1, out_dir)

    try:
        dispatch_ahead(range(0, len(emb), args.batch), run, flush)
    finally:
        writer.close()


if __name__ == "__main__":
    main()
