"""CLI: one-command orchestration of the whole EEG -> video pipeline.

Counterpart of ``eeg2video_tpu/cli/run_pipeline.py``. It chains the port's
stage CLIs in dependency order with consistent paths, make-style: a stage
whose declared outputs already exist is skipped (``--force`` reruns), so a
failed or preempted run resumes where it left off. The declared outputs are
the files the port's CLIs write (``.pt`` state dicts where the JAX package
writes orbax directories), and ``--device`` (default ``cuda``; ``cpu`` for a
dry run) goes to every stage CLI that takes one.

Stage graph (each delegates to ``eeg2video_tpu_torch.cli.<name>``, so every
flag documented there still applies via ``--extra``):

    segment            raw EEG -> (7,40,5,62,400) 2 s segments
    de_psd             DE/PSD 1per2s features (semantic input)
    gif                block mp4s -> per-clip GIFs
    latents            GIFs -> VAE latents (train 1200 + test 200)
    text_emb           captions -> CLIP text embeddings + negative.npy
    semantic           train + infer the semantic predictor
    seq2seq            train + infer the EEG->latent Seq2Seq
    flow               GIFs -> optical-flow score table
    dana               DANA noising of the Seq2Seq latents
    finetune           video-diffusion fine-tune (needs mp4s + SD weights)
    generate           semantic embeddings (+ latents) -> GIFs
    metrics            SSIM/MSE/... vs ground-truth GIFs

Optional benchmark side-chains (selectable via ``--stages``, not run by
default): ``sw`` (500 ms sliding windows), ``de_sw`` (DE/PSD 1per500ms),
``de_1per1s``, ``eegvp`` (the 7-fold classification benchmark), ``glmnet``.

``--stages`` selects a subset (dependencies are NOT added: earlier stage
outputs must exist); ``--dry_run`` logs the resolved per-stage argv without
running anything.
"""

import argparse
import importlib
import os

from ..convert.export_diffusion import WEIGHTS_NAME
from ..utils import get_logger, resolve_device

log = get_logger(__name__)

# the stage CLIs without a --device flag (they compute on the host)
_HOST_ONLY = {"extract_gif", "segment_sliding_window"}


def _complete(path):
    """A declared output counts as present only if it is a file, or a
    NON-EMPTY directory: stage CLIs may create their out_dir before doing any
    work, and an empty dir left by a failed run must not make resume skip the
    stage forever."""
    if not os.path.exists(path):
        return False
    if os.path.isdir(path):
        return bool(os.listdir(path))
    return True


def _stage_list(a):
    """The ordered stage table: (name, cli module, argv, outputs)."""
    data, out, sub = a.data_root, a.out_root, a.sub
    pre = os.path.join(data, "Preprocessing")
    seg = os.path.join(pre, "Segmented_Rawf_200Hz_2s")
    gifs = os.path.join(data, "Video_gifs")
    flow = os.path.join(data, "meta_info", "All_video_optical_flow_score.npy")
    semantic_out = os.path.join(out, "semantic")
    seq2seq_out = os.path.join(out, "seq2seq")
    emb = os.path.join(semantic_out, "semantic_embeddings.npy")
    s2s_latents = os.path.join(seq2seq_out, "latent_out_block7_40_classes.npy")
    dana_latents = os.path.join(out, "dana", "40_classes_latent_add_noise.pt")
    gen_dir = os.path.join(out, "generated")
    tune = os.path.join(out, "tuneavideo")
    glmnet = os.path.join(out, "glmnet")

    stages = [
        ("segment", "segment_raw_signals_200hz",
         ["--eeg_root", os.path.join(data, "EEG"), "--output_dir", seg,
          "--subs", str(sub)],
         [os.path.join(seg, f"sub{sub}.npy")]),
        ("de_psd", "extract_de_psd_features",
         ["--mode", "1per2s", "--raw_dir", seg,
          "--de_dir", os.path.join(pre, "DE_1per2s"),
          "--psd_dir", os.path.join(pre, "PSD_1per2s"), "--subs", str(sub)],
         [os.path.join(pre, "DE_1per2s", f"sub{sub}.npy")]),
        ("gif", "extract_gif",
         ["--video_dir", os.path.join(data, "Video"), "--out_root", gifs],
         [os.path.join(gifs, "Block6")]),
        ("latents", "generate_video_latents", None, None),  # two runs, below
        ("text_emb", "generate_text_emb",
         ["--captions_dir", os.path.join(data, "BLIP"),
          "--torch_clip", a.torch_clip or "", "--tokenizer", a.tokenizer or "",
          "--out_dir", os.path.join(data, "Text_embeddings"),
          "--negative_out", os.path.join(data, "negative.npy")],
         [os.path.join(data, "negative.npy")]),
        ("semantic", None, None, None),  # train + infer, below
        ("seq2seq", None, None, None),
        ("flow", "compute_optical_flow",
         ["--gif_dir", gifs, "--out", flow], [flow]),
        ("dana", "add_noise",
         ["--latents", s2s_latents, "--flow_scores", flow,
          "--out", dana_latents], [dana_latents]),
        # the train state, and the diffusers layout that generate loads
        ("finetune", "train_tuneavideo",
         ["--video_dir", os.path.join(data, "Video_mp4", "Block0"),
          "--text_embeddings", os.path.join(data, "Text_embeddings", "block0.pt"),
          "--vae", a.vae, "--output_dir", tune]
         + (["--unet_torch", a.unet_torch] if a.unet_torch else []),
         [os.path.join(tune, "ckpt"), os.path.join(tune, "unet", WEIGHTS_NAME)]),
        ("generate", "inference_eeg2video",
         ["--embeddings", emb, "--unet", tune,
          "--vae", a.vae, "--seq2seq_latents", s2s_latents,
          "--dana_latents", dana_latents, "--out_dir", gen_dir]
         + (["--woSeq2Seq"] if a.woSeq2Seq else [])
         + (["--woDANA"] if a.woDANA else []),
         [gen_dir]),
        ("metrics", "run_metrics",
         ["--pred_dir", gen_dir, "--gt_dir", os.path.join(gifs, "Block6"),
          "--out", os.path.join(out, "metrics.json")],
         [os.path.join(out, "metrics.json")]),
        # --- optional benchmark stages (not in DEFAULT_STAGES; select with
        # --stages): the EEG-VP classification benchmark and the GLMNet
        # encoder, which need the sliding-window feature variants ---
        ("sw", "segment_sliding_window",
         ["--input_dir", seg,
          "--output_dir", os.path.join(pre, "Segmented_500ms_sw")],
         [os.path.join(pre, "Segmented_500ms_sw", f"sub{sub}.npy")]),
        ("de_sw", "extract_de_psd_features",
         ["--mode", "1per500ms",
          "--raw_dir", os.path.join(pre, "Segmented_500ms_sw"),
          "--de_dir", os.path.join(pre, "DE_1per500ms"),
          "--psd_dir", os.path.join(pre, "PSD_1per500ms"), "--subs", str(sub)],
         [os.path.join(pre, "DE_1per500ms", f"sub{sub}.npy")]),
        ("de_1per1s", "extract_de_psd_features",
         ["--mode", "1per1s", "--raw_dir", seg,
          "--de_dir", os.path.join(pre, "DE_1per1s"),
          "--psd_dir", os.path.join(pre, "PSD_1per1s"), "--subs", str(sub)],
         [os.path.join(pre, "DE_1per1s", f"sub{sub}.npy")]),
        ("eegvp", "eegvp_train_test",
         ["--feature_dir", os.path.join(pre, "DE_1per1s"),
          "--out_dir", os.path.join(out, "eegvp"), "--subs", str(sub)],
         [os.path.join(out, "eegvp")]),
        ("glmnet", "train_glmnet",
         ["--raw_dir", os.path.join(pre, "Segmented_500ms_sw"),
          "--de_dir", os.path.join(pre, "DE_1per500ms"), "--sub", str(sub),
          "--save_path", glmnet],
         [os.path.join(glmnet, "ckpt")]),  # written after the last epoch
    ]

    # composite stages (multiple CLI invocations)
    feats = os.path.join(pre, "DE_1per2s", f"sub{sub}.npy")
    semantic_pt = os.path.join(semantic_out, "semantic.pt")
    seq2seq_pt = os.path.join(seq2seq_out, "seq2seq.pt")
    composite = {
        "latents": [
            ("generate_video_latents",
             ["--gif_root", gifs, "--vae", a.vae, "--blocks"]
             + [str(b) for b in range(6)]
             + ["--out", os.path.join(data, "1200_latent.npy")],
             [os.path.join(data, "1200_latent.npy")]),
            ("generate_video_latents",
             ["--gif_root", gifs, "--vae", a.vae, "--blocks", "6",
              "--out", os.path.join(data, "40classes_latents.pt")],
             [os.path.join(data, "40classes_latents.pt")]),
        ],
        "semantic": [
            ("train_semantic",
             ["--features", feats,
              "--text_dir", os.path.join(data, "Text_embeddings"),
              "--save_path", semantic_out, "--epochs", str(a.semantic_epochs)],
             [semantic_pt]),
            ("inference_semantic",
             ["--features", feats, "--ckpt", semantic_pt,
              "--scaler", os.path.join(semantic_out, "scaler.npz"),
              "--out", emb], [emb]),
        ],
        "seq2seq": [
            ("train_seq2seq_v2",
             ["--eeg", os.path.join(seg, f"sub{sub}.npy"),
              "--train_latents", os.path.join(data, "1200_latent.npy"),
              "--test_latents", os.path.join(data, "40classes_latents.pt"),
              "--save_path", seq2seq_out, "--epochs", str(a.seq2seq_epochs)],
             [seq2seq_pt]),
            ("inference_seq2seq_v2",
             ["--eeg", os.path.join(seg, f"sub{sub}.npy"),
              "--train_latents", os.path.join(data, "1200_latent.npy"),
              "--test_latents", os.path.join(data, "40classes_latents.pt"),
              "--ckpt", seq2seq_pt, "--out", s2s_latents],
             [s2s_latents]),
        ],
    }
    resolved = []
    for name, mod, argv, outputs in stages:
        for mod_i, argv_i, outputs_i in composite.get(name, [(mod, argv, outputs)]):
            if mod_i not in _HOST_ONLY:
                argv_i = argv_i + ["--device", a.device]
            resolved.append((name, mod_i, argv_i, outputs_i))
    return resolved


DEFAULT_STAGES = ["segment", "de_psd", "gif", "latents", "text_emb",
                  "semantic", "seq2seq", "flow", "dana", "finetune",
                  "generate", "metrics"]
# selectable via --stages but not run by default (benchmark side-chains)
OPTIONAL_STAGES = ["sw", "de_sw", "de_1per1s", "eegvp", "glmnet"]


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0],
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data_root", default="./data")
    p.add_argument("--out_root", default="./outputs")
    p.add_argument("--sub", type=int, default=1)
    p.add_argument("--stages", nargs="*", default=None,
                   help=f"subset of {DEFAULT_STAGES} + optional "
                        f"{OPTIONAL_STAGES} (ordered automatically)")
    p.add_argument("--dry_run", action="store_true",
                   help="log the per-stage argv and skip/run decision only")
    p.add_argument("--force", action="store_true", help="rerun even if outputs exist")
    p.add_argument("--vae", default="./checkpoints/vae/ckpt")
    p.add_argument("--unet_torch", default=None,
                   help="2-D SD UNet state dict to inflate for the fine-tune")
    p.add_argument("--torch_clip", default=None, help="CLIPTextModel weights for text_emb")
    p.add_argument("--tokenizer", default=None, help="CLIPTokenizer path for text_emb")
    p.add_argument("--semantic_epochs", type=int, default=200)
    p.add_argument("--seq2seq_epochs", type=int, default=200)
    p.add_argument("--woSeq2Seq", action="store_true")
    p.add_argument("--woDANA", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="passed to every stage CLI that takes --device: the card "
                        "by default; 'cpu' for a dry run")
    p.add_argument("--extra", nargs="*", default=[],
                   help="stage:--flag[=value] passthroughs, e.g. "
                        "'finetune:--epochs=2' 'generate:--limit=4'. For "
                        "composite stages (latents/semantic/seq2seq) a "
                        "stage-name key applies to EVERY sub-command; key by "
                        "the sub-CLI module name instead to target one "
                        "(e.g. 'train_semantic:--epochs=50')")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not args.dry_run:
        resolve_device(args.device)  # fail before any stage runs

    selected = args.stages if args.stages else DEFAULT_STAGES
    unknown = set(selected) - set(DEFAULT_STAGES) - set(OPTIONAL_STAGES)
    if unknown:
        raise SystemExit(f"unknown stages: {sorted(unknown)}")

    extras = {}
    for e in args.extra:
        stage, _, flag = e.partition(":")
        extras.setdefault(stage, []).extend(flag.split("=", 1) if "=" in flag else [flag])

    plan = [(n, m, v + extras.get(n, []) + (extras.get(m, []) if m != n else []), outs)
            for n, m, v, outs in _stage_list(args) if n in selected]
    ran = []
    for name, mod, stage_argv, outputs in plan:
        done = outputs and all(_complete(o) for o in outputs) and not args.force
        tag = "skip (outputs exist)" if done else "run"
        log.info("[%s] %s: %s %s", tag, name, mod, " ".join(stage_argv))
        if args.dry_run or done:
            continue
        if name == "text_emb" and not (args.torch_clip and args.tokenizer):
            # the CLIP weights are external inputs; without them the stage's
            # required args would abort the whole pipeline mid-run
            log.warning("skip text_emb: requires --torch_clip and --tokenizer "
                        "(pre-place %s to satisfy downstream stages)", outputs)
            continue
        importlib.import_module(f"eeg2video_tpu_torch.cli.{mod}").main(stage_argv)
        missing = [o for o in (outputs or []) if not _complete(o)]
        if missing and (name in extras or mod in extras):
            # --extra flags can legitimately change what a stage emits
            # (e.g. gif:--blocks=0 produces only Block0); don't hard-fail
            log.warning("stage %s: declared outputs %s absent (stage has "
                        "--extra overrides; skip/resume won't trigger for it)",
                        name, missing)
        elif missing:
            raise SystemExit(f"stage {name} ({mod}) did not produce {missing}")
        ran.append((name, mod))
    log.info("pipeline complete: %d stage commands ran, %d skipped",
             len(ran), len(plan) - len(ran))
    return ran


if __name__ == "__main__":
    main()
