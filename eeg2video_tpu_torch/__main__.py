"""``python -m eeg2video_tpu_torch [<command> ...]``: the catalog of the
port's stage CLIs and their dispatcher (each also runs on its own as
``python -m eeg2video_tpu_torch.cli.<name>``).

Counterpart of ``eeg2video_tpu/__main__.py`` (``COMMANDS`` :14-56): the
stages in pipeline order, each with its reference counterpart. With no
command it prints the catalog and returns 0; an unknown command returns 2.
"""

import importlib
import sys

# (command, reference counterpart, one-liner) in pipeline order
COMMANDS = [
    ("segment_raw_signals_200hz", "EEG_preprocessing/segment_raw_signals_200Hz.py",
     "raw (7,62,T) EEG -> (7,40,5,62,400) 2 s segments (--bandpass on the card)"),
    ("segment_sliding_window", "EEG_preprocessing/segment_sliding_window.py",
     "2 s segments -> (7,40,5,7,62,100) 500 ms sliding windows"),
    ("extract_de_psd_features", "EEG_preprocessing/extract_DE_PSD_features_*.py",
     "DE/PSD band power (--mode 1per2s|1per500ms|1per1s)"),
    ("extract_gif", "EEG2Video/extract_gif.py",
     "block mp4s -> per-clip 6-frame 288x512 GIFs"),
    ("eegvp_train_test", "EEG-VP/EEG_VP_train_test.py",
     "40-class EEG-VP benchmark (7-fold leave-one-block-out)"),
    ("train_glmnet", "README GLMNet branch contract",
     "GLMNet encoder training (--scheduler/--min_lr, train-split norm)"),
    ("inference_glmnet", "README GLMNet branch contract",
     "GLMNet encoder evaluation"),
    ("generate_video_latents", "EEG2Video_New/Seq2Seq/generate_*latent*.py",
     "GIF frames -> VAE latents (train 1200 / test 200)"),
    ("train_seq2seq_v2", "EEG2Video_New/Seq2Seq/my_autoregressive_transformer.py",
     "EEG->latent Seq2Seq training (--normalize/--stats_path)"),
    ("inference_seq2seq_v2", "same, eval block",
     "Seq2Seq rollout -> latent_out_block7_40_classes.npy"),
    ("generate_text_emb", "EEG2Video_New/Semantic (targets)",
     "CLIP text embeddings per block + negative.npy (local CLIP files)"),
    ("train_semantic", "EEG2Video_New/Semantic/eeg_text.py",
     "DE features -> 77*768 semantic predictor (--legacy variant)"),
    ("inference_semantic", "checkpoints/Semantic usage",
     "semantic embeddings for the test block (--int8)"),
    ("compute_optical_flow",
     "(no producer in the reference: its score table ships as dataset meta)",
     "GIF clips -> All_video_optical_flow_score.npy motion scores"),
    ("add_noise", "EEG2Video_New/DANA/add_noise.py",
     "DANA optical-flow-conditioned noising (--replicate_label_bug)"),
    ("train_tuneavideo", "EEG2Video_New/Generation/train_finetune_videodiffusion.py",
     "video-diffusion fine-tune (reference YAML schema, --use_8bit_adam)"),
    ("inference_eeg2video", "EEG2Video_New/Generation/inference_eeg2video.py",
     "semantic emb (+ Seq2Seq/DANA latents) -> GIFs (--woSeq2Seq/--woDANA/--legacy)"),
    ("run_metrics", "40_class_run_metrics.py",
     "SSIM/PSNR/hue/MSE + CLIP/ViT/VideoMAE classification metrics"),
    ("serve", "(no reference counterpart: the serving surface)",
     "warm-pipeline JSONL generation service (stdin/stdout or "
     "--listen TCP; --coalesce batches clips across requests)"),
    ("run_pipeline", "(no reference counterpart: its stages are run by hand)",
     "one-command orchestration of all stages, make-style skip/resume (--device)"),
]


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] in {c for c, _, _ in COMMANDS}:
        mod = importlib.import_module(f"eeg2video_tpu_torch.cli.{argv[0]}")
        # a stage's main may return its results (paths, metrics): only an
        # int is an exit status
        rc = mod.main(argv[1:])
        return rc if type(rc) is int else 0
    prog = "python -m eeg2video_tpu_torch"
    print(f"usage: {prog} <command> [args]   (or python -m eeg2video_tpu_torch.cli.<command>)")
    print("\nPipeline stages (reference counterpart in parentheses):\n")
    for cmd, ref, desc in COMMANDS:
        print(f"  {cmd:28s} {desc}")
        print(f"  {'':28s}   ({ref})")
    if argv:
        print(f"\nunknown command: {argv[0]}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
