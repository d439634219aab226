#!/usr/bin/env python3
"""Smoke check of the PyTorch + CUDA port (eeg2video_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA H100 and the
CUDA toolkit. It imports nothing of jax or of the JAX package. Phases, each
printed on its own line; any failure prints ``FAIL ...`` and exits 1:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compile every kernel from ``eeg2video_tpu_torch/csrc`` (and the
   host-side GIF encoder, so that no request pays for its build); the
   kernels of the main paths must be in the build log without spills (the
   temporal pair's staged route at the model's D = 40, 80, 160 and F = 6,
   bf16 and f32; ``geglu_out_bwd``; every kernel of the f32 feed-forward
   and GEGLU pairs; ``int8_dense`` at both of its widths, whose SASS must
   hold no conversion instruction; ``sos_filtfilt`` at 4 biquads);
3. kernels: each kernel (forward and backward) against its plain PyTorch
   version in f32 on the same inputs at the main paths' shapes (generation
   at batch 1 with guidance, the train step at batch 10), with its time, the plain version's
   time, the least time the card could take for the same work (``bound_ms``:
   the larger of operations / 989 TFLOP/s and bytes / 3.35 TB/s, each input
   read once and each output written once) and, where one PyTorch call
   computes the same function, that call's time (``library_ms``, a yardstick
   the port never calls); for the level-0 conv, which no single call
   computes, the cuDNN composition it fuses (``composed_ms``) and the bytes
   its blocks copy from L2, and every conv case run twice, bit for bit; the
   same for ``geglu_out`` (the cuBLAS composition, at each row count it
   runs at and at T = 1, 37, 130), whose rows of a T = 1728 call must equal
   the same rows inside a T = 3456 call, and for ``geglu_out_bwd`` (the
   cuBLAS composition g @ W -> the gate's backward in eager ops); the
   temporal pair at the train step's levels 0-2 and at 12 heads over 10
   frames, 10 heads, 8 heads over 32 frames (the kernels' any route), the
   attention at 12 heads of D = 53 (heads padded to 56 around the kernels);
   then the f32 counterparts (f32
   operands: the kernels JAX also runs at f32) at the same shapes, each within
   1e-4 of its plain version's max and bit for bit twice, bound_ms at the FP32
   rate without tensor cores (66.9 TFLOP/s), for the kernels on 3xTF32 (the
   f32 attention, feed-forward and GEGLU pairs) three tf32 products per
   operation at 494.7 TFLOP/s; the feed-forward pair's (T, I) / (T, 2I)
   intermediate, written and read once, counted in its bytes and printed;
   the f32 GEGLU pair's L2 bytes from its tiling; rows 0-1727 of a T = 3456
   f32 feed-forward call and of a T = 3456 f32 GEGLU call (forward and
   backward) held to a T = 1728 call bit for bit; the same yardsticks in f32;
   ``int8_dense`` at the semantic MLP's four layer shapes, each run twice
   bit for bit and held to F32_KERNEL_BOUND (its plain version has the same
   bf16 operands and f32 sums), with the bytes of x its blocks read from L2,
   and rows 0-6 of a 100-row call held to a 7-row call bit for bit;
4. UNet parity: a narrow UNet3D in bf16 with kernels on the card against the
   same weights through the plain versions in f32 on the CPU; then
   UNet3DConfig.tiny() in bf16 (C = 32: ``ff_ln`` on operands padded to its
   64-column grid) against its plain-patched self;
5. slice: two generation requests through ``EEG2VideoPipeline`` at full
   width (UNet3DConfig(), VAEConfig(), random weights from a seed), 4 DDIM
   steps, with per-UNet-forward launch counts of every kernel;
6. serve: the port's server, in-process, on ``--listen 127.0.0.1:0 --coalesce
   --max_batch 2 --semantic_int8 --sampler dpm++ --num_inference_steps 20
   --gif_encoder native --torch_seq2seq <file> --seq2seq_scaler <file>
   --flow_scores <table>`` with the
   same pipeline, a hidden=10000 int8 semantic MLP and a full-size Seq2Seq
   transformer; two client connections send feature and embedding requests,
   then requests that carry only raw EEG (a (2, 62, 400) segment stack; a
   whole (7, 40, 5, 62, 400) subject with one clip chosen; the woDANA and
   woSeq2Seq ablations), ping, stats and shutdown; GIFs are read back and
   launch counts checked; the file chain ``cli.inference_seq2seq_v2`` ->
   ``cli.add_noise`` on the same subject gives the server's DANA latents bit
   for bit; ``de_psd`` on the card against its float64 oracle;
7. the ``fused_attention`` op: one differentiable call on (B, H, L, D)
   operands, forward and backward launches counted, in bf16 and in f32;
8. f32 generation (the parity mode): one UNet3DConfig() forward of 2 samples
   at f32 through the f32 kernels (48 attention, 10 ``ff_ln``, 6 ``geglu_out``,
   no conv), against the same forward with the plain versions patched into
   ``models.attention3d`` (rtol 1e-3, atol 1e-4), then profiled;
9. train parity and train: a narrow train step and ``mask.grad`` via the
   kernels against the plain versions, the narrow step at 12 heads over 10
   frames, and the narrow step at f32;
   ``cli.train_tuneavideo.train`` at full width (three optimizer steps at
   batch 10, checkpoints, resume), one masked forward/backward with a soft
   ``attention_mask`` that asks for a gradient (the dbias launches counted),
   and ``cli.inference_eeg2video.main`` on the checkpoint the trainer wrote
   (fresh-noise and DANA latents, then ``--dtype float32``); then
   compute_dtype="float32" at full width: one optimizer step at batch 10
   (launches, seconds, peak memory), profiled, and one f32 masked step;
10. the rest of the training recipe, each line beside the card's name and
   power limit: ``train.semantic.train_semantic`` on ``SemanticPredictor()``
   (894.5M parameters), one epoch of 37 steps at batch 32 on 1200 seeded rows
   with f32 Adam and one with 8-bit Adam (s/step, peak memory, optimizer
   state bytes), then one 8-bit step on the card against the same step on
   the CPU from the same gradients and state (codes at most 1 apart,
   parameters within 1e-6 of the step's largest update) and the eager 8-bit
   step's share of a training step; ``cli.inference_semantic.main --int8`` on
   the trained weights (200 block-6 rows, ``int8_dense`` launched, cosine
   against the f32 MLP above 0.999); ``train.seq2seq.train_seq2seq`` on
   ``Seq2SeqTransformer()``, one epoch at batch 32 on 1200 seeded windows;
   ``cli.train_tuneavideo.train`` at UNet3DConfig(), batch 10,
   ``--use_8bit_adam --gradient_accumulation_steps 2``: two optimizer steps
   of two micro steps, each micro step launching what a plain step does, and
   the ``CheckpointSession``'s train state restored bit for bit;
   ``cli.generate_video_latents.encode_gifs`` on two seeded 6-frame 288x512
   GIFs with VAEConfig() in f32, one frame against the CPU's encode (rtol
   1e-3 / atol 1e-4).

11. the EEG front end at full size on seeded data, each line beside the
   card's name and power limit, its launch counts the ``preprocess`` path:
   (a) a (7, 62, 104000) float64 raw subject through
   ``segment_raw_signals_200hz.main --bandpass 0.5 47 --bandpass_order 4``
   (``sos_filtfilt`` in float32) and ``dsp.bandpass_filter`` on its float64
   values (``sos_filtfilt_f64``); both against ``scipy.signal.sosfiltfilt`` in
   float64 on the host (float32: 1e-3 of the output's max, since at a whole
   subject no float32 cascade, JAX's included, keeps the JAX test's atol 5e-4 +
   rtol 1e-3, whose outliers are counted and printed; float64: 1e-6), bit for
   bit against the plain version on the same inputs at full size (on the
   host's CPU), and against the plain version on the card at (434, 4000) (1e-4
   of the max, twice bit for bit), with times, the bytes, operations and
   recursion-latency bounds and the scipy yardstick; (b) ``segment_sliding_window.main``, then
   ``extract_de_psd_features.main`` in modes 1per500ms and 1per1s (also
   ``--f32``); (c) ``train_glmnet.main`` at emb_dim 256 (8400 windows, batch
   256, 2 epochs) and ``inference_glmnet.main`` -> (7, 40, 5, 7, 512), s/epoch
   and peak memory; (d) ``eegvp_train_test.main`` (glfnet_mlp, 5 epochs)
   serial and ``--fold_parallel``, equal per fold.
12. the trainer's saved residuals, evaluation and the native data path, each
   line beside the card's name and power limit: (a) the train step at
   UNet3DConfig(), batch 10, with the residuals kept (``remat_save_attn``,
   ``remat_save_convs``: the defaults) and recomputed, each twice,
   alternating, 4 optimizer steps a run from the same seeded weights:
   s/step (the median of the 3 after a warm-up), peak memory, every step's
   launches checked (kept: each forward kernel once per call site), the first
   loss bit for bit in all four runs, and the parameters of the two settings
   within 2x the gap between two runs of one setting; (b) ``score_clips`` on
   one block (200 clips of 6 x 288 x 512 moving by known shifts, chunk 25):
   seconds a block, the bytes of one level-0 Jacobi iteration and their
   bound, 4 clips against the host's CPU (1e-5 relative); (c) SSIM, MSE,
   PSNR and hue over 1200 frame pairs at 288 x 512, 12 against the CPU
   (5e-5); (d) ``extract_gif.main`` on one concept's mp4 where cv2 can write
   one, then ``compute_optical_flow.main`` and ``run_metrics.main`` on its 5
   GIFs, the GIF decoding timed apart; (e) ``NpyBatchLoader`` gather rates on
   a ~1 GB float32 .npy, and whether the clip decoder links
   here (it needs opencv4 through pkg-config; where it does not, the line
   says so and why).
13. the text path, DDIM inversion and the orchestration, each line beside
   the card's name and power limit: (a) ``CLIPTextConfig()`` in f32 with
   seeded weights encoding 200 prompts (one caption file's worth; a tokenizer
   stand-in, crc32 of each word), timed, 4 rows against the host's CPU
   (1e-4 of the max); (b) ``TextToVideoPipeline`` at UNet3DConfig() /
   VAEConfig() bf16: one prompt, 6 frames at 288 x 512, 4 DDIM steps,
   guidance 12.5, every UNet call launching the generation kernels; (c)
   ``ddim_inversion`` of one clip's latents, 50 inverse steps on the empty
   prompt's context, seconds a step, launches, the first step's eps against
   the same UNet call with every plain version in place (conv included;
   5e-2 of the norm), that call profiled, and ``inverse_step`` undoing
   ``step`` on the card (the kernels phase also holds every kernel at the
   inversion's batch-1 shapes); the MFU of (b)'s UNet call and (c)'s step at the
   989 TFLOP/s peak (``utils/flops.py``); (d) ``generate_text_emb``'s caption
   loop on three small caption files (shapes, float16 negative.npy), whether
   ``transformers`` imports, then the six 200-caption blocks for (e); (e)
   ``run_pipeline --stages segment de_psd semantic generate metrics
   --woSeq2Seq`` in a temporary data_root (a seeded raw subject, the caption
   embeddings, one ground-truth GIF, the seeded UNet in the fine-tune's
   diffusers layout and the VAE as a .pt), each stage's seconds and
   launches, then the same command again, which must skip every stage;
14. multi-GPU generation on one card (NCCL refuses two ranks on one
   device): (a) the ring's forward hops (sp = 2 and 4 played by rotating a
   list of K/V blocks) and a tp rank's residual-free ``ff_ln``; (b)
   ``inference_eeg2video --dp 1`` (a world of one over NCCL) bit-equal to no
   mesh; (c) a torchrun launch of it;
15. multi-GPU training on one card: (a) the ring's backward hops
   (``ring_bwd_step``) at the fine-tune's level-0 shapes, sp = 2 and 4 played
   by rotating the K/V blocks with their dk / dv / dbias accumulators, each
   rank's dq rows and each home block against the plain backward (f32,
   chunked over the batch), and one whole-KV ``flash_attention_bwd``; (b)
   ``ff_ln_bwd`` / ``ff_ln_bwd_f32`` with ``residual=False`` at the tp = 2 and
   4 shard widths of levels 0-1, beside the composed cuBLAS form and the
   bound, launched once by the residual-free ``feed_forward``'s backward; (c)
   ``train_tuneavideo.train`` on a ``--dp 1 --fsdp`` mesh at UNet3DConfig(),
   batch 10, three steps, its losses and masters bit-equal to the same call
   without a mesh.
16. multi-GPU serving and the semantic trainer's meshes on one card, each
   line beside the card's name and power limit: (a) ``cli.serve`` on a
   ``--dp 1 --coalesce --max_batch 2 --semantic_int8`` mesh (a world of one
   over NCCL; rank 0's dispatcher sends each dispatch over the control and
   the mesh's groups) at UNet3DConfig() / VAEConfig(), a features request of
   2 clips through the hidden=10000 int8 MLP, 4 DDIM steps, bit-equal to the
   same server without a mesh, launches counted; then a torchrun launch of
   ``serve --dp 1 --listen 127.0.0.1:0`` driven by a client over the socket
   (ready line, one request, stats, shutdown, exit 0); (b) ``gpipe_apply`` at
   pp = 1, n_micro = 8 on SemanticPredictor()'s hidden stack at batch 32:
   loss and gradients against the unpipelined step, s/step of each; (c)
   ``train_semantic`` through its tp branch at tp = 1, 8 steps at full
   width, bit-equal to no mesh.
17. the last multi-GPU paths on one card, each line beside the card's name
   and power limit: (a) ``train_glmnet.main --dp 1`` (a world of one over
   NCCL) at section 11's subject shape (8400 windows, emb_dim 256, batch 256,
   2 epochs), its checkpoint and losses bit-equal to no mesh, s/epoch; (b)
   ``run_benchmark(fold_parallel=True)`` on a fold mesh of one rank, every
   fold bit-equal to the batched path on a (7, 40, 5, 2, 62, 5) subject; (c)
   ``train_tuneavideo.train`` on a ``--dp 1 --fsdp`` mesh through the
   per-use gather at UNet3DConfig(), batch 10, three steps and a validation
   sample, losses and masters bit-equal to section 15 (c)'s run without a
   mesh, section 15's launches, peak memory; the kernels line gains
   ``launches_fsdp_gather_path``.

The third-to-last line is a JSON object with one entry per kernel, then the
``nvidia-smi`` line; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
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
PEAK_F32_FLOPS = 66.9e12       # H100 SXM, FP32 without tensor cores (NVIDIA data sheet)
PEAK_TF32_FLOPS = 494.7e12     # H100 SXM, TF32 dense on the tensor cores (NVIDIA data sheet)
# the f32 kernels on 3xTF32: three tf32 products for each f32 one, which
# bound_ms counts at that rate
TF32_PASSES = 3
TF32X3_KERNELS = ("flash_attention_fwd_f32", "flash_attention_bwd_f32",
                  "fused_attention_fwd_f32", "fused_attention_bwd_f32",
                  "ff_ln_f32", "ff_ln_bwd_f32", "geglu_out_f32", "geglu_out_bwd_f32")
# the kernels of csrc/ff_f32.cu (ff_ln_f32: stats, gate, out; ff_ln_bwd_f32:
# stats, dh2, dxa, the LayerNorm backward's row pass)
FF_F32_KERNELS = ("ff_f32_ln_stats_kernel", "ff_f32_gate_kernel", "ff_f32_out_kernel",
                  "ff_f32_bwd_ln_stats_kernel", "ff_f32_bwd_dh2_kernel", "ff_f32_bwd_dxa_kernel",
                  "ff_f32_bwd_ln_kernel")
# the kernels of csrc/geglu_f32.cu (geglu_out_f32: the gate's row pass, the
# out GEMM over runs of K, the partials' sum; geglu_out_bwd_f32: one kernel)
GEGLU_F32_KERNELS = ("geglu_f32_gate_kernel", "geglu_f32_out_kernel", "geglu_f32_sum_kernel",
                     "geglu_f32_bwd_kernel")
PEAK_BYTES = 3.35e12           # H100 SXM, HBM3 bytes/s
KERNEL_BOUND = 1e-2            # max|kernel - plain_f32| / max|plain_f32|
F32_KERNEL_BOUND = 1e-4        # the f32 kernels: summation order and the 3xTF32 split only
F32_UNET_RTOL, F32_UNET_ATOL = 1e-3, 1e-4  # f32 UNet via the f32 kernels vs via plain
F32_TRAIN_BOUND = 1e-3         # f32 loss and gradients via the f32 kernels vs via plain
UNET_BOUND = 5e-2              # ||bf16 card - f32 cpu|| / ||f32 cpu||
TRAIN_BOUND = 5e-2             # ||grad via kernels - grad via plain|| / ||grad via plain||
TRAIN_BATCH, TRAIN_STEPS = 10, 3
# per UNet forward at UNet3DConfig(), 6 frames of 36x64 latents (JAX trace):
# 16 transformers x (frames 0-1 + frames 2-5 + cross) attention calls;
# ff_ln at the 320/640 levels, geglu_out at 1280; 13 level-0 convs
EXPECTED_PER_FORWARD = {"flash_attention_fwd": 48, "ff_ln": 10,
                        "geglu_out": 6, "conv3x3_gn_silu": 13}
# every launch counter of ops._build (the f32 counterparts last)
BF16_COUNTERS = ("flash_attention_fwd", "flash_attention_bwd", "flash_attention_bwd_dbias",
                 "fused_attention_fwd", "fused_attention_bwd", "temporal_attention_fwd",
                 "temporal_attention_bwd", "ff_ln", "ff_ln_bwd", "geglu_out", "geglu_out_bwd")
F32_COUNTERS = tuple(f"{k}_f32" for k in BF16_COUNTERS)
COUNTERS = (*BF16_COUNTERS, "conv3x3_gn_silu", "int8_dense", *F32_COUNTERS, "sos_filtfilt",
            "sos_filtfilt_f64")
# an f32 forward: the same attention and feed-forward calls on the f32
# kernels; its convs take the library's (JAX: conv2d.py:131 sends f32 to XLA)
EXPECTED_F32_PER_FORWARD = {"flash_attention_fwd_f32": 48, "ff_ln_f32": 10, "geglu_out_f32": 6}
EXPECTED_CONV_STATS = 2
# per train step: 16 transformer blocks, each attn1 = 2 attention calls
# (frames 0-1, frames 2-5), attn2 = 1, one feed-forward, one temporal
# attention. The 10 blocks of levels 0 and 1 (C = 320, 640: ff_ln) are
# recomputed in the backward, but they keep their kernels' outputs
# (remat_save_attn, JAX's flash_out / ff_out), so every forward kernel
# launches once per call site, as in JAX's step; the 6 of level 2 and mid
# (C = 1280: geglu_out) are not recomputed. Every block launches each
# backward kernel once. Training takes the library convolution.
_TRAIN_STEP = {
    "flash_attention_fwd": 3 * 16, "flash_attention_bwd": 3 * 16,
    "temporal_attention_fwd": 16, "temporal_attention_bwd": 16,
    "ff_ln": 10, "ff_ln_bwd": 10, "geglu_out": 6, "geglu_out_bwd": 6}
# the same step with remat_save_attn=False, remat_save_convs=False (section
# 12): the recomputed blocks launch their forwards a second time
_RECOMPUTE_STEP = {**_TRAIN_STEP, "flash_attention_fwd": 3 * (2 * 10 + 6),
                   "temporal_attention_fwd": 2 * 10 + 6, "ff_ln": 2 * 10}
EXPECTED_PER_TRAIN_STEP = {**dict.fromkeys(COUNTERS, 0), **_TRAIN_STEP}
# compute_dtype="float32": the same calls on the f32 kernels, 0 conv
EXPECTED_F32_PER_TRAIN_STEP = {**dict.fromkeys(COUNTERS, 0),
                               **{f"{k}_f32": n for k, n in _TRAIN_STEP.items()}}
# a masked step: of each block's three backward launches the self (frames
# 0-1) and the two-segment (frames 2-5) call carry the mask's bias and write
# its gradient; cross-attention has no bias
EXPECTED_DBIAS_PER_MASKED_STEP = 2 * 16
TRAIN_ONLY_KERNELS = ("flash_attention_bwd", "temporal_attention_fwd", "temporal_attention_bwd",
                      "ff_ln_bwd", "geglu_out_bwd")
FUSED_OP_KERNELS = ("fused_attention_fwd", "fused_attention_bwd")
# the path that reads each f32 kernel's launches: the full-width f32
# generation forward, the f32 train step, the f32 fused_attention calls
F32_GENERATION_KERNELS = ("flash_attention_fwd_f32", "ff_ln_f32", "geglu_out_f32")
DE_BOUND = 1e-3               # worst relative error of de_psd's psd against the f64 oracle
INT8_LAYERS = 5               # int8_dense launches per 100-row chunk: fc0..fc3, out
INT8_WIDTHS = (8, 104)        # x rows a block of int8_dense (csrc/int8_plan.cuh kWidths)
KERNEL_SOURCES = {
    "flash_attention_fwd": ("eeg2video_tpu_torch/csrc/flash_attention.cu",
                            "eeg2video_tpu/ops/attention.py:415 _packed_single_kernel, "
                            ":566 _packed_dual_kernel"),
    "flash_attention_bwd": ("eeg2video_tpu_torch/csrc/flash_attention_bwd.cu",
                            "eeg2video_tpu/ops/attention.py:1021 _packed_dqkv_kernel, "
                            ":902 _packed_dq_kernel, :957 _packed_dkv_kernel (with dbias), "
                            ":789 _flash_attention_dual_bwd"),
    "fused_attention_fwd": ("eeg2video_tpu_torch/csrc/flash_attention_bhld.cu",
                            "eeg2video_tpu/ops/attention.py:75 _flash_kernel"),
    "fused_attention_bwd": ("eeg2video_tpu_torch/csrc/flash_attention_bhld.cu",
                            "eeg2video_tpu/ops/attention.py:118 _flash_dq_kernel, "
                            ":147 _flash_dkv_kernel"),
    "temporal_attention_fwd": ("eeg2video_tpu_torch/csrc/temporal_attention.cuh",
                               "eeg2video_tpu/ops/temporal.py:81 _temporal_fwd_kernel"),
    "temporal_attention_bwd": ("eeg2video_tpu_torch/csrc/temporal_attention.cuh",
                               "eeg2video_tpu/ops/temporal.py:95 _temporal_bwd_kernel"),
    "ff_ln": ("eeg2video_tpu_torch/csrc/ff_ln.cu",
              "eeg2video_tpu/ops/geglu.py:213 _ff_kernel"),
    "ff_ln_bwd": ("eeg2video_tpu_torch/csrc/ff_ln_bwd.cu",
                  "eeg2video_tpu/ops/geglu.py:280 _ff_bwd_kernel"),
    "geglu_out": ("eeg2video_tpu_torch/csrc/geglu_out.cu",
                  "eeg2video_tpu/ops/geglu.py:59 _geglu_kernel"),
    "geglu_out_bwd": ("eeg2video_tpu_torch/csrc/geglu_out_bwd.cu",
                      "eeg2video_tpu/ops/geglu.py:113 _geglu_bwd_kernel"),
    "conv3x3_gn_silu": ("eeg2video_tpu_torch/csrc/conv3x3.cu",
                        "eeg2video_tpu/ops/conv2d.py:48 _conv3x3_t_kernel"),
    "int8_dense": ("eeg2video_tpu_torch/csrc/int8_dense.cu",
                   "eeg2video_tpu/ops/int8_dense.py:62 _int8_dense_kernel"),
    # the f32 counterparts: the JAX package runs these Pallas kernels on f32
    # operands too (its attention, feed-forward and temporal dispatch tests no dtype)
    "flash_attention_fwd_f32": ("eeg2video_tpu_torch/csrc/flash_f32.cu",
                                "eeg2video_tpu/ops/attention.py:1282 _flash_fwd_packed "
                                "(:415, :487), :643 _flash_dual_fwd_packed (:566)"),
    "flash_attention_bwd_f32": ("eeg2video_tpu_torch/csrc/flash_f32_bwd.cu",
                                "eeg2video_tpu/ops/attention.py:1114 _flash_bwd_packed (:902, "
                                ":957 with dbias :1005-1018, :1021), :789 "
                                "_flash_attention_dual_bwd"),
    "fused_attention_fwd_f32": ("eeg2video_tpu_torch/csrc/flash_f32.cu",
                                "eeg2video_tpu/ops/attention.py:216 _flash_fwd (:75)"),
    "fused_attention_bwd_f32": ("eeg2video_tpu_torch/csrc/flash_f32_bwd.cu",
                                "eeg2video_tpu/ops/attention.py:269 _flash_bwd (:118, :147)"),
    "temporal_attention_fwd_f32": ("eeg2video_tpu_torch/csrc/temporal_attention.cuh",
                                   "eeg2video_tpu/ops/temporal.py:158 _temporal_fwd_pallas (:81)"),
    "temporal_attention_bwd_f32": ("eeg2video_tpu_torch/csrc/temporal_attention.cuh",
                                   "eeg2video_tpu/ops/temporal.py:179 _temporal_bwd_pallas (:95)"),
    "ff_ln_f32": ("eeg2video_tpu_torch/csrc/ff_f32.cu",
                  "eeg2video_tpu/ops/geglu.py:242 _ff_pallas (:213 _ff_kernel)"),
    "ff_ln_bwd_f32": ("eeg2video_tpu_torch/csrc/ff_f32.cu",
                      "eeg2video_tpu/ops/geglu.py:324 _ff_bwd_pallas (:280 _ff_bwd_kernel)"),
    "geglu_out_f32": ("eeg2video_tpu_torch/csrc/geglu_f32.cu",
                      "eeg2video_tpu/ops/geglu.py:87 _geglu_pallas (:59 _geglu_kernel)"),
    "geglu_out_bwd_f32": ("eeg2video_tpu_torch/csrc/geglu_f32.cu",
                          "eeg2video_tpu/ops/geglu.py:131 _geglu_bwd_pallas (:113)"),
}


def fail(msg):
    print(f"FAIL {msg}", flush=True)
    sys.exit(1)


def say(msg):
    print(msg, flush=True)


def timed_ms(fn, torch, reps):
    """Median of ``reps`` synchronized runs, CUDA events, after one warm-up;
    each run behind a spin of the device (attention_ab.PAD_CYCLES), so that
    the events time the device's work and not the host's enqueue."""
    from eeg2video_tpu_torch.utils.attention_ab import PAD_CYCLES

    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(PAD_CYCLES)
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
    log = build.build_log()
    secs = sorted(build.source_seconds(log).items(), key=lambda kv: -kv[1])
    say(f"build: seconds to each source's end, slowest first: "
        f"{', '.join(f'{name} {s:.1f}' for name, s in secs)}")
    # the attention, feed-forward, conv and geglu_out kernels' registers and
    # spills (-Xptxas -v)
    res = {k: v for k, v in build.kernel_resources(log).items()
           if k.startswith(("flash_", "ff_ln_kernel<", "ff_ln_bwd_kernel<", "conv3x3_",
                            "geglu_out_kernel", "geglu_out_bwd_kernel", "ff_f32_", "geglu_f32_",
                            "temporal_"))}
    spilled = {k: v for k, v in res.items() if v[1] or v[2]}
    say(f"build: {len(res)} attention (bf16 and f32), temporal, ff_ln, ff_ln_bwd, ff_f32, "
        f"conv3x3, geglu_out, geglu_out_bwd and geglu_f32 kernels, registers "
        f"(spill stores, loads in bytes): "
        f"{'; '.join(f'{k} {r} ({st}, {ld})' for k, (r, st, ld) in sorted(res.items()))}; "
        f"{len(spilled)} spill")
    # ff_ln_kernel<CT> and ff_ln_bwd_kernel<CT> serve C = 64 CT: the model's
    # C = 320 and 640 must not spill
    for name in ("ff_ln_kernel", "ff_ln_bwd_kernel"):
        for ct in (5, 10):
            if f"{name}<{ct}>" not in res or f"{name}<{ct}>" in spilled:
                fail(f"build: {name}<{ct}> (C = {64 * ct}) missing from build.log or spills")
    for name in ("conv3x3_kernel", "geglu_out_kernel"):
        found = [k for k in res if k.split("<")[0] == name]
        if len(found) != 1 or found[0] in spilled:
            fail(f"build: {name} is missing from build.log or spills: {found}")
    # the f32 feed-forward pair: each kernel of ff_f32.cu is one instance that
    # serves every C, the model's 320 and 640 among them
    # and the f32 GEGLU pair's, each one instance for every shape
    for name in (*FF_F32_KERNELS, *GEGLU_F32_KERNELS):
        if name not in res or name in spilled:
            fail(f"build: {name} missing from build.log or spills")
    # the temporal pair's staged route at the model's D = 40, 80 and 160
    # (H = 8) and F = 6, bf16 and f32: temporal_{fwd,bwd}_kernel<F, VEC,
    # steps, bytes a value>
    from eeg2video_tpu_torch.ops import temporal

    for d in (40, 80, 160):
        for itemsize in (2, 4):
            _, _, vec, iters = temporal.units_of(8, d, itemsize)
            for kind in ("fwd", "bwd"):
                name = f"temporal_{kind}_kernel<6,{vec},{iters},{itemsize}>"
                if name not in res or name in spilled:
                    fail(f"build: {name} (D = {d}, {itemsize}-byte values) missing from "
                         f"build.log or spills")
    # the f32 attention pair at the model's D = 40 and 80
    for name in ("flash_f32_fwd_kernel<{}>", "flash_f32_dq_kernel<{}>",
                 "flash_f32_dkv_kernel<{},0>", "flash_f32_dkv_kernel<{},1>"):
        for d in (40, 80):
            if name.format(d) not in res or name.format(d) in spilled:
                fail(f"build: {name.format(d)} missing from build.log or spills")
    # int8_dense at each x width it instantiates (csrc/int8_plan.cuh kWidths),
    # and its int8 -> bf16 step: byte permutes and f32 subtracts, no
    # conversion instruction in the SASS
    int8 = {k: v for k, v in build.kernel_resources(log).items()
            if k.startswith("int8_dense_kernel<")}
    say(f"build: int8_dense_kernel registers (spill stores, loads in bytes): "
        f"{'; '.join(f'{k} {r} ({st}, {ld})' for k, (r, st, ld) in sorted(int8.items()))}")
    for w in INT8_WIDTHS:
        name = f"int8_dense_kernel<{w}>"
        if name not in int8 or int8[name][1] or int8[name][2]:
            fail(f"build: {name} missing from build.log or spills")
    # the filtfilt recursion at the main path's 4 biquads (its float32 and float64
    # instantiations share the short name)
    sos = build.kernel_resources(log).get("sos_filtfilt_kernel<4,2,0>")
    say(f"build: sos_filtfilt_kernel<4,2,0> registers (spill stores, loads in bytes): {sos}")
    if sos is None or sos[1] or sos[2]:
        fail("build: sos_filtfilt_kernel<4,2,0> missing from build.log or spills")
    ops = build.sass_opcodes("int8_dense_kernel")
    if len(ops) != len(INT8_WIDTHS):
        fail(f"build: the SASS holds {len(ops)} int8_dense_kernel functions, "
             f"not {len(INT8_WIDTHS)}")
    for name, count in sorted(ops.items()):
        conv = {op: n for op, n in count.items() if op in build.CONVERSION_OPCODES}
        say(f"build: SASS of {name}: " + ", ".join(f"{op} {count[op]}" for op in (
            "LDSM", "LOP3", "PRMT", "FADD", "HGMMA") if op in count) + f"; conversions {conv}")
        if conv:
            fail(f"build: {name} converts with {conv}")


def kernel_cases(torch, dev, f32=False):
    """One dict per case: kernel, label, the kernel call, the plain call on
    f32 copies of ``args``, operations, an optional library call, primary?
    With ``f32`` the same shapes on f32 operands, which the f32 kernels take
    (named ``<kernel>_f32``; the conv and int8_dense have none), with the
    same yardsticks computed in f32."""
    import torch.nn.functional as F

    from eeg2video_tpu_torch.ops import _build, attention, conv2d, geglu, int8_dense, temporal
    from eeg2video_tpu_torch.utils.attention_ab import (conv_args, conv_composed, geglu_args,
                                                        geglu_bwd_composed, geglu_composed,
                                                        sdpa_views)

    g = torch.Generator(device=dev).manual_seed(0)
    dtype = torch.float32 if f32 else torch.bfloat16

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    cases = []

    def add(kernel, label, kern, plain, args, flops, library=None, primary=False,
            plain_takes_args=False, l2_bytes=None, composed=None, inter_bytes=None):
        if f32 and kernel in ("conv3x3_gn_silu", "int8_dense"):
            return
        cases.append(dict(kernel=kernel + ("_f32" if f32 else ""), label=label, kern=kern,
                          plain=plain, args=args, flops=flops, library=library, primary=primary,
                          plain_takes_args=plain_takes_args,
                          l2_bytes=l2_bytes, composed=composed,
                          inter_bytes=inter_bytes if f32 else None))

    def ff_inter(t, i, backward=False):
        """Bytes the f32 pair moves through its workspace (the (T, I) or
        (T, 2I) intermediate and the LayerNorm statistics), written once and
        read once."""
        return 2 * geglu.ff_f32_workspace_bytes(t, i, backward)

    def ff_composed(args):
        """layer_norm -> F.linear -> h gelu(g) -> F.linear + x in the operands'
        dtype (attention_ab's composition): a yardstick the port never calls."""
        x, gamma, beta, wp, bp, wo, bo = args
        c = x.shape[-1]
        vb = [v.to(dtype) for v in (gamma, beta, bp, bo)]

        def run(xl=x):
            h, gate = F.linear(F.layer_norm(xl, (c,), vb[0], vb[1]), wp, vb[2]).chunk(2, dim=-1)
            return F.linear(h * F.gelu(gate), wo, vb[3]) + xl
        return run

    def ff_bwd_composed(args):
        """The gradient in x of that composition (autograd), its forward included."""
        x, dout, gamma, beta, wp, bp, wo = args
        fwd = ff_composed([x, gamma, beta, wp, bp, wo, torch.zeros_like(gamma)])

        def run():
            xl = x.detach().requires_grad_()
            return torch.autograd.grad(fwd(xl), xl, dout)
        return run

    def geglu_f32_composed(args):
        """F.linear(h * F.gelu(g), W, b) in f32."""
        h2, w, b = args
        h, gate = h2.chunk(2, dim=-1)
        return lambda: F.linear(h * F.gelu(gate), w, b)

    def geglu_bwd_f32_composed(args):
        """The gradient in h2 of that composition (autograd), its forward included."""
        h2, dout, w = args

        def run():
            hl = h2.detach().requires_grad_()
            h, gate = hl.chunk(2, dim=-1)
            return torch.autograd.grad(F.linear(h * F.gelu(gate), w), hl, dout)
        return run

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
    # single call computes the same function, so their library_ms is null.
    # ff_ln at the generation shapes of levels 0 / 1 (batch 2 with CFG), the
    # train step's (batch 10), and row counts that end inside a 64-row block,
    # also at the tiny configs' C = 32 (the bf16 kernel on operands padded to
    # 64 columns); each run twice and compared bit for bit
    def ff_case(t, c, primary=False):
        i = 4 * c
        args = [r(t, c), 1.0 + 0.05 * r(c).float(), 0.02 * r(c).float(),
                r(2 * i, c, scale=c ** -0.5), 0.02 * r(2 * i).float(),
                r(c, i, scale=i ** -0.5), 0.02 * r(c).float()]
        add("ff_ln", f"T={t} C={c}", lambda a=args: geglu.ff_ln(*a),
            lambda ts: geglu.ff_ln_plain(*ts), args, flops=6 * t * c * i, primary=primary,
            composed=ff_composed(args) if f32 else None, inter_bytes=ff_inter(t, i))

    tb6 = TRAIN_BATCH * 6
    for t, c, primary in ((27648, 320, True), (6912, 640, False), (tb6 * 2304, 320, False),
                          (tb6 * 576, 640, False), (1, 320, False), (37, 320, False),
                          (130, 320, False), (1, 640, False), (37, 640, False),
                          (130, 640, False), (1, 32, False), (37, 32, False), (130, 32, False)):
        ff_case(t, c, primary)

    # geglu_out at the row counts of its launches, I = 5120, C = 1280: level 2
    # and the mid block of one clip's guidance pair (1728, 480) here; a
    # two-clip dispatch (3456), the train step (8640, 2400) and rows that end
    # inside a 64-row block at the end; the yardstick composed_ms is the
    # cuBLAS composition (attention_ab.geglu_composed), with the L2 bytes the
    # kernel's blocks copy (w and h2, computed from its tiling; at f32 also the
    # gated workspace and the partial sums, which the bound does not count:
    # the function need not move them)
    def geglu_case(t, primary=False):
        args = geglu_args(r, t)
        l2 = ((geglu.geglu_f32_l2_read_bytes(t, 5120, 1280), "h2, gated, w and the partial sums")
              if f32 else (geglu.geglu_out_l2_read_bytes(t, 5120, 1280), "w and h2"))
        add("geglu_out", f"T={t} I=5120 C=1280", lambda a=args: geglu.geglu_out(*a),
            lambda ts: geglu.geglu_out_plain(*ts), args, flops=2 * t * 5120 * 1280,
            primary=primary, composed=geglu_f32_composed(args) if f32 else geglu_composed(args),
            l2_bytes=l2)

    geglu_case(1728, primary=True)
    geglu_case(480)

    # the level-0 convolutions: one clip's guidance pair (N = 12 images) and
    # a two-clip dispatch (24); the yardstick composed_ms is the cuDNN
    # composition (attention_ab.conv_composed), with the L2 bytes the kernel's
    # blocks copy (weights and halo tiles, computed from its tiling)
    def conv(label, n, cin, stats, temb, zero_bias=False, primary=False):
        if f32:  # no f32 counterpart: JAX sends f32 convs to XLA (conv2d.py:131)
            return
        args = conv_args(torch, r, g, n, cin, temb, zero_bias, dev)
        add("conv3x3_gn_silu", label,
            lambda: conv2d.conv3x3_gn_silu(*args, with_stats=stats),
            lambda ts: conv2d.conv3x3_gn_silu_plain(*ts, with_stats=stats),
            args, flops=2 * n * 36 * 64 * 9 * cin * 320, primary=primary,
            l2_bytes=(conv2d.l2_read_bytes(n, 36, 64, cin, 320), "weights and halo tiles"),
            composed=conv_composed(torch, args, stats))

    conv("Cin=320 (12,36,64) +stats +temb", 12, 320, True, True, primary=True)
    conv("Cin=320 (12,36,64)", 12, 320, False, False)
    conv("Cin=640 (12,36,64) +temb", 12, 640, False, True)

    # --- the train step's shapes: batch 10, 6 frames, bf16 ---------------------
    # The plain attention versions hold (N, H, Lq, Lkv) f32 tensors, several
    # at once in the backward: they run over the batch in chunks of 2 and the
    # chunks are concatenated (a query group only sees its own batch element).
    def chunked(fn, ts, like_b, step=2):
        """fn over batch chunks; ts entries with leading dim like_b are cut."""
        outs = []
        for s0 in range(0, like_b, step):
            part = [t[s0:s0 + step] if t is not None and t.shape[0] == like_b else t
                    for t in ts]
            outs.append(_outputs(fn(part)))
        return tuple(torch.cat([o[i] for o in outs]) if outs[0][i] is not None else None
                     for i in range(len(outs[0])))

    def sdpa_operands(q, k0, v0, k1, v1, heads=heads):
        return sdpa_views(torch, q, k0, v0, k1, v1, heads)

    def attn_train(label, q, k0, v0, k1=None, v1=None, step=2, primary_bwd=False, heads=heads):
        """Forward with lse (kernel A) and backward (kernel B) of one call."""
        b, hd = k0.shape[0], q.shape[-1]
        n_rows = q.numel() // hd
        lkv = k0.shape[1] + (0 if k1 is None else k1.shape[-2])
        dout = r(*q.shape)
        out, lse = attention.flash_attention_fwd(q, k0, v0, heads, k1=k1, v1=v1,
                                                 return_lse=True)
        qh, kh, vh = sdpa_operands(q, k0, v0, k1, v1, heads)
        add("flash_attention_fwd", f"{label} +lse",
            lambda: attention.flash_attention_fwd(q, k0, v0, heads, k1=k1, v1=v1,
                                                  return_lse=True),
            lambda ts: chunked(lambda p: attention.flash_attention_plain(
                p[0], p[1], p[2], heads, k1=p[3], v1=p[4], return_lse=True), ts, b, step),
            [q, k0, v0, k1, v1], flops=4 * n_rows * lkv * hd,
            library=lambda: F.scaled_dot_product_attention(qh, kh, vh))
        # the yardstick of the backward: autograd through one
        # scaled_dot_product_attention call (its own backward kernel) on the
        # same operands, the forward outside the timed region
        leaves = [t.detach().requires_grad_() for t in (qh, kh, vh)]
        sd_out = F.scaled_dot_product_attention(*leaves)
        doh = dout.reshape(-1, dout.shape[-2], hd).unflatten(-1, (heads, hd // heads)).transpose(1, 2)
        add("flash_attention_bwd", label,
            lambda: attention.flash_attention_bwd(q, k0, v0, heads, dout, out, lse, k1=k1,
                                                  v1=v1),
            lambda ts: chunked(lambda p: attention.flash_attention_bwd_plain(
                p[0], p[1], p[2], heads, p[5], p[6],
                p[7].flatten(0, 1) if q.dim() == 4 else p[7], k1=p[3], v1=p[4]), ts, b, step),
            [q, k0, v0, k1, v1, dout, out,
             lse.unflatten(0, (b, -1)) if q.dim() == 4 else lse],
            flops=10 * n_rows * lkv * hd,
            library=lambda: torch.autograd.grad(sd_out, leaves, doh, retain_graph=True),
            primary=primary_bwd)

    tb = TRAIN_BATCH
    attn_train(f"train self f0-1 ({tb},2,2304,320)x2304", r(tb, 2, 2304, 320),
               r(tb, 2304, 320), r(tb, 2304, 320))
    attn_train(f"train cross ({6 * tb},2304,320)x77", r(6 * tb, 2304, 320), r(6 * tb, 77, 320),
               r(6 * tb, 77, 320), step=12)
    attn_train(f"train dual f2-5 ({tb},4,2304,320)x[2304|2304]", r(tb, 4, 2304, 320),
               r(tb, 2304, 320), r(tb, 2304, 320), k1=r(tb, 4, 2304, 320),
               v1=r(tb, 4, 2304, 320), primary_bwd=True)
    attn_train(f"train dual f2-5 D=80 ({tb},4,576,640)x[576|576]", r(tb, 4, 576, 640),
               r(tb, 576, 640), r(tb, 576, 640), k1=r(tb, 4, 576, 640), v1=r(tb, 4, 576, 640))
    attn_train(f"train dual f2-5 D=160 ({tb},4,40,1280)x[40|40]", r(tb, 4, 40, 1280),
               r(tb, 40, 1280), r(tb, 40, 1280), k1=r(tb, 4, 40, 1280), v1=r(tb, 4, 40, 1280))
    attn_train(f"train dual f2-5 D=160 ({tb},4,144,1280)x[144|144]", r(tb, 4, 144, 1280),
               r(tb, 144, 1280), r(tb, 144, 1280), k1=r(tb, 4, 144, 1280),
               v1=r(tb, 4, 144, 1280))

    def attn_dbias(label, q, k0, v0, k1=None, v1=None, step=2):
        """The backward that also writes the gradient of bias0. The bias is
        what a mask gives (0, and -1e4 at the holes) plus dense noise, so that
        dbias0 is not trivially 0. The yardstick: the backward of one
        scaled_dot_product_attention call whose attn_mask asks for a gradient."""
        b, hd = k0.shape[0], q.shape[-1]
        m = q.shape[1] if q.dim() == 4 else 1
        lkv0, lkv1 = k0.shape[1], 0 if k1 is None else k1.shape[-2]
        bias = 0.5 * torch.randn(b, 1, lkv0, generator=g, device=dev)
        bias[:, :, ::9] = -1e4
        dout = r(*q.shape)
        out, lse = attention.flash_attention_fwd(q, k0, v0, heads, k1=k1, v1=v1, bias0=bias,
                                                 return_lse=True)

        def kern():
            return attention.flash_attention_bwd(q, k0, v0, heads, dout, out, lse, k1=k1, v1=v1,
                                                 bias0=bias, need_dbias=True)

        first, again = kern(), kern()
        if not all(a is None or torch.equal(a, c) for a, c in zip(first, again)):
            fail(f"kernels: flash_attention_bwd [{label}]: two runs gave different bits")
        if float(first[5].abs().max()) == 0 or bool((first[5][:, :, ::9] != 0).any()):
            fail(f"kernels: flash_attention_bwd [{label}]: dbias0 is zero, or not zero at a hole")
        leaves = [t.detach().requires_grad_() for t in sdpa_operands(q, k0, v0, k1, v1)]
        mask = bias.to(q.dtype).requires_grad_()
        doh = dout.reshape(-1, dout.shape[-2], hd).unflatten(-1, (heads, hd // heads)).transpose(1, 2)
        try:  # the library may refuse a broadcast mask that asks for a gradient
            full = F.pad(mask.repeat_interleave(m, dim=0)[:, None], (0, lkv1))
            sd_out = F.scaled_dot_product_attention(*leaves, attn_mask=full)
            library = lambda: torch.autograd.grad(sd_out, leaves + [mask], doh, retain_graph=True)
            library()
        except RuntimeError as e:
            say(f"kernels: flash_attention_bwd [{label}]: no library yardstick, "
                f"scaled_dot_product_attention refused: {str(e).splitlines()[0]}")
            library = None
        add("flash_attention_bwd", label, kern,
            lambda ts: chunked(lambda p: attention.flash_attention_bwd_plain(
                p[0], p[1], p[2], heads, p[5], p[6],
                p[7].flatten(0, 1) if q.dim() == 4 else p[7], k1=p[3], v1=p[4], bias0=p[8],
                need_dbias=True), ts, b, step),
            [q, k0, v0, k1, v1, dout, out,
             lse.unflatten(0, (b, -1)) if q.dim() == 4 else lse, bias],
            flops=10 * (q.numel() // hd) * (lkv0 + lkv1) * hd, library=library)

    attn_dbias(f"train self +dbias ({tb},2,2304,320)x2304 bias ({tb},1,2304)",
               r(tb, 2, 2304, 320), r(tb, 2304, 320), r(tb, 2304, 320))
    attn_dbias(f"train dual f2-5 +dbias ({tb},4,2304,320)x[2304|2304] bias0 ({tb},1,2304)",
               r(tb, 4, 2304, 320), r(tb, 2304, 320), r(tb, 2304, 320),
               k1=r(tb, 4, 2304, 320), v1=r(tb, 4, 2304, 320))
    # the masked step's deeper levels: other head widths are other
    # instantiations of the pass that writes dbias0, each held here
    for l, hd in ((576, 640), (144, 1280), (40, 1280)):
        d = hd // heads
        attn_dbias(f"train self +dbias D={d} ({tb},2,{l},{hd})x{l} bias ({tb},1,{l})",
                   r(tb, 2, l, hd), r(tb, l, hd), r(tb, l, hd))
        attn_dbias(f"train dual f2-5 +dbias D={d} ({tb},4,{l},{hd})x[{l}|{l}] bias0 ({tb},1,{l})",
                   r(tb, 4, l, hd), r(tb, l, hd), r(tb, l, hd),
                   k1=r(tb, 4, l, hd), v1=r(tb, 4, l, hd))

    # fused_attention over head-major (B, H, L, D) operands, read in place;
    # the yardstick is one scaled_dot_product_attention call on the same
    # tensors, and autograd through it for the backward
    def fused(label, b, h, lq, lkv, d, primary=False):
        q, k, v, dout = r(b, h, lq, d), r(b, h, lkv, d), r(b, h, lkv, d), r(b, h, lq, d)
        out, lse = attention.fused_attention_fwd(q, k, v, return_lse=True)
        add("fused_attention_fwd", f"{label} +lse",
            lambda: attention.fused_attention_fwd(q, k, v, return_lse=True),
            lambda ts: chunked(lambda p: attention.fused_attention_plain(*p, return_lse=True),
                               ts, b),
            [q, k, v], flops=4 * b * h * lq * lkv * d,
            library=lambda: F.scaled_dot_product_attention(q, k, v), primary=primary)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        sd_out = F.scaled_dot_product_attention(*leaves)
        add("fused_attention_bwd", label,
            lambda: attention.fused_attention_bwd(q, k, v, dout, out, lse),
            lambda ts: chunked(lambda p: attention.fused_attention_bwd_plain(*p), ts, b),
            [q, k, v, dout, out, lse], flops=10 * b * h * lq * lkv * d,
            library=lambda: torch.autograd.grad(sd_out, leaves, dout, retain_graph=True),
            primary=primary)

    fused("(2,8,2304,40)x4608", 2, 8, 2304, 4608, 40)
    fused(f"train scale ({tb},8,2304,40)x4608", tb, 8, 2304, 4608, 40, primary=True)
    fused(f"D=160 ({tb},8,144,160)x144", tb, 8, 144, 144, 160)
    fused("ragged (1,2,300,40)x450", 1, 2, 300, 450, 40)

    # the tile edges of the redesigned attention kernels: Lq and Lkv that are
    # not multiples of the 64- and 128-row tiles (77, 40, 144, the ragged
    # case above), at every head dim the dispatch pads differently (D = 8, 40,
    # 80, 160); forward without and with lse, backward, and a bias gradient
    attn("edge D=40 Lq=40 (2,40,320)x77", r(2, 40, 320), r(2, 77, 320), r(2, 77, 320))
    attn_train("edge D=8 (2,77,64)x40", r(2, 77, 64), r(2, 40, 64), r(2, 40, 64))
    attn_train("edge D=80 (2,2,144,640)x[144|144]", r(2, 2, 144, 640), r(2, 144, 640),
               r(2, 144, 640), k1=r(2, 2, 144, 640), v1=r(2, 2, 144, 640))
    attn_train("edge D=160 (2,4,40,1280)x[40|40]", r(2, 4, 40, 1280), r(2, 40, 1280),
               r(2, 40, 1280), k1=r(2, 4, 40, 1280), v1=r(2, 4, 40, 1280))
    attn_train("edge D=160 (2,144,1280)x77", r(2, 144, 1280), r(2, 77, 1280), r(2, 77, 1280))
    attn_dbias("edge D=40 +dbias (2,2,144,320)x[77|77] bias0 (2,1,77)", r(2, 2, 144, 320),
               r(2, 77, 320), r(2, 77, 320), k1=r(2, 2, 77, 320), v1=r(2, 2, 77, 320))
    fused("edge D=8 (2,8,77,8)x40", 2, 8, 77, 40, 8)
    fused("edge D=80 (2,8,144,80)x77", 2, 8, 144, 77, 80)
    fused("edge D=160 (2,8,40,160)x144", 2, 8, 40, 144, 160)

    # temporal attention: bound by memory, 4 tensors forward and 7 backward;
    # operations: the F*F dot products and weighted sums per token and head.
    # The yardstick: one scaled_dot_product_attention call over the frames on
    # (B, L*H, F, D) views of the same tensors (no copy: frame stride L*H*D),
    # and autograd through it for the backward, the forward outside the
    # timed region.
    def temporal_case(l, hd, primary=False, f=6, heads=heads, b=tb):
        q, k, v, dout = (r(b, f, l, hd) for _ in range(4))
        frames_last = lambda t: t.view(b, f, l * heads, hd // heads).transpose(1, 2)
        qf, kf, vf = frames_last(q), frames_last(k), frames_last(v)
        label = f"({b},{f},{l},{hd}) {heads} heads of D={hd // heads}"
        add("temporal_attention_fwd", label,
            lambda: temporal.temporal_attention_fwd(q, k, v, heads),
            lambda ts: temporal.temporal_attention_plain(*ts, heads), [q, k, v],
            flops=4 * b * l * f * f * hd, primary=primary,
            library=lambda: F.scaled_dot_product_attention(qf, kf, vf))
        leaves = [t.detach().requires_grad_() for t in (qf, kf, vf)]
        sd_out = F.scaled_dot_product_attention(*leaves)
        add("temporal_attention_bwd", label,
            lambda: temporal.temporal_attention_bwd(q, k, v, dout, heads),
            lambda ts: temporal.temporal_attention_bwd_plain(*ts, heads), [q, k, v, dout],
            flops=10 * b * l * f * f * hd, primary=primary,
            library=lambda d=frames_last(dout): torch.autograd.grad(sd_out, leaves, d,
                                                                    retain_graph=True))

    temporal_case(2304, 320, primary=True)  # level 0
    temporal_case(144, 1280)  # level 2; level 1 is drawn last, below

    # ff_ln_bwd: 10*T*C*I operations (h2, dgated, dh2 Wp); geglu_out_bwd: one
    # 2*T*C*I product. As their forwards, no single PyTorch call computes them.
    # ff_ln_bwd at the train step's shapes of levels 0 / 1 and at row counts
    # that end inside a block, with the weight bytes its blocks copy from L2
    for t, c, primary in ((tb * 6 * 2304, 320, True), (tb * 6 * 576, 640, False),
                          (1, 320, False), (37, 320, False), (130, 320, False),
                          (1, 640, False), (37, 640, False), (130, 640, False),
                          (1, 32, False), (37, 32, False), (130, 32, False)):
        i = 4 * c
        args = [r(t, c), r(t, c), 1.0 + 0.05 * r(c).float(), 0.02 * r(c).float(),
                r(2 * i, c, scale=c ** -0.5), 0.02 * r(2 * i).float(),
                r(c, i, scale=i ** -0.5)]
        add("ff_ln_bwd", f"T={t} C={c}", lambda a=args: geglu.ff_ln_bwd(*a),
            lambda ts: geglu.ff_ln_bwd_plain(*ts), args, flops=10 * t * c * i, primary=primary,
            l2_bytes=None if f32 else (ff_ln_bwd_weight_bytes(_build, t, c, i), "weights"),
            composed=ff_bwd_composed(args) if f32 else None,
            inter_bytes=ff_inter(t, i, backward=True))
    for t, primary in ((tb * 6 * 144, True), (tb * 6 * 40, False)):
        args = [r(t, 10240), r(t, 1280), r(1280, 5120, scale=5120 ** -0.5)]
        add("geglu_out_bwd", f"T={t} I=5120 C=1280", lambda a=args: geglu.geglu_out_bwd(*a),
            lambda ts: geglu.geglu_out_bwd_plain(*ts), args, flops=2 * t * 5120 * 1280,
            primary=primary,
            composed=geglu_bwd_f32_composed(args) if f32 else geglu_bwd_composed(args),
            l2_bytes=(geglu.geglu_f32_l2_read_bytes(t, 5120, 1280, backward=True) if f32 else
                      geglu.geglu_out_bwd_l2_read_bytes(t, 5120, 1280), "g, w and h2"))

    # int8_dense at the five layer shapes of the hidden=10000 semantic MLP,
    # one 100-row chunk, f32 activations; the yardstick is a dequantize to
    # bf16 and one F.linear (cuBLAS), with the same scale and bias epilogue
    def int8(label, m, k, n, primary=False):
        if f32:  # its activations are f32 on every path already
            return
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
            plain_takes_args=True, l2_bytes=(int8_dense.plan(m, kp, np_)["x_l2_bytes"], "x"))

    int8("fc0 M=100 (310->10000)", 100, 310, 10000)
    int8("fc1-3 M=100 (10000->10000)", 100, 10000, 10000, primary=True)
    int8("fc1-3 M=1 (10000->10000)", 1, 10000, 10000)
    int8("out M=100 (10000->59136)", 100, 10000, 77 * 768)
    # drawn last, so that the inputs of the cases above stay as they were
    conv("Cin=320 (24,36,64) +stats +temb", 24, 320, True, True)
    conv("Cin=320 (12,36,64) skip half, zero bias", 12, 320, False, False, zero_bias=True)
    for t in (3456, 8640, 2400, 1, 37, 130):
        geglu_case(t)
    temporal_case(576, 640)  # the train step's level 1
    # the any route: head and frame counts off the staged route's grid (12
    # heads of D = 53 over 10 frames, 10 heads of D = 64, 8 heads over 32
    # frames), at batch 2
    temporal_case(576, 636, f=10, heads=12, b=2)
    temporal_case(576, 640, heads=10, b=2)
    temporal_case(576, 320, f=32, b=2)
    # attention at 12 heads of D = 53, which the wrappers pad to 56 around the
    # kernels (one segment and two)
    attn_train("D=53 12 heads (2,576,636)x77", r(2, 576, 636), r(2, 77, 636), r(2, 77, 636),
               heads=12)
    attn_train("D=53 12 heads (2,2,576,636)x[576|576]", r(2, 2, 576, 636), r(2, 576, 636),
               r(2, 576, 636), k1=r(2, 2, 576, 636), v1=r(2, 2, 576, 636), heads=12)
    # attention tile edges: a single query row, Lkv = 130 (two tiles, the
    # second of 2 rows) and 1030 (17 tiles, the last of 6 rows) with a second
    # segment of 70
    attn_train("edge D=40 Lq=1 (2,1,320)x130", r(2, 1, 320), r(2, 130, 320), r(2, 130, 320))
    attn_dbias("edge D=40 +dbias (1,2,1030,320)x[1030|70] bias0 (1,1,1030)",
               r(1, 2, 1030, 320), r(1, 1030, 320), r(1, 1030, 320),
               k1=r(1, 2, 70, 320), v1=r(1, 2, 70, 320))
    # ddim_inversion's shapes: one clip at batch 1, no guidance pair, in bf16
    # as section 13 runs it; every attention call of each level (frames 0-1,
    # frames 2-5, cross), the feed-forward of each level, the level-0 convs
    # (N = 6 images)
    if not f32:
        for l, hd in ((2304, 320), (576, 640), (144, 1280), (40, 1280)):
            attn(f"inversion self f0-1 (1,{2 * l},{hd})x{l}", r(1, 2 * l, hd), r(1, l, hd),
                 r(1, l, hd))
            attn(f"inversion dual f2-5 (1,4,{l},{hd})x[{l}|{l}]", r(1, 4, l, hd), r(1, l, hd),
                 r(1, l, hd), k1=r(1, 4, l, hd), v1=r(1, 4, l, hd))
            attn(f"inversion cross (1,{6 * l},{hd})x77", r(1, 6 * l, hd), r(1, 77, hd),
                 r(1, 77, hd))
        ff_case(6 * 2304, 320)
        ff_case(6 * 576, 640)
        geglu_case(6 * 144)
        geglu_case(6 * 40)
        conv("inversion Cin=320 (6,36,64) +stats +temb", 6, 320, True, True)
        conv("inversion Cin=320 (6,36,64)", 6, 320, False, False)
        conv("inversion Cin=640 (6,36,64) +temb", 6, 640, False, True)
        conv("inversion Cin=320 (6,36,64) skip half, zero bias", 6, 320, False, False,
             zero_bias=True)
    return cases


def ff_ln_bwd_weight_bytes(build, t, c, inner):
    """Weight bytes ff_ln_bwd's blocks copy from L2 for t rows: each block
    of the kernel's rows copies Wp (2I x C) twice and Wo (C x I) once, bf16,
    at C padded to the kernel's 64-column grid."""
    c = -(-c // 64) * 64
    rows = build.library().e2v_ff_ln_bwd_block_rows(c)
    return -(-t // rows) * (2 * 2 * inner * c + c * inner) * 2


def _outputs(res):
    return list(res) if isinstance(res, (tuple, list)) else [res]


def _nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def phase_kernels(torch, report, f32=False):
    """Every case of ``kernel_cases`` (bf16, or with ``f32`` the f32 kernels
    against the same plain versions, bound F32_KERNEL_BOUND, bound_ms at the
    FP32 rate without tensor cores, for TF32X3_KERNELS three tf32
    products at the TF32 rate); the results go into ``report``."""
    from eeg2video_tpu_torch.utils.flops import H100_BF16_PEAK

    dev = torch.device("cuda")
    for case in kernel_cases(torch, dev, f32):
        kernel, label, kern, plain, args = (case[k] for k in
                                            ("kernel", "label", "kern", "plain", "args"))
        # int8_dense and its plain version share the bf16 operands and f32
        # sums: only the summation order differs, as for the f32 kernels
        bound = F32_KERNEL_BOUND if f32 or kernel == "int8_dense" else KERNEL_BOUND
        # operations a second at the card's peak for this kernel's products
        peak = (PEAK_TF32_FLOPS / TF32_PASSES if kernel in TF32X3_KERNELS else
                PEAK_F32_FLOPS if f32 else H100_BF16_PEAK)
        got = [t for t in _outputs(kern()) if t is not None]
        torch.cuda.synchronize()
        if (f32 or kernel.endswith("_bwd")
                or kernel in ("ff_ln", "conv3x3_gn_silu", "geglu_out", "int8_dense")):
            again = [t for t in _outputs(kern()) if t is not None]
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                fail(f"kernels: {kernel} [{label}]: two runs gave different bits")
            del again
        # the plain version on f32 copies of the bf16 operands (int8_dense
        # takes f32 activations and int8 weights as they are)
        want = [t for t in _outputs(plain(
            args if case["plain_takes_args"] else
            [a.float() if a is not None else None for a in args])) if t is not None]
        if len(got) != len(want) or any(a.shape != b.shape for a, b in zip(got, want)):
            fail(f"kernels: {kernel} {label}: outputs differ in number or shape")
        abs_err = (got[0].float() - want[0]).abs().max().item()  # main output
        rel_err = max(((a.float() - b).abs().max() / b.abs().max()).item()
                      for a, b in zip(got, want))
        del want
        if not all(torch.isfinite(a).all().item() for a in got):
            fail(f"kernels: {kernel} {label}: non-finite output")
        # least time for the same work: every input read once, every output
        # written once (and the f32 feed-forward pair's intermediate written
        # and read once), against the operations at the bf16 tensor-core peak
        # (the f32 kernels: the FP32 peak without tensor cores; the 3xTF32
        # kernels: three tf32 products each at the TF32 peak)
        nbytes = _nbytes(args) + _nbytes(got) + (case["inter_bytes"] or 0)
        t_bytes, t_flops = nbytes / PEAK_BYTES * 1e3, case["flops"] / peak * 1e3
        bound_ms, bound_by = max(t_bytes, t_flops), "bytes" if t_bytes >= t_flops else "operations"
        ms = timed_ms(kern, torch, 10)
        plain_ms = timed_ms(lambda: plain(args), torch, 3)
        library_ms = timed_ms(case["library"], torch, 10) if case["library"] else None
        composed_ms = timed_ms(case["composed"], torch, 10) if case["composed"] else None
        ok = rel_err < bound
        lib = "no single call" if library_ms is None else f"{library_ms:.3f} ms"
        if composed_ms is not None:
            lib += f", composed {composed_ms:.3f} ms"
        l2 = case["l2_bytes"]
        l2 = "" if l2 is None else (f", {l2[1]} from L2 {l2[0]} bytes a call "
                                    f"({l2[0] / ms / 1e9:.2f} TB/s at this time)")
        if case["inter_bytes"]:
            l2 += f", workspace {case['inter_bytes']} bytes written and read"
        say(f"kernel {kernel} [{label}]: max_rel_err {rel_err:.3e} (bound {bound:.0e}) "
            f"max_abs_err {abs_err:.3e}, {ms:.3f} ms, bound {bound_ms:.4f} ms by {bound_by} "
            f"({bound_ms / ms:.3f} of it; {nbytes} bytes, {case['flops']} operations{l2}), "
            f"library {lib}, plain {plain_ms:.3f} ms {'ok' if ok else 'FAILED'}")
        if not ok:
            fail(f"kernels: {kernel} [{label}] disagrees with its plain version")
        rep = report[kernel]
        rep["max_abs_err"] = max(rep["max_abs_err"], abs_err)
        rep["max_rel_err"] = max(rep["max_rel_err"], rel_err)
        if case["primary"]:
            rep.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                       library_ms=library_ms, composed_ms=composed_ms, shape=label)
    if f32:
        check_ff_f32_rows(torch, dev)
    else:
        check_geglu_rows(torch, dev)
        check_int8_rows(torch, dev)
    torch.cuda.empty_cache()


def check_ff_f32_rows(torch, dev):
    """A clip's rows of the f32 feed-forward pair give the same bits alone
    (T = 1728) and beside another's (T = 3456), forward and backward, at
    C = 320; so do the f32 GEGLU pair's at I = 5120, C = 1280."""
    from eeg2video_tpu_torch.ops import geglu
    from eeg2video_tpu_torch.utils.attention_ab import geglu_args

    g = torch.Generator(device=dev).manual_seed(4)

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    c, i = 320, 1280
    x, dout = r(3456, c), r(3456, c)
    params = [1.0 + 0.05 * r(c), 0.02 * r(c), r(2 * i, c, scale=c ** -0.5), 0.02 * r(2 * i),
              r(c, i, scale=i ** -0.5)]
    bo = 0.02 * r(c)
    head, dhead = x[:1728].clone(), dout[:1728].clone()
    same = (torch.equal(geglu.ff_ln(x, *params, bo)[:1728], geglu.ff_ln(head, *params, bo))
            and torch.equal(geglu.ff_ln_bwd(x, dout, *params)[:1728],
                            geglu.ff_ln_bwd(head, dhead, *params)))
    say(f"kernel ff_ln_f32 / ff_ln_bwd_f32: rows 0-1727 of a T=3456 call equal a T=1728 call "
        f"on those rows (C=320): {'ok' if same else 'FAILED'}")
    if not same:
        fail("kernels: ff_ln_f32 / ff_ln_bwd_f32: a row's bits depend on the other rows")
    del x, dout, head, dhead
    h2, w, b = geglu_args(r, 3456)
    dout = r(3456, 1280)
    h2_head = h2[:1728].clone()
    same = (torch.equal(geglu.geglu_out(h2, w, b)[:1728], geglu.geglu_out(h2_head, w, b))
            and torch.equal(geglu.geglu_out_bwd(h2, dout, w)[:1728],
                            geglu.geglu_out_bwd(h2_head, dout[:1728].clone(), w)))
    say(f"kernel geglu_out_f32 / geglu_out_bwd_f32: rows 0-1727 of a T=3456 call equal a "
        f"T=1728 call on those rows: {'ok' if same else 'FAILED'}")
    if not same:
        fail("kernels: geglu_out_f32 / geglu_out_bwd_f32: a row's bits depend on the other rows")


def check_geglu_rows(torch, dev):
    """A clip's rows of geglu_out give the same bits alone (T = 1728, one
    clip's guidance pair at level 2) and beside another clip's (T = 3456, a
    two-clip dispatch)."""
    from eeg2video_tpu_torch.ops import geglu
    from eeg2video_tpu_torch.utils.attention_ab import geglu_args

    g = torch.Generator(device=dev).manual_seed(3)
    h2, w, b = geglu_args(lambda *shape, scale=1.0: (
        torch.randn(*shape, generator=g, device=dev) * scale).bfloat16(), 3456)
    same = torch.equal(geglu.geglu_out(h2, w, b)[:1728], geglu.geglu_out(h2[:1728].clone(), w, b))
    say(f"kernel geglu_out: rows 0-1727 of a T=3456 call equal a T=1728 call on those rows: "
        f"{'ok' if same else 'FAILED'}")
    if not same:
        fail("kernels: geglu_out: a row's bits depend on the other rows in the call")


def check_int8_rows(torch, dev):
    """Rows 0-6 of a 100-row int8_dense call (x rows as wgmma's N = 104)
    equal a 7-row call (N = 8) bit for bit, at a middle layer (K split three
    ways) and at the out layer (no split)."""
    from eeg2video_tpu_torch.ops import int8_dense

    # each layer's plan: its blocks in clusters of CLUSTER, and how many of
    # those clusters the card holds at once (the launch's waves)
    for label, m, kp, np_ in (("fc0", 100, 320, 10240), ("fc1-3", 100, 10016, 10240),
                              ("fc1-3 M=1", 1, 10016, 10240), ("out", 100, 10016, 59392)):
        p = int8_dense.plan(m, kp, np_, occupancy=True)
        at_once = p["clusters_at_once"]
        clusters = p["tiles"] // int8_dense.CLUSTER * p["splits"] * p["row_blocks"]
        say(f"kernel int8_dense [{label}]: {p['tiles']} column tiles x {p['splits']} splits x "
            f"{p['row_blocks']} row blocks of {p['width']} rows = {clusters} clusters of "
            f"{int8_dense.CLUSTER}, {at_once} at once: {clusters / max(at_once, 1):.2f} waves")
    g = torch.Generator(device=dev).manual_seed(5)
    for k, n in ((10000, 10000), (10000, 77 * 768)):
        w_q, scale = int8_dense.quantize_int8(torch.randn(k, n, generator=g, device=dev) * k ** -0.5)
        bias = 0.1 * torch.randn(n, generator=g, device=dev)
        x = torch.randn(100, k, generator=g, device=dev).relu()
        same = torch.equal(int8_dense.int8_dense(x, w_q, scale, bias, n)[:7],
                           int8_dense.int8_dense(x[:7].clone(), w_q, scale, bias, n))
        say(f"kernel int8_dense: rows 0-6 of an M=100 call equal an M=7 call ({k}->{n}): "
            f"{'ok' if same else 'FAILED'}")
        if not same:
            fail("kernels: int8_dense: a row's bits depend on the other rows in the call")


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

    # one UNet forward of 4 samples (a --max_batch 2 dispatch: 2 clips x the
    # CFG pair) under the profiler, after one unprofiled warm-up
    sample = torch.randn(4, 6, 36, 64, 4, generator=g, device=dev).bfloat16()
    ctx = torch.randn(4, 77, 768, generator=g, device=dev).bfloat16()
    t = torch.full((4,), 500, device=dev)
    with torch.inference_mode():
        pipe.unet(sample, t, ctx)
        _profile_step(torch, lambda: pipe.unet(sample, t, ctx),
                      "slice: one UNet forward of 4 samples")
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

    from eeg2video_tpu_torch.cli import add_noise, inference_seq2seq_v2, serve
    from eeg2video_tpu_torch.data.io import load_array
    from eeg2video_tpu_torch.data.video import load_gif
    from eeg2video_tpu_torch.models.init import random_init_
    from eeg2video_tpu_torch.models.semantic import HIDDEN, IN_DIM, Int8SemanticPredictor
    from eeg2video_tpu_torch.models.seq2seq import Seq2SeqTransformer
    from eeg2video_tpu_torch.ops.int8_dense import quantize_int8
    from eeg2video_tpu_torch.serving import runtimes
    from eeg2video_tpu_torch.serving.runtimes import PREDICT_CHUNK, make_semantic_predict
    from eeg2video_tpu_torch.train.seq2seq import ROLLOUT_CHUNK, windows_from_segments
    from eeg2video_tpu_torch.utils import StandardScaler

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
    front_ms = {"de_psd": [], "seq2seq rollout": [], "dana": []}  # per call, whole request part

    def timed(fn, into):
        """``fn`` with its synchronized host-clock milliseconds appended to ``into``."""
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = fn(*a, **k)
            torch.cuda.synchronize()
            into.append((time.perf_counter() - t0) * 1e3)
            return y
        return run

    timed_semantic = timed(semantic, chunk_ms)

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
        # raw EEG: a caller-ordered stack of two 2 s segments with positional
        # flow scores, and one whole segmented subject with the (7, 200) table
        raw2, flow2 = os.path.join(tmp, "raw2.npy"), os.path.join(tmp, "flow2.npy")
        subject, table = os.path.join(tmp, "subject.npy"), os.path.join(tmp, "flow_table.npy")
        np.save(raw2, 10.0 * rng.standard_normal((2, 62, 400), dtype=np.float32))
        np.save(flow2, np.asarray([2.5, 0.4], np.float32))
        subject_eeg = 10.0 * rng.standard_normal((7, 40, 5, 62, 400), dtype=np.float32)
        np.save(subject, subject_eeg)
        np.save(table, (1.8 + rng.standard_normal((7, 200))).astype(np.float32))
        # the Seq2Seq stage's EEG scaler, fitted on the windows of block 0
        scaler_file = os.path.join(tmp, "eeg_scaler.npz")
        StandardScaler().fit(windows_from_segments(subject_eeg[0]).reshape(200, -1)).save(scaler_file)
        del subject_eeg
        # a full-size Seq2Seq (d_model 512, latent 4x36x64), random from a seed,
        # written as the reference's .pt and read back by the server's loader
        seq2seq_file = os.path.join(tmp, "seq2seqmodel.pt")
        seq2seq = random_init_(Seq2SeqTransformer().to(dev), g)
        torch.save({"state_dict": seq2seq.state_dict()}, seq2seq_file)
        n_seq = sum(p.numel() for p in seq2seq.parameters())
        del seq2seq
        args = serve.build_parser().parse_args([
            "--listen", "127.0.0.1:0", "--coalesce", "--coalesce_wait", "1", "--max_batch", "2",
            "--semantic_int8", "--sampler", "dpm++", "--num_inference_steps", str(SERVE_STEPS),
            "--gif_encoder", "native", "--device", str(dev), "--out_dir", os.path.join(tmp, "out"),
            "--torch_seq2seq", seq2seq_file, "--seq2seq_scaler", scaler_file,
            "--flow_scores", table])
        t0 = time.perf_counter()
        seq2seq_untimed = runtimes._load_seq2seq(args)
        seq2seq_predict = timed(seq2seq_untimed, front_ms["seq2seq rollout"])
        say(f"serve: Seq2SeqTransformer() {n_seq} params (d_model 512, latent 4x36x64), random "
            f"from a seed, loaded from its .pt in {time.perf_counter() - t0:.2f} s")
        real_de, real_dana = runtimes.de_psd, runtimes.dana_mod.dana_add_noise
        runtimes.de_psd = timed(real_de, front_ms["de_psd"])
        runtimes.dana_mod.dana_add_noise = timed(real_dana, front_ms["dana"])
        ready, box = threading.Event(), {}

        def on_ready(line):
            box["port"] = line["port"]
            ready.set()

        def run():
            try:
                box["rc"] = serve.serve(
                    pipe, args, make_semantic_predict(timed_semantic, dev), on_ready,
                    seq2seq_predict=seq2seq_predict)
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
        # requests whose only payload is raw EEG: embeddings from de_psd -> the
        # int8 semantic predictor, latents from the Seq2Seq rollout -> DANA.
        # Two segments; one clip of a whole subject (GT reorder, 200-clip
        # rollout in 50-row chunks, 200-row DE and semantic pass, DANA over
        # the whole set); the first segment again without DANA, and without
        # Seq2Seq (noise latents)
        replies["raw"] = c1.ask({"id": "raw", "raw": raw2, "flow_scores": flow2,
                                 "out_dir": out("raw")})
        replies["subject"] = c2.ask({"id": "subject", "raw": subject, "indices": [3],
                                     "out_dir": out("subject")})
        replies["wodana"] = c1.ask({"id": "wodana", "raw": raw2, "indices": [0], "dana": False,
                                    "out_dir": out("wodana")})
        replies["woseq"] = c2.ask({"id": "woseq", "raw": raw2, "indices": [0], "seq2seq": False,
                                   "out_dir": out("woseq")})
        pong, _ = c1.ask({"cmd": "ping"})
        stats, _ = c2.ask({"cmd": "stats", "id": "s"})
        bye, _ = c1.ask({"cmd": "shutdown"})
        c1.close()
        c2.close()
        server.join(timeout=120)
        launches = dict(build.launches)
        for h in hooks:
            h.remove()
        # the DANA latents of the two segments as the file chain would store
        # them, (N, F, C, H, W), for inference_eeg2video.main later
        dana_latents = np.transpose(runtimes._latents_from_raw(
            args, {"raw": raw2, "flow_scores": flow2}), (0, 1, 4, 2, 3))
        runtimes.de_psd, runtimes.dana_mod.dana_add_noise = real_de, real_dana
        if "error" in box:
            fail(f"serve: the server thread raised {box['error']!r}")
        if server.is_alive() or box.get("rc") != 0:
            fail(f"serve: the server did not stop cleanly (rc {box.get('rc')})")

        # the file chain on the same subject: cli.inference_seq2seq_v2 ->
        # cli.add_noise write the two artifacts inference_eeg2video.main reads.
        # Same scaler, same 50-row rollout chunks, same seeded generator: its
        # DANA latents are the server's for that subject, bit for bit
        lat_file, dana_file = out("latent_out_block7_40_classes.npy"), out("dana.pt")
        t0 = time.perf_counter()
        inference_seq2seq_v2.main(["--eeg", subject, "--eeg_scaler", scaler_file, "--torch_ckpt",
                                   seq2seq_file, "--out", lat_file, "--device", str(dev)])
        add_noise.main(["--latents", lat_file, "--flow_scores", table, "--out", dana_file,
                        "--device", str(dev)])
        chain_s = time.perf_counter() - t0
        args.seq2seq_predict = seq2seq_untimed
        served = runtimes._latents_from_raw(args, {"raw": subject})
        chain = np.transpose(load_array(dana_file), (0, 1, 3, 4, 2))
        same = chain.shape == (200, 6, 36, 64, 4) and np.array_equal(chain, served)
        say(f"serve: file chain inference_seq2seq_v2.main -> add_noise.main on the subject, "
            f"{chain_s:.2f} s: DANA latents {chain.shape} "
            f"{'bit-equal to' if same else 'DIFFER from'} the server's {'ok' if same else 'FAILED'}")
        if not same:
            fail("serve: the file chain and the server disagree on a subject's DANA latents")

        clips = {"a": [0, 1], "b": [2], "c": [0], "b2": [2], "raw": [0, 1], "subject": [3],
                 "wodana": [0], "woseq": [0]}
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
        say("serve: 10 GIFs start with GIF89a and decode to (6, 288, 512, 3) with content")
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
        sources = {}
        for rid in ("raw", "wodana", "woseq"):
            with open(os.path.join(out(rid), "0.gif"), "rb") as f1:
                sources[rid] = f1.read()
        differ = len(set(sources.values())) == 3
        say(f"serve: segment 0 with Seq2Seq + DANA, Seq2Seq only and noise latents: "
            f"{[len(v) for v in sources.values()]} GIF bytes "
            f"{'all different' if differ else 'NOT all different'}")
        if not differ:
            fail("serve: the three latent sources did not give three different GIFs")
        if not (pong.get("ok") and pong.get("pong", 0) > 0 and bye == {"ok": True, "bye": True}):
            fail(f"serve: ping or shutdown reply is wrong: {pong} {bye}")
        ok = (stats.get("id") == "s" and stats.get("requests") == 8 and stats.get("clips") == 10
              and stats.get("errors") == 0)
        say(f"serve: stats {json.dumps(stats)} {'ok' if ok else 'FAILED'}")
        if not ok:
            fail("serve: stats do not count 8 requests, 10 clips, 0 errors")

    # dispatches: [a0 a1] [b b] [c b2] [raw0 raw1] [subject3 pad] [wodana0 pad] [woseq0 pad];
    # 100-row semantic chunks: one per features request (a, b, b2) and per
    # two-segment raw request (raw, wodana, woseq), two for the 200-clip subject;
    # the direct _latents_from_raw call above adds one rollout and one DANA call
    dispatches, chunks = 7, 8
    rollouts = {"calls": 4, "chunks": 3 + 200 // ROLLOUT_CHUNK}
    ok = (len(front_ms["seq2seq rollout"]) == rollouts["calls"] and len(front_ms["dana"]) == 3
          and len(front_ms["de_psd"]) == 4)
    say(f"serve: front half, ms per request part (host clock, synchronized): "
        f"{ {k: [round(t, 2) for t in v] for k, v in front_ms.items()} } "
        f"(de_psd and rollout: 2 segments, the 200-clip subject, 2 segments twice; the subject's "
        f"rollout is {200 // ROLLOUT_CHUNK} chunks of {ROLLOUT_CHUNK} rows) "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        fail("serve: the raw requests did not run DE, the rollout and DANA as often as expected")
    forwards = len(step_ms)
    expected = dict.fromkeys(launches, 0)  # no training kernel on the serving path
    expected.update({k: n * SERVE_STEPS * dispatches for k, n in EXPECTED_PER_FORWARD.items()})
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
    return launches, dana_latents


def phase_de_psd(torch):
    """de_psd on the card against its float64 numpy oracle."""
    import numpy as np

    from eeg2video_tpu_torch.dsp import de_psd, de_psd_numpy

    x = 10.0 * np.random.default_rng(8).standard_normal((200, 62, 400), dtype=np.float32)
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision())
    worst = {}
    try:
        for allow in (False, True):  # the result must not follow the global TF32 switch
            torch.backends.cuda.matmul.allow_tf32 = allow
            de, psd = de_psd(x)
            torch.cuda.synchronize()
            want_de, want_psd = de_psd_numpy(x.astype(np.float64))
            worst[allow] = (float(np.max(np.abs(psd.cpu().numpy() - want_psd) / want_psd)),
                            float(np.max(np.abs(de.cpu().numpy() - want_de))))
        ms = timed_ms(lambda: de_psd(x), torch, 5)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flags[0]
        torch.set_float32_matmul_precision(flags[1])
    ok = (de.is_cuda and tuple(psd.shape) == (200, 62, 5)
          and all(w[0] < DE_BOUND for w in worst.values()) and worst[False] == worst[True])
    say(f"de_psd (200,62,400) on the card vs the float64 oracle: worst relative error of psd "
        f"{worst[False][0]:.3e} (bound {DE_BOUND:.0e}), worst |de| error {worst[False][1]:.3e}; "
        f"with allow_tf32 on {worst[True][0]:.3e}; {ms:.3f} ms with the host-to-device copy "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        fail("de_psd disagrees with its oracle, or follows the global TF32 switch")


def phase_fused_op(torch, build, f32=False):
    """``fused_attention``, the public op over (B, H, L, D): a call without
    and a call with gradients, launches counted (``f32``: f32 operands, the
    f32 kernels)."""
    from eeg2video_tpu_torch.ops import attention, fused_attention

    dtype, sfx = (torch.float32, "_f32") if f32 else (torch.bfloat16, "")
    g = torch.Generator(device="cuda").manual_seed(9)
    q, k, v = (torch.randn(2, 8, l, 40, generator=g, device="cuda").to(dtype).requires_grad_()
               for l in (2304, 4608, 4608))
    dout = torch.randn(2, 8, 2304, 40, generator=g, device="cuda").to(dtype)
    build.reset_launches()
    with torch.no_grad():
        plain_call = fused_attention(q, k, v)
    out = fused_attention(q, k, v)
    grads = torch.autograd.grad(out, [q, k, v], dout)
    torch.cuda.synchronize()
    launches = dict(build.launches)
    want = attention.fused_attention_plain(q.detach().float(), k.detach().float(),
                                           v.detach().float())
    err = ((out.float() - want).abs().max() / want.abs().max()).item()
    expected = dict.fromkeys(launches, 0)
    expected.update({f"fused_attention_fwd{sfx}": 2, f"fused_attention_bwd{sfx}": 1})
    bound = F32_KERNEL_BOUND if f32 else KERNEL_BOUND
    ok = (launches == expected and torch.equal(plain_call, out.detach()) and err < bound
          and all(gr.shape == t.shape and bool(torch.isfinite(gr).all()) and float(gr.abs().max()) > 0
                  for gr, t in zip(grads, (q, k, v))))
    say(f"fused_attention (2,8,2304,40)x4608 {'f32' if f32 else 'bf16'}: one call without and one "
        f"with gradients, launches {_nonzero(launches)} (expected 2 forward, 1 backward), "
        f"max_rel_err {err:.3e} (bound {bound:.0e}) {'ok' if ok else 'FAILED'}")
    if not ok:
        fail("fused_attention: the op did not go through its kernels")
    return launches


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@contextlib.contextmanager
def _plain_versions(conv=False):
    """The plain versions in the kernels' place in models.attention3d (f32
    inside, autograd through them): attention (``flash_attention_fwd``'s
    ``out`` filled by a copy), temporal attention and the feed-forward; with
    ``conv`` also the level-0 conv's in models.resnet3d."""
    from eeg2video_tpu_torch.models import attention3d, resnet3d
    from eeg2video_tpu_torch.ops import attention, conv2d, geglu, temporal

    def fwd_into(q, k0, v0, heads, out=None, **kw):
        res = attention.flash_attention_plain(q, k0, v0, heads, **kw)
        return res if out is None else out.copy_(res)

    patched = {"flash_attention": lambda q, k0, v0, heads, **kw:
               attention.flash_attention_plain(q, k0, v0, heads, **kw),
               "flash_attention_fwd": fwd_into,
               "temporal_attention": temporal.temporal_attention_plain,
               "feed_forward": geglu.ff_ln_plain}
    sites = [(attention3d, name, fn) for name, fn in patched.items()]
    if conv:
        sites.append((resnet3d, "conv3x3_gn_silu", conv2d.conv3x3_gn_silu_plain))
    real = [(mod, name, getattr(mod, name)) for mod, name, _ in sites]
    try:
        for mod, name, fn in sites:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in real:
            setattr(mod, name, fn)


def _nonzero(launches):
    return {k: n for k, n in launches.items() if n}


def phase_train_parity(torch, build, f32=False, heads=8, frames=6):
    """A narrow UNet on the card: the fine-tune loss and its trainable
    gradients through the kernels, against the same model with the plain
    versions (f32 inside, autograd through them) in the kernels' place; in
    bf16, then (at 8 heads) the gradient of a soft mask; with ``f32`` at
    compute_dtype="float32" through the f32 kernels alone. ``heads`` = 12 and
    ``frames`` = 10: head dims 5 and 10 (the attention on heads padded to 8
    and 16, the temporal pair on its any route) and more frames than the
    staged route takes."""
    import copy

    from eeg2video_tpu_torch.models.init import random_init_
    from eeg2video_tpu_torch.models.unet3d import UNet3DConditionModel, UNet3DConfig
    from eeg2video_tpu_torch.train import videodiffusion as vd

    dev = torch.device("cuda")
    cfg = UNet3DConfig(block_out_channels=(64, 128, 128, 128), attention_heads=heads)
    tcfg = vd.VideoDiffusionTrainConfig(remat=True, remat_min_hw=64,
                                        compute_dtype="float32" if f32 else "bfloat16")
    g = torch.Generator(device=dev).manual_seed(5)
    unet = random_init_(UNet3DConditionModel(cfg).to(dev), g)
    twin = copy.deepcopy(unet)
    masked_pair = (copy.deepcopy(unet), copy.deepcopy(unet))  # for the mask.grad parity below
    post = torch.cat([torch.randn(2, frames, 16, 16, 4, generator=g, device=dev),
                      0.3 * torch.randn(2, frames, 16, 16, 4, generator=g, device=dev)], dim=-1)
    ctx = torch.randn(2, 77, 768, generator=g, device=dev)
    draws = dict(t=torch.tensor([10, 900], device=dev),
                 noise=torch.randn(2, frames, 16, 16, 4, generator=g, device=dev),
                 eps=torch.randn(2 * frames, 16, 16, 4, generator=g, device=dev))

    def loss_and_grads(model):
        state = vd.init_video_train_state(model, tcfg, dev)
        loss = vd.video_loss(state.unet, None, post, ctx, tcfg, **draws)
        loss.backward()
        return loss.item(), {n: p.grad for n, p in state.working.items()}

    build.reset_launches()
    loss_k, grads_k = loss_and_grads(unet)
    launched = _nonzero(build.launches)
    with _plain_versions():
        loss_p, grads_p = loss_and_grads(twin)
    worst = max((_rel(grads_k[n], grads_p[n]), n) for n in grads_p)
    total = _rel(torch.cat([grads_k[n].flatten() for n in grads_p]),
                 torch.cat([grads_p[n].flatten() for n in grads_p]))
    bound = F32_TRAIN_BOUND if f32 else TRAIN_BOUND
    wanted = {"flash_attention_fwd", "flash_attention_bwd", "temporal_attention_fwd",
              "temporal_attention_bwd", "ff_ln", "ff_ln_bwd"}
    if heads != 8:  # the attention and temporal kernels; the feed-forward's route varies
        wanted -= {"ff_ln", "ff_ln_bwd"}
    if f32:  # the f32 kernels only, each of the narrow model's
        wanted = {f"{k}_f32" for k in wanted}
    ok = (abs(loss_k - loss_p) <= bound * abs(loss_p) and total < bound
          and all(bool(torch.isfinite(v).all()) for v in grads_k.values())
          and (set(launched) == wanted if f32 else wanted <= set(launched)))
    say(f"train parity (64,128,128,128) {heads} heads, batch 2, {frames} frames of 16x16, "
        f"{'f32' if f32 else 'bf16'}, levels 0-1 recomputed: loss {loss_k:.6f} via kernels vs "
        f"{loss_p:.6f} via plain; {len(grads_p)} trainable gradients, rel_err of all {total:.3e} "
        f"(bound {bound:.0e}), worst tensor {worst[0]:.3e} ({worst[1]}); launches {launched} "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        fail(f"train parity ({'f32' if f32 else 'bf16'}, {heads} heads, {frames} frames)")
    if f32 or heads != 8:
        return

    # the same step with a soft attention_mask that asks for a gradient:
    # mask.grad through the kernels' dbias against autograd through the plain
    # attention (the plain versions patched in as above)
    mask0 = (1.0 - 2e-4 * torch.rand(2, 16, 16, generator=g, device=dev))
    mask0[:, ::5, ::3] = 0.0  # holes: bias -1e4

    def mask_grad(model):
        state = vd.init_video_train_state(model, tcfg, dev)
        mask = mask0.clone().requires_grad_()
        lat = post[..., :4] * vd.SD_VAE_SCALE
        noisy = vd.DDPMSchedule.create().add_noise(lat, draws["noise"], draws["t"])
        pred = state.unet(noisy.bfloat16(), draws["t"], ctx.bfloat16(), attention_mask=mask,
                          train=True, remat=True, remat_min_hw=tcfg.remat_min_hw).float()
        torch.mean((pred - draws["noise"]) ** 2).backward()
        return mask.grad

    build.reset_launches()
    mgrad_k = mask_grad(masked_pair[0])
    dbias_launches = build.launches["flash_attention_bwd_dbias"]
    with _plain_versions():
        mgrad_p = mask_grad(masked_pair[1])
    mask_err = _rel(mgrad_k, mgrad_p)
    ok = (mask_err < TRAIN_BOUND and bool(torch.isfinite(mgrad_k).all())
          and float(mgrad_k.abs().max()) > 0 and dbias_launches == EXPECTED_DBIAS_PER_MASKED_STEP)
    say(f"mask.grad parity, same narrow model, soft mask (2,16,16) with holes: rel_err "
        f"{mask_err:.3e} via kernels vs via plain (bound {TRAIN_BOUND:.0e}), max |grad| "
        f"{float(mgrad_k.abs().max()):.3e}, {dbias_launches} backward launches wrote dbias "
        f"(expected {EXPECTED_DBIAS_PER_MASKED_STEP}) {'ok' if ok else 'FAILED'}")
    if not ok:
        fail("mask.grad parity")


def _masked_step(torch, build, vd, state, post, contexts, f32=False):
    """One full-width forward/backward with a soft attention_mask (B, 36, 64)
    that asks for a gradient: the biased attention backward writes dbias0 and
    autograd carries it to ``mask.grad`` (``f32``: a compute_dtype="float32"
    state, through the f32 kernels)."""
    sfx = "_f32" if f32 else ""
    dev = post.device
    g = torch.Generator(device=dev).manual_seed(10)
    b = post.shape[0]
    mask = 1.0 - 2e-4 * torch.rand(b, 36, 64, generator=g, device=dev)
    mask[:, ::6, ::5] = 0.0  # holes: bias -1e4
    mask.requires_grad_()
    latents = post[..., :4].float() * vd.SD_VAE_SCALE
    t = torch.randint(0, 1000, (b,), generator=g, device=dev)
    noise = torch.randn(latents.shape, generator=g, device=dev)
    noisy = vd.DDPMSchedule.create().add_noise(latents, noise, t)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    pred = state.unet(noisy.to(state.dtype), t, contexts.to(state.dtype), attention_mask=mask,
                      train=True, remat=state.cfg.remat, remat_min_hw=state.cfg.remat_min_hw)
    loss = torch.mean((pred.float() - noise) ** 2)
    loss.backward()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launched = dict(build.launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    for p in state.unet.parameters():
        p.grad = None
    expected = dict(EXPECTED_F32_PER_TRAIN_STEP if f32 else EXPECTED_PER_TRAIN_STEP,
                    **{f"flash_attention_bwd_dbias{sfx}": EXPECTED_DBIAS_PER_MASKED_STEP})
    grad = mask.grad
    ok = (launched == expected and grad is not None and grad.shape == mask.shape
          and bool(torch.isfinite(grad).all()) and float(grad.abs().max()) > 0
          and bool(torch.isfinite(loss)))
    say(f"train{' f32' if f32 else ''}: masked step at batch {b}, soft attention_mask "
        f"({b},36,64) with holes, forward + backward {secs:.3f} s (no optimizer update), loss "
        f"{float(loss.detach()):.4f}, mask.grad finite, max |grad| {float(grad.abs().max()):.3e}, "
        f"{int((grad != 0).sum())} of {grad.numel()} non-zero; "
        f"{launched[f'flash_attention_bwd_dbias{sfx}']} of {launched[f'flash_attention_bwd{sfx}']} "
        f"backward launches wrote dbias (expected {EXPECTED_DBIAS_PER_MASKED_STEP} of "
        f"{_TRAIN_STEP['flash_attention_bwd']}), peak memory {peak:.2f} GiB "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        fail(f"train: the masked step launched {_nonzero(launched)}, expected "
             f"{_nonzero(expected)}, or mask.grad is missing, zero or not finite")
    return launched[f"flash_attention_bwd_dbias{sfx}"]


def _inference_main(torch, build, tmp, dana_latents):
    """cli.inference_eeg2video.main on the diffusers directories the trainer
    wrote: fresh-noise latents, then the DANA latents of the raw path, then
    fresh-noise latents again with ``--dtype float32`` (the parity mode: the
    f32 kernels, per UNet forward EXPECTED_F32_PER_FORWARD and nothing else)."""
    import numpy as np

    from eeg2video_tpu_torch.cli import inference_eeg2video
    from eeg2video_tpu_torch.data.video import load_gif

    emb = os.path.join(tmp, "embeddings.npy")
    np.save(emb, np.random.default_rng(11).standard_normal((3, 77 * 768)).astype(np.float32))
    np.save(os.path.join(tmp, "dana_latents.npy"), dana_latents)
    common = ["--embeddings", emb, "--unet", tmp, "--vae", tmp, "--limit", "2", "--batch", "2",
              "--num_inference_steps", str(STEPS), "--gif_encoder", "native"]
    runs = {"woSeq2Seq": ["--woSeq2Seq"],
            "Fullmodel": ["--dana_latents", os.path.join(tmp, "dana_latents.npy")],
            "woSeq2Seq_f32": ["--woSeq2Seq", "--dtype", "float32"]}
    gifs = {}
    for tag, extra in runs.items():
        out_dir = os.path.join(tmp, f"inference_{tag}")
        build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inference_eeg2video.main([*common, *extra, "--out_dir", out_dir])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        names = sorted(os.listdir(out_dir))
        frames = [load_gif(os.path.join(out_dir, n)) for n in names]
        f32 = tag.endswith("_f32")
        per_fwd = EXPECTED_F32_PER_FORWARD if f32 else EXPECTED_PER_FORWARD
        first = next(iter(per_fwd))
        forwards = build.launches[first] / per_fwd[first]
        launched = _nonzero(build.launches)
        ok = (names == ["0.gif", "1.gif"] and forwards == STEPS
              and all(f.shape == (6, 288, 512, 3) and f.std() > 0 for f in frames)
              and (not f32 or launched == {k: n * STEPS for k, n in per_fwd.items()}))
        say(f"inference_eeg2video.main --limit 2 --num_inference_steps {STEPS} {' '.join(extra)}: "
            f"{names} {[f.shape for f in frames]}, {forwards:g} UNet forwards, kernel launches "
            f"{launched}, {secs:.1f} s with loading the pipeline from the diffusers directories "
            f"{'ok' if ok else 'FAILED'}")
        if not ok:
            fail(f"inference_eeg2video.main ({tag}) did not write two 6-frame 288x512 GIFs")
        with open(os.path.join(out_dir, "0.gif"), "rb") as f:
            gifs[tag] = f.read()
    if gifs["woSeq2Seq"] == gifs["Fullmodel"]:
        fail("inference_eeg2video.main: noise latents and DANA latents gave the same GIF")


def phase_train(torch, build, vae, dana_latents):
    """The fine-tune path at full width through cli.train_tuneavideo.train."""
    from eeg2video_tpu_torch.cli import train_tuneavideo
    from eeg2video_tpu_torch.data.video import load_gif
    from eeg2video_tpu_torch.models.init import random_init_
    from eeg2video_tpu_torch.models.unet3d import UNet3DConditionModel, UNet3DConfig
    from eeg2video_tpu_torch.train import checkpoint as ckpt
    from eeg2video_tpu_torch.train import videodiffusion as vd

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    with torch.device("meta"):
        unet = UNet3DConditionModel(UNet3DConfig())
    unet = random_init_(unet.to_empty(device=dev), g)  # f32: the stored truth
    n_clips = TRAIN_BATCH * TRAIN_STEPS
    # synthetic clips: smooth random fields (8x upsampled noise) in [-1, 1]
    coarse = torch.randn(n_clips * 6, 3, 36, 64, generator=g, device=dev)
    pixels = torch.tanh(torch.nn.functional.interpolate(coarse, scale_factor=8, mode="bilinear"))
    pixels = pixels.permute(0, 2, 3, 1).reshape(n_clips, 6, 288, 512, 3)
    del coarse
    contexts = torch.randn(n_clips, 77, 768, generator=g, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    post = vd.encode_posteriors(vae, pixels)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    del pixels
    ok = tuple(post.shape) == (n_clips, 6, 36, 64, 8) and bool(torch.isfinite(post).all())
    say(f"train: {n_clips} synthetic clips of 6 x 288 x 512 -> posteriors {tuple(post.shape)} in "
        f"{enc_s:.2f} s ({enc_s / (n_clips * 6) * 1e3:.1f} ms a frame), mean std "
        f"{float(post[..., :4].std()):.3f} {'ok' if ok else 'FAILED'}")
    if not ok:
        fail("train: encode_posteriors gave a wrong shape or non-finite values")

    steps = []  # (seconds since the previous step ended, loss, launches)

    def on_step(state, loss):
        torch.cuda.synchronize()
        now = time.perf_counter()
        steps.append((now - clock[0], float(loss), dict(build.launches)))
        build.reset_launches()
        clock[0] = time.perf_counter()

    with tempfile.TemporaryDirectory(prefix="e2v_train_") as tmp:
        args = train_tuneavideo.build_parser().parse_args([
            "--device", "cuda", "--epochs", "1", "--train_batch_size", str(TRAIN_BATCH),
            "--validation_epochs", "1", "--validation_steps", "2", "--output_dir", tmp])
        # what was loaded: the trainable tensors in f32, the frozen ones as
        # the bf16 working copy will hold them
        loaded = {n: p.detach().clone() if vd.trainable(n) else p.detach().to(torch.bfloat16)
                  for n, p in unet.named_parameters()}
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        clock = [time.perf_counter()]
        t_run = clock[0]
        state, losses = train_tuneavideo.train(unet, vae, post, contexts, args, on_step=on_step)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t_run
        after_steps = dict(build.launches)  # the validation sample's launches
        peak = torch.cuda.max_memory_allocated() / 2**30

        n_train = sum(p.numel() for p in state.masters.values())
        say(f"train: UNet3DConfig() {sum(p.numel() for p in state.unet.parameters())} params, "
            f"{n_train} trainable in {len(state.masters)} tensors (f32 masters, bf16 working copy), "
            f"batch {TRAIN_BATCH}, levels 0-1 recomputed")
        step_s = [round(s[0], 3) for s in steps]
        step_loss = [round(s[1], 4) for s in steps]
        ok = (len(steps) == TRAIN_STEPS and state.step == TRAIN_STEPS
              and all(0.2 < l < 10.0 for l in step_loss))
        say(f"train: {len(steps)} optimizer steps, loss per step {step_loss} (random weights: "
            f"near 1 expected), seconds per step {step_s} (the first includes building the train "
            f"state), "
            f"whole run with the validation sample and the checkpoint {run_s:.1f} s, peak memory "
            f"{peak:.2f} GiB {'ok' if ok else 'FAILED'}")
        if not ok:
            fail("train: wrong number of steps or a loss that is not finite and near 1")
        for i, (_, _, launched) in enumerate(steps):
            ok = launched == EXPECTED_PER_TRAIN_STEP
            say(f"train: step {i} launches {launched} {'ok' if ok else 'FAILED'}")
            if not ok:
                fail(f"train: step {i} did not launch the expected kernels "
                     f"{EXPECTED_PER_TRAIN_STEP}")

        # the freeze rule, the optimizer's state and the working copy
        working = dict(state.unet.named_parameters())
        moved = [n for n, p in state.masters.items() if not torch.equal(p.detach(), loaded[n])
                 and torch.equal(working[n].detach(), p.detach().to(torch.bfloat16))]
        frozen_changed = [n for n, p in working.items()
                          if n not in state.masters and not torch.equal(p, loaded[n])]
        with_state = {id(p) for p in state.optimizer.state}
        held = {id(p) for grp in state.optimizer.param_groups for p in grp["params"]}
        stray = [n for n, p in working.items() if n not in state.masters
                 and (p.grad is not None or p.requires_grad or id(p) in held)]
        ok = (len(moved) == len(state.masters) and not frozen_changed and not stray
              and with_state == held == {id(p) for p in state.masters.values()}
              and all(vd.trainable(n) for n in state.masters))
        say(f"train: {len(moved)} of {len(state.masters)} trainable tensors changed and have Adam "
            f"moments; {len(frozen_changed)} of {len(working) - len(state.masters)} frozen tensors "
            f"changed, {len(stray)} of them hold a gradient or optimizer state "
            f"{'ok' if ok else 'FAILED'}")
        if not ok:
            fail("train: the freeze rule or the optimizer's state is wrong")
        del loaded

        gif = os.path.join(tmp, "samples", "sample-1.gif")
        frames = load_gif(gif)
        file = ckpt.latest_checkpoint(os.path.join(tmp, "ckpt"))
        sizes = {name: os.path.getsize(os.path.join(tmp, name, "diffusion_pytorch_model.bin"))
                 for name in ("unet", "vae")}
        ok = frames.shape == (6, 288, 2 * 512, 3) and frames.std() > 0 and file is not None
        say(f"train: validation sample {frames.shape} (2 clips, 2 DDIM steps, launches "
            f"{ {k: v for k, v in after_steps.items() if v} }), train state "
            f"{os.path.getsize(file) / 2**30:.2f} GiB, diffusers layout unet "
            f"{sizes['unet'] / 2**30:.2f} GiB vae {sizes['vae'] / 2**30:.2f} GiB "
            f"{'ok' if ok else 'FAILED'}")
        if not ok:
            fail("train: the validation GIF or the checkpoint is missing or malformed")

        # one more step from the live state; then restore the checkpoint
        # (written after step 3) and take the same step again
        batch, bctx = post[:TRAIN_BATCH], contexts[:TRAIN_BATCH]
        vd.train_step(state, vae, batch, bctx, args.seed)
        straight = {n: p.detach().clone() for n, p in state.masters.items()}
        t0 = time.perf_counter()
        restored = ckpt.restore_train_state(file, state)
        load_s = time.perf_counter() - t0
        vd.train_step(state, vae, batch, bctx, args.seed)
        torch.cuda.synchronize()
        same = [torch.equal(p.detach(), straight[n]) for n, p in state.masters.items()]
        ok = restored == TRAIN_STEPS and state.step == TRAIN_STEPS + 1 and all(same)
        say(f"train: restore (step {restored}, {load_s:.1f} s) + one step vs that step without "
            f"the interruption: {sum(same)} of {len(same)} trainable tensors bit-equal "
            f"{'ok' if ok else 'FAILED'}")
        if not ok:
            fail("train: a resumed step differs from the uninterrupted one")

        _profile_step(torch, lambda: vd.train_step(state, vae, batch, bctx, args.seed))
        dbias_launches = _masked_step(torch, build, vd, state, batch, bctx)
        del state
        torch.cuda.empty_cache()
        _inference_main(torch, build, tmp, dana_latents)

    return {k: sum(s[2][k] for s in steps) for k in EXPECTED_PER_TRAIN_STEP}, dbias_launches


def _full_width_unet(torch, seed):
    """UNet3DConfig() in f32 on the card, random weights from ``seed``."""
    from eeg2video_tpu_torch.models.init import random_init_
    from eeg2video_tpu_torch.models.unet3d import UNet3DConditionModel, UNet3DConfig

    g = torch.Generator(device="cuda").manual_seed(seed)
    with torch.device("meta"):
        unet = UNet3DConditionModel(UNet3DConfig())
    return random_init_(unet.to_empty(device="cuda"), g), g


def phase_f32_generation(torch, build):
    """The parity mode (``--dtype float32``) at full width: one UNet3DConfig()
    forward of 2 samples (one clip's guidance pair) at f32 through the f32
    kernels, against the same forward with the plain versions in their place;
    launches counted; then the forward under torch.profiler."""
    dev = torch.device("cuda")
    unet, g = _full_width_unet(torch, 12)
    unet.eval()
    sample = torch.randn(2, 6, 36, 64, 4, generator=g, device=dev)
    ctx = torch.randn(2, 77, 768, generator=g, device=dev)
    t = torch.tensor([10, 900], device=dev)
    with torch.inference_mode():
        unet(sample, t, ctx)  # warm-up: the library's first calls at these shapes
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        got = unet(sample, t, ctx)
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) * 1e3
        launches = dict(build.launches)
        with _plain_versions():
            want = unet(sample, t, ctx)
    worst = ((got - want).abs() - (F32_UNET_ATOL + F32_UNET_RTOL * want.abs())).max().item()
    rel = _rel(got, want)
    ok = (bool(torch.isfinite(got).all()) and worst <= 0
          and _nonzero(launches) == EXPECTED_F32_PER_FORWARD)
    say(f"f32 generation: UNet3DConfig() forward of 2 samples, 6 frames of 36x64, f32 on the card: "
        f"{fwd_ms:.1f} ms on the host clock, launches {_nonzero(launches)} (expected "
        f"{EXPECTED_F32_PER_FORWARD}, no conv: JAX sends f32 convs to XLA); against the same "
        f"forward via the plain versions: rel_err {rel:.3e}, worst |got - want| - (atol "
        f"{F32_UNET_ATOL:.0e} + rtol {F32_UNET_RTOL:.0e} |want|) {worst:.3e} "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        fail("f32 generation: the f32 forward did not go through the f32 kernels alone, or "
             "disagrees with its plain-patched self")
    del got, want
    with torch.inference_mode():
        _profile_step(torch, lambda: unet(sample, t, ctx),
                      what="f32 generation: one UNet forward of 2 samples")
    del unet
    torch.cuda.empty_cache()
    return launches


def phase_narrow_bf16(torch, build):
    """UNet3DConfig.tiny() (C = 32: the feed-forward through ``ff_ln`` on
    operands padded to its 64-column grid) in bf16 on the card, against its
    plain-patched self."""
    import dataclasses

    from eeg2video_tpu_torch.models.init import random_init_
    from eeg2video_tpu_torch.models.unet3d import UNet3DConditionModel, UNet3DConfig

    dev = torch.device("cuda")
    cfg = dataclasses.replace(UNet3DConfig.tiny(), cross_attention_dim=768)
    g = torch.Generator(device=dev).manual_seed(13)
    unet = random_init_(UNet3DConditionModel(cfg).to(dev), g).to(torch.bfloat16).eval()
    sample = torch.randn(2, 6, 16, 16, 4, generator=g, device=dev).bfloat16()
    ctx = torch.randn(2, 77, 768, generator=g, device=dev).bfloat16()
    t = torch.tensor([10, 900], device=dev)
    build.reset_launches()
    with torch.inference_mode():
        got = unet(sample, t, ctx)
        torch.cuda.synchronize()
        launches = _nonzero(build.launches)
        with _plain_versions():
            want = unet(sample, t, ctx)
    err = _rel(got, want)
    ok = (bool(torch.isfinite(got.float()).all()) and err < UNET_BOUND
          and launches.get("ff_ln", 0) > 0 and not any(k.endswith("_f32") for k in launches))
    say(f"narrow bf16: UNet3DConfig.tiny() (C 32/64, 4 heads) forward of 2 samples, 6 frames of "
        f"16x16: launches {launches}; against the same forward via the plain versions rel_err "
        f"{err:.3e} (bound {UNET_BOUND:.0e}) {'ok' if ok else 'FAILED'}")
    if not ok:
        fail("narrow bf16: the tiny UNet did not run ff_ln at C = 32, or disagrees")


def phase_f32_train(torch, build):
    """compute_dtype="float32" at full width: one optimizer step at batch 10
    through the f32 kernels (launches counted, 0 conv), its time and peak
    memory, a profiled step, and one masked forward/backward whose mask asks
    for a gradient (the f32 dbias launches)."""
    from eeg2video_tpu_torch.train import videodiffusion as vd

    dev = torch.device("cuda")
    unet, g = _full_width_unet(torch, 14)
    tcfg = vd.VideoDiffusionTrainConfig(compute_dtype="float32")
    state = vd.init_video_train_state(unet, tcfg, dev)
    b = TRAIN_BATCH
    # posteriors (mean || logvar) of synthetic clips: the loss samples them
    post = torch.cat([torch.randn(b, 6, 36, 64, 4, generator=g, device=dev),
                      -4.0 + 0.1 * torch.randn(b, 6, 36, 64, 4, generator=g, device=dev)], dim=-1)
    ctx = torch.randn(b, 77, 768, generator=g, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    loss = float(vd.train_step(state, None, post, ctx, 0))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(build.launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    ok = launches == EXPECTED_F32_PER_TRAIN_STEP and 0.2 < loss < 10.0 and state.step == 1
    say(f"f32 train: UNet3DConfig() compute_dtype=float32, one optimizer step at batch {b}, "
        f"levels 0-1 recomputed: loss {loss:.4f}, {secs:.3f} s, peak memory {peak:.2f} GiB, "
        f"launches {_nonzero(launches)} (expected {_nonzero(EXPECTED_F32_PER_TRAIN_STEP)}, "
        f"0 conv) {'ok' if ok else 'FAILED'}")
    if not ok:
        fail("f32 train: the step did not launch the f32 kernels as expected, or its loss is "
             "not finite and near 1")
    _profile_step(torch, lambda: vd.train_step(state, None, post, ctx, 0), what="f32 train: one step")
    dbias = _masked_step(torch, build, vd, state, post, ctx, f32=True)
    del state, unet
    torch.cuda.empty_cache()
    return launches, dbias


# --- the rest of the training recipe: the front-half trainers, the 8-bit and
# accumulated fine-tune, the semantic CLI and the latent encoder -------------

SEM_ROWS, SEM_BATCH = 1200, 32   # the reference's 6 x 200 rows, batch 32
S2S_WINDOWS = 1200               # the reference's 6 x 200 training windows
ACCUM = 2                        # micro steps an optimizer step (--gradient_accumulation_steps)
ADAMW_TRAIN_PEAK_GIB = 22.02      # the AdamW train step's peak at batch 10 (PERF.md §5)


def _sync_clock(torch):
    torch.cuda.synchronize()
    return time.perf_counter()


def _trainer_steps(torch):
    """``on_step`` for the trainers: the synchronized seconds between steps
    and the optimizer's state bytes after the last."""
    from eeg2video_tpu_torch.train.optim import state_bytes

    rec = {"t": [_sync_clock(torch)], "state_bytes": 0, "losses": []}

    def on_step(step, loss, opt):
        rec["t"].append(_sync_clock(torch))
        rec["losses"].append(float(loss))
        rec["state_bytes"] = state_bytes(opt)

    return rec, on_step


def phase_train_semantic(torch, build, card, tmp):
    """(a) ``train.semantic.train_semantic`` at full width: one epoch with f32
    Adam and one with 8-bit Adam on 1200 seeded rows; then one 8-bit step on
    the card against the same step on the CPU from the same gradients and
    state. Returns the 8-bit run's state dict and the run's launches."""
    import numpy as np

    from eeg2video_tpu_torch.models.init import lecun_init_
    from eeg2video_tpu_torch.models.semantic import SemanticPredictor
    from eeg2video_tpu_torch.train import optim
    from eeg2video_tpu_torch.train import semantic as sem
    from eeg2video_tpu_torch.train.checkpoint import host_copy

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(31)
    # targets a seeded linear map of the features: a function the MLP can learn
    x = torch.randn(SEM_ROWS, 310, generator=g, device=dev)
    w = torch.randn(310, 77 * 768, generator=g, device=dev) * (0.1 / 310 ** 0.5)
    eeg, text = x.cpu().numpy(), (x @ w).cpu().numpy()
    del x, w
    build.reset_launches()
    result = {}
    for eight_bit in (False, True):
        cfg = sem.SemanticTrainConfig(epochs=1, batch_size=SEM_BATCH, use_8bit_adam=eight_bit)
        rec, on_step = _trainer_steps(torch)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        sd, losses = sem.train_semantic(eeg, text, cfg, seed=7, device=dev, on_step=on_step)
        peak = torch.cuda.max_memory_allocated() / 2**30
        steps = np.diff(rec["t"])
        n_params = sum(v.numel() for v in sd.values())
        ok = (len(steps) == SEM_ROWS // SEM_BATCH and all(np.isfinite(rec["losses"]))
              and np.isfinite(losses[0]) and rec["losses"][-1] < rec["losses"][0])
        name = "8-bit Adam" if eight_bit else "f32 Adam"
        say(f"train_semantic: SemanticPredictor() {n_params} params, {name}, one epoch of "
            f"{len(steps)} steps at batch {SEM_BATCH} on {SEM_ROWS} seeded rows: loss first "
            f"{rec['losses'][0]:.5f} last {rec['losses'][-1]:.5f} (epoch sum {losses[0]:.4f}), "
            f"s/step median {np.median(steps[1:]):.4f} (first {steps[0]:.3f}, synchronized), "
            f"peak memory {peak:.2f} GiB, optimizer state {rec['state_bytes'] / 1e9:.3f} GB "
            f"[{card}] {'ok' if ok else 'FAILED'}")
        if not ok:
            fail(f"train_semantic ({name}): a non-finite loss, or the loss did not fall")
        result[eight_bit] = (np.median(steps[1:]), rec["state_bytes"])
        if not eight_bit:
            del sd
    launches = dict(build.launches)

    # one 8-bit step: its share of a step, then the card's update against the
    # CPU's from the same gradients and state
    with torch.device("meta"):
        model = SemanticPredictor()
    model = lecun_init_(model.to_empty(device=dev), torch.Generator(device=dev).manual_seed(8))
    opt = optim.Adam8bit(model.parameters(), lr=5e-4)
    x = torch.from_numpy(eeg[:SEM_BATCH]).to(dev)
    y = torch.from_numpy(text[:SEM_BATCH]).to(dev)

    def grads():
        opt.zero_grad(set_to_none=True)
        torch.mean((model(x) - y) ** 2).backward()

    fwd_bwd, step = [], []
    for _ in range(4):
        t0 = _sync_clock(torch)
        grads()
        t1 = _sync_clock(torch)
        opt.step()
        t2 = _sync_clock(torch)
        fwd_bwd.append(t1 - t0)
        step.append(t2 - t1)
    grads()
    params = {n: p for n, p in model.named_parameters()}

    def rows(t):
        """The first 2048 of a weight's rows (a row runs along the first axis:
        a column of the (out, in) weight, scaled as a whole), all of a bias."""
        return t[:, :2048] if t.dim() == 2 else t

    before = {n: host_copy((rows(p.detach()), rows(p.grad),
                            {k: rows(v) if torch.is_tensor(v) else v
                             for k, v in opt.state[p].items()})) for n, p in params.items()}
    opt.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    worst_code, worst_param, n_codes, n_equal = 0, 0.0, 0, 0
    for n, p in params.items():
        p0, g0, st = before.pop(n)
        u, mq, ms, vq, vs = optim.adam8_update(g0, st["mq"], st["ms"], st["vq"], st["vs"],
                                               st["count"] + 1, 0.9, 0.999, 1e-8)
        want = p0 + u * -5e-4
        got = opt.state[p]
        for cpu_codes, card_codes in ((mq, got["mq"]), (vq, got["vq"])):
            diff = (cpu_codes.int() - rows(card_codes).cpu().int()).abs()
            worst_code = max(worst_code, int(diff.max()))
            n_codes += diff.numel()
            n_equal += int((diff == 0).sum())
        largest = float((want - p0).abs().max())
        worst_param = max(worst_param,
                          float((rows(p.detach()).cpu() - want).abs().max()) / largest)
    cpu_s = time.perf_counter() - t0
    ok = worst_code <= 1 and worst_param <= 1e-6
    share = np.median(step) / result[True][0]
    say(f"train_semantic: one 8-bit step on the card vs the CPU from the same gradients and "
        f"state ({n_codes // 2} of {sum(p.numel() for p in params.values())} values: every "
        f"bias, 2048 whole rows of each weight): int8 codes at most {worst_code} apart "
        f"({n_equal / n_codes:.6f} equal), parameters within {worst_param:.2e} of the step's "
        f"largest update (bound 1 apart, 1e-6); CPU step {cpu_s:.1f} s; card: forward + backward "
        f"{np.median(fwd_bwd) * 1e3:.2f} ms, the eager 8-bit step {np.median(step) * 1e3:.2f} ms "
        f"({share:.3f} of the 8-bit training step); optimizer state 8-bit "
        f"{result[True][1] / 1e9:.3f} GB against f32 Adam's {result[False][1] / 1e9:.3f} GB "
        f"[{card}] {'ok' if ok else 'FAILED'}")
    if not ok:
        fail("train_semantic: the card's 8-bit step differs from the CPU's")
    del model, opt, params
    torch.cuda.empty_cache()
    return sd, launches


def phase_inference_semantic(torch, build, card, tmp, sd):
    """(d) ``cli.inference_semantic --int8`` through its ``main`` on the
    trained full-width weights: 200 block-6 rows, ``int8_dense`` launched, the
    embeddings against the f32 MLP's."""
    import numpy as np

    from eeg2video_tpu_torch.cli import inference_semantic
    from eeg2video_tpu_torch.data import meta
    from eeg2video_tpu_torch.train import semantic as sem
    from eeg2video_tpu_torch.utils import StandardScaler

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(32)
    feats = (3.0 * torch.randn(7, 40, 5, 62, 5, generator=g, device=dev) + 1.0).cpu().numpy()
    np.save(os.path.join(tmp, "de.npy"), feats)
    scaler = StandardScaler().fit(feats[:6].reshape(-1, 310))
    scaler.save(os.path.join(tmp, "scaler.npz"))
    torch.save({k: v.cpu() for k, v in sd.items()}, os.path.join(tmp, "semantic.pt"))
    out = os.path.join(tmp, "emb.npy")
    build.reset_launches()
    t0 = _sync_clock(torch)
    inference_semantic.main(["--features", os.path.join(tmp, "de.npy"), "--ckpt",
                             os.path.join(tmp, "semantic.pt"), "--scaler",
                             os.path.join(tmp, "scaler.npz"), "--hidden",
                             str(sd["fc0.weight"].shape[0]), "--int8", "--out", out])
    secs = _sync_clock(torch) - t0
    launches = dict(build.launches)
    emb = np.load(out)
    eeg = scaler.transform(meta.reorder_by_gt(feats[6], 6).reshape(-1, 310))
    ref = sem.predict_semantic(sd, eeg, device=dev)
    cos = float((emb * ref).sum() / np.sqrt((emb * emb).sum() * (ref * ref).sum()))
    n_chunks = -(-200 // sem.PREDICT_CHUNK)
    ok = (emb.shape == (200, 77 * 768) and np.isfinite(emb).all() and cos > 0.999
          and launches["int8_dense"] == INT8_LAYERS * n_chunks)
    say(f"inference_semantic --int8: 200 block-6 rows at full width through main, "
        f"{secs:.2f} s with loading the {os.path.getsize(os.path.join(tmp, 'semantic.pt')) / 1e9:.2f}"
        f" GB checkpoint and quantizing; embeddings "
        f"{emb.shape}, cosine against the f32 MLP {cos:.6f} (bound 0.999), int8_dense launches "
        f"{launches['int8_dense']} ({n_chunks} chunks of {INT8_LAYERS}) [{card}] "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        fail("inference_semantic --int8: wrong embeddings, or int8_dense did not launch")
    return launches


def phase_train_seq2seq(torch, build, card):
    """(b) ``train.seq2seq.train_seq2seq`` on ``Seq2SeqTransformer()``, one
    epoch at batch 32 on 1200 seeded windows."""
    import numpy as np

    from eeg2video_tpu_torch.train import seq2seq as s2s

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(33)
    eeg = torch.randn(S2S_WINDOWS, 7, 62, 100, generator=g, device=dev).cpu().numpy()
    lat = torch.randn(S2S_WINDOWS, 6, 4, 36, 64, generator=g, device=dev).cpu().numpy()
    rec, on_step = _trainer_steps(torch)
    build.reset_launches()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sd, losses = s2s.train_seq2seq(eeg, lat, s2s.Seq2SeqTrainConfig(epochs=1), seed=9,
                                   device=dev, on_step=on_step)
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = dict(build.launches)
    steps = np.diff(rec["t"])
    n_params = sum(v.numel() for k, v in sd.items() if v.is_floating_point()
                   and "running" not in k and k != "positional_encoding.pe")
    ok = (len(steps) == S2S_WINDOWS // 32 and all(np.isfinite(rec["losses"]))
          and rec["losses"][-1] < rec["losses"][0])
    say(f"train_seq2seq: Seq2SeqTransformer() {n_params} params, dropout on, one epoch of "
        f"{len(steps)} steps at batch 32 on {S2S_WINDOWS} seeded windows (7, 62, 100) -> "
        f"(6, 4, 36, 64): loss first {rec['losses'][0]:.4f} last {rec['losses'][-1]:.4f}, "
        f"s/step median {np.median(steps[1:]):.4f} (first {steps[0]:.3f}, synchronized), "
        f"peak memory {peak:.2f} GiB [{card}] {'ok' if ok else 'FAILED'}")
    if not ok:
        fail("train_seq2seq: a non-finite loss, or the loss did not fall")
    return launches


def phase_train_8bit_accum(torch, build, card, tmp):
    """(c) the fine-tune through ``cli.train_tuneavideo.train`` at
    UNet3DConfig(), batch 10, ``--use_8bit_adam --gradient_accumulation_steps
    2``: two optimizer steps of two micro steps; each micro step launches what
    a plain step does; the session's save restores bit for bit."""
    from eeg2video_tpu_torch.cli import train_tuneavideo
    from eeg2video_tpu_torch.models.init import random_init_
    from eeg2video_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from eeg2video_tpu_torch.train import checkpoint as ckpt
    from eeg2video_tpu_torch.train.optim import Adam8bit, state_bytes

    dev = torch.device("cuda")
    unet, g = _full_width_unet(torch, 15)
    b, n = TRAIN_BATCH, TRAIN_BATCH * 2 * ACCUM
    post = torch.cat([torch.randn(n, 6, 36, 64, 4, generator=g, device=dev),
                      -4.0 + 0.1 * torch.randn(n, 6, 36, 64, 4, generator=g, device=dev)], dim=-1)
    ctx = torch.randn(n, 77, 768, generator=g, device=dev)
    with torch.device("meta"):
        vae = AutoencoderKL(VAEConfig())
    vae = random_init_(vae.to_empty(device=dev), g)  # posteriors are given: no encode
    micro = []  # (seconds since the previous micro step ended, loss, launches)

    def on_step(state, loss):
        now = _sync_clock(torch)
        micro.append((now - clock[0], float(loss), dict(build.launches)))
        build.reset_launches()
        clock[0] = _sync_clock(torch)

    out = os.path.join(tmp, "accum")
    args = train_tuneavideo.build_parser().parse_args([
        "--device", "cuda", "--epochs", "1", "--train_batch_size", str(b), "--use_8bit_adam",
        "--gradient_accumulation_steps", str(ACCUM), "--validation_epochs", "9",
        "--output_dir", out])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    clock = [_sync_clock(torch)]
    state, losses = train_tuneavideo.train(unet, vae, post, ctx, args, on_step=on_step)
    peak = torch.cuda.max_memory_allocated() / 2**30
    per_opt = [sum(m[0] for m in micro[i:i + ACCUM]) for i in range(0, len(micro), ACCUM)]
    total = {k: sum(m[2][k] for m in micro) for k in EXPECTED_PER_TRAIN_STEP}
    per_step = {k: v // (len(micro) // ACCUM) for k, v in total.items()}
    ok = (len(micro) == 2 * ACCUM and state.step == 2 * ACCUM and state.mini_step == 0
          and isinstance(state.optimizer, Adam8bit)
          and all(m[2] == EXPECTED_PER_TRAIN_STEP for m in micro)
          and all(0.2 < m[1] < 10.0 for m in micro))
    say(f"train 8-bit + accumulation: UNet3DConfig(), batch {b}, --use_8bit_adam "
        f"--gradient_accumulation_steps {ACCUM}: {len(micro)} micro steps = "
        f"{len(micro) // ACCUM} optimizer steps, losses {[round(m[1], 4) for m in micro]}, "
        f"s per optimizer step {[round(s, 3) for s in per_opt]} (the first includes building "
        f"the train state), s per micro step {[round(m[0], 3) for m in micro]}, peak memory "
        f"{peak:.2f} GiB (AdamW step at batch 10: {ADAMW_TRAIN_PEAK_GIB} GiB, PERF.md), optimizer "
        f"state {state_bytes(state.optimizer) / 2**20:.1f} MiB for "
        f"{sum(p.numel() for p in state.masters.values())} trainable values; launches per "
        f"optimizer step {_nonzero(per_step)} (twice a plain step's) [{card}] "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        fail("train 8-bit + accumulation: wrong step counts, launches or losses")

    # the session wrote the train state at the run's end: restore it into the
    # live state and compare every tensor with the state before the restore
    file = ckpt.latest_checkpoint(os.path.join(out, "ckpt"))
    live = ckpt.host_copy(state.state_dict())
    t0 = time.perf_counter()
    restored = ckpt.restore_train_state(file, state)
    load_s = time.perf_counter() - t0
    again = state.state_dict()
    same, n_tensors = [], 0
    for key in ("params", "accum"):
        for k, v in live[key].items():
            same.append(torch.equal(v, again[key][k].cpu()))
    for i, st in live["opt_state"]["state"].items():
        for k, v in st.items():
            if torch.is_tensor(v):
                same.append(torch.equal(v, again["opt_state"]["state"][i][k].cpu())
                            and again["opt_state"]["state"][i][k].dtype == v.dtype)
    ok = restored == 2 * ACCUM and all(same) and file.endswith("train_state_1.pt")
    say(f"train 8-bit + accumulation: CheckpointSession's train state "
        f"{os.path.getsize(file) / 2**30:.2f} GiB restored in {load_s:.1f} s: {sum(same)} of "
        f"{len(same)} tensors (parameters, int8 moments and scales, the accumulator) bit-equal "
        f"[{card}] {'ok' if ok else 'FAILED'}")
    if not ok:
        fail("train 8-bit + accumulation: the session's checkpoint does not restore bit for bit")
    del state, unet, vae, post
    torch.cuda.empty_cache()
    return total


def phase_generate_latents(torch, build, card, tmp):
    """(e) ``cli.generate_video_latents.encode_gifs`` on two seeded 6-frame
    288x512 GIF clips with VAEConfig() in f32: (2, 4, 6, 36, 64); one frame
    against the same frame encoded on the CPU."""
    import numpy as np

    from eeg2video_tpu_torch.cli import generate_video_latents as gen
    from eeg2video_tpu_torch.data.video import save_videos_grid
    from eeg2video_tpu_torch.models.init import random_init_
    from eeg2video_tpu_torch.models.vae import AutoencoderKL, VAEConfig

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(34)
    paths = []
    for i in range(2):
        coarse = torch.rand(6, 3, 36, 64, generator=g, device=dev)
        clip = torch.nn.functional.interpolate(coarse, scale_factor=8, mode="bilinear")
        path = os.path.join(tmp, "gifs", f"{i}.gif")
        save_videos_grid(clip.permute(0, 2, 3, 1)[None].clamp(0, 1).cpu().numpy(), path,
                         encoder="native")
        paths.append(path)
    with torch.device("meta"):
        vae = AutoencoderKL(VAEConfig())
    vae = random_init_(vae.to_empty(device=dev), g).eval().requires_grad_(False)
    build.reset_launches()
    t0 = _sync_clock(torch)
    z = gen.encode_gifs(vae, paths)
    secs = _sync_clock(torch) - t0
    launches = dict(build.launches)
    frame = torch.from_numpy(gen.load_gif(paths[1])[2]).float().div_(127.5).sub_(1.0)
    with torch.no_grad():
        cpu = vae.cpu().encode(frame[None])[0][0].permute(2, 0, 1).numpy()
    err = np.abs(z[1, :, 2] - cpu)
    ok = (z.shape == (2, 4, 6, 36, 64) and np.isfinite(z).all()
          and bool((err <= 1e-4 + 1e-3 * np.abs(cpu)).all()))
    say(f"generate_video_latents: 2 seeded GIF clips of 6 x 288 x 512, VAEConfig() f32 -> "
        f"{z.shape} posterior means in {secs:.2f} s ({secs / 12 * 1e3:.1f} ms a frame with "
        f"decoding the GIFs); clip 1 frame 2 against the CPU's encode: max abs err "
        f"{float(err.max()):.2e} (rtol 1e-3 / atol 1e-4) [{card}] {'ok' if ok else 'FAILED'}")
    if not ok:
        fail("generate_video_latents: wrong shape, or the card's frame differs from the CPU's")
    return launches


def phase_recipe(torch, build, card):
    """The training recipe's remaining paths, each driven with the launch
    counts set to 0 just before it; returns their launches by path."""
    with tempfile.TemporaryDirectory(prefix="e2v_recipe_") as tmp:
        sd, sem_launches = phase_train_semantic(torch, build, card, tmp)
        infer_launches = phase_inference_semantic(torch, build, card, tmp, sd)
        del sd
        torch.cuda.empty_cache()
        s2s_launches = phase_train_seq2seq(torch, build, card)
        accum_launches = phase_train_8bit_accum(torch, build, card, tmp)
        latent_launches = phase_generate_latents(torch, build, card, tmp)
    return {"train_semantic": sem_launches, "inference_semantic": infer_launches,
            "train_seq2seq": s2s_launches, "train_8bit_accum": accum_launches,
            "generate_latents": latent_launches}


# section 11: the EEG front end
PEAK_F64_FLOPS = 33.5e12          # H100 SXM, FP64 without tensor cores (NVIDIA data sheet)
# Dependent FP add / multiply latency in cycles, f32 / f64, as microbenchmarks
# measured it on Volta (Jia et al. 2018, "Dissecting the NVIDIA Volta GPU
# Architecture via Microbenchmarking", arXiv:1804.06826); NVIDIA publishes none
# for Hopper. Taken as Hopper's, not measured: the latency bound rests on it.
FP_LATENCY_CYCLES = {4: 4, 8: 8}
IIR_SECTIONS, IIR_PADLEN = 4, 27  # the order-4 bandpass: 4 biquads, padlen 3 (2 * 4 + 1)
IIR_OPS = 9                       # a biquad's step: 5 products, 4 sums (csrc/sos_filtfilt.cu)
IIR_SWEEP = (1, 8)                # biquads also timed at full size, beside the path's 4
SUBJECT = (7, 62, 104000)         # a raw subject: 7 blocks of 40 x (3 s + 5 x 2 s) at 200 Hz
# float32 against scipy's float64: tests/test_bandpass.py::test_bandpass_filter_matches_scipy_f32
# holds 400-sample rows at 1-49 Hz to atol 5e-4 + rtol 1e-3 (JAX_F32_BOUND). At a whole
# subject, 104,000 samples a row and a 0.5 Hz edge, no float32 cascade keeps it: on this
# subject's 434 unit-variance rows JAX's own float32 filter reaches 1.73e-3 (2.6e-4 of the
# output's max; 66 samples beyond it), the port's plain version 2.48e-3 (3.7e-4; 86), on
# the CPU. Held to 1e-3 of the output's max; the samples beyond the JAX test's bound are
# printed.
JAX_F32_BOUND = dict(atol=5e-4, rtol=1e-3)
F32_VS_SCIPY = 1e-3
SCIPY_F64_ABS = 1e-6              # tests/test_bandpass.py::test_filtfilt_matches_scipy_f64_subprocess
IIR_PLAIN_T = 4000                # the plain version's length on the card (its steps are eager ops)
GLMNET_EPOCHS, EEGVP_EPOCHS = 2, 5
IIR_SOURCE = "eeg2video_tpu_torch/csrc/sos_filtfilt.cu"
IIR_REPLACES = "eeg2video_tpu/dsp/bandpass.py:177 _sos_scan (lax.scan, no pallas_call)"


def _sm_clock_during_mhz(fn, torch, seconds):
    """The median SM clock that ``nvidia-smi`` samples while ``fn`` runs over
    and over for ``seconds``; None where it gave no sample."""
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
                            "-lms", "100"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                           text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            fn()
        torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=60)
    samples = [float(v) for v in out.split() if v.replace(".", "", 1).isdigit()]
    return statistics.median(samples) if samples else None


def _plain_on_host(torch, iir, sos, zi, x, rows, t):
    """The plain version on the host's CPU at the path's full shape; returns
    (out, seconds). A step's ops are on (rows, sections) tensors: one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        t0 = time.perf_counter()
        xt = torch.from_numpy(x.reshape(rows, t))
        out = iir.filtfilt_plain(xt, torch.as_tensor(sos).to(xt.dtype),
                                 torch.as_tensor(zi).to(xt.dtype), IIR_PADLEN, tf=False)
        return out, time.perf_counter() - t0
    finally:
        torch.set_num_threads(threads)


def _iir_check(torch, build, x, x64, filt32, filt64, report, card):
    """(a) the kernel's full-size outputs on the path against scipy's float64
    sosfiltfilt and, bit for bit, against its plain version on the same inputs
    (on the host's CPU); against the plain version on the card at (434,
    IIR_PLAIN_T), twice bit for bit; its times and bounds."""
    import numpy as np
    from scipy import signal

    from eeg2video_tpu_torch.dsp import bandpass as bp
    from eeg2video_tpu_torch.ops import iir

    sos = bp.butter_bandpass_sos(4, 0.5, 47.0, 200.0)
    zi = bp._sos_zi(sos)
    rows, t = x.shape[0] * x.shape[1], x.shape[2]
    n_ext = t + 2 * IIR_PADLEN
    t0 = time.perf_counter()
    want64 = signal.sosfiltfilt(sos, x64.reshape(rows, t), axis=-1, padlen=IIR_PADLEN)
    scipy_ms = (time.perf_counter() - t0) * 1e3
    want32 = signal.sosfiltfilt(sos, x.reshape(rows, t).astype(np.float64), axis=-1,
                                padlen=IIR_PADLEN)
    got32 = filt32.reshape(rows, t).cpu().numpy()
    got64 = filt64.reshape(rows, t).cpu().numpy()
    beyond = int(np.sum(np.abs(got32 - want32) > JAX_F32_BOUND["atol"]
                        + JAX_F32_BOUND["rtol"] * np.abs(want32)))
    rel32 = float(np.abs(got32 - want32).max() / np.abs(want32).max())
    ok32 = rel32 < F32_VS_SCIPY
    err64 = float(np.abs(got64 - want64).max())
    say(f"front end (a): scipy.signal.sosfiltfilt float64 on the host at ({rows}, {t}): "
        f"{scipy_ms:.1f} ms; the float32 kernel's worst error against it "
        f"{float(np.abs(got32 - want32).max()):.3e}, {rel32:.3e} of the output's max (bound "
        f"{F32_VS_SCIPY}; {beyond} of {got32.size} samples beyond the JAX test's atol "
        f"{JAX_F32_BOUND['atol']} + rtol {JAX_F32_BOUND['rtol']}) {'ok' if ok32 else 'FAILED'}; "
        f"the float64 kernel's "
        f"{err64:.3e} (bound {SCIPY_F64_ABS}) {'ok' if err64 < SCIPY_F64_ABS else 'FAILED'}")
    if not ok32 or not err64 < SCIPY_F64_ABS:
        fail("front end: sos_filtfilt disagrees with scipy.signal.sosfiltfilt")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(51)
    for name, dtype, peak, src, got in (
            ("sos_filtfilt", torch.float32, PEAK_F32_FLOPS, x, got32),
            ("sos_filtfilt_f64", torch.float64, PEAK_F64_FLOPS, x64, got64)):
        item = 4 if dtype == torch.float32 else 8
        # the path's own output at full size against the plain version on its inputs
        plain_full, host_s = _plain_on_host(torch, iir, sos, zi, src, rows, t)
        got = torch.from_numpy(got)
        full_equal = bool(torch.equal(got, plain_full))
        full_abs = float((got - plain_full).abs().max())
        full_rel = full_abs / float(plain_full.abs().max())
        del plain_full
        small = torch.randn(rows, IIR_PLAIN_T, generator=g, device=dev, dtype=dtype)
        full = torch.from_numpy(src.reshape(rows, t)).to(dev)
        call = lambda v, s=sos, z=zi, p=IIR_PADLEN: iir.sos_filtfilt(v, s, z, p)
        out1, out2 = call(small), call(small)
        coef = torch.as_tensor(sos, dtype=dtype, device=dev)
        zit = torch.as_tensor(zi, dtype=dtype, device=dev)
        torch.cuda.synchronize()
        p0 = time.perf_counter()
        plain = iir.filtfilt_plain(small, coef, zit, IIR_PADLEN, tf=False)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - p0) * 1e3
        small_abs = float((out1 - plain).abs().max())
        err = small_abs / float(plain.abs().max())
        same = bool(torch.equal(out1, out2))
        bitwise = bool(torch.equal(out1, plain))
        ms = timed_ms(lambda: call(full), torch, 5)
        sweep = []
        for order in IIR_SWEEP:
            s_sos = bp.butter_bandpass_sos(order, 0.5, 47.0, 200.0)
            s_call = lambda v, s=s_sos, z=bp._sos_zi(s_sos), p=3 * (2 * order + 1): \
                iir.sos_filtfilt(v, s, z, p)
            sweep.append(f"{order}: {timed_ms(lambda: s_call(full), torch, 5):.3f}")
        mhz = _sm_clock_during_mhz(lambda: call(full), torch, 1.5)
        del full
        bytes_ = 2 * rows * t * item  # x read once, out written once
        ws_bytes = 4 * rows * n_ext * item  # with the workspace written and read back
        ops = 2 * n_ext * rows * IIR_SECTIONS * IIR_OPS
        bytes_ms, ops_ms = bytes_ / PEAK_BYTES * 1e3, ops / peak * 1e3
        # a section's loop-carried chain a step: y = b0 u + z0, a1 y, (b1 u - a1 y), + z1 -> z0
        latency = ("not measured (no clock sample)" if mhz is None else
                   f"{2 * n_ext * 4 * FP_LATENCY_CYCLES[item] / (mhz * 1e6) * 1e3:.3f} ms (2 x "
                   f"{n_ext} steps x 4 dependent ops x {FP_LATENCY_CYCLES[item]} cycles, Volta's "
                   f"latency, at the {mhz:.0f} MHz nvidia-smi sampled during the run)")
        report[name] = {
            "max_abs_err": max(full_abs, small_abs), "max_rel_err": max(full_rel, err),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "library_ms": None,
            "composed_ms": None, "shape": [rows, t],
            "scipy_host_ms": scipy_ms,  # float64 on the host, both rows
            "plain_shape": [rows, IIR_PLAIN_T]}
        ok = full_equal and err < F32_KERNEL_BOUND and same
        say(f"front end (a): {name} at ({rows}, {t}) {ms:.3f} ms (biquads {', '.join(sweep)} ms "
            f"beside the path's {IIR_SECTIONS}); bounds: bytes {bytes_ms:.4f} ms (x and out "
            f"once), {ws_bytes / PEAK_BYTES * 1e3:.4f} ms with the workspace, operations "
            f"{ops_ms:.4f} ms, the recursion's latency {latency}; the path's output against the "
            f"plain version on the same inputs (the host's CPU, {host_s:.1f} s): bit-equal "
            f"{full_equal} (worst {full_abs:.3e}); plain version on the card at ({rows}, "
            f"{IIR_PLAIN_T}) {plain_ms:.1f} ms, kernel vs plain {err:.3e} of the max (bound "
            f"{F32_KERNEL_BOUND}), bit-equal {bitwise}, twice bit for bit {same} [{card}] "
            f"{'ok' if ok else 'FAILED'}")
        if not ok:
            fail(f"front end: {name} disagrees with its plain version or is not deterministic")


def phase_front_end(torch, build, card, report):
    """Section 11, the EEG front end at full size on seeded data, driven with
    the launch counts set to 0 just before its main path and read just after
    it: (a) a raw subject through ``segment_raw_signals_200hz.main --bandpass``
    and ``dsp.bandpass_filter`` on its float64 values; (b) the sliding windows
    and DE / PSD features; (c) GLMNet training and embedding; (d) EEG-VP
    serial and fold-parallel. Returns the path's launches."""
    import numpy as np

    from eeg2video_tpu_torch.cli import (eegvp_train_test, extract_de_psd_features,
                                         inference_glmnet, segment_raw_signals_200hz,
                                         segment_sliding_window, train_glmnet)
    from eeg2video_tpu_torch.dsp import bandpass_filter

    t_section = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="e2v_front_") as tmp:
        d = lambda *p: os.path.join(tmp, *p)
        os.makedirs(d("raw"))
        g = torch.Generator(device="cuda").manual_seed(50)
        # unit variance, as the JAX test that sets the float32 bound draws it
        x64 = torch.randn(SUBJECT, generator=g, device="cuda", dtype=torch.float64).cpu().numpy()
        np.save(d("raw", "sub1.npy"), x64)
        # (a) the path: the CLI (float32, as the JAX CLI filters), then the
        # library entry point on the float64 values
        build.reset_launches()
        t0 = _sync_clock(torch)
        segment_raw_signals_200hz.main(["--eeg_root", d("raw"), "--output_dir", d("seg"),
                                        "--bandpass", "0.5", "47", "--bandpass_order", "4"])
        seg_s = _sync_clock(torch) - t0
        filt64 = bandpass_filter(x64, 0.5, 47.0, 200.0, order=4)
        torch.cuda.synchronize()
        launches = dict(build.launches)
        if not (launches["sos_filtfilt"] and launches["sos_filtfilt_f64"]):
            fail(f"front end: the preprocess path did not launch both filtfilt kernels: "
                 f"{launches['sos_filtfilt']}, {launches['sos_filtfilt_f64']}")
        segs = np.load(d("seg", "sub1.npy"))
        x = x64.astype(np.float32)
        filt32 = bandpass_filter(x, 0.5, 47.0, 200.0, order=4)
        from eeg2video_tpu_torch.dsp import segment_subject

        seg_ok = (segs.shape == (7, 40, 5, SUBJECT[1], 400) and segs.dtype == np.float64
                  and np.array_equal(segs, segment_subject(filt32.cpu().numpy()).astype(np.float64)))
        say(f"front end (a): segment_raw_signals_200hz --bandpass 0.5 47 on a ({', '.join(map(str, SUBJECT))}) "
            f"float64 subject: {seg_s:.2f} s (loading, the float32 filter, the gather, writing "
            f"{segs.nbytes / 1e6:.0f} MB), segments {segs.shape} equal to the filtered signal's "
            f"{seg_ok}; launches sos_filtfilt {launches['sos_filtfilt']}, sos_filtfilt_f64 "
            f"{launches['sos_filtfilt_f64']} [{card}] {'ok' if seg_ok else 'FAILED'}")
        if not seg_ok:
            fail("front end: the segments are not those of the filtered subject")
        _iir_check(torch, build, x, x64, filt32, filt64, report, card)
        del x64, x, filt32, filt64

        # (b) features
        t0 = time.perf_counter()
        segment_sliding_window.main(["--input_dir", d("seg"), "--output_dir", d("sw")])
        sw_s = time.perf_counter() - t0
        secs = {}
        for mode, raw_dir, extra in (("1per500ms", d("sw"), []), ("1per1s", d("seg"), []),
                                     ("1per1s", d("seg"), ["--f32"])):
            tag = mode + ("_f32" if extra else "")
            t0 = _sync_clock(torch)
            extract_de_psd_features.main(["--mode", mode, "--raw_dir", raw_dir, "--de_dir",
                                          d(f"DE_{tag}"), "--psd_dir", d(f"PSD_{tag}"), *extra])
            secs[tag] = _sync_clock(torch) - t0
        de500 = np.load(d("DE_1per500ms", "sub1.npy"))
        de1, de1_32 = np.load(d("DE_1per1s", "sub1.npy")), np.load(d("DE_1per1s_f32", "sub1.npy"))
        psd1 = np.load(d("PSD_1per1s", "sub1.npy"))
        psd1_32 = np.load(d("PSD_1per1s_f32", "sub1.npy"))
        rel = float(np.max(np.abs(psd1_32 - psd1) / psd1))
        ok = (de500.shape == (7, 40, 5, 7, 62, 5) and de1.shape == (7, 40, 5, 2, 62, 5)
              and np.isfinite(de500).all() and np.isfinite(de1_32).all() and rel < DE_BOUND)
        say(f"front end (b): segment_sliding_window {sw_s:.2f} s -> (7, 40, 5, 7, 62, 100); "
            f"extract_de_psd_features 1per500ms {secs['1per500ms']:.2f} s -> {de500.shape}, "
            f"1per1s {secs['1per1s']:.2f} s -> {de1.shape}, 1per1s --f32 on the card "
            f"{secs['1per1s_f32']:.2f} s, its psd against the float64 path worst relative "
            f"{rel:.3e} (bound {DE_BOUND}) [{card}] {'ok' if ok else 'FAILED'}")
        if not ok:
            fail("front end: wrong DE / PSD features")

        # (c) GLMNet at full width: 8400 training windows of blocks 0-5
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = _sync_clock(torch)
        acc = train_glmnet.main(["--raw_dir", d("sw"), "--de_dir", d("DE_1per500ms"), "--sub", "1",
                                 "--save_path", d("glmnet"), "--epochs", str(GLMNET_EPOCHS),
                                 "--batch_size", "256", "--emb_dim", "256"])
        train_s = _sync_clock(torch) - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        stamps = [json.loads(s)["time"] for s in
                  open(d("glmnet", "glmnet_metrics.jsonl")).read().splitlines()]
        t0 = _sync_clock(torch)
        emb = inference_glmnet.main(["--raw_dir", d("sw"), "--de_dir", d("DE_1per500ms"),
                                     "--sub", "1", "--ckpt", d("glmnet", "ckpt"), "--norm_stats",
                                     d("glmnet", "norm_stats.npz"), "--emb_dim", "256",
                                     "--out", d("glmnet", "emb.npy")])
        infer_s = _sync_clock(torch) - t0
        ok = (emb.shape == (7, 40, 5, 7, 512) and np.isfinite(emb).all() and len(stamps) == 2
              and 0.0 <= acc <= 1.0)
        say(f"front end (c): train_glmnet at emb_dim 256, 8400 windows, batch 256, "
            f"{GLMNET_EPOCHS} epochs (cut from 100): {train_s:.2f} s with loading, the second "
            f"epoch {stamps[-1] - stamps[0]:.3f} s, peak {peak:.2f} GiB, block-6 top-1 {acc:.3f}; "
            f"inference_glmnet {infer_s:.2f} s -> {emb.shape} [{card}] {'ok' if ok else 'FAILED'}")
        if not ok:
            fail("front end: GLMNet training or embedding failed")

        # (d) EEG-VP on the DE_1per1s features, serial and fold-parallel
        runs = {}
        for tag, extra in (("serial", []), ("fold_parallel", ["--fold_parallel"])):
            t0 = _sync_clock(torch)
            eegvp_train_test.main(["--feature_dir", d("DE_1per1s"), "--out_dir", d(f"vp_{tag}"),
                                   "--epochs", str(EEGVP_EPOCHS), "--encoder", "glfnet_mlp",
                                   *extra])
            runs[tag] = (_sync_clock(torch) - t0,
                         np.load(d(f"vp_{tag}", "sub1_top1.npy")),
                         np.load(d(f"vp_{tag}", "sub1_preds.npy")))
        (s_s, s_top1, s_preds), (p_s, p_top1, p_preds) = runs["serial"], runs["fold_parallel"]
        ok = (s_top1.shape == (7,) and float(np.abs(s_top1 - p_top1).max()) <= 1e-6
              and np.array_equal(s_preds, p_preds))
        say(f"front end (d): eegvp_train_test glfnet_mlp, {EEGVP_EPOCHS} epochs (cut from 100), "
            f"one subject: serial {s_s:.2f} s, --fold_parallel {p_s:.2f} s; top-1 by fold "
            f"{np.round(s_top1, 4).tolist()}, fold-parallel equal (within 1e-6, predictions "
            f"identical) [{card}] {'ok' if ok else 'FAILED'}")
        if not ok:
            fail("front end: fold-parallel EEG-VP differs from serial")
    say(f"front end: section {time.perf_counter() - t_section:.1f} s")
    return launches


# section 12: the trainer's saved residuals, evaluation and the native data path
RESIDUAL_RUNS = (("saved", True), ("recompute", False), ("saved", True), ("recompute", False))
RESIDUAL_STEPS = 4                # a warm-up step, then the 3 timed (their median)
SPREAD_FACTOR = 2.0               # saved vs recompute within 2x the same-setting spread
FLOW_CLIPS, FLOW_CHUNK = 200, 25  # one block of clips, JAX's default chunk
FLOW_CPU_CLIPS = 4                # clips also scored on the host's CPU
FLOW_RTOL = 1e-5
METRIC_FRAMES, METRIC_CPU_FRAMES = 1200, 12  # one test block's 200 clips x 6 frames
METRIC_BOUND = 5e-5               # SSIM absolute, the others relative
NPY_ROWS, NPY_ROW = 40000, 62 * 100  # ~1 GB of float32 EEG windows
NPY_BATCH, NPY_BATCHES = 256, 40


def _masters_gap(a, b):
    """(max, mean) |a - b| over every trainable tensor."""
    diffs = [(a[n] - b[n]).abs() for n in a]
    return (max(float(d.max()) for d in diffs),
            sum(float(d.sum()) for d in diffs) / sum(d.numel() for d in diffs))


def _residual_run(torch, build, vd, post, ctx, save):
    """RESIDUAL_STEPS optimizer steps at batch TRAIN_BATCH from the weights of
    seed 23, keeping the residuals (``save``) or recomputing them."""
    import functools

    unet, _ = _full_width_unet(torch, 23)
    state = vd.init_video_train_state(unet, vd.VideoDiffusionTrainConfig(remat_save_attn=save),
                                      "cuda")
    del unet
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = functools.partial(state.unet, remat_save_convs=save)
    losses, secs, launches = [], [], []
    for _ in range(RESIDUAL_STEPS):
        build.reset_launches()
        t0 = _sync_clock(torch)
        gen = vd.step_generator(5, state.step, state.device)
        loss = vd.video_loss(model, None, post, ctx, state.cfg, generator=gen)
        loss.backward()
        state.apply_gradients()
        secs.append(_sync_clock(torch) - t0)
        losses.append(loss.detach())
        launches.append(dict(build.launches))
    peak = torch.cuda.max_memory_allocated() / 2**30
    masters = {n: p.detach().clone() for n, p in state.masters.items()}
    del state, model
    torch.cuda.empty_cache()
    return {"losses": losses, "secs": secs, "launches": launches, "peak": peak,
            "masters": masters}


def _phase_saved_residuals(torch, build, card):
    """(a) the train step at batch 10 (the train cell) with the residuals kept
    (the defaults) and recomputed, each setting twice, alternating: s/step,
    peak memory, launches; the first loss bit for bit; the updated
    parameters of the two settings within the spread of two runs of one."""
    from eeg2video_tpu_torch.train import videodiffusion as vd

    g = torch.Generator(device="cuda").manual_seed(21)
    post = torch.cat([torch.randn(TRAIN_BATCH, 6, 36, 64, 4, generator=g, device="cuda"),
                      -4.0 + 0.1 * torch.randn(TRAIN_BATCH, 6, 36, 64, 4, generator=g,
                                               device="cuda")], dim=-1)
    ctx = torch.randn(TRAIN_BATCH, 77, 768, generator=g, device="cuda")
    runs = [(name, _residual_run(torch, build, vd, post, ctx, save))
            for name, save in RESIDUAL_RUNS]
    expected = {"saved": EXPECTED_PER_TRAIN_STEP,
                "recompute": {**EXPECTED_PER_TRAIN_STEP, **_RECOMPUTE_STEP}}
    for name, r in runs:
        med = statistics.median(r["secs"][1:])
        ok = all(launched == expected[name] for launched in r["launches"])
        say(f"saved residuals (a): {name}, UNet3DConfig() at batch {TRAIN_BATCH}, levels 0-1 "
            f"recomputed: s/step {med:.4f} (median of {len(r['secs']) - 1} after a warm-up, "
            f"each {[round(s, 4) for s in r['secs']]}), peak {r['peak']:.2f} GiB (the "
            f"recomputing step's {ADAMW_TRAIN_PEAK_GIB} GiB in PERF.md §5), losses "
            f"{[round(float(x), 6) for x in r['losses']]}, launches a step "
            f"{_nonzero(r['launches'][-1])} [{card}] {'ok' if ok else 'FAILED'}")
        if not ok:
            fail(f"saved residuals: the {name} step launched "
                 f"{[_nonzero(x) for x in r['launches']]}, expected {_nonzero(expected[name])}")
    (_, s1), (_, r1), (_, s2), (_, r2) = runs
    same_loss = all(torch.equal(r["losses"][0], s1["losses"][0]) for _, r in runs)
    spread = [_masters_gap(s1["masters"], s2["masters"]), _masters_gap(r1["masters"],
                                                                      r2["masters"])]
    cross = [_masters_gap(s1["masters"], r1["masters"]), _masters_gap(s2["masters"],
                                                                     r2["masters"])]
    spread_max, spread_mean = max(x[0] for x in spread), max(x[1] for x in spread)
    cross_max, cross_mean = max(x[0] for x in cross), max(x[1] for x in cross)
    ok = same_loss and (cross_max <= SPREAD_FACTOR * spread_max
                        and cross_mean <= SPREAD_FACTOR * spread_mean)
    saved_s = statistics.median(s1["secs"][1:] + s2["secs"][1:])
    again_s = statistics.median(r1["secs"][1:] + r2["secs"][1:])
    say(f"saved residuals (a): first-step loss bit for bit in all four runs: {same_loss}; "
        f"after {RESIDUAL_STEPS} steps the trainable parameters of saved vs recompute differ by "
        f"max {cross_max:.3e} / mean {cross_mean:.3e}, two runs of one setting by max "
        f"{spread_max:.3e} / mean {spread_mean:.3e} (bound {SPREAD_FACTOR}x); s/step saved "
        f"{saved_s:.4f} vs recompute {again_s:.4f} ({(again_s - saved_s) * 1e3:.1f} ms a step), "
        f"peak {max(s1['peak'], s2['peak']):.2f} vs {max(r1['peak'], r2['peak']):.2f} GiB "
        f"[{card}] {'ok' if ok else 'FAILED'}")
    if not ok:
        fail("saved residuals: the loss differs, or saving moved the parameters further than "
             "two runs of one setting differ")
    launches = {k: sum(x[k] for x in s1["launches"][1:]) for k in EXPECTED_PER_TRAIN_STEP}
    recompute = {k: sum(x[k] for x in r1["launches"][1:]) for k in EXPECTED_PER_TRAIN_STEP}
    return launches, recompute


def _translated_clips(torch, n, frames, h, w, seed):
    """n uint8 clips (n, frames, h, w, 3) of a smooth random field, clip i
    moving by ((i % 5) - 2, (i // 5) % 3 - 1) pixels a frame; and the
    moves."""
    pad = 2 * frames + 2
    g = torch.Generator(device="cuda").manual_seed(seed)
    coarse = torch.rand(n, 1, (h + 2 * pad) // 8 + 1, (w + 2 * pad) // 8 + 1, generator=g,
                        device="cuda")
    field = torch.nn.functional.interpolate(coarse, scale_factor=8, mode="bicubic",
                                            align_corners=False)[:, 0].clamp(0, 1)
    moves = [((i % 5) - 2, (i // 5) % 3 - 1) for i in range(n)]
    out = torch.empty(n, frames, h, w, dtype=torch.uint8, device="cuda")
    for i, (dx, dy) in enumerate(moves):
        for k in range(frames):
            y0, x0 = pad - k * dy, pad - k * dx
            out[i, k] = (field[i, y0:y0 + h, x0:x0 + w] * 255).to(torch.uint8)
    return out[..., None].expand(n, frames, h, w, 3).contiguous(), moves


def _phase_flow_block(torch, card):
    """(b) ``score_clips`` on one block at full size: seconds a block, the
    level-0 Jacobi iteration's bytes bound, and 4 clips against the CPU."""
    import numpy as np

    from eeg2video_tpu_torch.data.optical_flow import score_clips

    clips, moves = _translated_clips(torch, FLOW_CLIPS, 6, 288, 512, 31)
    frames = clips.cpu().numpy()
    del clips
    score_clips(frames[:FLOW_CHUNK], chunk=FLOW_CHUNK)  # warm-up: the allocator's first chunk
    t0 = _sync_clock(torch)
    scores = score_clips(frames, chunk=FLOW_CHUNK)
    block_s = _sync_clock(torch) - t0
    t0 = time.perf_counter()
    cpu = score_clips(frames[:FLOW_CPU_CLIPS], chunk=FLOW_CPU_CLIPS, device="cpu")
    cpu_s = time.perf_counter() - t0
    rel = float(np.max(np.abs(scores[:FLOW_CPU_CLIPS] - cpu) / np.maximum(np.abs(cpu), 1e-12)))
    speed = np.array([np.hypot(dx, dy) for dx, dy in moves])
    static = float(scores[speed == 0].max())
    corr = float(np.corrcoef(speed, scores)[0, 1])
    pairs = FLOW_CLIPS * 5
    # one Jacobi iteration at level 0 reads du, dv, Ix, Iy, It and the
    # denominator and writes du, dv: 8 float32 images a frame pair
    it_bytes = 8 * 4 * 288 * 512 * pairs
    it_bound = it_bytes / PEAK_BYTES
    loop_bound = 100 * it_bound * (1 + 1 / 4 + 1 / 16)  # 100 iterations at 3 levels
    ok = np.isfinite(scores).all() and rel <= FLOW_RTOL and static < 0.05 and corr > 0.9
    say(f"flow (b): score_clips on {FLOW_CLIPS} clips of 6 x 288 x 512 (one block), chunk "
        f"{FLOW_CHUNK}, 3 levels x 100 iterations: {block_s:.3f} s a block "
        f"({block_s / pairs * 1e3:.3f} ms a frame pair); one level-0 Jacobi iteration moves "
        f"{it_bytes / 1e9:.3f} GB, bound {it_bound * 1e3:.3f} ms at {PEAK_BYTES / 1e12} TB/s, "
        f"the 300 iterations' bound {loop_bound:.3f} s a block; static clips score at most "
        f"{static:.2e}, correlation of score and shift {corr:.3f}; {FLOW_CPU_CLIPS} clips on the "
        f"host's CPU ({cpu_s:.1f} s) within {rel:.2e} relative (bound {FLOW_RTOL}) [{card}] "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        fail("flow: scores disagree with the CPU, or do not follow the known motion")
    return block_s


def _phase_pixel_metrics(torch, card):
    """(c) SSIM, MSE, PSNR and hue over 1200 frame pairs at 288x512, the
    first 12 against the CPU."""
    import numpy as np

    from eeg2video_tpu_torch.eval import metrics

    gt, _ = _translated_clips(torch, METRIC_FRAMES // 6, 6, 288, 512, 41)
    g = torch.Generator(device="cuda").manual_seed(42)
    noise = torch.randn(gt.shape, generator=g, device="cuda") * 12
    pred = (gt.float() + noise).clamp(0, 255).to(torch.uint8)
    gt, pred = (t.reshape(METRIC_FRAMES, 288, 512, 3).cpu().numpy() for t in (gt, pred))
    del noise
    fns = {"ssim": metrics.ssim_frames, "mse": metrics._mse, "psnr": metrics._psnr,
           "hue": metrics._hue}
    line, worst, ok = [], {}, True
    for name, fn in fns.items():
        t0 = _sync_clock(torch)
        vals = metrics.per_frame(fn, pred, gt)
        secs = _sync_clock(torch) - t0
        want = metrics.per_frame(fn, pred[:METRIC_CPU_FRAMES], gt[:METRIC_CPU_FRAMES],
                                 device="cpu")
        got = vals[:METRIC_CPU_FRAMES]
        err = (np.abs(got - want).max() if name == "ssim"
               else (np.abs(got - want) / np.abs(want)).max())
        worst[name] = float(err)
        ok = ok and np.isfinite(vals).all() and err <= METRIC_BOUND
        line.append(f"{name} {secs:.3f} s (mean {vals.mean():.5f})")
    say(f"metrics (c): {METRIC_FRAMES} frame pairs of 288 x 512 from the host, 50 a pass on the "
        f"card: {', '.join(line)}; the first {METRIC_CPU_FRAMES} against the CPU, worst "
        f"{worst} (bound {METRIC_BOUND}, SSIM absolute) [{card}] {'ok' if ok else 'FAILED'}")
    if not ok:
        fail("metrics: the card disagrees with the CPU")


def _phase_eval_clis(torch, card, tmp):
    """(d) the gif stage where cv2 can write the block video, then
    compute_optical_flow and run_metrics on its GIFs; the GIF decoding timed
    apart (``load_gif`` is Python)."""
    import numpy as np

    from eeg2video_tpu_torch.cli import compute_optical_flow, extract_gif, run_metrics
    from eeg2video_tpu_torch.data import meta
    from eeg2video_tpu_torch.data.native import write_gif_native
    from eeg2video_tpu_torch.data.video import load_gif

    d = lambda *p: os.path.join(tmp, *p)  # noqa: E731
    os.makedirs(d("video"))
    per_concept = (meta.BASELINE_SEC + meta.N_REPS * meta.CLIP_SEC) * meta.VIDEO_FPS
    clips, _ = _translated_clips(torch, 1, per_concept, 288, 512, 51)
    frames = clips[0].cpu().numpy()  # (312, 288, 512, 3): one concept's hint and 5 clips
    wrote = False
    try:
        import cv2

        vw = cv2.VideoWriter(d("video", "1.mp4"), cv2.VideoWriter_fourcc(*"mp4v"),
                             meta.VIDEO_FPS, (512, 288))
        wrote = vw.isOpened()
        if wrote:
            for f in frames:
                vw.write(f[..., ::-1].copy())
            vw.release()
        why = "cv2 could not open an mp4v writer"
    except ImportError:
        why = "cv2 is not installed"
    if wrote:
        t0 = time.perf_counter()
        written = extract_gif.main(["--video_dir", d("video"), "--out_root", d("gifs"),
                                    "--blocks", "0"])
        gif_s = time.perf_counter() - t0
        ok = written == {0: [0, 1, 2, 3, 4]}
        say(f"clis (d): the gif stage, extract_gif on one concept's 312-frame 288 x 512 mp4: "
            f"{gif_s:.2f} s -> {written} {'ok' if ok else 'FAILED'}")
        if not ok:
            fail("clis: extract_gif wrote the wrong clips")
    else:
        say(f"clis (d): the gif stage was not run: {why}; its GIFs are written directly")
        os.makedirs(d("gifs", "Block0"))
        for i in range(5):
            write_gif_native(d("gifs", "Block0", f"{i}.gif"),
                             frames[72 + 48 * i: 72 + 48 * (i + 1): 8], 333)
    names = [d("gifs", "Block0", f"{i}.gif") for i in range(5)]
    t0 = time.perf_counter()
    gifs = [load_gif(p) for p in names]
    decode_s = time.perf_counter() - t0
    t0 = _sync_clock(torch)
    table = compute_optical_flow.main(["--gif_dir", d("gifs"), "--out", d("flow.npy"),
                                       "--blocks", "1"])
    flow_s = _sync_clock(torch) - t0
    # run_metrics: the GIFs as ground truth (named as block 6's class order
    # finds them), noisy copies as predictions
    os.makedirs(d("pred"))
    os.makedirs(d("gt"))
    order = run_metrics.gt_order()
    rng = np.random.default_rng(52)
    for i, clip in enumerate(gifs):
        write_gif_native(d("gt", f"{int(order[i])}.gif"), clip, 333)
        noisy = np.clip(clip + rng.normal(0, 10, clip.shape), 0, 255).astype(np.uint8)
        write_gif_native(d("pred", f"{i}.gif"), noisy, 333)
    t0 = _sync_clock(torch)
    res = run_metrics.main(["--pred_dir", d("pred"), "--gt_dir", d("gt"), "--n_clips", "5",
                            "--out", d("metrics.json")])
    metrics_s = _sync_clock(torch) - t0
    ok = (table.shape == (1, 5) and np.isfinite(table).all()
          and all(np.isfinite(v) for v in res.values()) and 0 < res["ssim"] < 1)
    say(f"clis (d): 5 GIFs of 6 x 288 x 512: load_gif {decode_s:.2f} s for the 5 (Python); "
        f"compute_optical_flow {flow_s:.2f} s with its own decoding -> {np.round(table, 3)}; "
        f"run_metrics on 5 predicted + 5 ground-truth GIFs {metrics_s:.2f} s with its decoding "
        f"-> ssim {res['ssim']:.4f} psnr {res['psnr']:.2f} [{card}] {'ok' if ok else 'FAILED'}")
    if not ok:
        fail("clis: compute_optical_flow or run_metrics gave a malformed result")


def _phase_native_loader(torch, card, tmp):
    """(e) ``NpyBatchLoader`` (numpy's memory map) gathers on a ~1 GB float32
    .npy (warm in the page cache: just written), a first and a second pass,
    raw and normalized, held to the array in memory; and whether the clip
    decoder builds here."""
    import numpy as np

    from eeg2video_tpu_torch.data import native

    path = os.path.join(tmp, "windows.npy")
    g = torch.Generator(device="cuda").manual_seed(61)
    arr = torch.randn(NPY_ROWS, NPY_ROW, generator=g, device="cuda").cpu().numpy()
    np.save(path, arr)
    loader = native.NpyBatchLoader(path)
    rng = np.random.default_rng(62)
    batches = [rng.integers(0, NPY_ROWS, NPY_BATCH) for _ in range(NPY_BATCHES)]
    mean, std = np.zeros(NPY_ROW, np.float32), np.full(NPY_ROW, 2.0, np.float32)

    def rate(fn):
        t0 = time.perf_counter()
        for idx in batches:
            out = fn(idx)
        return NPY_BATCH * NPY_BATCHES * NPY_ROW * 4 / (time.perf_counter() - t0) / 1e9, out

    # a first pass touches each row's pages in that mapping for the first
    # time (the page faults of a new mapping); the second finds them mapped,
    # as an epoch after the first does
    rates = {}
    rates["gather first"], _ = rate(loader.gather)
    rates["gather again"], out = rate(loader.gather)
    rates["gather_normalized"], norm = rate(lambda i: loader.gather_normalized(i, mean, std))
    last = arr[batches[-1]]
    ok = np.array_equal(out, last) and np.array_equal(norm, (last - mean) / std)
    say(f"loader (e): NpyBatchLoader on a {os.path.getsize(path) / 1e9:.2f} GB float32 .npy "
        f"({NPY_ROWS} x {NPY_ROW}, warm in the page cache), {NPY_BATCHES} batches of "
        f"{NPY_BATCH} random rows, GB/s: "
        f"{', '.join(f'{k} {v:.2f}' for k, v in rates.items())} (first: the mapping's first "
        f"touch of those rows); rows and normalized rows equal to the array's: {ok} "
        f"({os.cpu_count()} cores) [{card}] {'ok' if ok else 'FAILED'}")
    loader.close()
    if not ok:
        fail("loader: NpyBatchLoader disagrees with the array it was saved from")
    try:
        native.video_library()
        say("loader (e): the clip decoder (csrc/video_decoder.cpp) built against opencv4")
    except RuntimeError as e:
        say(f"loader (e): the clip decoder was not built or run here: "
            f"{str(e).splitlines()[0]}")


def phase_section12(torch, build, card):
    """Section 12: (a) the train step with the residuals kept and recomputed;
    (b) optical-flow scoring of one block; (c) the pixel metrics; (d) the gif
    stage and the evaluation CLIs; (e) the .npy loader. Returns the
    launches of (a)'s two settings (3 timed steps of one run each)."""
    t_section = time.perf_counter()
    torch.cuda.empty_cache()
    saved, recompute = _phase_saved_residuals(torch, build, card)
    _phase_flow_block(torch, card)
    _phase_pixel_metrics(torch, card)
    with tempfile.TemporaryDirectory(prefix="e2v_eval_") as tmp:
        _phase_eval_clis(torch, card, tmp)
        _phase_native_loader(torch, card, tmp)
    say(f"section 12: {time.perf_counter() - t_section:.1f} s")
    return {"train_saved": saved, "train_recompute": recompute}


# section 13: the text path, DDIM inversion, generate_text_emb and run_pipeline
TEXT_PROMPTS = 200                # one caption file's worth: a block's 200 clips
TEXT_STEPS = 4                    # DDIM steps of the text-conditioned request
INV_STEPS = 50                    # ddim_inversion's default
CLIP_BOUND = 1e-4                 # CLIP f32 on the card vs the CPU: max|diff| / max|cpu|
CLIP_CPU_ROWS = 4                 # prompts also encoded on the host's CPU
INVERSION_TOL = 2e-5              # |inverse_step(step(x)) - x| <= tol (1 + |x|), the CPU test's
SMALL_CAPTIONS = (3, 5, 2)        # (d): captions in each of three small files
RUN_PIPELINE_STAGES = ("segment", "de_psd", "semantic", "generate", "metrics")
_CAPTION_WORDS = ("a", "the", "red", "small", "old", "bird", "car", "dog", "river", "city",
                  "flies", "runs", "over", "under", "slowly", "street", "forest", "at", "night",
                  "sunset", "two", "people", "walk", "beach", "mountain", "snow", "boat")


class _HashTokenizer:
    """CLIPTokenizer stand-in (the card's machine may lack transformers and
    has no vocabulary files): bos, one id a word (crc32 of the word), eos,
    then eos as padding to ``max_length``."""

    def __init__(self, vocab_size):
        self.bos, self.eos = vocab_size - 2, vocab_size - 1

    def __call__(self, prompts, max_length=77, padding=None, truncation=None,
                 return_tensors=None):
        import types
        import zlib

        import numpy as np

        ids = np.full((len(prompts), max_length), self.eos, np.int64)
        for i, p in enumerate(prompts):
            toks = [self.bos] + [zlib.crc32(w.encode()) % self.bos for w in p.split()]
            toks = (toks + [self.eos])[:max_length]
            ids[i, :len(toks)] = toks
        return types.SimpleNamespace(input_ids=ids)


def _captions(seed, n):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(_CAPTION_WORDS, size=int(rng.integers(4, 13)))) for _ in range(n)]


def _write_captions(folder, counts, seed):
    os.makedirs(folder)
    for i, n in enumerate(counts):
        with open(os.path.join(folder, f"{i + 1}_10min.txt"), "w") as f:
            f.write("\n".join(_captions(seed + i, n)) + "\n")


def _phase_clip(torch, card):
    """(a) CLIPTextConfig() in f32 on the card, seeded weights: 200 prompts
    encoded, timed, a few rows against the same model on the host's CPU."""
    from eeg2video_tpu_torch.diffusion.text_pipeline import tokenize
    from eeg2video_tpu_torch.models.clip_text import CLIPTextModel, encode_ids
    from eeg2video_tpu_torch.models.init import random_init_

    g = torch.Generator(device="cuda").manual_seed(60)
    with torch.device("meta"):
        model = CLIPTextModel()
    model = random_init_(model.to_empty(device="cuda"), g).eval().requires_grad_(False)
    tok = _HashTokenizer(model.config.vocab_size)
    ids = tokenize(tok, _captions(61, TEXT_PROMPTS))
    got = encode_ids(model, ids)
    ms = timed_ms(lambda: encode_ids(model, ids), torch, 5)
    host = CLIPTextModel().eval()
    host.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    want = encode_ids(host, ids[:CLIP_CPU_ROWS])
    err = ((got[:CLIP_CPU_ROWS].cpu() - want).abs().max() / want.abs().max()).item()
    ok = (tuple(got.shape) == (TEXT_PROMPTS, 77, 768) and got.dtype == torch.float32
          and bool(torch.isfinite(got).all()) and err < CLIP_BOUND)
    n_params = sum(p.numel() for p in model.parameters())
    say(f"text (a): CLIPTextConfig() ({n_params} params, 12 layers, 768 wide) f32 on the card, "
        f"seeded weights: {TEXT_PROMPTS} prompts (77 ids each) in {ms:.2f} ms (median of 5), "
        f"{TEXT_PROMPTS / ms * 1e3:.0f} prompts/s; rows 0-{CLIP_CPU_ROWS - 1} against the CPU "
        f"max|diff| / max {err:.3e} (bound {CLIP_BOUND:.0e}) [{card}] {'ok' if ok else 'FAILED'}")
    if not ok:
        fail("text: the CLIP text tower on the card is malformed or disagrees with the CPU")
    return model, tok


def _phase_text_pipeline(torch, build, card, clip, tok):
    """(b) TextToVideoPipeline at full width: one prompt, 6 frames at 288 x
    512, 4 DDIM steps, guidance 12.5; launches counted; then one UNet call on
    the guidance pair timed for its MFU."""
    from eeg2video_tpu_torch.diffusion.pipeline import EEG2VideoPipeline
    from eeg2video_tpu_torch.diffusion.text_pipeline import TextToVideoPipeline
    from eeg2video_tpu_torch.models.init import random_init_
    from eeg2video_tpu_torch.models.unet3d import UNet3DConfig
    from eeg2video_tpu_torch.models.vae import VAEConfig
    from eeg2video_tpu_torch.utils import flops

    dev = torch.device("cuda")
    base = EEG2VideoPipeline.create(None, None, UNet3DConfig(), VAEConfig(),
                                    dtype=torch.bfloat16, device=dev)
    g = torch.Generator(device=dev).manual_seed(62)
    random_init_(base.unet, g)
    random_init_(base.vae, g)
    pipe = TextToVideoPipeline(base, clip, tok)
    prompt = ["a red car drives along the coast at sunset"]
    build.reset_launches()
    t0 = _sync_clock(torch)
    video = pipe(prompt, generator=torch.Generator(device=dev).manual_seed(63), video_length=6,
                 height=288, width=512, num_inference_steps=TEXT_STEPS, guidance_scale=12.5)
    secs = _sync_clock(torch) - t0
    launches = dict(build.launches)
    expected = {k: n * TEXT_STEPS for k, n in EXPECTED_PER_FORWARD.items()}
    ok = (tuple(video.shape) == (1, 6, 288, 512, 3) and bool(torch.isfinite(video).all())
          and float(video.min()) >= 0.0 and float(video.max()) <= 1.0 and float(video.std()) > 0
          and _nonzero(launches) == expected)
    say(f"text (b): TextToVideoPipeline, UNet3DConfig() + VAEConfig() bf16 + the CLIP tower f32, "
        f"seeded weights: 1 prompt, 6 frames 288x512, {TEXT_STEPS} DDIM steps, guidance 12.5: "
        f"{secs:.3f} s (the prompt and the empty prompt encoded, {TEXT_STEPS} UNet calls on the "
        f"guidance pair, 6 VAE decodes), launches {_nonzero(launches)} (expected {expected}: "
        f"packed and two-segment attention, ff_ln, geglu_out, the level-0 conv) [{card}] "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        fail("text: the text pipeline's video is malformed or it did not launch the generation "
             "kernels")
    ctx = torch.cat([pipe.encode_prompts([""]), pipe.encode_prompts(prompt)]).bfloat16()
    sample = torch.randn(2, 6, 36, 64, 4, generator=g, device=dev).bfloat16()
    t = torch.full((2,), 500, device=dev)
    with torch.inference_mode():
        unet_ms = timed_ms(lambda: base.unet(sample, t, ctx), torch, 5)
    return pipe, launches, (flops.unet3d_forward_flops(UNet3DConfig(), 2, 6, 36, 64)["total"],
                            unet_ms)


def _phase_inversion(torch, build, card, pipe):
    """(c) ddim_inversion at full width: one clip's latents, 50 inverse steps,
    the empty prompt's context; launches counted; the first step's eps (batch
    1, no guidance pair) against the same UNet call with every kernel's plain
    version in its place; the inverse step undoes the forward step on the
    card."""
    from eeg2video_tpu_torch.diffusion.schedulers import DDIMSchedule
    from eeg2video_tpu_torch.diffusion.text_pipeline import ddim_inversion
    from eeg2video_tpu_torch.models.unet3d import UNet3DConfig
    from eeg2video_tpu_torch.utils import flops

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(64)
    lat = torch.randn(1, 6, 36, 64, 4, generator=g, device=dev)
    ctx = pipe.encode_prompts([""])
    build.reset_launches()
    t0 = _sync_clock(torch)
    inv = ddim_inversion(pipe.base.unet, lat, ctx, num_inv_steps=INV_STEPS)
    secs = _sync_clock(torch) - t0
    launches = dict(build.launches)
    expected = {k: n * INV_STEPS for k, n in EXPECTED_PER_FORWARD.items()}
    sched = DDIMSchedule.create(INV_STEPS)
    # the first inverse step's UNet call as ddim_inversion makes it, through
    # the kernels and through the plain versions (which must launch nothing)
    unet, dt = pipe.base.unet, pipe.base.unet.conv_in.weight.dtype
    tt = torch.full((1,), int(sched.timesteps[-1]), device=dev, dtype=torch.int64)
    with torch.inference_mode():
        got = unet(lat.to(dt), tt, ctx.to(dt))
        build.reset_launches()
        with _plain_versions(conv=True):
            want = unet(lat.to(dt), tt, ctx.to(dt))
        plain_launches = _nonzero(build.launches)
        # where an inverse step's time goes: the device's busy time and idle
        # share over one such UNet call
        _profile_step(torch, lambda: unet(lat.to(dt), tt, ctx.to(dt)),
                      what="text (c): one inverse step's UNet call (batch 1)")
    eps_err = _rel(got, want)
    eps_ok = bool(torch.isfinite(got.float()).all()) and eps_err < UNET_BOUND and not plain_launches
    del got, want
    eps = torch.randn(1, 6, 36, 64, 4, generator=g, device=dev)
    x = torch.randn(1, 6, 36, 64, 4, generator=g, device=dev)
    worst = max(((sched.inverse_step(eps, t, sched.step(eps, t, x)) - x).abs()
                 - INVERSION_TOL * (1 + x.abs())).max().item() for t in sched.timesteps)
    ok = (tuple(inv.shape) == tuple(lat.shape) and inv.dtype == torch.float32
          and bool(torch.isfinite(inv).all()) and _nonzero(launches) == expected and worst <= 0
          and eps_ok)
    say(f"text (c): ddim_inversion, UNet3DConfig() bf16, one clip (1, 6, 36, 64, 4), "
        f"{INV_STEPS} inverse steps, the empty prompt's context: {secs:.3f} s, "
        f"{secs / INV_STEPS * 1e3:.2f} ms per step; launches {_nonzero(launches)} (expected "
        f"{expected}); the first step's eps (t = {int(tt[0])}) against the same call via the "
        f"plain versions (conv included; they launched {plain_launches}): rel_err "
        f"{eps_err:.3e} (bound {UNET_BOUND:.0e}); "
        f"inverse_step(eps, t, step(eps, t, x)) against x at all {INV_STEPS} t: "
        f"worst |diff| - {INVERSION_TOL:.0e} (1 + |x|) {worst:.3e} [{card}] "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        fail("text: ddim_inversion is malformed, did not launch the generation kernels, its "
             "eps disagrees with the plain versions, or its inverse step does not undo the step")
    return launches, (flops.unet3d_forward_flops(UNet3DConfig(), 1, 6, 36, 64)["total"],
                      secs / INV_STEPS * 1e3)


def _phase_text_emb(torch, card, pipe, tmp, data):
    """(d) generate_text_emb's caption loop (``write_text_embeddings``) with
    the tokenizer stand-in: three small caption files, then the six
    200-caption blocks and negative.npy that (e)'s semantic stage reads."""
    import numpy as np

    from eeg2video_tpu_torch.cli.generate_text_emb import write_text_embeddings
    from eeg2video_tpu_torch.data.io import load_array

    d = lambda *p: os.path.join(tmp, *p)  # noqa: E731
    _write_captions(d("captions"), SMALL_CAPTIONS, 65)
    written = write_text_embeddings(pipe.text_model, pipe.tokenizer, d("captions"), d("emb"),
                                    d("emb", "negative.npy"))
    blocks = [load_array(p) for p in written]
    neg = np.load(d("emb", "negative.npy"))
    ok = ([b.shape for b in blocks] == [(n, 77, 768) for n in SMALL_CAPTIONS]
          and all(b.dtype == np.float32 and np.isfinite(b).all() for b in blocks)
          and neg.shape == (1, 77, 768) and neg.dtype == np.float16 and np.isfinite(neg).all())
    try:
        import transformers

        have = f"transformers {transformers.__version__} imports here"
    except ImportError as e:
        have = f"transformers does not import here ({e}); generate_text_emb.main would raise"
    say(f"text (d): write_text_embeddings on {len(SMALL_CAPTIONS)} caption files of "
        f"{SMALL_CAPTIONS} captions: {[b.shape for b in blocks]} float32, negative.npy "
        f"{neg.shape} {neg.dtype} {'ok' if ok else 'FAILED'}")
    say(f"text (d): {have}")
    if not ok:
        fail("text: generate_text_emb's caption loop wrote malformed files")
    _write_captions(os.path.join(data, "BLIP"), (TEXT_PROMPTS,) * 6, 66)
    t0 = _sync_clock(torch)
    write_text_embeddings(pipe.text_model, pipe.tokenizer, os.path.join(data, "BLIP"),
                          os.path.join(data, "Text_embeddings"),
                          os.path.join(data, "negative.npy"))
    say(f"text (d): the six 200-caption blocks for (e) -> Text_embeddings/block0-5.pt and "
        f"negative.npy in {_sync_clock(torch) - t0:.2f} s with writing [{card}]")


def _phase_run_pipeline(torch, build, card, pipe, tmp, data):
    """(e) run_pipeline on the card on seeded inputs in a temporary data_root:
    segment, de_psd, semantic (train 1 epoch + infer), generate (one clip, 4
    steps) and metrics, each stage's launches and seconds; then the same
    command again, which must skip every stage."""
    import numpy as np

    from eeg2video_tpu_torch.cli import (extract_de_psd_features, inference_eeg2video,
                                         inference_semantic, run_metrics, run_pipeline,
                                         segment_raw_signals_200hz, train_semantic)
    from eeg2video_tpu_torch.convert.export_diffusion import WEIGHTS_NAME, unet_config_dict
    from eeg2video_tpu_torch.data.native import write_gif_native
    from eeg2video_tpu_torch.models.unet3d import UNet3DConfig

    d = lambda *p: os.path.join(tmp, *p)  # noqa: E731
    g = torch.Generator(device="cuda").manual_seed(67)
    os.makedirs(os.path.join(data, "EEG"))
    np.save(os.path.join(data, "EEG", "sub1.npy"),
            torch.randn(SUBJECT, generator=g, device="cuda").cpu().numpy())
    gt = os.path.join(data, "Video_gifs", "Block6")
    os.makedirs(gt)
    clip = (torch.rand(6, 288, 512, 3, generator=g, device="cuda") * 255).to(torch.uint8)
    write_gif_native(os.path.join(gt, f"{int(run_metrics.gt_order()[0])}.gif"),
                     clip.cpu().numpy(), 333)
    # the fine-tune's diffusers layout, where generate reads the UNet (bf16
    # weights: the stage loads them into a bf16 model), and the VAE as a .pt
    unet_dir = d("out", "tuneavideo", "unet")
    os.makedirs(unet_dir)
    with open(os.path.join(unet_dir, "config.json"), "w") as f:
        json.dump(unet_config_dict(UNet3DConfig()), f)
    t0 = time.perf_counter()
    torch.save({k: v.cpu() for k, v in pipe.base.unet.state_dict().items()},
               os.path.join(unet_dir, WEIGHTS_NAME))
    torch.save({k: v.cpu() for k, v in pipe.base.vae.state_dict().items()}, d("vae.pt"))
    write_s = time.perf_counter() - t0
    argv = ["--data_root", data, "--out_root", d("out"), "--stages", *RUN_PIPELINE_STAGES,
            "--woSeq2Seq", "--vae", d("vae.pt"), "--device", "cuda",
            "--extra", "train_semantic:--epochs=1", "generate:--num_inference_steps=4",
            "generate:--limit=1", "generate:--gif_encoder=native", "metrics:--n_clips=1"]

    per_stage = []
    mods = (segment_raw_signals_200hz, extract_de_psd_features, train_semantic,
            inference_semantic, inference_eeg2video, run_metrics)
    real = {m: m.main for m in mods}

    def counted(mod):
        def main(stage_argv):
            before = dict(build.launches)
            t0 = _sync_clock(torch)
            out = real[mod](stage_argv)
            per_stage.append((mod.__name__.rsplit(".", 1)[-1], _sync_clock(torch) - t0,
                              {k: n - before[k] for k, n in build.launches.items()
                               if n != before[k]}))
            return out
        return main

    for m in mods:
        m.main = counted(m)
    try:
        build.reset_launches()
        t0 = _sync_clock(torch)
        ran = run_pipeline.main(argv)
        run_s = _sync_clock(torch) - t0
        launches = dict(build.launches)
        t0 = time.perf_counter()
        again = run_pipeline.main(argv)
        again_s = time.perf_counter() - t0
    finally:
        for m in mods:
            m.main = real[m]
    expected_ran = [("segment", "segment_raw_signals_200hz"),
                    ("de_psd", "extract_de_psd_features"), ("semantic", "train_semantic"),
                    ("semantic", "inference_semantic"), ("generate", "inference_eeg2video"),
                    ("metrics", "run_metrics")]
    gen_launches = next(n for mod, _, n in per_stage if mod == "inference_eeg2video")
    expected_gen = {k: n * 4 for k, n in EXPECTED_PER_FORWARD.items()}
    with open(d("out", "metrics.json")) as f:
        res = json.load(f)
    ok = (ran == expected_ran and again == [] and gen_launches == expected_gen
          and os.path.exists(d("out", "generated", "0.gif"))
          and all(np.isfinite(v) for v in res.values()))
    say(f"text (e): run_pipeline --stages {' '.join(RUN_PIPELINE_STAGES)} --woSeq2Seq on a "
        f"seeded (7, 62, 104000) subject, 6 x 200 caption embeddings, one ground-truth GIF, "
        f"UNet3DConfig() / VAEConfig() seeded weights (written in {write_s:.2f} s): {run_s:.2f} s; "
        f"by stage (s, launches): "
        + "; ".join(f"{m} {s:.2f} {launch}" for m, s, launch in per_stage)
        + f"; metrics ssim {res['ssim']:.4f}; the second call ran {again} in {again_s:.2f} s "
        f"(every stage skipped) [{card}] {'ok' if ok else 'FAILED'}")
    if not ok:
        fail(f"text: run_pipeline ran {ran} (expected {expected_ran}), generate launched "
             f"{gen_launches} (expected {expected_gen}), or its second call ran {again}")
    return launches


def phase_section13(torch, build, card):
    """Section 13: (a) the CLIP text tower; (b) TextToVideoPipeline; (c)
    ddim_inversion; (d) generate_text_emb's caption loop; (e) run_pipeline,
    twice; the MFU of (b)'s UNet call and (c)'s step. Returns the launches of
    the text, inversion and run_pipeline paths."""
    from eeg2video_tpu_torch.utils import flops

    t_section = time.perf_counter()
    torch.cuda.empty_cache()
    clip, tok = _phase_clip(torch, card)
    pipe, text_launches, (unet_flops, unet_ms) = _phase_text_pipeline(torch, build, card,
                                                                      clip, tok)
    inv_launches, (step_flops, step_ms) = _phase_inversion(torch, build, card, pipe)
    say(f"text: MFU at the H100's {flops.H100_BF16_PEAK / 1e12:.0f} TFLOP/s bf16 peak "
        f"(utils/flops.py, matmul FLOPs): (b)'s UNet call on the guidance pair "
        f"{unet_flops / 1e12:.3f} TFLOP in {unet_ms:.2f} ms (median of 5) -> "
        f"{flops.mfu(unet_flops, unet_ms / 1e3):.3f}; (c)'s inverse step on one clip "
        f"{step_flops / 1e12:.3f} TFLOP in {step_ms:.2f} ms (the mean of {INV_STEPS}, with the "
        f"step's host work) -> {flops.mfu(step_flops, step_ms / 1e3):.3f} [{card}]")
    with tempfile.TemporaryDirectory(prefix="e2v_text_") as tmp:
        data = os.path.join(tmp, "data")
        _phase_text_emb(torch, card, pipe, tmp, data)
        pipeline_launches = _phase_run_pipeline(torch, build, card, pipe, tmp, data)
    del pipe, clip
    torch.cuda.empty_cache()
    say(f"section 13: {time.perf_counter() - t_section:.1f} s")
    return {"text": text_launches, "inversion": inv_launches, "run_pipeline": pipeline_launches}


# --- section 14: multi-GPU generation on one card -----------------------------

RING_SPS = (2, 4)         # ring sizes (a) plays on one card
MESH_CLIPS = 2            # clips of the --dp 1 runs of (b) and (c)
TORCHRUN_TIMEOUT = 300    # seconds (c)'s launcher may take


def _ring_cases(torch, dev):
    """(label, q, k, v, bias) at the full-width level-0 shapes of one clip's
    guidance pair (8 heads of 40): frames 0-1 as one query of 2L against K0;
    frames 2-5 against the [K0 | K_prev] concat, with and without the
    [bias, 0] the model builds; cross-attention against the 77 context rows."""
    g = torch.Generator(device=dev).manual_seed(14)

    def r(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    l, c = 2304, 320
    mask = (torch.rand((8, 1, l), generator=g, device=dev) < 0.25) * -1e4
    bias = torch.cat([mask + torch.randn((8, 1, l), generator=g, device=dev),
                      torch.zeros((8, 1, l), device=dev)], dim=-1)
    k2, v2 = r(8, 2 * l, c), r(8, 2 * l, c)
    return [("frames 0-1 (2,4608,320)x2304", r(2, 2 * l, c), r(2, l, c), r(2, l, c), None),
            ("frames 2-5 (8,2304,320)x[K0|K_prev] 4608", r(8, l, c), k2, v2, None),
            ("frames 2-5 (8,2304,320)x[K0|K_prev] 4608 + (8,1,4608) bias", r(8, l, c), k2, v2,
             bias),
            ("cross (2,13824,320)x77", r(2, 6 * l, c), r(2, 77, c), r(2, 77, c), None)]


def _phase_ring_hops(torch, build, card):
    """(a) ``ring.ring_step`` on one card: the exchange of sp ranks played by
    rotating a list of the sp K/V blocks (rank i holds block (i + t) % sp at
    hop t). The sp ranks' rows, and one ``flash_attention_fwd`` over the
    whole KV, each against ``flash_attention_plain`` (f32, on the same
    inputs) at KERNEL_BOUND. Returns the hops' launches."""
    from eeg2video_tpu_torch.ops import ring
    from eeg2video_tpu_torch.ops.attention import flash_attention_fwd, flash_attention_plain

    dev, heads = torch.device("cuda"), 8
    launches = dict.fromkeys(COUNTERS, 0)

    def rel(got, want):
        return ((got.float() - want).abs().max() / want.abs().max()).item()

    for label, q, k, v, bias in _ring_cases(torch, dev):
        plain = flash_attention_plain(q.float(), k.float(), v.float(), heads, bias0=bias)
        torch.cuda.empty_cache()
        whole = flash_attention_fwd(q, k, v, heads, bias0=bias)
        whole_err = rel(whole, plain)
        whole_ms = timed_ms(lambda: flash_attention_fwd(q, k, v, heads, bias0=bias), torch, 10)
        ok_whole = whole_err < KERNEL_BOUND and bool(torch.isfinite(whole).all())
        say(f"ring (a) [{label}]: one whole-KV flash_attention_fwd max_rel_err {whole_err:.3e} "
            f"against flash_attention_plain (bound {KERNEL_BOUND:.0e}), {whole_ms:.3f} ms "
            f"{'ok' if ok_whole else 'FAILED'} [{card}]")
        if not ok_whole:
            fail(f"ring (a) [{label}]: the whole-KV call disagrees with its plain version")
        scale = (q.shape[-1] // heads) ** -0.5
        for sp in RING_SPS:
            ring_kv = k.shape[1] % sp == 0
            lq, lk = q.shape[1] // sp, k.shape[1] // sp
            blocks = [(k, v, bias)]  # replicated KV: every rank's one block
            if ring_kv:  # block j: keys j lk .. (j + 1) lk and the bias over them
                blocks = [(k[:, j * lk:(j + 1) * lk].contiguous(),
                           v[:, j * lk:(j + 1) * lk].contiguous(),
                           None if bias is None else bias[..., j * lk:(j + 1) * lk].contiguous())
                          for j in range(sp)]

            def run_rank(i):
                qi, out, lse = q[:, i * lq:(i + 1) * lq], None, None
                for kb, vb, bb in blocks[i:] + blocks[:i]:
                    out, lse = ring.ring_step(out, lse, qi, kb, vb, bb, heads, scale)
                return out.to(q.dtype)

            build.reset_launches()
            got = torch.cat([run_rank(i) for i in range(sp)], dim=1)
            torch.cuda.synchronize()
            n = build.launches["flash_attention_fwd"]
            for name, count in build.launches.items():
                launches[name] += count
            per_rank = sp if ring_kv else 1
            err = rel(got, plain)
            q0 = q[:, :lq]
            first = ring.ring_step(None, None, q0, *blocks[0], heads, scale)
            if ring_kv:  # a later hop: the launch and the log-sum-exp combine
                hop_ms = timed_ms(lambda: ring.ring_step(*first, q0, *blocks[1], heads, scale),
                                  torch, 10)
            else:
                hop_ms = timed_ms(lambda: ring.ring_step(None, None, q0, *blocks[0], heads,
                                                         scale), torch, 10)
            rank_ms = timed_ms(lambda: run_rank(0), torch, 10)
            ok = (err < KERNEL_BOUND and n == sp * per_rank and bool(torch.isfinite(got).all()))
            say(f"ring (a) [{label}] sp={sp} ({'ring' if ring_kv else 'replicated KV'}): "
                f"max_rel_err {err:.3e} against flash_attention_plain (bound "
                f"{KERNEL_BOUND:.0e}), "
                f"flash_attention_fwd launches {n} ({per_rank} a rank), whole-KV call "
                f"{whole_ms:.3f} ms, one {'hop with its combine' if ring_kv else 'call'} "
                f"{hop_ms:.3f} ms, one rank's {per_rank} {rank_ms:.3f} ms (whole / sp "
                f"{whole_ms / sp:.3f}) {'ok' if ok else 'FAILED'} [{card}]")
            if not ok:
                fail(f"ring (a) [{label}] sp={sp}: the ring's rows disagree with the plain "
                     "version or launched another count")
    return launches


def _phase_tp_feed_forward(torch, build, card):
    """(a) the feed-forward of a tp rank without residual, through ``ff_ln``
    and ``ff_ln_f32``, against ``ff_ln_plain(..., residual=False)``: levels 0
    and 1 of one clip's pair at tp = 2 (I / 2 of the weights), and level 0 at
    tp = 4 (I / 4 = 320, off JAX's 128 grid, on the kernel's 64). Each case
    also goes through ``feed_forward(..., residual=False)``, which must route
    the shard to the same kernel launch."""
    from eeg2video_tpu_torch.ops import geglu

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(15)
    for t, c, tp in ((27648, 320, 2), (6912, 640, 2), (27648, 320, 4)):
        i = 4 * c // tp
        for dt, bound in ((torch.bfloat16, KERNEL_BOUND), (torch.float32, F32_KERNEL_BOUND)):
            def r(*shape, scale=1.0, dtype=dt):
                return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

            f32 = torch.float32
            args = [r(t, c), 1.0 + 0.05 * r(c, dtype=f32), 0.02 * r(c, dtype=f32),
                    r(2 * i, c, scale=c ** -0.5), 0.02 * r(2 * i, dtype=f32),
                    r(c, i, scale=i ** -0.5), 0.02 * r(c, dtype=f32)]
            kernel = "ff_ln" if dt == torch.bfloat16 else "ff_ln_f32"
            got = geglu.ff_ln(*args, residual=False)
            want = geglu.ff_ln_plain(*[a.float() for a in args], residual=False)
            full = geglu.ff_ln(*args)
            before = build.launches[kernel]
            routed = geglu.feed_forward(*args, residual=False)
            via_route = build.launches[kernel] - before
            err = ((got.float() - want).abs().max() / want.abs().max()).item()
            # the residual-free output plus x is the full block's, to the rounding of one add
            gap = ((got.float() + args[0].float() - full.float()).abs().max()
                   / full.float().abs().max()).item()
            same = torch.equal(routed, got)
            ok = err < bound and gap < bound and via_route == 1 and same
            say(f"tp feed-forward (a) tp={tp} T={t} C={c} I/{tp}={i} {str(dt)[6:]}: "
                f"residual-free kernel max_rel_err {err:.3e} (bound {bound:.0e}), + x against "
                f"the full block {gap:.3e}; feed_forward(residual=False) launched {kernel} "
                f"{via_route} time(s), bit-equal {same} {'ok' if ok else 'FAILED'} [{card}]")
            if not ok:
                fail(f"tp feed-forward (a): the residual-free {kernel} at C={c} I={i} disagrees "
                     "or the shard's route left the kernel")


def _record_videos():
    """save_videos_grid replaced by a recorder that also writes the GIF:
    {gif name: the (1, F, H, W, 3) float array}."""
    from eeg2video_tpu_torch.data import video

    seen, real = {}, video.save_videos_grid

    def record(videos, path, **kw):
        seen[os.path.basename(path)] = videos.copy()
        return real(videos, path, **kw)

    video.save_videos_grid = record
    return seen, lambda: setattr(video, "save_videos_grid", real)


def _phase_mesh_world1(torch, build, card, tmp):
    """(b) inference_eeg2video.main with --dp 1 (a world of one on a local
    store, NCCL) against the same command without it: bit-equal videos.
    Returns the --dp 1 run's launches and its GIF bytes."""
    import numpy as np
    import torch.distributed as dist

    from eeg2video_tpu_torch.cli import inference_eeg2video

    runs, launches = {}, None
    for tag, extra in (("one_gpu", []), ("dp1", ["--dp", "1"])):
        out_dir = os.path.join(tmp, tag)
        seen, restore = _record_videos()
        build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            inference_eeg2video.main([*_mesh_command(tmp), *extra, "--out_dir", out_dir])
        finally:
            restore()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if tag == "dp1":
            launches = dict(build.launches)
            backend, world = dist.get_backend(), dist.get_world_size()
            x = torch.ones(4, device="cuda")
            dist.all_reduce(x)
            say(f"mesh (b): the --dp 1 group: backend {backend}, world size {world}, an "
                f"all_reduce on the card gave {x.tolist()}")
            if backend != "nccl" or world != 1 or x.tolist() != [1.0] * 4:
                fail("mesh (b): --dp 1 did not run on a world of one over NCCL")
            dist.destroy_process_group()
        names = sorted(os.listdir(out_dir))
        runs[tag] = (names, seen)
        forwards = launches["flash_attention_fwd"] / EXPECTED_PER_FORWARD["flash_attention_fwd"] \
            if tag == "dp1" else None
        say(f"mesh (b): inference_eeg2video.main {' '.join(extra) or '(no mesh)'}: {names}, "
            f"{secs:.1f} s with loading the pipeline"
            + (f", {forwards:g} UNet forwards, launches {_nonzero(launches)}" if forwards else "")
            + f" [{card}]")
    (names1, one), (names2, dp1) = runs["one_gpu"], runs["dp1"]
    same = names1 == names2 == [f"{i}.gif" for i in range(MESH_CLIPS)] and all(
        np.array_equal(one[n], dp1[n]) for n in names1)
    want = {k: n * STEPS for k, n in EXPECTED_PER_FORWARD.items()}
    ok = same and {k: launches[k] for k in want} == want
    say(f"mesh (b): --dp 1 against no mesh: videos bit-equal {same}, launches "
        f"{ {k: launches[k] for k in want} } (expected {want}) {'ok' if ok else 'FAILED'}")
    if not ok:
        fail("mesh (b): --dp 1 differs from the run without a mesh")
    with open(os.path.join(tmp, "dp1", "0.gif"), "rb") as f:
        return launches, f.read()


def _mesh_command(tmp):
    return ["--embeddings", os.path.join(tmp, "embeddings.npy"), "--woSeq2Seq",
            "--unet", os.path.join(tmp, "unet.pt"), "--vae", os.path.join(tmp, "vae.pt"),
            "--limit", str(MESH_CLIPS), "--batch", str(MESH_CLIPS), "--num_inference_steps",
            str(STEPS), "--gif_encoder", "native"]


def _phase_torchrun(torch, card, tmp, gif0):
    """(c) the same --dp 1 command under ``torchrun --nproc_per_node 1``
    (``python -m torch.distributed.run --standalone``), in a subprocess with a
    timeout: init_distributed takes the launcher's environment."""
    out_dir = os.path.join(tmp, "torchrun")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
           "-m", "eeg2video_tpu_torch.cli.inference_eeg2video", *_mesh_command(tmp), "--dp", "1",
           "--out_dir", out_dir]
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                             timeout=TORCHRUN_TIMEOUT)
    except subprocess.TimeoutExpired:
        fail(f"mesh (c): torchrun passed its {TORCHRUN_TIMEOUT} s timeout")
    secs = time.perf_counter() - t0
    log = res.stderr.strip().splitlines()
    launcher = [ln for ln in log if "process group" in ln]
    names = sorted(os.listdir(out_dir)) if os.path.isdir(out_dir) else []
    same = False
    if names:
        with open(os.path.join(out_dir, "0.gif"), "rb") as f:
            same = f.read() == gif0
    ok = (res.returncode == 0 and names == [f"{i}.gif" for i in range(MESH_CLIPS)]
          and any("from the launcher" in ln for ln in launcher))
    say(f"mesh (c): torchrun --nproc_per_node 1 ... --dp 1: exit {res.returncode}, {names}, "
        f"{secs:.1f} s with the launcher and loading; {launcher[-1:] or log[-3:]}; 0.gif "
        f"byte-equal to (b)'s {same} {'ok' if ok else 'FAILED'} [{card}]")
    if not ok:
        fail("mesh (c): the torchrun launch failed or did not take the launcher's group")


def phase_section14(torch, build, card):
    """Section 14: multi-GPU generation on one card. (a) the ring's hop step
    and a tp rank's residual-free feed-forward; (b) the mesh path at world size
    1 over NCCL (--dp 1) against no mesh; (c) a torchrun launch of it. Returns
    the launches of the ring hops and of the --dp 1 path."""
    import numpy as np

    from eeg2video_tpu_torch.diffusion.pipeline import EEG2VideoPipeline
    from eeg2video_tpu_torch.models.init import random_init_
    from eeg2video_tpu_torch.models.unet3d import UNet3DConfig
    from eeg2video_tpu_torch.models.vae import VAEConfig

    t_section = time.perf_counter()
    ring_launches = _phase_ring_hops(torch, build, card)
    _phase_tp_feed_forward(torch, build, card)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="e2v_mesh_") as tmp:
        g = torch.Generator(device="cuda").manual_seed(16)
        pipe = EEG2VideoPipeline.create(None, None, UNet3DConfig(), VAEConfig(),
                                        dtype=torch.bfloat16, device="cuda")
        random_init_(pipe.unet, g)
        random_init_(pipe.vae, g)
        torch.save(pipe.unet.state_dict(), os.path.join(tmp, "unet.pt"))
        torch.save(pipe.vae.state_dict(), os.path.join(tmp, "vae.pt"))
        del pipe
        torch.cuda.empty_cache()
        np.save(os.path.join(tmp, "embeddings.npy"), np.random.default_rng(16).standard_normal(
            (MESH_CLIPS, 77 * 768)).astype(np.float32))
        mesh_launches, gif0 = _phase_mesh_world1(torch, build, card, tmp)
        torch.cuda.empty_cache()
        _phase_torchrun(torch, card, tmp, gif0)
    say(f"section 14: {time.perf_counter() - t_section:.1f} s")
    return {"ring_hops": ring_launches, "mesh": mesh_launches}


# --- section 15: multi-GPU training on one card -------------------------------

RING_BWD_CHUNK_BYTES = 2 << 30  # per f32 logits-sized tensor of the chunked plain backward
MESH_TRAIN_CLIPS = TRAIN_BATCH * TRAIN_STEPS  # (c): one epoch of three optimizer steps


def _ring_bwd_cases(torch, dev):
    """(label, q, k, v, bias) at the fine-tune's level-0 shapes in its sp
    route (batch 10, 8 heads of 40), bf16: frames 0-1 as one (10, 4608) query
    against K0; frames 2-5 against the [K0 | K_prev] concat of 4608 keys,
    with and without the [bias, 0] the model builds; cross-attention per
    frame against the 77 context rows."""
    g = torch.Generator(device=dev).manual_seed(25)

    def r(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    l, c, b = 2304, 320, TRAIN_BATCH
    mask = (torch.rand((4 * b, 1, l), generator=g, device=dev) < 0.25) * -1e4
    bias = torch.cat([mask + torch.randn((4 * b, 1, l), generator=g, device=dev),
                      torch.zeros((4 * b, 1, l), device=dev)], dim=-1)
    k2, v2 = r(4 * b, 2 * l, c), r(4 * b, 2 * l, c)
    return [(f"frames 0-1 ({b},4608,320)x2304", r(b, 2 * l, c), r(b, l, c), r(b, l, c), None),
            (f"frames 2-5 ({4 * b},2304,320)x[K0|K_prev] 4608", r(4 * b, l, c), k2, v2, None),
            (f"frames 2-5 ({4 * b},2304,320)x[K0|K_prev] 4608 + ({4 * b},1,4608) bias",
             r(4 * b, l, c), k2, v2, bias),
            (f"cross ({6 * b},2304,320)x77", r(6 * b, l, c), r(6 * b, 77, c), r(6 * b, 77, c),
             None)]


def _plain_bwd_chunked(torch, q, k, v, bias, dout, heads):
    """flash_attention_plain's forward and flash_attention_bwd_plain (f32)
    over chunks of the batch (every batch row is independent): (dq, dk, dv,
    dbias or None)."""
    from eeg2video_tpu_torch.ops.attention import (flash_attention_bwd_plain,
                                                   flash_attention_plain)

    n, lq, lk = q.shape[0], q.shape[1], k.shape[1]
    step = max(1, RING_BWD_CHUNK_BYTES // (heads * lq * lk * 4))
    parts = []
    for s in range(0, n, step):
        sl = slice(s, s + step)
        qs, ks, vs, ds = (t[sl].float() for t in (q, k, v, dout))
        bs = None if bias is None else bias[sl]
        out, lse = flash_attention_plain(qs, ks, vs, heads, bias0=bs, return_lse=True)
        dq, dk, dv, _, _, db = flash_attention_bwd_plain(qs, ks, vs, heads, ds, out, lse,
                                                         bias0=bs, need_dbias=bs is not None)
        parts.append((dq, dk, dv, db))
        del out, lse
        torch.cuda.empty_cache()
    return [None if parts[0][i] is None else torch.cat([p[i] for p in parts])
            for i in range(4)]


def _phase_ring_bwd_hops(torch, build, card):
    """(a) ``ring.ring_bwd_step`` on one card: sp ranks played by rotating a
    list of the sp K/V blocks and their f32 dk / dv / dbias accumulators, as
    ``ops.ring`` does across processes; each rank's forward hops first
    (``ring_step``) for the global (out, lse). Each rank's dq rows and each
    home block's dk / dv / dbias (replicated-KV mode: summed over the ranks),
    and one whole-KV ``flash_attention_bwd``, against the plain backward (f32,
    chunked over the batch) at KERNEL_BOUND. Returns the ring runs' launches."""
    from eeg2video_tpu_torch.ops import ring
    from eeg2video_tpu_torch.ops.attention import flash_attention_bwd, flash_attention_fwd

    dev, heads = torch.device("cuda"), 8
    launches = dict.fromkeys(COUNTERS, 0)
    g = torch.Generator(device=dev).manual_seed(26)

    def rel(got, want):
        return ((got.float() - want).abs().max() / want.abs().max()).item()

    for label, q, k, v, bias in _ring_bwd_cases(torch, dev):
        dout = torch.randn(q.shape, generator=g, device=dev).to(torch.bfloat16)
        want = _plain_bwd_chunked(torch, q, k, v, bias, dout, heads)
        scale = (q.shape[-1] // heads) ** -0.5
        out, lse = flash_attention_fwd(q, k, v, heads, bias0=bias, return_lse=True)

        def whole():
            return flash_attention_bwd(q, k, v, heads, dout, out, lse, bias0=bias,
                                       need_dbias=bias is not None)

        got = whole()
        errs = [rel(a, b) for a, b in zip((got[0], got[1], got[2], got[5]), want)
                if b is not None]
        whole_ms = timed_ms(whole, torch, 5)
        ok = max(errs) < KERNEL_BOUND and all(bool(torch.isfinite(t).all()) for t in
                                              (got[0], got[1], got[2]))
        say(f"ring bwd (a) [{label}]: one whole-KV flash_attention_bwd max_rel_err "
            f"{max(errs):.3e} (dq, dk, dv{', dbias' if bias is not None else ''}) against the "
            f"plain backward (bound {KERNEL_BOUND:.0e}), {whole_ms:.3f} ms "
            f"{'ok' if ok else 'FAILED'} [{card}]")
        if not ok:
            fail(f"ring bwd (a) [{label}]: the whole-KV backward disagrees with its plain version")
        del got, out, lse
        for sp in RING_SPS:
            ring_kv = k.shape[1] % sp == 0
            lq, lk = q.shape[1] // sp, k.shape[1] // sp
            blocks = [(k, v, bias)]  # replicated KV: every rank's one block
            if ring_kv:  # block j: keys j lk .. (j + 1) lk and the bias over them
                blocks = [(k[:, j * lk:(j + 1) * lk].contiguous(),
                           v[:, j * lk:(j + 1) * lk].contiguous(),
                           None if bias is None else bias[..., j * lk:(j + 1) * lk].contiguous())
                          for j in range(sp)]
            rows = [q[:, i * lq:(i + 1) * lq].contiguous() for i in range(sp)]
            drows = [dout[:, i * lq:(i + 1) * lq].contiguous() for i in range(sp)]

            def forward(i):  # rank i's forward hops: its rows' global (out, lse)
                o = l_ = None
                for kb, vb, bb in blocks[i:] + blocks[:i]:
                    o, l_ = ring.ring_step(o, l_, rows[i], kb, vb, bb, heads, scale)
                return o.to(q.dtype), l_

            fwd = [forward(i) for i in range(sp)]

            def backward(i, acc):
                """Rank i's backward hops; the block's accumulators in ``acc``
                (indexed by block) stand for the ones that travel with it."""
                dq = torch.zeros(rows[i].shape, dtype=torch.float32, device=dev)
                for t in range(len(blocks)):
                    j = (i + t) % len(blocks)
                    kb, vb, bb = blocks[j]
                    dq_p, *parts = ring.ring_bwd_step(rows[i], kb, vb, bb, drows[i], *fwd[i],
                                                      heads, scale)
                    dq += dq_p.float()
                    for a, p in zip(acc[j], parts):
                        a += p.float()
                return dq

            def fresh():
                return [[torch.zeros(t.shape, dtype=torch.float32, device=dev)
                         for t in blk if t is not None] for blk in blocks]

            build.reset_launches()
            acc = fresh()
            dq = torch.cat([backward(i, acc) for i in range(sp)], dim=1)
            torch.cuda.synchronize()
            n = build.launches["flash_attention_bwd"]
            for name, count in build.launches.items():
                launches[name] += count
            dk = torch.cat([a[0] for a in acc], dim=1)
            dv = torch.cat([a[1] for a in acc], dim=1)
            db = None if bias is None else torch.cat([a[2] for a in acc], dim=-1)
            errs = [rel(a.to(q.dtype), b) for a, b in zip((dq, dk, dv, db), want)
                    if b is not None]
            per_rank = sp if ring_kv else 1
            hop_ms = timed_ms(lambda: ring.ring_bwd_step(rows[0], *blocks[0], drows[0], *fwd[0],
                                                         heads, scale), torch, 5)
            rank_ms = timed_ms(lambda: backward(0, fresh()), torch, 5)
            ok = (max(errs) < KERNEL_BOUND and n == sp * per_rank
                  and bool(torch.isfinite(dq).all()))
            say(f"ring bwd (a) [{label}] sp={sp} ({'ring' if ring_kv else 'replicated KV'}): "
                f"max_rel_err {max(errs):.3e} (dq rows, home blocks' dk, dv"
                f"{', dbias' if bias is not None else ''}) against the plain backward (bound "
                f"{KERNEL_BOUND:.0e}), flash_attention_bwd launches {n} ({per_rank} a rank), "
                f"whole-KV backward {whole_ms:.3f} ms, one hop {hop_ms:.3f} ms, one rank's "
                f"{per_rank} with the f32 accumulation {rank_ms:.3f} ms (whole / sp "
                f"{whole_ms / sp:.3f}) {'ok' if ok else 'FAILED'} [{card}]")
            if not ok:
                fail(f"ring bwd (a) [{label}] sp={sp}: the ring's gradients disagree with the "
                     "plain backward or launched another count")
            del acc, dq, dk, dv, db, fwd
        del want
        torch.cuda.empty_cache()
    return launches


def _ff_bwd_free_composed(torch, args):
    """The gradient in x of layer_norm -> F.linear -> h gelu(g) -> F.linear
    without the residual, in the operands' dtype (autograd, its forward
    included): a yardstick the port never calls."""
    import torch.nn.functional as F

    x, dout, gamma, beta, wp, bp, wo = args
    c = x.shape[-1]
    vb = [t.to(x.dtype) for t in (gamma, beta, bp)]

    def run():
        xl = x.detach().requires_grad_()
        h, gate = F.linear(F.layer_norm(xl, (c,), vb[0], vb[1]), wp, vb[2]).chunk(2, dim=-1)
        return torch.autograd.grad(F.linear(h * F.gelu(gate), wo), xl, dout)
    return run


def _phase_tp_ff_bwd(torch, build, card):
    """(b) ``ff_ln_bwd`` / ``ff_ln_bwd_f32`` with ``residual=False`` (a tp
    rank's feed-forward, without the residual's gradient) at the tp = 2 and
    tp = 4 shard widths of the train levels 0 and 1 (I / tp of the weights),
    against ``ff_ln_bwd_plain(..., residual=False)`` (f32); each beside the
    composed cuBLAS form and its bound; the differentiable
    ``feed_forward(..., residual=False)`` must launch it once in its backward.
    Returns {(T, C, I, dtype): ms}."""
    from eeg2video_tpu_torch.ops import geglu
    from eeg2video_tpu_torch.utils.flops import H100_BF16_PEAK

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(27)
    times = {}
    tb = TRAIN_BATCH * 6
    for t, c, tp in ((tb * 2304, 320, 2), (tb * 2304, 320, 4), (tb * 576, 640, 2),
                     (tb * 576, 640, 4)):
        i = 4 * c // tp
        for dt, bound in ((torch.bfloat16, KERNEL_BOUND), (torch.float32, F32_KERNEL_BOUND)):
            def r(*shape, scale=1.0, dtype=dt):
                return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

            f32 = torch.float32
            args = [r(t, c), r(t, c), 1.0 + 0.05 * r(c, dtype=f32), 0.02 * r(c, dtype=f32),
                    r(2 * i, c, scale=c ** -0.5), 0.02 * r(2 * i, dtype=f32),
                    r(c, i, scale=i ** -0.5)]
            kernel = "ff_ln_bwd" if dt == torch.bfloat16 else "ff_ln_bwd_f32"
            got = geglu.ff_ln_bwd(*args, residual=False)
            again = geglu.ff_ln_bwd(*args, residual=False)
            want = geglu.ff_ln_bwd_plain(*[a.float() for a in args], residual=False)
            err = ((got.float() - want).abs().max() / want.abs().max()).item()
            full = geglu.ff_ln_bwd(*args)
            # with the residual: the same LayerNorm path plus g, to the rounding
            # of that sum
            gap = ((full.float() - args[1].float() - got.float()).abs().max()
                   / full.float().abs().max()).item()
            del want, full
            x = args[0].detach().requires_grad_()
            before = build.launches[kernel]
            out = geglu.feed_forward(x, *args[2:7], torch.zeros_like(args[2]), residual=False)
            out.backward(args[1])
            via_route = build.launches[kernel] - before
            same = torch.equal(x.grad, got)
            ms = timed_ms(lambda: geglu.ff_ln_bwd(*args, residual=False), torch, 10)
            composed_ms = timed_ms(_ff_bwd_free_composed(torch, args), torch, 10)
            plain_ms = timed_ms(lambda: geglu.ff_ln_bwd_plain(*args, residual=False), torch, 3)
            nbytes = _nbytes(args) + got.numel() * got.element_size() + (
                2 * geglu.ff_f32_workspace_bytes(t, i, backward=True) if dt == f32 else 0)
            peak = PEAK_TF32_FLOPS / TF32_PASSES if dt == f32 else H100_BF16_PEAK
            t_bytes, t_flops = nbytes / PEAK_BYTES * 1e3, 10 * t * c * i / peak * 1e3
            bound_ms = max(t_bytes, t_flops)
            times[(t, c, i, str(dt)[6:])] = ms
            ok = (err < bound and gap < bound and via_route == 1 and same
                  and torch.equal(got, again))
            say(f"tp ff_ln_bwd (b) tp={tp} T={t} C={c} I/{tp}={i} {str(dt)[6:]}: residual-free "
                f"{kernel} max_rel_err {err:.3e} (bound {bound:.0e}), + g against the call with "
                f"its residual {gap:.3e}, twice bit for bit; {ms:.3f} ms, bound {bound_ms:.4f} ms "
                f"by {'bytes' if t_bytes >= t_flops else 'operations'} ({bound_ms / ms:.3f} of "
                f"it), composed {composed_ms:.3f} ms, plain {plain_ms:.3f} ms; "
                f"feed_forward(residual=False)'s backward "
                f"launched {kernel} {via_route} time(s), dx bit-equal {same} "
                f"{'ok' if ok else 'FAILED'} [{card}]")
            if not ok:
                fail(f"tp ff_ln_bwd (b): the residual-free {kernel} at C={c} I={i} disagrees, "
                     "is not deterministic or the shard's route left the kernel")
            del args, got, again, x, out
        torch.cuda.empty_cache()
    return times


def _mesh_train_run(torch, build, tmp, post, contexts, flags):
    """``train_tuneavideo.train`` at UNet3DConfig() from the seeded weights,
    one epoch of TRAIN_STEPS steps at batch TRAIN_BATCH, a tiny VAE (the
    posteriors are given; it is only written beside the checkpoint and
    decodes a validation sample where the flags ask for one): per step
    (seconds, loss, launches), the masters after it, the mesh, and the
    units' gathers under fsdp (None without)."""
    from eeg2video_tpu_torch.cli import train_tuneavideo
    from eeg2video_tpu_torch.models.vae import AutoencoderKL, VAEConfig

    unet, _ = _full_width_unet(torch, 28)
    vae = AutoencoderKL(VAEConfig.tiny())
    steps, clock = [], [0.0]

    def on_step(state, loss):
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - clock[0], float(loss), dict(build.launches)))
        build.reset_launches()
        clock[0] = time.perf_counter()

    args = train_tuneavideo.build_parser().parse_args([
        "--device", "cuda", "--epochs", "1", "--train_batch_size", str(TRAIN_BATCH),
        "--validation_epochs", "100", "--output_dir", tmp, *flags])
    build.reset_launches()
    torch.cuda.synchronize()
    clock[0] = time.perf_counter()
    state, losses = train_tuneavideo.train(unet, vae, post, contexts, args, on_step=on_step)
    masters = {n: p.detach().clone() for n, p in state.masters.items()}
    mesh, gathers = state.mesh, None if state.gather is None else state.gather.gathers
    del state, unet
    torch.cuda.empty_cache()
    return steps, masters, mesh, gathers


def _mesh_train_data(torch):
    """Section 15 (c)'s seeded posteriors and contexts, one epoch's worth."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(29)
    n = MESH_TRAIN_CLIPS
    post = torch.cat([torch.randn((n, 6, 36, 64, 4), generator=g, device=dev),
                      -4.0 + 0.1 * torch.randn((n, 6, 36, 64, 4), generator=g, device=dev)],
                     dim=-1)
    return post, torch.randn((n, 77, 768), generator=g, device=dev)


def _phase_mesh_train(torch, build, card):
    """(c) ``train_tuneavideo.train`` on a ``--dp 1 --fsdp`` mesh (a world of
    one on a local store, NCCL) at UNet3DConfig(), batch 10, three optimizer
    steps, against the same call without a mesh: every loss and master bit
    for bit (every collective is over one rank), the train kernels launched
    as the mesh-less step launches them. Returns the mesh run's launches and
    the run without a mesh: its losses and its masters, on the host."""
    import torch.distributed as dist

    post, contexts = _mesh_train_data(torch)
    runs = {}
    for tag, flags in (("no mesh", []), ("--dp 1 --fsdp", ["--dp", "1", "--fsdp"])):
        with tempfile.TemporaryDirectory(prefix="e2v_mesh_train_") as tmp:
            runs[tag] = _mesh_train_run(torch, build, tmp, post, contexts, flags)
        steps, _, mesh, _ = runs[tag]
        say(f"mesh train (c) {tag} ({mesh}): {len(steps)} steps, loss per step "
            f"{[s[1] for s in steps]}, seconds per step {[round(s[0], 3) for s in steps]} "
            f"(the first includes building the train state) [{card}]")
    (base, base_m, _, _), (mesh_steps, mesh_m, mesh, _) = runs["no mesh"], runs["--dp 1 --fsdp"]
    backend, world = dist.get_backend(), dist.get_world_size()
    same_loss = [a[1] == b[1] for a, b in zip(base, mesh_steps)]
    same_m = [torch.equal(base_m[k], mesh_m[k]) for k in base_m]
    launched = [s[2] for s in mesh_steps]
    ok = (len(mesh_steps) == len(base) == TRAIN_STEPS and all(same_loss) and all(same_m)
          and list(base_m) == list(mesh_m) and mesh is not None and backend == "nccl"
          and world == 1 and all(l == EXPECTED_PER_TRAIN_STEP for l in launched)
          and launched == [s[2] for s in base])
    say(f"mesh train (c): --dp 1 --fsdp over {backend} (world {world}) against no mesh: losses "
        f"bit-equal {sum(same_loss)} of {len(same_loss)}, masters bit-equal {sum(same_m)} of "
        f"{len(same_m)}, per-step launches {_nonzero(launched[0])} in each of "
        f"{len(launched)} steps (the mesh-less run's: {launched == [s[2] for s in base]}) "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        fail("mesh train (c): the --dp 1 --fsdp step differs from the step without a mesh")
    dist.destroy_process_group()
    return ({k: sum(l[k] for l in launched) for k in COUNTERS},
            ([s[1] for s in base], {k: v.cpu() for k, v in base_m.items()}))


def phase_section15(torch, build, card):
    """Section 15: multi-GPU training on one card. (a) the ring's backward
    hops; (b) a tp rank's residual-free feed-forward backward; (c) the
    fine-tune on a --dp 1 --fsdp mesh over NCCL against no mesh. Returns the
    launches of the ring's backward runs and of the mesh's steps, and (c)'s
    run without a mesh (losses, masters on the host)."""
    t_section = time.perf_counter()
    ring_launches = _phase_ring_bwd_hops(torch, build, card)
    if not ring_launches["flash_attention_bwd"]:
        fail("ring bwd (a): no flash_attention_bwd launched")
    torch.cuda.empty_cache()
    _phase_tp_ff_bwd(torch, build, card)
    torch.cuda.empty_cache()
    mesh_launches, base = _phase_mesh_train(torch, build, card)
    say(f"section 15: {time.perf_counter() - t_section:.1f} s")
    return {"ring_bwd": ring_launches, "mesh_train": mesh_launches}, base


# --- section 16: multi-GPU serving and the semantic trainer's meshes on one card ---

SERVE_MESH_FEATURES = 2   # feature rows of (a)'s request: one int8 chunk on rank 0
SERVE_MESH_CLIPS = 2      # and its clips, at --max_batch 2
GPIPE_MICRO, GPIPE_BATCH, GPIPE_REPS = 8, 32, 3
SEM_MESH_ROWS = 256       # (c): 8 steps at batch 32


def _serve_stdin(serve_fn, lines):
    """``serve_fn()`` with stdin the lines and stdout captured: (exit code,
    the replies)."""
    import io

    real_in, real_out = sys.stdin, sys.stdout
    sys.stdin, sys.stdout = io.StringIO("".join(line + "\n" for line in lines)), io.StringIO()
    try:
        rc = serve_fn()
        printed = sys.stdout.getvalue()
    finally:
        sys.stdin, sys.stdout = real_in, real_out
    return rc, [json.loads(line) for line in printed.splitlines() if line.strip()]


def _int8_semantic(torch, dev, seed):
    """The hidden=10000 MLP, each layer drawn and quantized on the card, as
    the serve phase builds it; the request path's callable."""
    from eeg2video_tpu_torch.models.semantic import HIDDEN, IN_DIM, Int8SemanticPredictor
    from eeg2video_tpu_torch.ops.int8_dense import quantize_int8
    from eeg2video_tpu_torch.serving.runtimes import make_semantic_predict

    g = torch.Generator(device=dev).manual_seed(seed)
    dims = [IN_DIM] + [HIDDEN] * 4 + [77 * 768]
    layers = []
    for k, n in zip(dims[:-1], dims[1:]):
        w = torch.randn(k, n, generator=g, device=dev) * k ** -0.5
        w_q, scale = quantize_int8(w)
        del w
        layers.append((w_q, scale, 0.02 * torch.randn(n, generator=g, device=dev), n))
    return make_semantic_predict(Int8SemanticPredictor(layers), dev)


def _phase_mesh_serve(torch, build, card, tmp, pipe):
    """(a) ``serve --dp 1 --coalesce --max_batch 2 --semantic_int8`` in-process
    on a world of one over NCCL (``serve_on_mesh``: rank 0's dispatcher sends
    each dispatch over the control group and the mesh's group) against the
    same server without a mesh: one features request of 2 clips through the
    int8 MLP on rank 0, 4 DDIM steps, noise drawn on rank 0; the clips bit
    for bit. Returns the mesh run's launches."""
    import numpy as np
    import torch.distributed as dist

    from eeg2video_tpu_torch.cli import serve
    from eeg2video_tpu_torch.parallel import make_mesh
    from eeg2video_tpu_torch.serving.mesh import ControlPlane

    dev = pipe.device
    semantic = _int8_semantic(torch, dev, 43)
    feats = os.path.join(tmp, "features.npy")
    np.save(feats, np.random.default_rng(43).standard_normal(
        (SERVE_MESH_FEATURES, 310)).astype(np.float32))
    runs = {}
    for tag in ("no mesh", "--dp 1"):
        out = os.path.join(tmp, "served_" + tag.replace(" ", "").replace("-", ""))
        args = serve.build_parser().parse_args([
            "--device", "cuda", "--coalesce", "--max_batch", str(SERVE_MESH_CLIPS),
            "--semantic_int8", "--num_inference_steps", str(STEPS), "--gif_encoder", "native",
            "--out_dir", out, *(["--dp", "1"] if tag == "--dp 1" else [])])
        lines = [json.dumps({"id": "r", "features": feats}), json.dumps({"cmd": "stats"}),
                 json.dumps({"cmd": "shutdown"})]
        if tag == "no mesh":
            fn = lambda: serve.serve(pipe, args, semantic)  # noqa: E731
        else:
            mesh = make_mesh(dp=1, device=dev)
            plane = ControlPlane(mesh)
            pipe.shard(mesh)
            fn = lambda: serve.serve_on_mesh(pipe, args, plane, semantic)  # noqa: E731
        seen, restore = _record_videos()
        build.reset_launches()
        t0 = _sync_clock(torch)
        try:
            rc, replies = _serve_stdin(fn, lines)
        finally:
            restore()
        secs = _sync_clock(torch) - t0
        runs[tag] = (rc, replies, seen, dict(build.launches))
        keep = ("id", "ok", "clips", "requests", "bye")
        say(f"mesh serve (a) {tag}: exit {rc}, replies "
            f"{[{k: r[k] for k in r if k in keep} for r in replies]}, {secs:.2f} s, launches "
            f"{_nonzero(build.launches)} [{card}]")
    pipe.mesh = None
    (rc1, rep1, one, _), (rc2, rep2, dp1, launches) = runs["no mesh"], runs["--dp 1"]
    backend, world = dist.get_backend(), dist.get_world_size()
    same = sorted(one) == sorted(dp1) == [f"{i}.gif" for i in range(SERVE_MESH_CLIPS)] and all(
        np.array_equal(one[n], dp1[n]) for n in one)
    # one dispatch of 2 clips: STEPS UNet forwards; one 100-row chunk of the MLP
    want = {**{k: n * STEPS for k, n in EXPECTED_PER_FORWARD.items()}, "int8_dense": 5}
    got = {k: launches[k] for k in want}
    ok = (rc1 == rc2 == 0 and same and all(r.get("ok") for r in rep2) and got == want
          and backend == "nccl" and world == 1 and runs["no mesh"][3] == launches)
    say(f"mesh serve (a): --dp 1 over {backend} (world {world}) against no mesh: clips "
        f"bit-equal {same}, launches {got} (expected {want}, the same as without the mesh "
        f"{runs['no mesh'][3] == launches}) {'ok' if ok else 'FAILED'} [{card}]")
    if not ok:
        fail("mesh serve (a): the --dp 1 server differs from the server without a mesh")
    return launches


def _read_line(stream, seconds):
    """One line of ``stream`` within ``seconds``, or None."""
    box = []
    t = threading.Thread(target=lambda: box.append(stream.readline()), daemon=True)
    t.start()
    t.join(seconds)
    return box[0] if box else None


def _phase_serve_torchrun(torch, card, tmp):
    """(a) ``torchrun --nproc_per_node 1 -m eeg2video_tpu_torch.cli.serve --dp 1
    --listen 127.0.0.1:0`` on the saved weights, driven by a client over the
    socket: the ready line, one request (noise drawn on rank 0), stats,
    shutdown, exit 0. The process is killed if any step fails."""
    emb = os.path.join(tmp, "embeddings.npy")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
           "-m", "eeg2video_tpu_torch.cli.serve", "--dp", "1", "--listen", "127.0.0.1:0",
           "--unet", os.path.join(tmp, "unet.pt"), "--vae", os.path.join(tmp, "vae.pt"),
           "--num_inference_steps", str(STEPS), "--gif_encoder", "native",
           "--out_dir", os.path.join(tmp, "served_torchrun")]
    t0 = time.perf_counter()
    with open(os.path.join(tmp, "serve_torchrun.err"), "w+") as err:
        proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=err, text=True)
        replies, rc, ready, t_ready = [], None, {}, float("nan")
        try:
            line = _read_line(proc.stdout, TORCHRUN_TIMEOUT)
            ready = json.loads(line)
            t_ready = time.perf_counter() - t0
            with socket.create_connection(("127.0.0.1", ready["port"]), timeout=120) as sock:
                rfile = sock.makefile("r", encoding="utf-8")
                replies.append(json.loads(rfile.readline()))
                for req in ({"id": "r", "embeddings": emb, "indices": [0]}, {"cmd": "stats"},
                            {"cmd": "shutdown"}):
                    t1 = time.perf_counter()
                    sock.sendall((json.dumps(req) + "\n").encode())
                    replies.append(json.loads(rfile.readline()))
                    replies[-1]["client_s"] = round(time.perf_counter() - t1, 3)
            rc = proc.wait(timeout=120)
        except Exception as e:  # noqa: BLE001 - reported below, the process killed
            replies.append({"error": f"{type(e).__name__}: {e}"})
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        err.seek(0)
        log = err.read().strip().splitlines()
    ok = (rc == 0 and len(replies) == 4 and replies[1].get("ok") and replies[1].get("clips") == 1
          and replies[2].get("requests") == 1 and replies[3].get("bye"))
    say(f"mesh serve (a): torchrun --nproc_per_node 1 ... serve --dp 1 --listen: exit {rc}, "
        f"ready after {t_ready:.1f} s (loading included), port {ready.get('port')}, replies "
        f"{replies}; {log[-1:] if not ok else ''} {'ok' if ok else 'FAILED'} [{card}]")
    if not ok:
        fail("mesh serve (a): the torchrun launch of the server failed")


def _phase_gpipe(torch, card):
    """(b) ``gpipe_apply`` at pp = 1 (the world of one), n_micro = 8, on
    SemanticPredictor()'s hidden stack at batch 32, fc0 before it and the
    head after it: the loss and every gradient against the unpipelined step
    (f32, within F32_KERNEL_BOUND of each gradient's max), and seconds a
    step (forward and backward) of each."""
    import torch.distributed as dist
    import torch.nn.functional as F

    from eeg2video_tpu_torch.models.init import lecun_init_
    from eeg2video_tpu_torch.models.semantic import SemanticPredictor
    from eeg2video_tpu_torch.parallel import gpipe_apply

    dev = torch.device("cuda")
    with torch.device("meta"):
        model = SemanticPredictor()
    model = lecun_init_(model.to_empty(device=dev), torch.Generator(device=dev).manual_seed(44))
    g = torch.Generator(device=dev).manual_seed(45)
    x = torch.randn(GPIPE_BATCH, 310, generator=g, device=dev)
    y = 0.1 * torch.randn(GPIPE_BATCH, 77 * 768, generator=g, device=dev)
    params = list(model.parameters())

    def stage(layers, a):
        for lin in layers:
            a = F.relu(lin(a))
        return a

    def plain():
        return model(x)

    def piped():
        h = F.relu(model.fc0(x))
        h = gpipe_apply(stage, [model.fc1, model.fc2, model.fc3], h, dist.group.WORLD,
                        GPIPE_MICRO)
        return model.out(h)

    res = {}
    for tag, fwd in (("unpipelined", plain), ("gpipe_apply", piped)):
        secs = []
        for _ in range(GPIPE_REPS + 1):
            t0 = _sync_clock(torch)
            loss = torch.mean((fwd() - y) ** 2)
            grads = torch.autograd.grad(loss, params)
            secs.append(_sync_clock(torch) - t0)
        res[tag] = (float(loss.detach()), grads, statistics.median(secs[1:]))
    (l0, g0, s0), (l1, g1, s1) = res["unpipelined"], res["gpipe_apply"]
    errs = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(g1, g0)]
    ok = abs(l1 - l0) <= F32_KERNEL_BOUND * abs(l0) and max(errs) <= F32_KERNEL_BOUND
    say(f"gpipe (b): SemanticPredictor() at batch {GPIPE_BATCH}, pp = 1, n_micro = "
        f"{GPIPE_MICRO} over {dist.get_backend()}: loss {l1!r} against {l0!r} unpipelined, "
        f"gradients' largest error {max(errs):.3e} of their max (bound {F32_KERNEL_BOUND:g}); "
        f"s/step (forward and backward, median of {GPIPE_REPS}) {s1:.4f} against {s0:.4f} "
        f"{'ok' if ok else 'FAILED'} [{card}]")
    if not ok:
        fail("gpipe (b): the pipelined step differs from the unpipelined one")


def _phase_semantic_tp1(torch, card):
    """(c) ``train_semantic`` through its tp branch on a (dp 1, tp 1) mesh, a
    world of one over NCCL, at SemanticPredictor(), 8 steps at batch 32,
    against the same call without a mesh: losses and state dict bit for bit."""
    import torch.distributed as dist

    from eeg2video_tpu_torch.parallel import make_mesh
    from eeg2video_tpu_torch.train import semantic as sem

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(46)
    x = torch.randn(SEM_MESH_ROWS, 310, generator=g, device=dev)
    w = torch.randn(310, 77 * 768, generator=g, device=dev) * (0.1 / 310 ** 0.5)
    eeg, text = x.cpu().numpy(), (x @ w).cpu().numpy()
    del x, w
    cfg = sem.SemanticTrainConfig(epochs=1, batch_size=SEM_BATCH)
    runs = {}
    for tag in ("no mesh", "tp branch"):
        mesh = make_mesh(dp=1, tp=1, device=dev) if tag == "tp branch" else None
        torch.cuda.empty_cache()
        t0 = _sync_clock(torch)
        sd, losses = sem.train_semantic(eeg, text, cfg, seed=47, device=dev, mesh=mesh)
        secs = _sync_clock(torch) - t0
        runs[tag] = (sd, losses)
        say(f"semantic (c) {tag}: losses {losses}, {secs:.2f} s for "
            f"{SEM_MESH_ROWS // SEM_BATCH} steps with the model's init [{card}]")
    (sd0, l0), (sd1, l1) = runs["no mesh"], runs["tp branch"]
    same = l0 == l1 and sd0.keys() == sd1.keys() and all(torch.equal(sd0[k], sd1[k]) for k in sd0)
    say(f"semantic (c): train_semantic's tp branch at tp = 1 over {dist.get_backend()} (world "
        f"{dist.get_world_size()}) against no mesh: losses and {len(sd1)} tensors bit-equal "
        f"{same} {'ok' if same else 'FAILED'} [{card}]")
    if not same:
        fail("semantic (c): the tp branch at tp = 1 differs from the trainer without a mesh")


def phase_section16(torch, build, card):
    """Section 16: multi-GPU serving and the semantic trainer's meshes on one
    card. (a) the server on a --dp 1 mesh over NCCL against no mesh, and a
    torchrun launch of it over --listen; (b) gpipe_apply at pp = 1; (c) the
    semantic trainer's tp branch at tp = 1. Returns the launches of (a)'s
    mesh run."""
    import numpy as np
    import torch.distributed as dist

    from eeg2video_tpu_torch.diffusion.pipeline import EEG2VideoPipeline
    from eeg2video_tpu_torch.models.init import random_init_
    from eeg2video_tpu_torch.models.unet3d import UNet3DConfig
    from eeg2video_tpu_torch.models.vae import VAEConfig

    t_section = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="e2v_mesh_serve_") as tmp:
        g = torch.Generator(device="cuda").manual_seed(42)
        pipe = EEG2VideoPipeline.create(None, None, UNet3DConfig(), VAEConfig(),
                                        dtype=torch.bfloat16, device="cuda")
        random_init_(pipe.unet, g)
        random_init_(pipe.vae, g)
        torch.save(pipe.unet.state_dict(), os.path.join(tmp, "unet.pt"))
        torch.save(pipe.vae.state_dict(), os.path.join(tmp, "vae.pt"))
        np.save(os.path.join(tmp, "embeddings.npy"), np.random.default_rng(42).standard_normal(
            (1, 77 * 768)).astype(np.float32))
        launches = _phase_mesh_serve(torch, build, card, tmp, pipe)
        del pipe
        torch.cuda.empty_cache()
        _phase_serve_torchrun(torch, card, tmp)
    _phase_gpipe(torch, card)
    torch.cuda.empty_cache()
    _phase_semantic_tp1(torch, card)
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    say(f"section 16: {time.perf_counter() - t_section:.1f} s")
    return {"mesh_serve": launches}


# --- section 17: the last multi-GPU paths on one card ----------------------------
GLMNET_DP_EPOCHS = 2


def _phase_glmnet_dp1(torch, card, tmp):
    """(a) ``train_glmnet.main --dp 1`` (a world of one on a local store,
    NCCL) against the same command without a mesh, at section 11's subject
    shape (seeded windows and DE features): the checkpoint and every epoch's
    loss bit for bit, and s/epoch (the second epoch's, from the metrics'
    stamps). cuDNN's deterministic algorithms are asked for while both run:
    its default convolution backward sums in an order that varies between
    two runs of one command."""
    import numpy as np
    import torch.distributed as dist

    from eeg2video_tpu_torch.cli import train_glmnet

    rng = np.random.default_rng(70)
    for name, last in (("sw", 100), ("de", 5)):
        os.makedirs(os.path.join(tmp, name))
        np.save(os.path.join(tmp, name, "sub1.npy"),
                rng.standard_normal((7, 40, 5, 7, 62, last)).astype(np.float32))
    runs = {}
    deterministic = torch.backends.cudnn.deterministic
    for tag, extra in (("no mesh", []), ("--dp 1", ["--dp", "1"])):
        out = os.path.join(tmp, tag.replace(" ", "_"))
        torch.backends.cudnn.deterministic = True
        try:
            t0 = _sync_clock(torch)
            acc = train_glmnet.main(["--raw_dir", os.path.join(tmp, "sw"), "--de_dir",
                                     os.path.join(tmp, "de"), "--sub", "1", "--save_path", out,
                                     "--epochs", str(GLMNET_DP_EPOCHS), "--batch_size", "256",
                                     "--emb_dim", "256", *extra])
            secs = _sync_clock(torch) - t0
        finally:
            torch.backends.cudnn.deterministic = deterministic
        if tag == "--dp 1":
            backend, world = dist.get_backend(), dist.get_world_size()
            dist.destroy_process_group()
            if backend != "nccl" or world != 1:
                fail(f"section 17 (a): --dp 1 ran over {backend}, world {world}")
        lines = [json.loads(s) for s in
                 open(os.path.join(out, "glmnet_metrics.jsonl")).read().splitlines()]
        sd = torch.load(os.path.join(out, "ckpt", f"train_state_{GLMNET_DP_EPOCHS}.pt"),
                        weights_only=True)
        runs[tag] = (acc, [ln["train_loss"] for ln in lines], sd,
                     lines[-1]["time"] - lines[0]["time"], secs)
    (acc0, loss0, sd0, ep0, s0), (acc1, loss1, sd1, ep1, s1) = runs["no mesh"], runs["--dp 1"]
    same = (loss0 == loss1 and acc0 == acc1 and list(sd0) == list(sd1)
            and all(torch.equal(sd0[k], sd1[k]) for k in sd0))
    gap = max(float((sd0[k].double() - sd1[k].double()).abs().max()) for k in sd0)
    say(f"section 17 (a): train_glmnet --dp 1 over NCCL (world 1) against no mesh at emb_dim "
        f"256, 8400 windows, batch 256, {GLMNET_DP_EPOCHS} epochs: losses {loss1} (no mesh "
        f"{loss0}), block-6 top-1 {acc1:.4f}, checkpoint and losses bit-equal {same} (largest "
        f"gap {gap:.3e}); s/epoch (the second) "
        f"{ep1:.3f} (no mesh {ep0:.3f}), {s1:.2f} s with loading ({s0:.2f}) [{card}] "
        f"{'ok' if same else 'FAILED'}")
    if not same:
        fail("section 17 (a): train_glmnet --dp 1 differs from the run without a mesh")


def _phase_fold_mesh1(torch, card):
    """(b) ``run_benchmark(fold_parallel=True)`` on a fold mesh of one rank
    (a world of one over NCCL) against the batched path without a mesh, on a
    seeded (7, 40, 5, 2, 62, 5) subject: every fold's results bit for bit."""
    import numpy as np
    import torch.distributed as dist

    from eeg2video_tpu_torch.data import meta
    from eeg2video_tpu_torch.parallel import make_fold_mesh
    from eeg2video_tpu_torch.train import eegvp

    rng = np.random.default_rng(71)
    feats = rng.standard_normal((7, 400, meta.N_CHANNELS, meta.N_BANDS)).astype(np.float32)
    labels = meta.all_labels(10)
    cfg = eegvp.EEGVPConfig(epochs=EEGVP_EPOCHS)
    runs = {}
    for tag in ("no mesh", "fold mesh of 1"):
        mesh = make_fold_mesh(1, "cuda") if tag != "no mesh" else None
        t0 = _sync_clock(torch)
        res = eegvp.run_benchmark(feats, labels, cfg, seed=1, fold_parallel=True, mesh=mesh)
        runs[tag] = (res, _sync_clock(torch) - t0)
        if mesh is not None:
            backend = dist.get_backend()
            dist.destroy_process_group()
            if backend != "nccl":
                fail(f"section 17 (b): the fold mesh ran over {backend}")
    (a, sa), (b, sb) = runs["no mesh"], runs["fold mesh of 1"]
    same = all(fa["test_top1"] == fb["test_top1"] and fa["test_top5"] == fb["test_top5"]
               and fa["val_top1"] == fb["val_top1"]
               and np.array_equal(fa["predictions"], fb["predictions"])
               and np.array_equal(fa["confusion"], fb["confusion"])
               and np.array_equal(fa["losses"], fb["losses"])
               and all(torch.equal(fa["params"][k], fb["params"][k]) for k in fa["params"])
               for fa, fb in zip(a["folds"], b["folds"])) and len(b["folds"]) == 7
    say(f"section 17 (b): run_benchmark --fold_parallel on a fold mesh of 1 (NCCL) against the "
        f"batched path, {EEGVP_EPOCHS} epochs on a (7, 40, 5, 2, 62, 5) subject: {sb:.2f} s "
        f"({sa:.2f} s without), top-1 by fold {[round(f['test_top1'], 4) for f in b['folds']]}, "
        f"every fold bit-equal {same} [{card}] {'ok' if same else 'FAILED'}")
    if not same:
        fail("section 17 (b): the fold mesh of one differs from the batched path")


def _phase_fsdp_gather1(torch, build, card, base):
    """(c) ``train_tuneavideo.train`` on a ``--dp 1 --fsdp`` mesh at
    UNet3DConfig(), batch 10, three steps, through the per-use gather (each
    unit's gather and its gradient path to the masters, no collective at dp
    1) and a validation sample after the epoch (the VAE brought from the
    host): losses and masters bit-equal to section 15 (c)'s run without a
    mesh, every step's launches section 15's, peak memory. Returns the
    launches of the steps."""
    import torch.distributed as dist

    post, contexts = _mesh_train_data(torch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="e2v_fsdp_gather_") as tmp:
        steps, masters, mesh, gathers = _mesh_train_run(
            torch, build, tmp, post, contexts,
            ["--dp", "1", "--fsdp", "--validation_epochs", "1", "--validation_steps", "2"])
        sampled = os.listdir(os.path.join(tmp, "samples"))
    peak = torch.cuda.max_memory_allocated() / 2**30
    dist.destroy_process_group()
    base_losses, base_masters = base
    launched = [s[2] for s in steps]
    same_loss = [s[1] for s in steps] == base_losses
    same_m = list(masters) == list(base_masters) and all(
        torch.equal(masters[k].cpu(), base_masters[k]) for k in base_masters)
    ok = (same_loss and same_m and len(steps) == TRAIN_STEPS and gathers
          and all(l == EXPECTED_PER_TRAIN_STEP for l in launched)
          and sampled == ["sample-1.gif"])
    say(f"section 17 (c): train --dp 1 --fsdp with the per-use gather ({mesh}): losses "
        f"{[s[1] for s in steps]} bit-equal to no mesh {same_loss}, masters bit-equal {same_m}, "
        f"seconds per step {[round(s[0], 3) for s in steps]} (the first includes building the "
        f"train state), {gathers} unit gathers in {len(steps)} steps, per-step launches "
        f"{_nonzero(launched[0])}, a validation sample {sampled}, peak {peak:.2f} GiB "
        f"[{card}] {'ok' if ok else 'FAILED'}")
    if not ok:
        fail("section 17 (c): the --dp 1 --fsdp step with the per-use gather differs from no mesh")
    return {k: sum(l[k] for l in launched) for k in COUNTERS}


def phase_section17(torch, build, card, mesh_train_base):
    """Section 17: the last multi-GPU paths on one card. (a) ``train_glmnet
    --dp 1`` on the mesh path over NCCL bit-equal to no mesh; (b) EEG-VP's
    fold mesh of one rank bit-equal to the batched path; (c) the ``--dp 1
    --fsdp`` fine-tune through the per-use gather bit-equal to no mesh.
    Returns (c)'s launches."""
    t_section = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="e2v_glmnet_dp_") as tmp:
        _phase_glmnet_dp1(torch, card, tmp)
    torch.cuda.empty_cache()
    _phase_fold_mesh1(torch, card)
    torch.cuda.empty_cache()
    launches = _phase_fsdp_gather1(torch, build, card, mesh_train_base)
    say(f"section 17: {time.perf_counter() - t_section:.1f} s")
    return {"fsdp_gather": launches}


def _profile_step(torch, step, what="train: one step"):
    """One call of ``step`` under torch.profiler: where the device time goes,
    by the port's one grouping of its kernels (``utils.profiling``:
    ``_KERNEL_GROUPS`` applied by ``device_time_by_group``)."""
    from torch.profiler import ProfilerActivity, profile

    from eeg2video_tpu_torch.utils.profiling import device_time_by_group

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    groups, n_kernels, first, last = device_time_by_group(prof.events())
    if not groups:
        say(f"{what}: profile: the profiler recorded no device activity (not measured)")
        return
    busy = sum(groups.values())
    table = ", ".join(f"{g} {ms:.1f}" for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]))
    # the idle share of the device between its first and its last kernel
    # (the host clock also holds the profiler's own start-up)
    window = (last - first) / 1e3
    say(f"{what} under torch.profiler: {wall_ms:.1f} ms on the host clock, device busy "
        f"{busy:.1f} ms in {n_kernels} kernels and copies over a {window:.1f} ms window from the "
        f"first to the last, idle share {max(0.0, 1 - busy / window):.3f} (ms by group: {table})")


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
    if tuple(build.launches) != COUNTERS:
        fail(f"launches: the port counts {tuple(build.launches)}, this script {COUNTERS}")
    phase_build(build)
    report = {k: {"max_abs_err": 0.0, "max_rel_err": 0.0} for k in KERNEL_SOURCES}
    phase_kernels(torch, report)
    phase_kernels(torch, report, f32=True)
    phase_unet_parity(torch)
    phase_narrow_bf16(torch, build)
    pipe, ddim_launches = phase_slice(torch, build)
    launches, dana_latents = phase_serve(torch, build, pipe)
    phase_de_psd(torch)
    fused_launches = phase_fused_op(torch, build)
    f32_fused_launches = phase_fused_op(torch, build, f32=True)
    pipe.unet = None  # the train phase builds its own, with f32 masters
    torch.cuda.empty_cache()
    f32_gen_launches = phase_f32_generation(torch, build)
    phase_train_parity(torch, build)
    phase_train_parity(torch, build, heads=12, frames=10)
    phase_train_parity(torch, build, f32=True)
    train_launches, dbias_launches = phase_train(torch, build, pipe.vae, dana_latents)
    del pipe
    torch.cuda.empty_cache()
    f32_train_launches, f32_dbias_launches = phase_f32_train(torch, build)
    recipe = phase_recipe(torch, build, smi_line)
    torch.cuda.empty_cache()
    recipe["preprocess"] = phase_front_end(torch, build, smi_line, report)
    torch.cuda.empty_cache()
    recipe.update(phase_section12(torch, build, smi_line))
    torch.cuda.empty_cache()
    recipe.update(phase_section13(torch, build, smi_line))
    torch.cuda.empty_cache()
    recipe.update(phase_section14(torch, build, smi_line))
    torch.cuda.empty_cache()
    section15, mesh_train_base = phase_section15(torch, build, smi_line)
    recipe.update(section15)
    torch.cuda.empty_cache()
    recipe.update(phase_section16(torch, build, smi_line))
    torch.cuda.empty_cache()
    recipe.update(phase_section17(torch, build, smi_line, mesh_train_base))
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "flax", "eeg2video_tpu"))
    if leaked:
        fail(f"imports: jax or the JAX package was imported: {leaked[:5]}")

    kernels = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        rep = report[name]
        # each main path was driven with the counts set to 0 just before it
        # and read just after: the serve phase (20-step dispatches), the slice
        # phase (4-step DDIM requests), the train phase (three optimizer
        # steps), the fused_attention op (one call without, one with
        # gradients). launches: the count on the path the kernel was ported
        # for, the serve path for the forward kernels (as this line always
        # gave it), the train path for the kernels only training runs, the
        # op's own calls for the fused_attention pair, which no model path
        # reaches; a kernel its path did not launch fails the run. The f32
        # kernels: the f32 generation forward (one UNet forward of 2 samples)
        # for the forward ones, the f32 train step (one optimizer step) for
        # the others, the f32 fused_attention calls for that pair.
        if name.endswith("_f32"):
            per_path = {"launches_f32_generation_path": f32_gen_launches[name],
                        "launches_f32_train_path": f32_train_launches[name],
                        "launches_f32_fused_op_path": f32_fused_launches[name]}
            if name == "flash_attention_bwd_f32":
                per_path["launches_dbias_masked_step"] = f32_dbias_launches
            path = ("f32_generation" if name in F32_GENERATION_KERNELS else
                    "f32_fused_op" if name.startswith("fused_") else "f32_train")
        else:
            per_path = {"launches_serve_path": launches[name],
                        "launches_ddim_path": ddim_launches[name],
                        "launches_train_path": train_launches[name],
                        "launches_fused_op_path": fused_launches[name]}
            if name == "flash_attention_bwd":  # of one masked step's launches, those that wrote dbias
                per_path["launches_dbias_masked_step"] = dbias_launches
            path = ("train" if name in TRAIN_ONLY_KERNELS else
                    "fused_op" if name in FUSED_OP_KERNELS else "serve")
        # the recipe's paths (section 10): the 8-bit accumulated fine-tune
        # launches the train kernels, the semantic CLI int8_dense; the
        # semantic and Seq2Seq trainers and the latent encoder launch none;
        # section 11's preprocess path, 12's train steps, 13's text, inversion
        # and run_pipeline paths
        per_path.update({f"launches_{p}_path": counts[name] for p, counts in recipe.items()})
        if per_path[f"launches_{path}_path"] == 0:
            fail(f"launches: the {path} path did not launch {name}")
        if name in _TRAIN_STEP and per_path["launches_train_8bit_accum_path"] == 0:
            fail(f"launches: the 8-bit accumulated fine-tune did not launch {name}")
        if name == "int8_dense" and per_path["launches_inference_semantic_path"] == 0:
            fail("launches: inference_semantic --int8 did not launch int8_dense")
        # section 13: the text pipeline, the inversion and run_pipeline's
        # generate stage run the generation kernels
        if name in EXPECTED_PER_FORWARD and not all(
                per_path[f"launches_{p}_path"] for p in ("text", "inversion", "run_pipeline")):
            fail(f"launches: the text, inversion or run_pipeline path did not launch {name}")
        # section 14: the --dp 1 mesh path runs the generation kernels, the
        # ring's hops the attention forward
        if name in EXPECTED_PER_FORWARD and not per_path["launches_mesh_path"]:
            fail(f"launches: the --dp 1 mesh path did not launch {name}")
        if name == "flash_attention_fwd" and not per_path["launches_ring_hops_path"]:
            fail("launches: the ring's hops did not launch flash_attention_fwd")
        # section 15: the ring's backward hops run the attention backward; the
        # --dp 1 --fsdp mesh's steps every kernel of the step without a mesh
        if name == "flash_attention_bwd" and not per_path["launches_ring_bwd_path"]:
            fail("launches: the ring's backward hops did not launch flash_attention_bwd")
        if name in _TRAIN_STEP and not per_path["launches_mesh_train_path"]:
            fail(f"launches: the --dp 1 --fsdp mesh's steps did not launch {name}")
        # section 17: the --dp 1 --fsdp steps through the per-use gather
        if name in _TRAIN_STEP and not per_path["launches_fsdp_gather_path"]:
            fail(f"launches: the per-use gather's steps did not launch {name}")
        # section 16: the server's --dp 1 mesh runs the generation kernels and,
        # on rank 0's front half, int8_dense
        if (name in EXPECTED_PER_FORWARD or name == "int8_dense") and not per_path[
                "launches_mesh_serve_path"]:
            fail(f"launches: the --dp 1 mesh server did not launch {name}")
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": per_path[f"launches_{path}_path"], "launches_path": path,
                        **per_path,
                        "max_abs_err": rep["max_abs_err"], "max_rel_err": rep["max_rel_err"],
                        "ms": rep["ms"], "plain_ms": rep["plain_ms"],
                        "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
                        "library_ms": rep["library_ms"], "composed_ms": rep["composed_ms"],
                        "shape": rep["shape"]})
    # the filtfilt recursion (no Pallas counterpart): the preprocess path, section 11
    for name in build.IIR_KERNELS:
        per_path = {f"launches_{p}_path": counts[name] for p, counts in recipe.items()}
        rep = report[name]
        kernels.append({"name": name, "route": "cuda", "source": IIR_SOURCE,
                        "replaces": IIR_REPLACES,
                        "launches": per_path["launches_preprocess_path"],
                        "launches_path": "preprocess", **per_path,
                        "max_abs_err": rep["max_abs_err"], "max_rel_err": rep["max_rel_err"],
                        "ms": rep["ms"], "plain_ms": rep["plain_ms"],
                        "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
                        "library_ms": rep["library_ms"], "composed_ms": rep["composed_ms"],
                        "shape": rep["shape"], "scipy_host_ms": rep["scipy_host_ms"],
                        "plain_shape": rep["plain_shape"]})
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
