"""eeg2video_tpu_torch: the PyTorch + CUDA port of ``eeg2video_tpu``.

Four slices are ported, for one NVIDIA H100: the generation path
(``diffusion.pipeline``: the UNet3D denoising loop with classifier-free
guidance, DDIM or DPM-Solver++, and the per-frame VAE decode, in bf16), the
serving path (``cli.serve``: the JSONL server with the warm semantic
predictor in front of the pipeline), the fine-tune training path
(``cli.train_tuneavideo`` over ``train.videodiffusion``: the video-diffusion
train step with f32 parameters and bf16 compute) and the raw-EEG front half
(``dsp`` DE features, the ``models.seq2seq`` rollout, ``diffusion.dana``: raw
EEG in a request, GIFs out; the same stages as a file chain of CLIs). The JAX
package beside it is the reference the port is tested against; this package
imports torch and never jax, nor anything of the JAX package.

- ``ops``        hand-written Hopper kernels (``csrc/*.cu``), their ctypes
                 wrappers and plain PyTorch versions
- ``models``     the video UNet, the VAE, the semantic predictor and the
                 Seq2Seq transformer as ``nn.Module``s, with diffusers /
                 reference key names
- ``diffusion``  the DDPM, DDIM and DPM-Solver++ schedules,
                 ``EEG2VideoPipeline``, DANA noising
- ``dsp``        2 s segmentation and DE / PSD band features
- ``train``      the fine-tune step, its train state and checkpoints; the
                 Seq2Seq stage's inference helpers
- ``convert``    JAX parameter trees and diffusers directories -> the
                 port's state dicts
- ``serving``    warm runtimes, batch dispatch, transports
- ``cli``        ``serve``, ``train_tuneavideo``, ``inference_eeg2video``,
                 ``inference_seq2seq_v2``, ``add_noise`` (the entry points)
- ``data``       artifact IO, GIF writing and reading, the training clip
                 loader, dataset metadata
- ``utils``      device resolution, logging, metrics, the standard scaler

Entry points run on the card unless the caller names the CPU.
"""

__version__ = "0.4.0"
