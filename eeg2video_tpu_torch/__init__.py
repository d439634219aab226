"""eeg2video_tpu_torch: the PyTorch + CUDA port of ``eeg2video_tpu``.

Three slices are ported, for one NVIDIA H100: the generation path
(``diffusion.pipeline``: the UNet3D denoising loop with classifier-free
guidance, DDIM or DPM-Solver++, and the per-frame VAE decode, in bf16), the
serving path (``cli.serve``: the JSONL server with the warm semantic
predictor in front of the pipeline) and the fine-tune training path
(``cli.train_tuneavideo`` over ``train.videodiffusion``: the video-diffusion
train step with f32 parameters and bf16 compute). The JAX package beside it is the
reference the port is tested against; this package imports torch and never
jax, nor anything of the JAX package.

- ``ops``        hand-written Hopper kernels (``csrc/*.cu``), their ctypes
                 wrappers and plain PyTorch versions
- ``models``     the video UNet, the VAE and the semantic predictor as
                 ``nn.Module``s, with diffusers / reference key names
- ``diffusion``  the DDPM, DDIM and DPM-Solver++ schedules, ``EEG2VideoPipeline``
- ``train``      the fine-tune step, its train state and checkpoints
- ``convert``    JAX parameter trees and diffusers directories -> the
                 port's state dicts
- ``serving``    warm runtimes, batch dispatch, transports
- ``cli``        ``serve`` and ``train_tuneavideo`` (the entry points),
                 ``load_pipeline``
- ``data``       artifact IO, GIF writing and reading, the training clip
                 loader, dataset metadata
- ``utils``      device resolution, logging, metrics, the standard scaler

Entry points run on the card unless the caller names the CPU.
"""

__version__ = "0.3.0"
