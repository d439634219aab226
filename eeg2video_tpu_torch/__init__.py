"""eeg2video_tpu_torch: the PyTorch + CUDA port of ``eeg2video_tpu``.

Two slices are ported, for one NVIDIA H100: the generation path
(``diffusion.pipeline``: the UNet3D denoising loop with classifier-free
guidance, DDIM or DPM-Solver++, and the per-frame VAE decode, in bf16) and
the serving path (``cli.serve``: the JSONL server with the warm semantic
predictor in front of the pipeline). The JAX package beside it is the
reference the port is tested against; this package imports torch and never
jax, nor anything of the JAX package.

- ``ops``        hand-written Hopper kernels (``csrc/*.cu``), their ctypes
                 wrappers and plain PyTorch versions
- ``models``     the video UNet, the VAE decoder and the semantic predictor
                 as ``nn.Module``s, with diffusers / reference key names
- ``diffusion``  the DDIM and DPM-Solver++ schedules, ``EEG2VideoPipeline``
- ``convert``    JAX parameter trees and diffusers directories -> the
                 port's state dicts
- ``serving``    warm runtimes, batch dispatch, transports
- ``cli``        ``serve`` (the entry point) and ``load_pipeline``
- ``data``       artifact IO, GIF writing and reading, dataset metadata
- ``utils``      device resolution, logging, the standard scaler

Entry points run on the card unless the caller names the CPU.
"""

__version__ = "0.2.0"
