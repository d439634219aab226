"""eeg2video_tpu_torch: the PyTorch + CUDA port of ``eeg2video_tpu``.

The first slice is the generation path (``diffusion.pipeline``): the UNet3D
denoising loop with classifier-free guidance and the per-frame VAE decode,
in bf16 on one NVIDIA H100. The JAX package beside it is the reference the
port is tested against; this package imports torch and never jax.

- ``ops``        hand-written Hopper kernels (``csrc/*.cu``), their ctypes
                 wrappers and plain PyTorch versions
- ``models``     the video UNet and the VAE decoder as ``nn.Module``s,
                 channels-last, with diffusers key names
- ``diffusion``  the DDIM schedule and ``EEG2VideoPipeline``
- ``convert``    JAX parameter trees -> the port's state dicts
"""

__version__ = "0.1.0"
