"""Hand-written CUDA kernels of the generation, serving and training paths and
their plain PyTorch versions. Nothing is built at import:
``_build.library()`` compiles ``csrc/*.cu`` at the first kernel launch."""

from .attention import fused_attention  # noqa: F401  (the JAX package's name for the op)
