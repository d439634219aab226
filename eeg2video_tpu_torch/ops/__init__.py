"""Hand-written CUDA kernels of the generation path and their plain PyTorch
versions. Nothing is built at import: ``_build.library()`` compiles
``csrc/*.cu`` at the first kernel launch."""

