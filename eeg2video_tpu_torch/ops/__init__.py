"""Hand-written CUDA kernels of the generation, serving and training paths and
their plain PyTorch versions. Nothing is built at import:
``_build.library()`` compiles ``csrc/*.cu`` at the first kernel launch."""
