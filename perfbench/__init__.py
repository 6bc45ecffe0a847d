"""The benchmark of the PyTorch/CUDA port (``ttsx_torch``): see
``perfbench/README.md``."""
