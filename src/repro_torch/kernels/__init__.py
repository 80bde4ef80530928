"""Hand-written Hopper kernels, one folder each: ``csrc/`` (CUDA C++),
``ops.py`` (the wrapper the model calls) and ``ref.py`` (the plain PyTorch
version, run for CPU tensors and held against the kernel on the card)."""
