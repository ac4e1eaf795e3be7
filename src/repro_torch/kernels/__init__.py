"""Hand-written Hopper kernels, one package each: ``kernel.py`` (the CUDA
wrapper, sources under ``csrc/``) + ``ref.py`` (the plain PyTorch version) +
``ops.py`` (the dispatch the engine calls: the kernel for tensors on the
card, the plain version for tensors on the CPU)."""
