"""Hand-written CUDA kernels: sources in ``csrc/``, wrappers here."""
