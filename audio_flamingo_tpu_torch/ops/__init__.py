"""Tensor ops: norms, RoPE, MLPs, attention, sampling; hand-written kernels in ``kernels``."""
