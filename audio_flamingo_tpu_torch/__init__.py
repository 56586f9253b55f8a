"""audio_flamingo_tpu_torch: the PyTorch/CUDA port of audio_flamingo_tpu for NVIDIA Hopper.

A second package beside the JAX one, which stays the reference. It imports torch and
numpy only. Entry points run on CUDA unless the caller passes ``device="cpu"``; every
Pallas kernel on the ported path is a hand-written CUDA kernel under ``csrc/``, built
with one nvcc call at first use (ops/kernels/_build.py).
"""

__version__ = "0.1.0"
