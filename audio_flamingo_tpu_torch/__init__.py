"""audio_flamingo_tpu_torch: the PyTorch/CUDA port of audio_flamingo_tpu for NVIDIA Hopper.

A second package beside the JAX one, which stays the reference. It imports torch and
numpy only. Entry points run on CUDA unless the caller passes ``device="cpu"``; every
Pallas kernel on the ported path is a hand-written CUDA kernel under ``csrc/``, built at
first use by one nvcc process a source and one link (ops/kernels/_build.py). It runs AF3
(``api.AudioFlamingo``) and the AF1/AF2 family (``api.AudioFlamingo2``).
"""

__version__ = "0.1.0"
