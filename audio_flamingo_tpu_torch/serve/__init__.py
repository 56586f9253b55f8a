"""serve of the PyTorch port (mirrors audio_flamingo_tpu/serve)."""

from audio_flamingo_tpu_torch.serve.demo import DemoServer  # noqa: F401
