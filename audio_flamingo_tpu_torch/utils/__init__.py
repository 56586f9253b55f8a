"""utils of the PyTorch port (mirrors audio_flamingo_tpu/utils)."""
