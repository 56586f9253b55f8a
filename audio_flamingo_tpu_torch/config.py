"""Model configs of the port: own copies of the JAX package's AF3 configs.

Field names and defaults follow ``audio_flamingo_tpu/config.py`` (which mirrors the HF
``config.json`` vocabulary), limited to the fields this port implements. ``AF3Config()``
is full AF3: Whisper-large-class encoder (32 x 1280) and Qwen2.5-7B (28 x 3584).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

# message of the NotImplementedError raised for a JAX option this port does not run yet
NOT_PORTED = "{} is not ported to the PyTorch package yet (ROADMAP.md, Queue 1: {})"


@dataclass(frozen=True)
class MelConfig:
    """Whisper log-mel frontend (30 s windows of 480,000 samples -> 3000 frames)."""

    sampling_rate: int = 16_000
    n_fft: int = 400
    hop_length: int = 160
    num_mel_bins: int = 128
    fmin: float = 0.0
    fmax: float = 8_000.0
    chunk_length_s: int = 30


@dataclass(frozen=True)
class WhisperEncoderConfig:
    """AF-Whisper audio tower (Whisper-encoder architecture)."""

    num_mel_bins: int = 128
    d_model: int = 1280
    num_layers: int = 32
    num_heads: int = 20
    ffn_dim: int = 5120
    max_source_positions: int = 1500  # tokens per 30 s window after the 2x conv stride
    activation: str = "gelu"          # "gelu" (exact) or "relu"
    use_flash: bool = False           # flash-attention kernel; plain attention otherwise
    pool_stride: int = 2              # AvgPool after the stack, before ln_post

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


@dataclass(frozen=True)
class Qwen2Config:
    """Qwen2 / Qwen2.5 decoder (defaults: Qwen2.5-7B)."""

    vocab_size: int = 152_064
    hidden_size: int = 3584
    intermediate_size: int = 18_944
    num_layers: int = 28
    num_heads: int = 28
    num_kv_heads: int = 4
    head_dim: int | None = None       # default hidden_size // num_heads
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    tie_word_embeddings: bool = False
    attention_bias: bool = True       # q/k/v bias, o_proj without
    sliding_window: int | None = None
    # layer i slides iff sliding_window is set and i >= max_window_layers
    max_window_layers: int = 0
    use_flash: bool = False           # flash-attention kernel for fresh multi-token prefill

    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.hidden_size // self.num_heads


@dataclass(frozen=True)
class AF3Config:
    """AF3 / Music Flamingo: AF-Whisper -> MLP adaptor -> Qwen2.5 with prefix tokens."""

    encoder: WhisperEncoderConfig = field(default_factory=WhisperEncoderConfig)
    lm: Qwen2Config = field(default_factory=Qwen2Config)
    audio_token_id: int = 151_646     # <sound> placeholder id in the AF vocab

    @staticmethod
    def tiny() -> "AF3Config":
        """Micro config for tests: 2-layer encoder, 2-layer LM."""
        return AF3Config(
            encoder=WhisperEncoderConfig(num_mel_bins=16, d_model=64, num_layers=2,
                                         num_heads=4, ffn_dim=128, max_source_positions=1500),
            lm=Qwen2Config(vocab_size=512, hidden_size=64, intermediate_size=128,
                           num_layers=2, num_heads=4, num_kv_heads=2, tie_word_embeddings=True),
            audio_token_id=500,
        )


# prompt-length buckets: one prefill shape per bucket instead of per length
TOKEN_BUCKETS = (128, 256, 512, 1024, 2048, 4096, 8192, 16384)


def bucket_tokens(n: int, buckets: Sequence[int] = TOKEN_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]
