"""Model configs of the port: own copies of the JAX package's configs.

Field names and defaults follow ``audio_flamingo_tpu/config.py`` (which mirrors the HF
``config.json`` vocabulary), limited to the fields this port implements. ``AF3Config()``
is full AF3: Whisper-large-class encoder (32 x 1280) and Qwen2.5-7B (28 x 3584).
``AF2Config()`` is full AF2: the HTSAT-base CLAP tower with fusion, 3 audio-transform
layers at 512 and a gated cross-attention block before each of Qwen2.5-3B's 36 layers;
``AF1Config.make()`` swaps in OPT-IML-1.3B.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Sequence

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
class ClapMelConfig:
    """CLAP/HTSAT frontend: 48 kHz, 1024-point FFT at hop 480, 64 bins, dB scale."""

    sampling_rate: int = 48_000
    n_fft: int = 1024
    hop_length: int = 480
    num_mel_bins: int = 64
    fmin: float = 0.0
    fmax: float = 14_000.0
    max_length_s: int = 10
    truncation: str = "fusion"   # "fusion" | "rand_trunc"
    padding: str = "repeatpad"   # "repeatpad" | "repeat" | "pad"


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
    # int8-QK flash attention (K8) for the plain a8 layer's attention; needs use_flash
    a8_attention: bool = False
    # stages ("qkv", "out", "mlp") of the fused int8 layout that run their K9 kernel;
    # the others run composed w8a8 torch ops (models/whisper_encoder.py)
    fused_stages: tuple = ()
    pool_stride: int = 2              # AvgPool after the stack, before ln_post
    remat: str = "none"               # activation recompute per layer (ops/remat.py)

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
    # w8a8 multi-token products on an int8 LM: dynamic per-token int8 activations
    # (ops/quant.q_matmul_a8); decode (one token) stays w8a16
    a8_prefill: bool = False
    # int8-QK flash attention (K8) for a fresh flash prefill; needs use_flash
    a8_attention: bool = False
    remat: str = "none"               # activation recompute per layer, cache-free forward only

    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.hidden_size // self.num_heads

    @staticmethod
    def qwen25_7b() -> "Qwen2Config":
        return Qwen2Config()

    @staticmethod
    def qwen25_3b() -> "Qwen2Config":
        """Qwen2.5-3B, AF2's LM."""
        return Qwen2Config(vocab_size=151_936, hidden_size=2048, intermediate_size=11_008,
                           num_layers=36, num_heads=16, num_kv_heads=2, tie_word_embeddings=True)

    @staticmethod
    def qwen25_1_5b() -> "Qwen2Config":
        return Qwen2Config(vocab_size=151_936, hidden_size=1536, intermediate_size=8960,
                           num_layers=28, num_heads=12, num_kv_heads=2, tie_word_embeddings=True)

    @staticmethod
    def qwen25_0_5b() -> "Qwen2Config":
        """Qwen2.5-0.5B, the speculative draft of the 7B (same tokenizer; 128 fewer rows)."""
        return Qwen2Config(vocab_size=151_936, hidden_size=896, intermediate_size=4864,
                           num_layers=24, num_heads=14, num_kv_heads=2, tie_word_embeddings=True)


@dataclass(frozen=True)
class OPTConfig:
    """OPT decoder (AF1's OPT-IML-MAX-1.3B): learned positions with offset 2, pre-norm,
    ReLU MLP, biased linears."""

    vocab_size: int = 50_272
    hidden_size: int = 2048
    ffn_dim: int = 8192
    num_layers: int = 24
    num_heads: int = 32
    max_position_embeddings: int = 2048
    position_offset: int = 2
    do_layer_norm_before: bool = True
    word_embed_proj_dim: int | None = None  # != hidden_size in some checkpoints
    enable_bias: bool = True


@dataclass(frozen=True)
class ClapAudioConfig:
    """HTSAT (Swin-style) audio encoder of CLAP (defaults: HTSAT-base with fusion)."""

    num_mel_bins: int = 64
    spec_size: int = 256              # mel spectrogram reshaped to spec_size x spec_size
    patch_size: int = 4
    patch_stride: int = 4
    patch_embed_dim: int = 96
    depths: tuple[int, ...] = (2, 2, 6, 2)
    num_heads: tuple[int, ...] = (4, 8, 16, 32)
    window_size: int = 8
    mlp_ratio: float = 4.0
    drop_path_rate: float = 0.0
    projection_dim: int = 512
    hidden_act: str = "gelu"
    enable_fusion: bool = True
    layer_norm_eps: float = 1e-5


@dataclass(frozen=True)
class GatedXAttnConfig:
    """Flamingo-style gated cross-attention (AF1/AF2 fusion): a block before every
    ``cross_every_n_layers``-th LM layer."""

    cross_every_n_layers: int = 1
    num_heads: int = 32
    ffn_mult: int = 4


@dataclass(frozen=True)
class AF3Config:
    """AF3 / Music Flamingo: AF-Whisper -> MLP adaptor -> Qwen2.5 with prefix tokens."""

    encoder: WhisperEncoderConfig = field(default_factory=WhisperEncoderConfig)
    lm: Qwen2Config = field(default_factory=Qwen2Config)
    adaptor_hidden: int | None = None   # default: lm.hidden_size
    audio_token_id: int = 151_646     # <sound> placeholder id in the AF vocab
    max_windows: int = 20             # 10 min = 20 x 30 s
    mel: MelConfig = field(default_factory=MelConfig)

    @staticmethod
    def music_flamingo() -> "AF3Config":
        """Music Flamingo: the AF3 backbone for full songs, 30 windows = 15 min of audio =
        22.5k prefix tokens (within Qwen2.5's 32k RoPE positions)."""
        return AF3Config(max_windows=30)

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


@dataclass(frozen=True)
class AF2Config:
    """AF1/AF2: CLAP tower -> audio-transform layers -> gated xattn into the LM (a
    ``Qwen2Config`` for AF2, an ``OPTConfig`` for AF1)."""

    clap: ClapAudioConfig = field(default_factory=ClapAudioConfig)
    lm: Qwen2Config | OPTConfig = field(default_factory=Qwen2Config.qwen25_3b)
    xattn: GatedXAttnConfig = field(default_factory=GatedXAttnConfig)
    num_audio_transform_layers: int = 3
    audio_embed_dim: int = 512
    mel: ClapMelConfig = field(default_factory=ClapMelConfig)


@dataclass(frozen=True)
class AF1Config:
    """AF1: the AF2 composition with OPT-IML-1.3B as the LM."""

    @staticmethod
    def make(**kw) -> AF2Config:
        defaults = dict(lm=OPTConfig(), xattn=GatedXAttnConfig(num_heads=32),
                        num_audio_transform_layers=3, audio_embed_dim=512)
        defaults.update(kw)
        return AF2Config(**defaults)


def asdict(cfg: Any) -> dict:
    return dataclasses.asdict(cfg)


# prompt-length buckets: one prefill shape per bucket instead of per length
TOKEN_BUCKETS = (128, 256, 512, 1024, 2048, 4096, 8192, 16384)


def bucket_tokens(n: int, buckets: Sequence[int] = TOKEN_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]
