"""Processor: ChatML template, ``<sound>`` expansion and log-mel extraction, as
``audio_flamingo_tpu/runtime/processor.py``.

Each ``<sound>`` placeholder becomes windows x 750 copies between the audio BOS/EOS
markers before tokenization, so prefill sees the final length. Clips are zero-padded to
whole 30 s windows, and the window count is rounded up to a bucket (``use_buckets``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from audio_flamingo_tpu_torch.audio.mel import WhisperMelFrontend
from audio_flamingo_tpu_torch.config import AF3Config, MelConfig
from audio_flamingo_tpu_torch.runtime.tokenizer import BBPETokenizer

AUDIO_TOKEN = "<sound>"
AUDIO_BOS = "<|audio_bos|>"
AUDIO_EOS = "<|audio_eos|>"
IM_START = "<|im_start|>"
IM_END = "<|im_end|>"

# window buckets (30 = Music Flamingo's 15 min)
WINDOW_BUCKETS = (1, 2, 4, 10, 20, 30)


def bucket_windows(n: int, buckets=WINDOW_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


@dataclass
class AF3Processor:
    """Fields as the JAX processor's, plus ``device``: the log-mel frontend's device
    (None = CUDA) when no ``frontend`` is given. An injected frontend keeps its own
    device (e.g. ``WhisperMelFrontend(use_pallas=True)`` for the log-mel kernel).
    ``use_buckets`` rounds each clip's window count up to ``WINDOW_BUCKETS``."""

    tokenizer: BBPETokenizer
    cfg: AF3Config
    frontend: WhisperMelFrontend | None = None
    system_prompt: str = "You are a helpful audio-understanding assistant."
    use_buckets: bool = True
    device: torch.device | str | None = None

    def __post_init__(self):
        if self.frontend is None:
            self.frontend = WhisperMelFrontend(
                MelConfig(num_mel_bins=self.cfg.encoder.num_mel_bins), device=self.device)
        elif self.device is not None:
            raise ValueError("pass a frontend or a device, not both: an injected frontend "
                             "keeps its own device")
        self.device = self.frontend.device

    def apply_chat_template(self, messages: list[dict], add_generation_prompt: bool = True) -> str:
        """messages: [{'role': 'user'|'assistant'|'system', 'content': str}] -> ChatML."""
        parts = []
        if messages and messages[0]["role"] != "system" and self.system_prompt:
            parts.append(f"{IM_START}system\n{self.system_prompt}{IM_END}\n")
        for m in messages:
            parts.append(f"{IM_START}{m['role']}\n{m['content']}{IM_END}\n")
        if add_generation_prompt:
            parts.append(f"{IM_START}assistant\n")
        return "".join(parts)

    def expand_audio_tokens(self, text: str, windows_per_clip: list[int]) -> str:
        """Replace each AUDIO_TOKEN with num_windows * tokens_per_window copies + bos/eos."""
        tpw = self.cfg.encoder.max_source_positions // self.cfg.encoder.pool_stride
        n_clips = text.count(AUDIO_TOKEN)
        if n_clips != len(windows_per_clip):
            raise ValueError(
                f"found {n_clips} {AUDIO_TOKEN} tokens but {len(windows_per_clip)} clips")
        out = []
        rest = text
        for nw in windows_per_clip:
            idx = rest.find(AUDIO_TOKEN)
            out.append(rest[:idx])
            out.append(AUDIO_BOS + AUDIO_TOKEN * (nw * tpw) + AUDIO_EOS)
            rest = rest[idx + len(AUDIO_TOKEN):]
        out.append(rest)
        return "".join(out)

    def __call__(self, text: str | None = None, audios: list[np.ndarray] | None = None,
                 messages: list[dict] | None = None) -> dict:
        """-> {'ids': [1, T] int32 numpy, 'mels': [1, W, 3000, n_mels] f32 tensor on the
        frontend's device, or None}. audios: mono 16 kHz float32, one per <sound>."""
        if messages is not None:
            text = self.apply_chat_template(messages)
        if text is None:
            raise ValueError("pass text or messages")
        mels = None
        if audios:
            windows, mel_list = [], []
            for wav in audios:
                nw = max(1, -(-len(wav) // self.frontend.window_samples))
                if self.use_buckets:
                    nw = bucket_windows(nw)
                padded = self.frontend.pad_or_trim(np.asarray(wav), num_windows=nw)
                m = self.frontend(padded[None])                    # [1, nw * 3000, n_mels]
                mel_list.append(m.reshape(nw, -1, m.shape[-1]))
                windows.append(nw)
            text = self.expand_audio_tokens(text, windows)
            mels = torch.cat(mel_list, dim=0)[None]
        ids = np.asarray([self.tokenizer.encode(text)], dtype=np.int32)
        return {"ids": ids, "mels": mels}
