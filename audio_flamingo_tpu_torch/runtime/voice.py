"""Voice-out session: LM token stream -> streaming TTS -> waveform chunks, as
``audio_flamingo_tpu/runtime/voice.py``.

AF3-Chat's wiring: the decode streamer (``AudioFlamingo.generate(..., stream=True)``,
``runtime/generate.generate_stream``) feeds the TTS head chunk by chunk; each full chunk
of text tokens becomes ``frames_per_chunk`` * 10 ms of audio at once, so speech starts
before the LM finishes. Each chunk's mel is vocoded on its own
(``vocoder.mel_to_waveform``), as JAX's session does.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator

import numpy as np
import torch

from audio_flamingo_tpu_torch.device import resolve_device
from audio_flamingo_tpu_torch.models.tts import TTSConfig, TTSHead, synthesize_chunk


@dataclass
class StreamingTTSSession:
    tts: TTSHead
    tts_cfg: TTSConfig
    vocoder: object = None         # default: the trained NeuralVocoder on ``device``
    #                                (audio.neural_vocoder.default_vocoder); a GriffinLim
    #                                is the zero-setup alternative; both are duck-typed on
    #                                .mel_to_waveform(log_mel)
    pad_id: int = 0
    speaker: int | None = None     # voice id when tts_cfg.num_speakers > 0
    device: torch.device | str | None = None   # CUDA unless given; the head's device
    _buf: list = field(default_factory=list)
    _state: object = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.tts.device.type != self.device.type:
            raise ValueError(f"the TTS head is on {self.tts.device}, the session on "
                             f"{self.device}")
        if self.vocoder is None:
            from audio_flamingo_tpu_torch.audio.neural_vocoder import default_vocoder

            self.vocoder = default_vocoder(device=self.tts.device)
        self._state = torch.zeros(1, self.tts_cfg.state_frames, self.tts_cfg.n_mels,
                                  device=self.tts.device)
        self._speaker = (None if self.speaker is None else
                         torch.tensor([self.speaker], dtype=torch.long,
                                      device=self.tts.device))

    def feed(self, token_id: int) -> np.ndarray | None:
        """Add one LM token; returns a waveform chunk when a full token chunk is ready."""
        self._buf.append(int(token_id))
        if len(self._buf) < self.tts_cfg.chunk_tokens:
            return None
        return self._emit(self._buf[: self.tts_cfg.chunk_tokens], flush_len=None)

    def flush(self) -> np.ndarray | None:
        """Synthesize whatever remains in the buffer (padded to a full chunk)."""
        if not self._buf:
            return None
        chunk = self._buf + [self.pad_id] * (self.tts_cfg.chunk_tokens - len(self._buf))
        return self._emit(chunk, flush_len=len(self._buf))

    @torch.no_grad()
    def _emit(self, chunk: list[int], flush_len: int | None) -> np.ndarray:
        ids = torch.tensor([chunk], dtype=torch.long, device=self.tts.device)
        mel = synthesize_chunk(self.tts, self.tts_cfg, ids, self._state, self._speaker)
        self._state = mel[:, -self.tts_cfg.state_frames:]
        self._buf = self._buf[self.tts_cfg.chunk_tokens:] if flush_len is None else []
        return self.vocoder.mel_to_waveform(mel[0])


def speak_stream(token_iter: Iterator[int], session: StreamingTTSSession) -> Iterator[np.ndarray]:
    """Wrap a streamed token iterator (``generate(stream=True)``) into waveform chunks."""
    for tok in token_iter:
        chunk = session.feed(tok)
        if chunk is not None:
            yield chunk
    tail = session.flush()
    if tail is not None:
        yield tail
