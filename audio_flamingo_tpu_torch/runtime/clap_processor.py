"""AF1/AF2 processor, as ``audio_flamingo_tpu/runtime/clap_processor.py``: the chat
template with ``<sound>`` markers, long audio cut into 10 s CLAP windows, and the
per-token media ordinals of Flamingo masking.

A clip becomes ceil(len / 10 s) windows, rounded up to a bucket of
``CLAP_WINDOW_BUCKETS`` (5 minutes = 30 windows); every window is a short clip to the
frontend (tail tiled by ``_pad_short``, zero rows past the audio, ``is_longer`` False, the
fusion channels four copies), so all windows go through one batched ``_db_mel``. The
mels are made on the processor's device: a clip makes one upload of its waveform and no
download (JAX's ``windows_for_device``; its host ``windows_for`` gives the same numbers).
int16 PCM is uploaded as it is and scaled by 1 / 32768 on the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from audio_flamingo_tpu_torch.audio.clap_mel import ClapMelFrontend
from audio_flamingo_tpu_torch.config import AF2Config
from audio_flamingo_tpu_torch.runtime.tokenizer import BBPETokenizer

AUDIO_TOKEN = "<sound>"

# window-count buckets for 10 s CLAP windows (5 min = 30 windows)
CLAP_WINDOW_BUCKETS = (1, 2, 4, 8, 15, 30)


def bucket_clap_windows(n: int, buckets=CLAP_WINDOW_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


@dataclass
class AF2Processor:
    """Fields as the JAX processor's, plus ``device``: the frontend's device (None =
    CUDA) when no ``frontend`` is given; an injected frontend keeps its own."""

    tokenizer: BBPETokenizer
    cfg: AF2Config
    frontend: ClapMelFrontend | None = None
    system_prompt: str = "You are a helpful audio-understanding assistant."
    device: torch.device | str | None = None

    def __post_init__(self):
        if self.frontend is None:
            self.frontend = ClapMelFrontend(self.cfg.mel, device=self.device)
        elif self.device is not None:
            raise ValueError("pass a frontend or a device, not both: an injected frontend "
                             "keeps its own device")
        self.device = self.frontend.device

    def windows_for(self, wav: np.ndarray | torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Mono 48 kHz clip (f32, or int16 PCM) -> (mels [n, C, T, n_mels] and is_longer
        [n] bool, on the processor's device). C = 4 for 'fusion', 1 for 'rand_trunc'."""
        fe = self.frontend
        cfg = fe.cfg
        true_len = int(wav.shape[0])
        n = bucket_clap_windows(max(1, -(-true_len // fe.max_samples)))
        if not isinstance(wav, torch.Tensor):
            wav = torch.from_numpy(np.ascontiguousarray(wav))
        wav = wav.to(fe.device)                                  # the one upload
        wav = wav.float() * (1.0 / 32768.0) if wav.dtype == torch.int16 else wav.float()
        chunks = fe.window_chunks_device(wav, n, cfg.padding)
        mel = fe._db_mel(chunks, fe.num_frames_max, cfg.truncation == "fusion")
        c = 4 if cfg.truncation == "fusion" else 1
        mels = mel[:, None].expand(n, c, *mel.shape[1:])
        return mels, torch.zeros(n, dtype=torch.bool, device=fe.device)

    def apply_chat_template(self, messages: list[dict]) -> str:
        parts = []
        if messages[0]["role"] != "system" and self.system_prompt:
            parts.append(f"<|im_start|>system\n{self.system_prompt}<|im_end|>\n")
        for m in messages:
            parts.append(f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n")
        parts.append("<|im_start|>assistant\n")
        return "".join(parts)

    def __call__(self, text: str | None = None, audios: list | None = None,
                 messages: list[dict] | None = None) -> dict:
        """-> {'ids': [1, T] int32 numpy, 'mels': [n_media, n_windows, C, T, M] f32 on the
        device or None, 'is_longer': [n_media, n_windows] bool or None, 'media_idx':
        [1, T] int numpy, the <sound> markers seen up to each token (the marker counts
        its own clip)}. Clips with fewer windows are zero-padded to the longest."""
        if messages is not None:
            text = self.apply_chat_template(messages)
        if text is None:
            raise ValueError("pass text or messages")
        mels = longer = None
        if audios:
            per_clip = [self.windows_for(a) for a in audios]
            max_w = max(m.shape[0] for m, _ in per_clip)
            padded, longer_rows = [], []
            for m, lg in per_clip:
                if m.shape[0] < max_w:
                    m = torch.cat([m, m.new_zeros((max_w - m.shape[0],) + m.shape[1:])])
                    lg = torch.cat([lg, lg.new_zeros(max_w - lg.shape[0])])
                padded.append(m)
                longer_rows.append(lg)
            mels = torch.stack(padded)
            longer = torch.stack(longer_rows)
        ids = np.asarray([self.tokenizer.encode(text)], dtype=np.int32)
        audio_id = self.tokenizer.special_tokens.get(AUDIO_TOKEN, -1)
        media_idx = np.cumsum((ids == audio_id).astype(np.int32), axis=1)
        return {"ids": ids, "mels": mels, "is_longer": longer, "media_idx": media_idx}
