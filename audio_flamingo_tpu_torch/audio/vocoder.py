"""Griffin-Lim vocoder: log-mel -> waveform, as ``audio_flamingo_tpu/audio/vocoder.py``.

Backs the streaming TTS head (models/tts.py) as the zero-setup alternative to the trained
neural vocoder. The mel is inverted through the pseudo-inverse of the filterbank; the
phase is recovered by Griffin-Lim rounds. The STFT is a product with the windowed DFT
basis of the analysis frontend (audio/mel.py); the ISTFT is the transposed basis and a
windowed overlap-add.

The overlap-add is deterministic and in JAX's order: the frames are cut into blocks of
gcd(n_fft, hop) samples, and each output block sums its frames' blocks in frame order
(no ``index_add_``, whose order on CUDA is the atomics').

JAX draws the first phase with ``jax.random.uniform(PRNGKey(seed))``, which torch cannot
reproduce: ``mel_to_waveform(log_mel, seed)`` draws it from a ``torch.Generator`` seeded
with ``seed`` (the same seed gives another waveform than JAX's); ``from_phase`` runs the
rounds from a phase the caller gives, and ``rounds`` from a magnitude and a phase.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from audio_flamingo_tpu_torch.audio.clap_mel import frame_signal
from audio_flamingo_tpu_torch.audio.mel import _windowed_dft_basis, mel_filter_bank
from audio_flamingo_tpu_torch.device import resolve_device


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """[num_frames, n_fft] -> [num_frames * hop + n_fft]: frame i added at i * hop, each
    sample's frames summed from zero in frame order."""
    num_frames, n_fft = frames.shape
    g = math.gcd(n_fft, hop)
    per, step = n_fft // g, hop // g
    blocks = frames.reshape(num_frames, per, g)
    out = frames.new_zeros((num_frames * hop + n_fft) // g, g)
    # output block j takes frame i's block r where j = i * step + r: a larger r is an
    # earlier frame, so r descending adds each block's frames in ascending frame order
    for r in range(per - 1, -1, -1):
        out[r: r + step * (num_frames - 1) + 1: step] += blocks[:, r]
    return out.reshape(-1)


class GriffinLim:
    def __init__(self, sr: int = 16_000, n_fft: int = 400, hop: int = 160,
                 n_mels: int = 80, fmin: float = 0.0, fmax: float = 8000.0,
                 n_iter: int = 32, device: torch.device | str | None = None):
        self.sr, self.n_fft, self.hop, self.n_iter = sr, n_fft, hop, n_iter
        self.device = resolve_device(device)
        f32 = dict(dtype=torch.float32, device=self.device)
        mel = mel_filter_bank(n_fft // 2 + 1, n_mels, fmin, fmax, sr)
        self.mel = torch.tensor(np.asarray(mel, np.float32), **f32)                   # [bins, mels]
        self.mel_pinv = torch.tensor(np.asarray(np.linalg.pinv(mel), np.float32), **f32)
        c, s = _windowed_dft_basis(n_fft)
        self.C = torch.tensor(np.asarray(c, np.float32), **f32)
        self.S = torch.tensor(np.asarray(s, np.float32), **f32)
        # synthesis window normalization for overlap-add (hann, hop/n_fft overlap)
        hann = 0.5 * (1 - np.cos(2 * np.pi * np.arange(n_fft) / n_fft))
        self.hann = torch.tensor(np.asarray(hann, np.float32), **f32)
        nb = n_fft // 2 + 1
        self._scale = torch.full((nb,), 2.0, **f32)
        self._scale[0] = self._scale[-1] = 1.0
        self._n_fft = torch.tensor(float(n_fft), **f32)      # a true division, as JAX's
        self._wsum = {}

    def _stft(self, wav: torch.Tensor, num_frames: int):
        half = self.n_fft // 2
        padded = F.pad(wav[None], (half, half), mode="reflect")
        frames = frame_signal(padded, self.n_fft, self.hop, num_frames)[0]
        re = frames @ self.C
        im = -(frames @ self.S)
        return re, im

    def _window_sum(self, num_frames: int) -> torch.Tensor:
        if num_frames not in self._wsum:
            sq = (self.hann ** 2).expand(num_frames, self.n_fft)
            self._wsum[num_frames] = overlap_add(sq, self.hop)
        return self._wsum[num_frames]

    def _istft(self, re: torch.Tensor, im: torch.Tensor, n_samples: int) -> torch.Tensor:
        """Inverse rFFT per frame (through the transposed windowed basis: C = cos * hann,
        so the product carries hann^2, the synthesis window the sum(hann^2) normalization
        expects) + overlap-add."""
        frames = ((re * self._scale) @ self.C.T - (im * self._scale) @ self.S.T) / self._n_fft
        out = overlap_add(frames, self.hop)
        out = out / torch.clamp(self._window_sum(frames.shape[0]), min=1e-8)
        half = self.n_fft // 2
        return out[half: half + n_samples]

    def _magnitude(self, log_mel: torch.Tensor) -> torch.Tensor:
        log_mel = torch.as_tensor(log_mel, dtype=torch.float32, device=self.device)
        power = torch.pow(10.0, log_mel) @ self.mel_pinv             # [frames, bins]
        return torch.sqrt(torch.clamp(power, min=0.0))

    def from_phase(self, log_mel: torch.Tensor, phase: torch.Tensor) -> torch.Tensor:
        """Griffin-Lim from a given first phase [frames, bins] -> waveform [frames * hop]."""
        return self.rounds(self._magnitude(log_mel), phase)

    def rounds(self, mag: torch.Tensor, phase: torch.Tensor) -> torch.Tensor:
        """``n_iter`` Griffin-Lim rounds on the target magnitude [frames, bins] from the
        first phase -> waveform [frames * hop]."""
        num_frames = mag.shape[0]
        n_samples = num_frames * self.hop
        phase = torch.as_tensor(phase, dtype=torch.float32, device=self.device)
        re, im = mag * torch.cos(phase), mag * torch.sin(phase)
        wav = self._istft(re, im, n_samples)
        for _ in range(self.n_iter):
            re_a, im_a = self._stft(wav, num_frames)
            mag_a = torch.sqrt(re_a ** 2 + im_a ** 2) + 1e-8
            re, im = mag * re_a / mag_a, mag * im_a / mag_a
            wav = self._istft(re, im, n_samples)
        return wav

    def mel_to_waveform(self, log_mel: torch.Tensor, seed: int = 0) -> np.ndarray:
        """[frames, n_mels] log10-mel (Whisper's scale NOT applied) -> waveform, the first
        phase uniform in [-pi, pi) from a torch generator seeded with ``seed``."""
        frames = log_mel.shape[0]
        gen = torch.Generator(device=self.device).manual_seed(seed)
        phase = torch.rand((frames, self.n_fft // 2 + 1), generator=gen, device=self.device)
        phase = phase * (2 * math.pi) - math.pi
        return self.from_phase(log_mel, phase).cpu().numpy()
