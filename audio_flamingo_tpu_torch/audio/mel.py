"""Whisper log-mel frontend (f32), as ``audio_flamingo_tpu/audio/mel.py``.

The STFT is a matmul against a windowed real-DFT basis: reflect-pad by n_fft/2, frame at
hop 160 (3000 frames per 30 s window, the 3001st dropped), power = (x C)^2 + (x S)^2,
mel matmul, log10(max(., 1e-10)), then per 30 s window max(x, max - 8) and (x + 4) / 4
(ops/kernels/log_mel.py: the plain version, and the fused kernel with ``use_pallas``).
The filterbank and basis are host-side float64 numpy constants (slaney mel scale and
norm, periodic Hann), cast to f32 on the frontend's device.
"""

from __future__ import annotations

import numpy as np
import torch

from audio_flamingo_tpu_torch.config import MelConfig
from audio_flamingo_tpu_torch.device import resolve_device
from audio_flamingo_tpu_torch.ops.kernels.log_mel import fused_log_mel, log_mel_reference


def _hertz_to_mel(freq, mel_scale: str = "slaney"):
    freq = np.asarray(freq, dtype=np.float64)
    if mel_scale == "htk":
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    min_log_hertz = 1000.0
    min_log_mel = 15.0
    logstep = 27.0 / np.log(6.4)
    mels = 3.0 * freq / 200.0
    high = freq >= min_log_hertz
    return np.where(high, min_log_mel + np.log(np.maximum(freq, 1e-12) / min_log_hertz) * logstep,
                    mels)


def _mel_to_hertz(mels, mel_scale: str = "slaney"):
    mels = np.asarray(mels, dtype=np.float64)
    if mel_scale == "htk":
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    min_log_hertz = 1000.0
    min_log_mel = 15.0
    logstep = np.log(6.4) / 27.0
    freq = 200.0 * mels / 3.0
    high = mels >= min_log_mel
    return np.where(high, min_log_hertz * np.exp(logstep * (mels - min_log_mel)), freq)


def mel_filter_bank(num_frequency_bins: int, num_mel_filters: int, min_frequency: float,
                    max_frequency: float, sampling_rate: int, norm: str | None = "slaney",
                    mel_scale: str = "slaney") -> np.ndarray:
    """Triangular mel filterbank [num_frequency_bins, num_mel_filters] (float64)."""
    mel_min = _hertz_to_mel(min_frequency, mel_scale)
    mel_max = _hertz_to_mel(max_frequency, mel_scale)
    mel_freqs = np.linspace(mel_min, mel_max, num_mel_filters + 2)
    filter_freqs = _mel_to_hertz(mel_freqs, mel_scale)
    fft_freqs = np.linspace(0, sampling_rate // 2, num_frequency_bins)
    filter_diff = np.diff(filter_freqs)
    slopes = np.expand_dims(filter_freqs, 0) - np.expand_dims(fft_freqs, 1)
    down_slopes = -slopes[:, :-2] / filter_diff[:-1]
    up_slopes = slopes[:, 2:] / filter_diff[1:]
    filters = np.maximum(np.zeros(1), np.minimum(down_slopes, up_slopes))
    if norm == "slaney":
        enorm = 2.0 / (filter_freqs[2: num_mel_filters + 2] - filter_freqs[:num_mel_filters])
        filters *= np.expand_dims(enorm, 0)
    return filters.astype(np.float64)


def _windowed_dft_basis(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Real-DFT cos/sin bases [n_fft, n_fft//2 + 1] with the periodic Hann window folded
    in: power of frame x = (x @ C)^2 + (x @ S)^2."""
    n = np.arange(n_fft)[:, None].astype(np.float64)
    k = np.arange(n_fft // 2 + 1)[None, :].astype(np.float64)
    hann = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft))
    ang = 2.0 * np.pi * n * k / n_fft
    return np.cos(ang) * hann[:, None], np.sin(ang) * hann[:, None]


class WhisperMelFrontend:
    """[batch, k * 480000] f32 waveform -> [batch, k * 3000, num_mel_bins] f32 log-mel.

    Each 30 s window is normalized on its own (its own max - 8 clamp). Runs on CUDA
    unless ``device`` names another device; without a card and a device it raises.
    ``use_pallas`` (the JAX frontend's name for its fused kernel) sends the windows
    through the hand-written log-mel kernel (ops/kernels/log_mel.py); off, through its
    plain PyTorch version. On the CPU both are the plain version."""

    def __init__(self, cfg: MelConfig = MelConfig(), use_pallas: bool = False,
                 device: torch.device | str | None = None):
        self.cfg = cfg
        self.use_pallas = use_pallas
        self.device = resolve_device(device)
        self.window_samples = cfg.chunk_length_s * cfg.sampling_rate
        self.frames_per_window = self.window_samples // cfg.hop_length
        n_bins = cfg.n_fft // 2 + 1
        mel = mel_filter_bank(n_bins, cfg.num_mel_bins, cfg.fmin, cfg.fmax, cfg.sampling_rate)
        c, s = _windowed_dft_basis(cfg.n_fft)
        self.mel_weights = torch.tensor(mel, dtype=torch.float32, device=self.device)
        self.dft_cos = torch.tensor(c, dtype=torch.float32, device=self.device)
        self.dft_sin = torch.tensor(s, dtype=torch.float32, device=self.device)

    def pad_or_trim(self, wav: np.ndarray, num_windows: int | None = None) -> np.ndarray:
        """Host-side: zero-pad (silence) or trim to a whole number of 30 s windows."""
        wav = np.asarray(wav, dtype=np.float32)
        if num_windows is None:
            num_windows = max(1, -(-len(wav) // self.window_samples))
        total = num_windows * self.window_samples
        out = np.zeros(total, dtype=np.float32)
        out[: min(len(wav), total)] = wav[:total]
        return out

    def __call__(self, wav: np.ndarray | torch.Tensor) -> torch.Tensor:
        wav = torch.as_tensor(wav, dtype=torch.float32, device=self.device)
        if wav.ndim == 1:
            wav = wav[None]
        b, n = wav.shape
        k = n // self.window_samples
        if k * self.window_samples != n or k == 0:
            raise ValueError(f"{n} samples is not a whole number of "
                             f"{self.window_samples}-sample windows")
        mels = self._window_mels(wav.reshape(b * k, self.window_samples))
        return mels.reshape(b, k * self.frames_per_window, self.cfg.num_mel_bins)

    def _window_mels(self, wins: torch.Tensor) -> torch.Tensor:
        """[N, window_samples] -> [N, 3000, n_mels] with per-window normalization."""
        fn = fused_log_mel if self.use_pallas else log_mel_reference
        return fn(wins, self.dft_cos, self.dft_sin, self.mel_weights, self.cfg.hop_length,
                  self.frames_per_window)
