"""Training-time audio augmentation: SpecAugment (time and frequency masks), noise at an
SNR and a random gain, as ``audio_flamingo_tpu/audio/augment.py``.

JAX draws from a ``jax.random`` key, which torch cannot reproduce, so each function here
is split in two: ``*_draws`` / the generator-driven function draw from a
``torch.Generator`` (on the generator's device), and ``apply_*`` applies given draws
(mask widths and starts, the noise, the gain in dB). The same draws give JAX's output.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SpecAugmentDraws(NamedTuple):
    """Mask widths and starts, each [num_masks] int64: time masks over frames, frequency
    masks over mel bins."""

    time_width: torch.Tensor
    time_start: torch.Tensor
    freq_width: torch.Tensor
    freq_start: torch.Tensor


def spec_augment_draws(generator: torch.Generator, frames: int, n_mels: int, *,
                       num_time_masks: int = 2, max_time_frac: float = 0.05,
                       num_freq_masks: int = 2, max_freq_bins: int = 16) -> SpecAugmentDraws:
    """JAX's draws, from ``generator``: a time mask's width is uniform in [0,
    max(1, int(frames * max_time_frac))], its start in [0, frames); a frequency mask's
    width in [0, max_freq_bins], its start in [0, n_mels)."""
    max_t = max(1, int(frames * max_time_frac))

    def draw(n: int, high: int) -> torch.Tensor:
        return torch.randint(0, high, (n,), generator=generator, device=generator.device)

    return SpecAugmentDraws(draw(num_time_masks, max_t + 1), draw(num_time_masks, frames),
                            draw(num_freq_masks, max_freq_bins + 1), draw(num_freq_masks, n_mels))


def apply_spec_augment(mels: torch.Tensor, draws: SpecAugmentDraws) -> torch.Tensor:
    """[..., frames, n_mels] log-mel -> a copy with every masked cell set to the mel mean
    (over the last two axes, taken before masking)."""
    frames, n_mels = mels.shape[-2:]

    def covered(n: int, width: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
        idx = torch.arange(n, device=mels.device)[:, None]
        start, width = start.to(mels.device), width.to(mels.device)
        return ((idx >= start) & (idx < start + width)).any(dim=-1)

    fill = mels.mean(dim=(-2, -1), keepdim=True)
    mask = (covered(frames, draws.time_width, draws.time_start)[:, None]
            | covered(n_mels, draws.freq_width, draws.freq_start)[None, :])
    return torch.where(mask, fill, mels)


def spec_augment(generator: torch.Generator, mels: torch.Tensor, *, num_time_masks: int = 2,
                 max_time_frac: float = 0.05, num_freq_masks: int = 2,
                 max_freq_bins: int = 16) -> torch.Tensor:
    """[..., frames, n_mels] log-mel -> masked copy (masked cells set to the mel mean);
    the mask counts are fixed, the widths and starts drawn per call."""
    draws = spec_augment_draws(generator, mels.shape[-2], mels.shape[-1],
                               num_time_masks=num_time_masks, max_time_frac=max_time_frac,
                               num_freq_masks=num_freq_masks, max_freq_bins=max_freq_bins)
    return apply_spec_augment(mels, draws)


def apply_noise_snr(wav: torch.Tensor, noise: torch.Tensor, snr_db: float) -> torch.Tensor:
    """Add ``noise`` (same shape as wav) scaled to the given SNR (dB), per row of
    [..., samples]."""
    sig_pow = torch.mean(wav ** 2, dim=-1, keepdim=True) + 1e-12
    noise_pow = torch.mean(noise ** 2, dim=-1, keepdim=True)
    target = sig_pow / (10.0 ** (snr_db / 10.0))
    return wav + noise * torch.sqrt(target / noise_pow)


def add_noise_snr(generator: torch.Generator, wav: torch.Tensor, snr_db: float) -> torch.Tensor:
    """Add white (standard normal) noise at the given SNR (dB) to a waveform [..., samples]."""
    noise = torch.randn(wav.shape, generator=generator, device=generator.device,
                        dtype=wav.dtype).to(wav.device)
    return apply_noise_snr(wav, noise, snr_db)


def apply_gain(wav: torch.Tensor, gain_db: float | torch.Tensor) -> torch.Tensor:
    """Scale a waveform by ``gain_db`` decibels."""
    return wav * (10.0 ** (torch.as_tensor(gain_db, dtype=wav.dtype, device=wav.device) / 20.0))


def random_gain(generator: torch.Generator, wav: torch.Tensor, min_db: float = -6.0,
                max_db: float = 6.0) -> torch.Tensor:
    """Scale a waveform by a gain drawn uniformly in [min_db, max_db) dB."""
    u = torch.rand((), generator=generator, device=generator.device, dtype=wav.dtype)
    return apply_gain(wav, min_db + (max_db - min_db) * u)
