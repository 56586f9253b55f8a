"""CLAP mel frontend (AF1/AF2), as ``audio_flamingo_tpu/audio/clap_mel.py``: 48 kHz dB
log-mel with dual filterbanks and the fusion crops.

- ``_db_mel``: reflect pad by n_fft / 2, the exact strided framing (``frame_signal``), the
  windowed real-DFT products, power, the mel product (HTK banks without norm for
  'fusion', Slaney banks and norm for 'rand_trunc') and ``10 log10(max(., 1e-10))`` on
  the frontend's device, from f32 samples to an f32 mel. The banks and basis are the
  port's own float64 numpy constants (``audio/mel.py``) cast to f32; the products run in
  float64 on them. A band near DC sums ~1024 windowed samples that nearly cancel, and
  f32 products in torch's order of sums land up to ~1.2e-3 dB from the exact value there
  where XLA's land within ~1.5e-4 dB; float64 products keep the port within the
  latter of JAX. There is no kernel here: JAX runs it as plain XLA products, and it is
  not Whisper's log-mel (K1).
- Clips longer than 10 s: 'rand_trunc' takes a random 10 s crop; 'fusion' takes the
  full-length mel, shrinks it bilinearly to 1001 frames and stacks three random crops
  beside it (``_fusion_stack``). Shorter clips are tiled and padded (``_pad_short``).
  The random choices come from ``np.random.default_rng(seed)`` in the JAX frontend's
  order of draws, so one seed gives JAX's crops.
- ``window_chunks_device``: a waveform already on the device -> [n, 480000] 10 s windows
  with the tail tiled as ``_pad_short`` tiles it, with no host round trip.

``frame_signal`` is also the framing of the Griffin-Lim and neural vocoders
(audio/vocoder.py, audio/neural_vocoder.py).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from audio_flamingo_tpu_torch.audio.mel import _windowed_dft_basis, mel_filter_bank
from audio_flamingo_tpu_torch.config import ClapMelConfig
from audio_flamingo_tpu_torch.device import resolve_device


def frame_signal(padded: torch.Tensor, n_fft: int, hop: int, num_frames: int) -> torch.Tensor:
    """[N, L] centered-padded signal -> [N, num_frames, n_fft], exact strided slices
    (frame i is ``padded[:, i * hop : i * hop + n_fft]``; a signal too short for the last
    frame is zero-padded at its end, as JAX's block framing does)."""
    need = (num_frames - 1) * hop + n_fft
    if padded.shape[-1] < need:
        padded = F.pad(padded, (0, need - padded.shape[-1]))
    return padded.unfold(-1, n_fft, hop)[:, :num_frames]


def _bilinear_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Torch bilinear align_corners=False 1D interpolation matrix [n_out, n_in]."""
    w = np.zeros((n_out, n_in), np.float64)
    scale = n_in / n_out
    for i in range(n_out):
        src = (i + 0.5) * scale - 0.5
        f = int(np.floor(src))
        frac = src - f
        i0, i1 = min(max(f, 0), n_in - 1), min(max(f + 1, 0), n_in - 1)
        w[i, i0] += 1 - frac
        w[i, i1] += frac
    return w


class ClapMelFrontend:
    """10 s (max) 48 kHz clips -> [4|1, T, 64] dB log-mel (HF CLAP's feature extractor).
    Runs on CUDA unless ``device`` names another device; without a card and a device it
    raises."""

    def __init__(self, cfg: ClapMelConfig = ClapMelConfig(), seed: int = 0,
                 device: torch.device | str | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.max_samples = cfg.max_length_s * cfg.sampling_rate
        self.num_frames_max = self.max_samples // cfg.hop_length + 1  # 1001
        n_bins = cfg.n_fft // 2 + 1
        def const(a):   # the f32 constant of JAX's frontend, held in float64
            return torch.tensor(a, dtype=torch.float32, device=self.device).double()

        self.mel_htk = const(mel_filter_bank(n_bins, cfg.num_mel_bins, cfg.fmin, cfg.fmax,
                                             cfg.sampling_rate, norm=None, mel_scale="htk"))
        self.mel_slaney = const(mel_filter_bank(n_bins, cfg.num_mel_bins, cfg.fmin, cfg.fmax,
                                                cfg.sampling_rate, norm="slaney",
                                                mel_scale="slaney"))
        c, s = _windowed_dft_basis(cfg.n_fft)
        self.dft_cos, self.dft_sin = const(c), const(s)
        self.rng = np.random.default_rng(seed)

    def _db_mel(self, wav: torch.Tensor, num_frames: int, use_htk: bool) -> torch.Tensor:
        """[N, L] f32 -> [N, num_frames, n_mels] dB mel (10 log10, floor 1e-10)."""
        half = self.cfg.n_fft // 2
        padded = F.pad(wav.float()[:, None], (half, half), mode="reflect")[:, 0]
        frames = frame_signal(padded, self.cfg.n_fft, self.cfg.hop_length, num_frames)
        frames = frames.double()
        re = torch.matmul(frames, self.dft_cos)
        im = torch.matmul(frames, self.dft_sin)
        power = re * re + im * im
        mel = torch.matmul(power, self.mel_htk if use_htk else self.mel_slaney)
        return (10.0 * torch.log10(torch.clamp(mel, min=1e-10))).float()

    def window_chunks_device(self, wav: torch.Tensor, n: int, padding: str) -> torch.Tensor:
        """A [true_len] waveform on the device -> [n, max_samples] chunks: whole 10 s
        windows, then the tail tiled as ``_pad_short`` tiles it ('repeat' n_rep + 1 times
        then cut, 'repeatpad' n_rep times then zero-padded, 'pad' zero-padded), then zero
        rows up to n."""
        max_s = self.max_samples
        true_len = int(wav.shape[0])
        n_full = min(true_len // max_s, n)
        parts = []
        if n_full:
            parts.append(wav[: n_full * max_s].reshape(n_full, max_s))
        tail_len = min(true_len, n * max_s) - n_full * max_s
        if tail_len > 0:
            tail = wav[n_full * max_s: n_full * max_s + tail_len]
            n_rep = max_s // tail_len
            if padding == "repeat":
                tiled = tail.repeat(n_rep + 1)[:max_s]
            elif padding == "repeatpad":
                tiled = F.pad(tail.repeat(max(n_rep, 1)), (0, max_s - max(n_rep, 1) * tail_len))
            else:
                tiled = F.pad(tail, (0, max_s - tail_len))
            parts.append(tiled[None])
        n_zero = n - n_full - (1 if tail_len > 0 else 0)
        if n_zero:
            parts.append(torch.zeros((n_zero, max_s), dtype=wav.dtype, device=wav.device))
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)

    def _pad_short(self, wav: np.ndarray) -> np.ndarray:
        cfg = self.cfg
        if len(wav) < self.max_samples:
            n_rep = int(self.max_samples / len(wav))
            if cfg.padding == "repeat":
                wav = np.tile(wav, n_rep + 1)[: self.max_samples]
            elif cfg.padding == "repeatpad":
                wav = np.tile(wav, max(n_rep, 1))
            wav = np.pad(wav, (0, self.max_samples - len(wav)))
        return wav

    def _upload(self, wav: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(wav, np.float32)[None], device=self.device)

    def __call__(self, wav: np.ndarray, truncation: str | None = None):
        """Mono 48 kHz f32 waveform -> (mel [C, T, n_mels] f32 on the device, is_longer).
        C = 4 for 'fusion' (global shrink + 3 crops), 1 for 'rand_trunc'."""
        cfg = self.cfg
        truncation = truncation or cfg.truncation
        wav = np.asarray(wav, np.float32)
        if len(wav) > self.max_samples:
            if truncation == "rand_trunc":
                idx = int(self.rng.integers(0, len(wav) - self.max_samples + 1))
                wav = wav[idx: idx + self.max_samples]
                return self._db_mel(self._upload(wav), self.num_frames_max, False), True
            num_frames = len(wav) // cfg.hop_length + 1
            mel = self._db_mel(self._upload(wav), num_frames, True)[0]
            chunk = self.num_frames_max
            if chunk == num_frames:
                return torch.stack([mel] * 4), False
            return self._fusion_stack(mel, num_frames, chunk), True
        wav = self._pad_short(wav)
        if truncation == "fusion":
            mel = self._db_mel(self._upload(wav), self.num_frames_max, True)[0]
            return torch.stack([mel] * 4), False
        return self._db_mel(self._upload(wav), self.num_frames_max, False), False

    def _fusion_stack(self, mel: torch.Tensor, total: int, chunk: int) -> torch.Tensor:
        """HF's _random_mel_fusion: the bilinear global shrink and 3 random range crops."""
        ranges = np.array_split(list(range(0, total - chunk + 1)), 3)
        ranges = [r if len(r) else [0] for r in ranges]
        idxs = [int(self.rng.choice(r)) for r in ranges]
        crops = [mel[i: i + chunk] for i in idxs]
        shrink = torch.tensor(_bilinear_matrix(total, chunk), dtype=torch.float64,
                              device=mel.device) @ mel.double()
        return torch.stack([shrink.float()] + crops, dim=0)
