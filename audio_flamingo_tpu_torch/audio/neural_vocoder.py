"""Neural mel -> waveform vocoder (HiFi-GAN-style generator with an NSF harmonic source),
as ``audio_flamingo_tpu/audio/neural_vocoder.py``.

The voice-out path behind the streaming TTS head (runtime/voice.py). ``Vocoder`` holds the
weights in torch layouts: convs [out, in, k], the transposed upsampling convs in
``conv_transpose1d``'s [in, out, k] with the kernel flipped (``io/convert`` moves JAX's
NWC / WIO cross-correlations there once). Activations run [B, C, T].

- ``apply``: the generator. With the harmonic layout (``f0_head``) a sine stack at the
  predicted per-frame F0 is average-pooled to each stage's rate and injected through a
  1x1 conv after every upsample; F0 and voicing are detached (JAX's ``stop_gradient``).
  On the card its f32 convs run under a scoped ``cudnn.flags(allow_tf32=False,
  deterministic=True)``: no TF32 rounding, and two launches give the same bits.
- ``_harmonic_source``: JAX's hierarchical 2*pi-wrapped phase (256-frame chunks), with its
  floor mod (``torch.remainder``) and its cumulative sums in the order XLA's CPU backend
  runs them (``_cumsum``: sequential blocks of 16, then the block totals; ``_chunk_sum``:
  eight sequential runs of 32, then the eight), so the phase is the same on the CPU and on
  the card and matches JAX's on the CPU.
- ``stream_synthesize``: chunked synthesis with a ctx-frame overlap on both sides, the
  harmonic frame-base phase carried across chunks in float64 on the host.
- ``default_vocoder(device=None)``: the shipped trained asset
  (``audio_flamingo_tpu/assets/vocoder.safetensors``, read by path with the port's own
  safetensors reader), or, without it, a short training run as JAX does.
- Evaluation (``evaluate``, ``envelope_correlation`` on the numpy corpora, which give
  JAX's arrays) and training (``multires_stft_loss``, ``loss``, ``train`` on
  ``torch.optim.Adam`` at optax.adam's defaults).
"""

from __future__ import annotations

import math
import os
import sys
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audio_flamingo_tpu_torch.audio.clap_mel import frame_signal
from audio_flamingo_tpu_torch.audio.mel import _windowed_dft_basis, mel_filter_bank
from audio_flamingo_tpu_torch.device import resolve_device

TWO_PI = 2.0 * math.pi
ASSET = os.path.join(os.path.dirname(__file__), "..", "..", "audio_flamingo_tpu", "assets",
                     "vocoder.safetensors")


@dataclass(frozen=True)
class VocoderConfig:
    n_mels: int = 80
    hop: int = 160                       # total upsampling factor (== mel hop)
    upsample: tuple = (5, 4, 4, 2)       # per-stage strides; product == hop
    channels: int = 192                  # width before the first upsample
    res_kernels: tuple = (3, 7)          # multi-receptive-field kernel sizes
    res_dilations: tuple = (1, 3)
    sr: int = 16_000
    n_fft: int = 400                     # analysis params for mel_spectrogram
    harmonics: int = 8                   # the NSF sine stack at the predicted F0
    f0_min: float = 60.0
    f0_span: float = 440.0               # f0 = f0_min + f0_span * sigmoid(raw)

    def stage_channels(self, i: int) -> int:
        return max(self.channels // (2 ** (i + 1)), 8)

    @property
    def receptive_frames(self) -> int:
        """Mel frames of one-sided receptive field (the streaming overlap): 3 for the
        pre conv, each stage's transposed conv and widest res block divided back to the
        frame rate, about 6.7 in all; 12 over-covers."""
        return 12


class Conv(nn.Module):
    """One conv's weight ([out, in, k]; a transposed conv's [in, out, k], flipped) and bias."""

    def __init__(self, k: int, cin: int, cout: int, transposed: bool = False, **factory):
        super().__init__()
        self.transposed = transposed
        shape = (cin, cout, k) if transposed else (cout, cin, k)
        self.weight = nn.Parameter(torch.empty(shape, **factory))
        self.bias = nn.Parameter(torch.empty(cout, **factory))


class ConvPair(nn.Module):
    def __init__(self, k: int, cin: int, mid: int, cout: int, **factory):
        super().__init__()
        self.c1 = Conv(k, cin, mid, **factory)
        self.c2 = Conv(k, mid, cout, **factory)


class Vocoder(nn.Module):
    """The generator's weights: ``pre``, ``ups`` / ``res`` / ``src`` per stage, ``post``,
    and with the harmonic layout ``f0_head`` and ``src`` (None in the legacy layout)."""

    def __init__(self, cfg: "VocoderConfig", harmonic: bool = True, **factory):
        super().__init__()
        self.pre = Conv(7, cfg.n_mels, cfg.channels, **factory)
        ups, res, src = [], [], []
        cin = cfg.channels
        for i, u in enumerate(cfg.upsample):
            cout = cfg.stage_channels(i)
            ups.append(Conv(2 * u, cin, cout, transposed=True, **factory))
            src.append(Conv(1, 1, cout, **factory))
            res.append(nn.ModuleList(ConvPair(k, cout, cout, cout, **factory)
                                     for k in cfg.res_kernels for _ in cfg.res_dilations))
            cin = cout
        self.ups = nn.ModuleList(ups)
        self.res = nn.ModuleList(res)
        self.post = Conv(7, cin, 1, **factory)
        self.f0_head = ConvPair(5, cfg.n_mels, 64, 2, **factory) if harmonic else None
        self.src = nn.ModuleList(src) if harmonic else None

    @property
    def harmonic(self) -> bool:
        return self.f0_head is not None


@torch.no_grad()
def init(cfg: VocoderConfig, harmonic: bool = True, generator: torch.Generator | None = None,
         device: torch.device | str | None = None) -> Vocoder:
    """Uniform(+-1/sqrt(k * cin)) weights, zero biases (JAX's ``_conv_init``), drawn from
    ``generator`` on ``device``."""
    device = resolve_device(device)
    with torch.device("meta"):
        voc = Vocoder(cfg, harmonic, dtype=torch.float32)
    voc = voc.to_empty(device=device)
    for m in voc.modules():
        if isinstance(m, Conv):
            w = m.weight
            k = w.shape[-1]
            cin = w.shape[0] if m.transposed else w.shape[1]
            scale = (1.0 / (k * cin)) ** 0.5
            w.uniform_(-scale, scale, generator=generator)
            m.bias.zero_()
    return voc


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


def _conv(x: torch.Tensor, c: Conv, *, dilation: int = 1) -> torch.Tensor:
    """[B, C, T] same-padded conv (JAX's pad: (k-1)d // 2 on the left, the rest right)."""
    k = c.weight.shape[-1]
    left = (k - 1) * dilation // 2
    right = (k - 1) * dilation - left
    if left != right:
        x = F.pad(x, (left, right))
        left = 0
    return F.conv1d(x, c.weight, c.bias, padding=left, dilation=dilation)


def _conv_transpose(x: torch.Tensor, c: Conv, stride: int) -> torch.Tensor:
    """Stride-u transposed conv with kernel 2u, output length T * u. JAX dilates the
    input by u, pads (k-1-u//2, u//2+u-1) and cross-correlates with w; that is
    ``conv_transpose1d`` with the kernel flipped (as stored) and padding u // 2."""
    t = x.shape[-1]
    y = F.conv_transpose1d(x, c.weight, stride=stride, padding=stride // 2)
    return y[..., : t * stride] + c.bias[:, None]


def predict_f0(voc: Vocoder, cfg: VocoderConfig, log_mel: torch.Tensor):
    """[B, F, n_mels] -> (f0_hz [B, F], voiced [B, F] in (0, 1))."""
    with _conv_flags():
        x = log_mel.transpose(1, 2)
        h = _leaky(_conv(x, voc.f0_head.c1))
        out = _conv(h, voc.f0_head.c2)
    f0 = cfg.f0_min + cfg.f0_span * torch.sigmoid(out[:, 0])
    return f0, torch.sigmoid(out[:, 1])


def _conv_flags():
    """cuDNN in full f32 with deterministic algorithms, for this call only."""
    return torch.backends.cudnn.flags(enabled=True, allow_tf32=False, deterministic=True)


def _seq_cumsum(x: torch.Tensor) -> torch.Tensor:
    out = [x[..., 0]]
    for i in range(1, x.shape[-1]):
        out.append(out[-1] + x[..., i])
    return torch.stack(out, -1)


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum over the last axis in the order of XLA's CPU backend:
    sequential within blocks of 16, the blocks' totals summed the same way (recursively)
    and added to each block."""
    n = x.shape[-1]
    if n <= 16:
        return _seq_cumsum(x)
    blocks = F.pad(x, (0, (-n) % 16)).reshape(*x.shape[:-1], -1, 16)
    within = _seq_cumsum(blocks)
    before = F.pad(_cumsum(within[..., -1])[..., :-1], (1, 0))
    return (before[..., None] + within).reshape(*x.shape[:-1], -1)[..., :n]


def _chunk_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over a last axis of 256 in XLA's CPU order: eight sequential runs of 32, then
    the eight partial sums in sequence."""
    parts = x.reshape(*x.shape[:-1], 8, 32)
    acc = parts[..., 0]
    for i in range(1, 32):
        acc = acc + parts[..., i]
    total = acc[..., 0]
    for i in range(1, 8):
        total = total + acc[..., i]
    return total


def _harmonic_source(cfg: VocoderConfig, f0: torch.Tensor, voiced: torch.Tensor,
                     phase0: torch.Tensor | None) -> torch.Tensor:
    """Sine-stack excitation at f0: [B, F] -> [B, F * hop].

    Frame j starts at phase0 + the exclusive sum of the per-frame increments
    2*pi*f0*hop/sr and advances linearly within the frame. The sum is hierarchical and
    wrapped mod 2*pi (exact within a 256-frame chunk, the chunk totals wrapped before the
    outer sum), so a long single-shot call keeps its phase small; mod 2*pi before the
    harmonic multiply keeps the sin argument small (sin(h(phi - 2 pi k)) = sin(h phi))."""
    b, frames = f0.shape
    inc = f0 * (TWO_PI * cfg.hop / cfg.sr)        # [B, F]; XLA's folded constant, as JAX jits it
    chunk = 256
    inc_p = F.pad(torch.remainder(inc, TWO_PI), (0, (-frames) % chunk))
    inc_c = inc_p.reshape(b, -1, chunk)
    within = _cumsum(inc_c) - inc_c                                  # < chunk * 2 pi
    tot = torch.remainder(_chunk_sum(inc_c), TWO_PI)                 # [B, n]
    cbase = torch.remainder(_cumsum(tot) - tot, TWO_PI)
    base = torch.remainder(cbase[..., None] + within, TWO_PI)
    base = base.reshape(b, -1)[:, :frames]                           # exclusive
    if phase0 is not None:
        base = base + phase0[:, None]
    # XLA folds the jitted constants to f32(2 pi) * f32(1 / sr); so does this product
    rate = torch.tensor(TWO_PI, dtype=torch.float32) * torch.tensor(1.0 / cfg.sr,
                                                                   dtype=torch.float32)
    step = f0[..., None] * rate.to(f0.device)                        # per sample
    k = 1.0 + torch.arange(cfg.hop, dtype=torch.float32, device=f0.device)
    # XLA contracts base + step * k into one FMA: the f32 product is exact in f64 and the
    # f64 sum too (about 35 bits), so rounding it to f32 once gives the FMA's bits
    within = (base[..., None].double() + step.double() * k.double()).float()
    phase = torch.remainder(within, TWO_PI)                          # [B, F, hop]
    hs = torch.arange(1, cfg.harmonics + 1, dtype=torch.float32, device=f0.device)
    amps = 1.0 / hs
    src = torch.sin(phase[..., None] * hs) @ amps                    # [B, F, hop]
    src = src * voiced[..., None] * (0.3 / math.log(cfg.harmonics + 1))
    return src.reshape(b, frames * cfg.hop)


def apply(voc: Vocoder, cfg: VocoderConfig, log_mel: torch.Tensor,
          phase0: torch.Tensor | None = None) -> torch.Tensor:
    """[B, frames, n_mels] log10-mel -> waveform [B, frames * hop] in (-1, 1). ``phase0``
    [B]: the harmonic frame-base phase carried across streaming chunks."""
    src = None
    if voc.harmonic:
        f0, voiced = predict_f0(voc, cfg, log_mel)
        # the excitation is an input signal, not a differentiable path (JAX's stop_gradient)
        src = _harmonic_source(cfg, f0.detach(), voiced.detach(), phase0)   # [B, T]
    with _conv_flags():
        x = _conv(log_mel.transpose(1, 2), voc.pre)
        rate = 1
        for i, u in enumerate(cfg.upsample):
            x = _conv_transpose(_leaky(x), voc.ups[i], u)
            rate *= u
            if src is not None:
                pool = cfg.hop // rate
                s_i = src.reshape(src.shape[0], -1, pool).mean(-1) if pool > 1 else src
                x = x + _conv(s_i[:, None, :].to(x.dtype), voc.src[i])
            acc = None
            for blk in voc.res[i]:
                # two stacked dilated convs per multi-receptive-field block
                h = x + _conv(_leaky(_conv(_leaky(x), blk.c1, dilation=cfg.res_dilations[0])),
                              blk.c2, dilation=cfg.res_dilations[-1])
                acc = h if acc is None else acc + h
            x = acc / len(voc.res[i])
        wav = torch.tanh(_conv(_leaky(x), voc.post))
    return wav[:, 0]


# --------------------------------------------------------------------------------------
# Analysis side: the log10 slaney mel that GriffinLim inverts
# --------------------------------------------------------------------------------------


class VocoderMel:
    """wav -> [frames, n_mels] log10-mel with the filterbank and scale GriffinLim inverts,
    so Griffin-Lim and the neural vocoder are drop-in alternatives."""

    def __init__(self, cfg: VocoderConfig = VocoderConfig(), fmin: float = 0.0,
                 fmax: float = 8000.0, device: torch.device | str | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        f32 = dict(dtype=torch.float32, device=self.device)
        mel = mel_filter_bank(cfg.n_fft // 2 + 1, cfg.n_mels, fmin, fmax, cfg.sr)
        self.mel = torch.tensor(np.asarray(mel, np.float32), **f32)
        c, s = _windowed_dft_basis(cfg.n_fft)
        self.C = torch.tensor(np.asarray(c, np.float32), **f32)
        self.S = torch.tensor(np.asarray(s, np.float32), **f32)

    def __call__(self, wav) -> torch.Tensor:
        """wav [B, T] (T a multiple of hop) -> [B, T // hop, n_mels]."""
        cfg = self.cfg
        wav = torch.as_tensor(wav, dtype=torch.float32, device=self.device)
        num_frames = wav.shape[-1] // cfg.hop
        half = cfg.n_fft // 2
        padded = F.pad(wav, (half, half), mode="reflect")
        frames = frame_signal(padded, cfg.n_fft, cfg.hop, num_frames)
        power = (frames @ self.C) ** 2 + (frames @ self.S) ** 2
        melspec = torch.clamp(power @ self.mel, min=1e-10)
        return torch.log10(melspec)


# --------------------------------------------------------------------------------------
# Training: multi-resolution STFT + waveform loss on the synthetic voice-like corpus
# --------------------------------------------------------------------------------------

_STFT_RESOLUTIONS = ((512, 128), (1024, 256), (256, 64))


def _stft_mag(wav: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    num_frames = (wav.shape[-1] - n_fft) // hop + 1
    frames = frame_signal(wav, n_fft, hop, num_frames)
    win = torch.tensor(np.hanning(n_fft).astype(np.float32), device=wav.device)
    spec = torch.fft.rfft(frames * win, dim=-1)
    return torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-9)


def multires_stft_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Parallel-WaveGAN auxiliary loss: spectral convergence + log-magnitude L1."""
    total = 0.0
    for n_fft, hop in _STFT_RESOLUTIONS:
        pm = _stft_mag(pred, n_fft, hop)
        tm = _stft_mag(target, n_fft, hop)
        sc = torch.linalg.norm(pm - tm) / torch.clamp(torch.linalg.norm(tm), min=1e-6)
        mag = torch.mean(torch.abs(torch.log(pm) - torch.log(tm)))
        total = total + sc + mag
    return total / len(_STFT_RESOLUTIONS)


def loss(voc: Vocoder, cfg: VocoderConfig, log_mel: torch.Tensor, target_wav: torch.Tensor,
         f0_target: torch.Tensor | None = None,
         voiced_target: torch.Tensor | None = None) -> torch.Tensor:
    """Multi-res STFT + L1; with the harmonic layout and per-frame targets (``f0_track``)
    the F0 head is supervised directly: normalized |df0| over voiced frames + BCE on the
    voicing gate."""
    pred = apply(voc, cfg, log_mel)
    total = multires_stft_loss(pred, target_wav) + 2.0 * torch.mean(torch.abs(pred - target_wav))
    if f0_target is not None and voc.harmonic:
        f0, voiced = predict_f0(voc, cfg, log_mel)
        vm = voiced_target.to(torch.float32)
        nv_ = torch.clamp(vm.sum(), min=1.0)
        total = total + 2.0 * (torch.abs(f0 - f0_target) / cfg.f0_span * vm).sum() / nv_
        bce = -(vm * torch.log(voiced + 1e-6) + (1 - vm) * torch.log(1 - voiced + 1e-6))
        total = total + 0.2 * bce.mean()
    return total


def f0_track(wav: np.ndarray, sr: int = 16_000, hop: int = 160,
             frames: int | None = None, fmin: float = 60.0,
             fmax: float = 420.0) -> tuple[np.ndarray, np.ndarray]:
    """Per-mel-frame autocorrelation pitch: wav -> (f0 [frames], voiced [frames]); a 40 ms
    window centered on each frame; unvoiced or silent frames get f0 = 0, voiced False."""
    if frames is None:
        frames = len(wav) // hop
    win = int(0.04 * sr)
    lo, hi = int(sr / fmax), int(sr / fmin)
    f0 = np.zeros(frames, np.float32)
    voiced = np.zeros(frames, bool)
    padded = np.pad(wav, (win // 2, win))
    for j in range(frames):
        x = padded[j * hop: j * hop + win].astype(np.float64)
        x = x - x.mean()
        if np.max(np.abs(x)) < 1e-3:
            continue
        ac = np.correlate(x, x, mode="full")[win - 1:]
        seg = ac[lo:hi]
        if seg.size == 0 or ac[0] <= 0:
            continue
        lag = lo + int(np.argmax(seg))
        if ac[lag] / ac[0] > 0.3:
            f0[j] = sr / lag
            voiced[j] = True
    return f0, voiced


def speaker_spec(spk_id: int) -> dict:
    """Deterministic per-speaker voice parameters: f0 base, 3 formants, bandwidths, rolloff."""
    r = np.random.default_rng(1000 + spk_id)
    return {
        "f0": float(r.uniform(85.0, 280.0)),
        "formants": np.array([r.uniform(300, 850), r.uniform(900, 2300),
                              r.uniform(2400, 3200)], np.float32),
        "bw": np.array([r.uniform(60, 110), r.uniform(90, 160),
                        r.uniform(120, 220)], np.float32),
        "rolloff": float(r.uniform(0.6, 1.1)),
    }


# vowel-like formant targets (F1, F2) the sentence generator moves between
_VOWELS = np.array([[730, 1090], [270, 2290], [300, 870], [530, 1840], [660, 1720]],
                   np.float32)


def synthetic_sentence(rng: np.random.Generator, spk: dict, seconds: float,
                       sr: int = 16_000) -> np.ndarray:
    """One speech-like sentence: vowel segments with interpolated formant targets, f0
    declination and vibrato, a syllable envelope and breath noise."""
    n = int(seconds * sr)
    t = np.arange(n) / sr
    n_seg = max(2, int(seconds / 0.12))
    seg_ids = rng.integers(0, len(_VOWELS), n_seg)
    bounds = np.linspace(0, n, n_seg + 1).astype(int)
    f1 = np.empty(n, np.float32)
    f2 = np.empty(n, np.float32)
    env = np.empty(n, np.float32)
    for i in range(n_seg):
        sl = slice(bounds[i], bounds[i + 1])
        v = _VOWELS[seg_ids[i]]
        scale = spk["formants"][0] / 500.0   # speaker's vocal-tract scaling
        f1[sl], f2[sl] = v[0] * scale, v[1] * scale
        env[sl] = rng.uniform(0.45, 1.0)     # syllable stress
    k = int(0.02 * sr) | 1
    kernel = np.hanning(k)
    kernel /= kernel.sum()
    f1 = np.convolve(f1, kernel, mode="same")
    f2 = np.convolve(f2, kernel, mode="same")
    env = np.convolve(env, kernel, mode="same")

    f0 = spk["f0"] * (1.06 - 0.12 * t / max(seconds, 1e-3))       # declination
    f0 = f0 * (1.0 + 0.008 * np.sin(2 * np.pi * rng.uniform(4.5, 6.5) * t))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    wav = np.zeros(n, np.float32)
    f3, bw = float(spk["formants"][2]), spk["bw"]
    for h in range(1, 16):
        fh = h * spk["f0"]
        if fh > sr / 2 - 200:
            break
        res = (1.0 / (1 + ((fh - f1) / bw[0]) ** 2)
               + 0.7 / (1 + ((fh - f2) / bw[1]) ** 2)
               + 0.3 / (1 + ((fh - f3) / bw[2]) ** 2))
        wav += (h ** -spk["rolloff"]) * res * np.sin(h * phase + rng.uniform(0, 2 * np.pi))
    wav = wav * env + 0.008 * rng.normal(size=n)
    return (0.6 * wav / max(np.max(np.abs(wav)), 1e-6)).astype(np.float32)


def synthetic_speaker_batch(rng: np.random.Generator, spk_ids, seconds: float,
                            sr: int = 16_000) -> np.ndarray:
    """[len(spk_ids), T] sentences, one per requested speaker id."""
    return np.stack([synthetic_sentence(rng, speaker_spec(int(s)), seconds, sr)
                     for s in spk_ids])


def synthetic_voice_batch(rng: np.random.Generator, batch: int, seconds: float,
                          sr: int = 16_000) -> tuple[np.ndarray, np.ndarray]:
    """Harmonic stacks with vibrato and drifting f0, spectral rolloff, an amplitude
    envelope and breath noise. Returns (wav [B, T], f0 [B])."""
    t = np.arange(int(seconds * sr)) / sr
    wavs, f0s = [], []
    for _ in range(batch):
        f0 = rng.uniform(90.0, 320.0)
        vib = 1.0 + 0.01 * np.sin(2 * np.pi * rng.uniform(4, 7) * t)
        drift = 1.0 + 0.03 * np.sin(2 * np.pi * rng.uniform(0.3, 1.0) * t)
        phase = 2 * np.pi * np.cumsum(f0 * vib * drift) / sr
        wav = np.zeros_like(t)
        for h in range(1, 12):
            if h * f0 > sr / 2 - 200:
                break
            amp = h ** -rng.uniform(0.8, 1.6)
            wav += amp * np.sin(h * phase + rng.uniform(0, 2 * np.pi))
        env = 0.4 + 0.6 * np.abs(np.sin(2 * np.pi * rng.uniform(1.5, 4.0) * t
                                        + rng.uniform(0, np.pi)))
        wav = wav * env + 0.01 * rng.normal(size=t.shape)
        wav = 0.6 * wav / np.max(np.abs(wav))
        wavs.append(wav.astype(np.float32))
        f0s.append(f0)
    return np.stack(wavs), np.asarray(f0s, np.float32)


def train(cfg: VocoderConfig, *, steps: int = 300, batch: int = 8, seconds: float = 0.5,
          lr: float = 2e-4, seed: int = 0, log_every: int = 0, corpus: str = "speakers",
          num_speakers: int = 8, voc: Vocoder | None = None,
          generator: torch.Generator | None = None,
          device: torch.device | str | None = None) -> tuple[Vocoder, list[float]]:
    """Train the generator on the synthetic corpus (``corpus``: "speakers", "voice" or
    "mixed", alternating batches). Starts from ``voc`` when given (trained in place), else
    from ``init(cfg, generator=generator)``. Adam at optax.adam's defaults (b1 0.9, b2
    0.999, eps 1e-8, bias-corrected). Returns (vocoder, loss history)."""
    device = resolve_device(device) if voc is None else voc.pre.weight.device
    if voc is None:
        voc = init(cfg, generator=generator, device=device)
    mel_fe = VocoderMel(cfg, device=device)
    opt = torch.optim.Adam(voc.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    np_rng = np.random.default_rng(seed)
    history = []
    for step in range(steps):
        kind = corpus if corpus != "mixed" else ("speakers" if step % 2 == 0 else "voice")
        if kind == "speakers":
            wavs = synthetic_speaker_batch(
                np_rng, np_rng.integers(0, num_speakers, batch), seconds, cfg.sr)
        else:
            wavs, _ = synthetic_voice_batch(np_rng, batch, seconds, cfg.sr)
        wavs_t = torch.as_tensor(wavs, device=device)
        mels = mel_fe(wavs_t)
        f0t = vt = None
        if voc.harmonic:
            tracks = [f0_track(w, cfg.sr, cfg.hop) for w in wavs]
            f0t = torch.as_tensor(np.stack([t[0] for t in tracks]), device=device)
            vt = torch.as_tensor(np.stack([t[1] for t in tracks]), device=device)
        opt.zero_grad(set_to_none=True)
        lval = loss(voc, cfg, mels, wavs_t, f0t, vt)
        lval.backward()
        opt.step()
        history.append(float(lval.detach()))
        if log_every and step % log_every == 0:
            print(f"vocoder step {step}: loss {history[-1]:.4f}", flush=True)
    return voc, history


# --------------------------------------------------------------------------------------
# Objective evaluation: mel reconstruction MSE + F0 tracking on a held-out corpus
# --------------------------------------------------------------------------------------


def estimate_f0(wav: np.ndarray, sr: int = 16_000,
                fmin: float = 60.0, fmax: float = 420.0) -> float:
    """Median autocorrelation pitch over 40 ms frames (voiced synthetic signals)."""
    frame, hop = int(0.04 * sr), int(0.02 * sr)
    lo, hi = int(sr / fmax), int(sr / fmin)
    f0s = []
    for start in range(0, len(wav) - frame, hop):
        x = wav[start: start + frame]
        x = x - x.mean()
        if np.max(np.abs(x)) < 1e-3:
            continue
        ac = np.correlate(x, x, mode="full")[frame - 1:]
        seg = ac[lo:hi]
        if seg.size == 0 or ac[0] <= 0:
            continue
        lag = lo + int(np.argmax(seg))
        if ac[lag] / ac[0] > 0.3:
            f0s.append(sr / lag)
    return float(np.median(f0s)) if f0s else 0.0


def _device_of(voc: Vocoder) -> torch.device:
    return voc.pre.weight.device


@torch.no_grad()
def evaluate(voc: Vocoder, cfg: VocoderConfig, *, n: int = 8, seconds: float = 0.5,
             seed: int = 123) -> dict:
    """Held-out objective eval: {mel_mse, f0_mae_hz}."""
    mel_fe = VocoderMel(cfg, device=_device_of(voc))
    np_rng = np.random.default_rng(seed)
    wavs, f0s = synthetic_voice_batch(np_rng, n, seconds, cfg.sr)
    mels = mel_fe(wavs)
    pred = apply(voc, cfg, mels)
    pred_mels = mel_fe(pred)
    mel_mse = float(torch.mean((pred_mels - mels) ** 2))
    pred_np = pred.cpu().numpy()
    f0_err = [abs(estimate_f0(pred_np[i], cfg.sr) - f0s[i]) for i in range(n)]
    return {"mel_mse": mel_mse, "f0_mae_hz": float(np.mean(f0_err))}


@torch.no_grad()
def envelope_correlation(voc: Vocoder, cfg: VocoderConfig, *, n: int = 6,
                         seconds: float = 0.6, seed: int = 321,
                         num_speakers: int = 8) -> float:
    """Spectral-envelope intelligibility proxy on held-out multi-speaker sentences: the
    mean per-frame Pearson correlation between the target's and the resynthesis's mel
    envelopes."""
    mel_fe = VocoderMel(cfg, device=_device_of(voc))
    rng = np.random.default_rng(seed)
    wavs = synthetic_speaker_batch(rng, rng.integers(0, num_speakers, n), seconds, cfg.sr)
    mels = mel_fe(wavs)
    pred_mels = mel_fe(apply(voc, cfg, mels))
    a = mels.cpu().numpy()
    b = pred_mels.cpu().numpy()
    # per-frame correlation over the mel axis, averaged over frames and sentences
    a = a - a.mean(axis=-1, keepdims=True)
    b = b - b.mean(axis=-1, keepdims=True)
    num = (a * b).sum(-1)
    den = np.sqrt((a * a).sum(-1) * (b * b).sum(-1)) + 1e-9
    return float((num / den).mean())


def _unflatten(flat: dict) -> dict:
    """A flat ``a.0.b`` -> array dict (the asset's names) -> JAX's nested tree, with
    numeric levels as lists."""
    tree: dict = {}
    for name, value in flat.items():
        node, parts = tree, name.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [listify(node[str(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(tree)


def load_vocoder(path: str, cfg: VocoderConfig = VocoderConfig(),
                 device: torch.device | str | None = None) -> Vocoder:
    """A vocoder safetensors file in JAX's flat names (``pre.w`` [7, 80, 192], ...)."""
    from audio_flamingo_tpu_torch.io.convert import vocoder_params_from_jax
    from audio_flamingo_tpu_torch.io.safetensors import load_safetensors

    device = resolve_device(device)
    tree = _unflatten(load_safetensors(path))
    with torch.device("meta"):
        voc = Vocoder(cfg, harmonic="f0_head" in tree, dtype=torch.float32)
    voc = voc.to_empty(device=device)
    voc.load_state_dict(vocoder_params_from_jax(tree))
    return voc.requires_grad_(False)


_DEFAULT_VOCODERS: dict = {}


def default_vocoder(steps: int = 200, device: torch.device | str | None = None
                    ) -> "NeuralVocoder":
    """The process-cached default voice-out vocoder on ``device`` (runtime/voice.py): the
    shipped trained asset when present; otherwise the first call on a device runs a
    ``steps``-step training loop on the procedural corpus (tens of seconds)."""
    device = resolve_device(device)
    key = str(device)
    if key not in _DEFAULT_VOCODERS:
        cfg = VocoderConfig()
        if os.path.exists(ASSET):
            voc = load_vocoder(ASSET, cfg, device)
        else:
            print(f"[audio_flamingo_tpu_torch] training the default neural vocoder "
                  f"({steps} steps, first call only)...", file=sys.stderr, flush=True)
            voc, _ = train(cfg, steps=steps,
                           generator=torch.Generator(device=device).manual_seed(0),
                           device=device)
            voc.requires_grad_(False)
        _DEFAULT_VOCODERS[key] = NeuralVocoder(voc, cfg)
    return _DEFAULT_VOCODERS[key]


# --------------------------------------------------------------------------------------
# Streaming synthesis + runtime adapter
# --------------------------------------------------------------------------------------


@torch.no_grad()
def stream_synthesize(voc: Vocoder, cfg: VocoderConfig, mel_chunks,
                      ctx_frames: int | None = None):
    """Generator over waveform chunks (numpy) from an iterator of [frames, n_mels] chunks.

    The convs are non-causal, so each emitted sample needs ``ctx_frames`` of mel context
    on both sides: the stream holds back a ctx-frame lookahead and re-runs a ctx-frame
    left overlap. Legacy layout: every sample equals the full pass up to the convs'
    rounding. Harmonic layout: the sine source's frame-base phase is carried across
    chunks as a float64 scalar on the host (from the same F0 predictions), so the stream
    is phase-continuous and matches the full pass to a small band."""
    harmonic = voc.harmonic
    device = _device_of(voc)
    ctx = (cfg.receptive_frames + (5 if harmonic else 0)
           if ctx_frames is None else ctx_frames)
    buf = None          # retained mel frames; buf[0] is absolute frame `base`
    base = 0
    emitted = 0         # absolute frames emitted so far
    phase0 = 0.0        # harmonic frame-base phase of frame `base`

    def synth(window):
        if not harmonic:
            return apply(voc, cfg, window[None])[0]
        p0 = torch.tensor([phase0], dtype=torch.float32, device=device)
        return apply(voc, cfg, window[None], phase0=p0)[0]

    for chunk in mel_chunks:
        chunk = torch.as_tensor(chunk, dtype=torch.float32, device=device)
        buf = chunk if buf is None else torch.cat([buf, chunk], dim=0)
        ready = base + buf.shape[0] - ctx      # frames with full right context
        if ready > emitted:
            lo = max(emitted - ctx, 0)
            window = buf[lo - base:]
            wav = synth(window)
            out = wav[(emitted - lo) * cfg.hop: (ready - lo) * cfg.hop].cpu().numpy()
            emitted = ready
            keep = max(emitted - ctx, 0)
            if harmonic and keep > base:
                f0_win, _ = predict_f0(voc, cfg, window[None])
                drop = f0_win[0, : keep - lo].cpu().numpy().astype(np.float64)
                phase0 = float(np.mod(phase0 + 2.0 * np.pi * drop.sum() * cfg.hop / cfg.sr,
                                      2.0 * np.pi))
            buf, base = buf[keep - base:], keep
            yield out
    if buf is not None and base + buf.shape[0] > emitted:
        lo = max(emitted - ctx, 0)
        window = buf[lo - base:]
        wav = synth(window)
        yield wav[(emitted - lo) * cfg.hop:].cpu().numpy()


class NeuralVocoder:
    """Drop-in alternative to audio.vocoder.GriffinLim for runtime/voice.py."""

    def __init__(self, voc: Vocoder, cfg: VocoderConfig = VocoderConfig()):
        self.voc, self.cfg = voc, cfg

    @property
    def device(self) -> torch.device:
        return _device_of(self.voc)

    @torch.no_grad()
    def mel_to_waveform(self, log_mel: torch.Tensor, seed: int = 0) -> np.ndarray:
        if isinstance(log_mel, np.ndarray):
            log_mel = np.array(log_mel, np.float32)     # a writable copy for torch
        mel = torch.as_tensor(log_mel, dtype=torch.float32, device=self.device)
        return apply(self.voc, self.cfg, mel[None])[0].cpu().numpy()
