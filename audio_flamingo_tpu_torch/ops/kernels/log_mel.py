"""Fused Whisper log-mel: the hand-written Hopper kernel and its plain PyTorch version.

Replaces the Pallas TPU kernel ``audio_flamingo_tpu/ops/pallas/stft_mel.py``
(``fused_log_mel`` :58, kernels ``_logmel_kernel`` :32 and ``_clamp_kernel`` :50). The
CUDA source is ``csrc/log_mel.cu``; its header states the kernels' design and what
bounds them on the H100: the products run in 3xTF32 on the tensor cores (each f32 split
into a TF32 high part and a TF32 remainder, ``tf32_split``), the bases split once into
high and low arrays laid out as the kernel streams them (``prepare_bases``; the
frontend keeps its own).

Dispatch is by the tensors' device: a CPU tensor goes to ``log_mel_reference``; a CUDA
tensor launches the two kernels or raises. There is no fallback between the two.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from audio_flamingo_tpu_torch.ops.kernels import _build
from audio_flamingo_tpu_torch.ops.kernels.launches import LaunchCounter

LAUNCHES = LaunchCounter()   # key: (kernel name, its main operand's shape); no inputs kept
KERNEL_MAX_BINS = 208        # csrc/log_mel.cu kBins: 201 bins padded to the MMA's n-step
KERNEL_MAX_MELS = 128        # csrc/log_mel.cu kMels
TILE_FRAMES = 64             # csrc/log_mel.cu kTF: frames a block takes
PASS_BINS = KERNEL_MAX_BINS // 2   # csrc/log_mel.cu kPassBins: bins of one DFT pass


def log_mel_reference(wins: torch.Tensor, dft_cos: torch.Tensor, dft_sin: torch.Tensor,
                      mel_weights: torch.Tensor, hop: int,
                      frames_per_window: int) -> torch.Tensor:
    """[N, window_samples] f32 -> [N, frames_per_window, n_mels] f32, in plain PyTorch.

    Reflect-pad by n_fft/2, frame at ``hop``, power = (x C)^2 + (x S)^2, mel product,
    log10(max(., 1e-10)), then per window max(x, max - 8) and (x + 4) / 4."""
    n_fft = dft_cos.shape[0]
    half = n_fft // 2
    padded = F.pad(wins[:, None], (half, half), mode="reflect")[:, 0]
    frames = padded.unfold(-1, n_fft, hop)[:, :frames_per_window]
    re = frames @ dft_cos
    im = frames @ dft_sin
    power = re * re + im * im
    log_spec = torch.log10(torch.clamp(power @ mel_weights, min=1e-10))
    mx = log_spec.amax(dim=(1, 2), keepdim=True)
    log_spec = torch.maximum(log_spec, mx - 8.0)
    return (log_spec + 4.0) / 4.0


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x = hi + lo (up to the last bits of lo) with hi and lo TF32 values: hi is x rounded
    to 10 mantissa bits, to nearest with ties away from zero (PTX ``cvt.rna.tf32.f32``: add
    half an ulp of TF32 to the bit pattern and clear the 13 low bits), lo the remainder
    rounded the same way. Exact bit operations, the same on any device."""
    def rna(v: torch.Tensor) -> torch.Tensor:
        return ((v.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)

    x = x.float().contiguous()
    hi = rna(x)
    return hi, rna(x - hi)


@dataclasses.dataclass(frozen=True)
class KernelBases:
    """The bases split into TF32 high and low parts and laid out as the kernel streams
    them: ``dft`` [2 passes][n_fft / 8][hi | lo][k 0-3 | 4-7][208 rows][4] (per pass, rows
    0-103 the cos and 104-207 the sin of its 104 bins; bins past n_bins are 0), ``mel``
    [26][hi | lo][k 0-3 | 4-7][128 mels][4] (bins and mels past the real ones 0)."""
    dft: torch.Tensor
    mel: torch.Tensor
    n_fft: int
    n_bins: int
    n_mels: int


def prepare_bases(dft_cos: torch.Tensor, dft_sin: torch.Tensor,
                  mel_weights: torch.Tensor) -> KernelBases:
    """Split the bases once into the kernel's high/low layout (on their own device)."""
    n_fft, n_bins = dft_cos.shape
    n_mels = mel_weights.shape[1]
    if n_bins > KERNEL_MAX_BINS or n_mels > KERNEL_MAX_MELS or n_fft % 8:
        raise ValueError(f"the CUDA kernel takes <= {KERNEL_MAX_BINS} bins, <= "
                         f"{KERNEL_MAX_MELS} mels and n_fft a multiple of 8; got {n_bins}, "
                         f"{n_mels}, {n_fft}")
    dev = dft_cos.device
    cs = torch.zeros((2, n_fft, KERNEL_MAX_BINS), dtype=torch.float32, device=dev)
    cs[0, :, :n_bins] = dft_cos
    cs[1, :, :n_bins] = dft_sin
    # [cos|sin, k, pass, bin in pass] -> [pass, kstep, half, cos|sin, bin in pass, 4]
    b = cs.reshape(2, n_fft // 8, 2, 4, 2, PASS_BINS).permute(4, 1, 2, 0, 5, 3)
    b = b.reshape(2, n_fft // 8, 1, 2, 2 * PASS_BINS, 4)
    dft = torch.cat(tf32_split(b), dim=2).contiguous()
    w = torch.zeros((KERNEL_MAX_BINS, KERNEL_MAX_MELS), dtype=torch.float32, device=dev)
    w[:n_bins, :n_mels] = mel_weights
    # [bin, mel] -> [kstep, half, mel, 4]
    w = w.reshape(KERNEL_MAX_BINS // 8, 2, 4, KERNEL_MAX_MELS).permute(0, 1, 3, 2)[:, None]
    mel = torch.cat(tf32_split(w), dim=1).contiguous()
    return KernelBases(dft=dft, mel=mel, n_fft=n_fft, n_bins=n_bins, n_mels=n_mels)


def _check(wins, dft_cos, dft_sin, mel_weights, hop, frames_per_window) -> None:
    tensors = (wins, dft_cos, dft_sin, mel_weights)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("fused_log_mel takes float32 tensors only")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"tensors on different devices: {[str(t.device) for t in tensors]}")
    if wins.ndim != 2 or dft_cos.ndim != 2 or mel_weights.ndim != 2:
        raise ValueError(f"expected wins [N, L], bases [n_fft, n_bins], mel [n_bins, n_mels]; "
                         f"got {wins.shape}, {dft_cos.shape}, {mel_weights.shape}")
    n_fft, n_bins = dft_cos.shape
    if dft_sin.shape != dft_cos.shape or mel_weights.shape[0] != n_bins:
        raise ValueError(f"bases {dft_cos.shape}, {dft_sin.shape} and mel {mel_weights.shape} "
                         "do not agree")
    if wins.shape[0] == 0 or n_fft // 2 >= wins.shape[1] or hop <= 0:
        raise ValueError(f"wins {wins.shape} too short for n_fft {n_fft}, or hop {hop} <= 0")
    if (frames_per_window - 1) * hop + n_fft > wins.shape[1] + 2 * (n_fft // 2):
        raise ValueError(f"{frames_per_window} frames at hop {hop} overrun the padded window")


def fused_log_mel(wins: torch.Tensor, dft_cos: torch.Tensor, dft_sin: torch.Tensor,
                  mel_weights: torch.Tensor, hop: int, frames_per_window: int,
                  bases: KernelBases | None = None) -> torch.Tensor:
    """[N, window_samples] f32 -> [N, frames_per_window, n_mels] f32.

    The function of ``log_mel_reference``; on a CUDA tensor it is two kernel launches:
    the framed DFT, power, mel and log10 with each tile's maximum, then the per-window
    clamp in place. ``bases``: these bases' ``prepare_bases`` (made here when None)."""
    _check(wins, dft_cos, dft_sin, mel_weights, hop, frames_per_window)
    if wins.device.type == "cpu":
        return log_mel_reference(wins, dft_cos, dft_sin, mel_weights, hop, frames_per_window)
    if wins.device.type != "cuda":
        raise ValueError(f"fused_log_mel runs on cuda (kernel) or cpu (reference), "
                         f"not {wins.device}")
    n, length = wins.shape
    n_fft, n_bins = dft_cos.shape
    n_mels = mel_weights.shape[1]
    if n > 65535 or hop % 8 or n_mels % 8:
        raise ValueError(f"the CUDA kernel takes <= 65535 windows, hop and n_mels multiples "
                         f"of 8; got {n}, {hop}, {n_mels}")
    if bases is None:
        bases = prepare_bases(dft_cos, dft_sin, mel_weights)
    elif (bases.n_fft, bases.n_bins, bases.n_mels) != (n_fft, n_bins, n_mels) or \
            bases.dft.device != wins.device:
        raise ValueError("the prepared bases are not these bases' layout on this device")
    wins = wins.contiguous()
    lib = _build.load_library()   # builds csrc/*.cu on first use
    tiles = -(-frames_per_window // TILE_FRAMES)
    out = torch.empty((n, frames_per_window, n_mels), dtype=torch.float32, device=wins.device)
    tile_max = torch.empty((n, tiles), dtype=torch.float32, device=wins.device)
    with torch.cuda.device(wins.device):
        stream = torch.cuda.current_stream(wins.device).cuda_stream
        start = LAUNCHES.start(wins.device)
        err = lib.af_log_mel_power(wins.data_ptr(), bases.dft.data_ptr(), bases.mel.data_ptr(),
                                   out.data_ptr(), tile_max.data_ptr(), n, length,
                                   frames_per_window, hop, n_fft, n_mels, stream)
        if err != 0:
            raise RuntimeError(f"log_mel power kernel launch failed with CUDA error {err}")
        LAUNCHES.record(("log_mel", tuple(wins.shape)), wins.device, start)
        start = LAUNCHES.start(wins.device)
        err = lib.af_log_mel_clamp(out.data_ptr(), tile_max.data_ptr(), n, frames_per_window,
                                   n_mels, stream)
        if err != 0:
            raise RuntimeError(f"log_mel clamp kernel launch failed with CUDA error {err}")
        LAUNCHES.record(("clamp", tuple(out.shape)), wins.device, start)
    return out
