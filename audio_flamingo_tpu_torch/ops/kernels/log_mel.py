"""Fused Whisper log-mel: the hand-written Hopper kernel and its plain PyTorch version.

Replaces the Pallas TPU kernel ``audio_flamingo_tpu/ops/pallas/stft_mel.py``
(``fused_log_mel`` :58, kernels ``_logmel_kernel`` :32 and ``_clamp_kernel`` :50). The
CUDA source is ``csrc/log_mel.cu``; its header states the kernels' design and what
bounds them on the H100 (f32 CUDA-core FLOPs).

Dispatch is by the tensors' device: a CPU tensor goes to ``log_mel_reference``; a CUDA
tensor launches the two kernels or raises. There is no fallback between the two.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from audio_flamingo_tpu_torch.ops.kernels import _build
from audio_flamingo_tpu_torch.ops.kernels.launches import LaunchCounter

LAUNCHES = LaunchCounter()   # key: (kernel name, its main operand's shape); no inputs kept
KERNEL_MAX_BINS = 224        # csrc/log_mel.cu kNB
KERNEL_MAX_MELS = 128        # csrc/log_mel.cu kNM


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
                  mel_weights: torch.Tensor, hop: int, frames_per_window: int) -> torch.Tensor:
    """[N, window_samples] f32 -> [N, frames_per_window, n_mels] f32.

    The function of ``log_mel_reference``; on a CUDA tensor it is two kernel launches:
    the framed DFT, power, mel and log10, then the per-window clamp in place."""
    _check(wins, dft_cos, dft_sin, mel_weights, hop, frames_per_window)
    if wins.device.type == "cpu":
        return log_mel_reference(wins, dft_cos, dft_sin, mel_weights, hop, frames_per_window)
    if wins.device.type != "cuda":
        raise ValueError(f"fused_log_mel runs on cuda (kernel) or cpu (reference), "
                         f"not {wins.device}")
    n, length = wins.shape
    n_fft, n_bins = dft_cos.shape
    n_mels = mel_weights.shape[1]
    if n_bins > KERNEL_MAX_BINS or n_mels > KERNEL_MAX_MELS or n > 65535:
        raise ValueError(f"the CUDA kernel takes <= {KERNEL_MAX_BINS} bins, <= "
                         f"{KERNEL_MAX_MELS} mels and <= 65535 windows; got {n_bins}, "
                         f"{n_mels}, {n}")
    wins, dft_cos, dft_sin, mel_weights = (
        t.contiguous() for t in (wins, dft_cos, dft_sin, mel_weights))
    lib = _build.load_library()   # builds csrc/*.cu on first use
    out = torch.empty((n, frames_per_window, n_mels), dtype=torch.float32, device=wins.device)
    with torch.cuda.device(wins.device):
        stream = torch.cuda.current_stream(wins.device).cuda_stream
        start = LAUNCHES.start(wins.device)
        err = lib.af_log_mel_power(wins.data_ptr(), dft_cos.data_ptr(), dft_sin.data_ptr(),
                                   mel_weights.data_ptr(), out.data_ptr(), n, length,
                                   frames_per_window, hop, n_fft, n_bins, n_mels, stream)
        if err != 0:
            raise RuntimeError(f"log_mel power kernel launch failed with CUDA error {err}")
        LAUNCHES.record(("log_mel", tuple(wins.shape)), wins.device, start)
        start = LAUNCHES.start(wins.device)
        err = lib.af_log_mel_clamp(out.data_ptr(), n, frames_per_window * n_mels, stream)
        if err != 0:
            raise RuntimeError(f"log_mel clamp kernel launch failed with CUDA error {err}")
        LAUNCHES.record(("clamp", tuple(out.shape)), wins.device, start)
    return out
