"""CLAP mel frontend helpers, as ``audio_flamingo_tpu/audio/clap_mel.py``.

Only ``frame_signal`` so far: the exact strided framing that the Griffin-Lim and neural
vocoders share (audio/vocoder.py, audio/neural_vocoder.py). The CLAP frontend itself comes
with the AF1/AF2 family.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def frame_signal(padded: torch.Tensor, n_fft: int, hop: int, num_frames: int) -> torch.Tensor:
    """[N, L] centered-padded signal -> [N, num_frames, n_fft], exact strided slices
    (frame i is ``padded[:, i * hop : i * hop + n_fft]``; a signal too short for the last
    frame is zero-padded at its end, as JAX's block framing does)."""
    need = (num_frames - 1) * hop + n_fft
    if padded.shape[-1] < need:
        padded = F.pad(padded, (0, need - padded.shape[-1]))
    return padded.unfold(-1, n_fft, hop)[:, :num_frames]
