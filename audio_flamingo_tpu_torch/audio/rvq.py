"""Residual vector quantization (RVQ) mel codec, as ``audio_flamingo_tpu/audio/rvq.py``.

The streaming TTS head's discrete acoustic target (models/tts.py, RVQ mode): each mel
frame becomes ``num_quantizers`` codebook indices, and decoding sums the chosen codes
back into a frame. ``RVQ`` holds the codebooks and their EMA statistics as buffers.
Training is EMA k-means (no codebook gradients): ``ema_update`` refreshes the codebooks
from a batch's statistics in place; ``quantize`` gives the straight-through estimator and
the commitment loss for an upstream encoder.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from audio_flamingo_tpu_torch.device import resolve_device


@dataclass(frozen=True)
class RVQConfig:
    dim: int = 80                  # mel bins
    num_quantizers: int = 4
    codebook_size: int = 256
    ema_decay: float = 0.99
    commit_weight: float = 0.25


class RVQ(nn.Module):
    def __init__(self, cfg: RVQConfig, **factory):
        super().__init__()
        q, k, d = cfg.num_quantizers, cfg.codebook_size, cfg.dim
        self.register_buffer("codebooks", torch.empty(q, k, d, **factory))
        self.register_buffer("ema_count", torch.empty(q, k, **factory))
        self.register_buffer("ema_sum", torch.empty(q, k, d, **factory))


@torch.no_grad()
def init(cfg: RVQConfig, generator: torch.Generator | None = None,
         data: torch.Tensor | None = None, device: torch.device | str | None = None) -> RVQ:
    """N(0, 0.5^2) codebooks, or, from ``data`` [N, dim] (N >= codebook_size), greedy
    layer-wise: codebook q is drawn (with replacement) from the residuals left by
    codebooks 0..q-1, so each stage lives at its own residual scale."""
    device = resolve_device(device) if data is None else data.device
    q, k, d = cfg.num_quantizers, cfg.codebook_size, cfg.dim
    codec = RVQ(cfg, dtype=torch.float32, device=device)
    if data is not None and data.shape[0] >= k:
        residual = data.to(torch.float32)
        for qi in range(q):
            idx = torch.randint(residual.shape[0], (k,), generator=generator, device=device)
            book = residual[idx]
            codec.codebooks[qi] = book
            residual = residual - book[_nearest(residual, book)]
    else:
        codec.codebooks.normal_(0.0, 0.5, generator=generator)
    codec.ema_count.fill_(1.0)
    codec.ema_sum.copy_(codec.codebooks)
    return codec


def _nearest(residual: torch.Tensor, book: torch.Tensor) -> torch.Tensor:
    """residual [..., dim], book [K, dim] -> indices [...]: the squared-L2 argmin through
    the expanded form, argmin_k |b_k|^2 - 2 r.b_k (|r|^2 does not depend on k)."""
    dots = residual @ book.T                                   # [..., K]
    norms = torch.sum(book ** 2, dim=-1)
    return torch.argmin(norms - 2 * dots, dim=-1)


def encode(codec: RVQ, cfg: RVQConfig, x: torch.Tensor) -> torch.Tensor:
    """x [..., dim] -> codes [..., num_quantizers] int32."""
    residual = x
    codes = []
    for qi in range(cfg.num_quantizers):
        book = codec.codebooks[qi]
        idx = _nearest(residual, book)
        codes.append(idx.to(torch.int32))
        residual = residual - book[idx]
    return torch.stack(codes, dim=-1)


def decode(codec: RVQ, cfg: RVQConfig, codes: torch.Tensor) -> torch.Tensor:
    """codes [..., num_quantizers] -> x_hat [..., dim]."""
    out = 0.0
    for qi in range(cfg.num_quantizers):
        out = out + codec.codebooks[qi][codes[..., qi].long()]
    return out


def quantize(codec: RVQ, cfg: RVQConfig, x: torch.Tensor):
    """Straight-through quantization: (x_q with the identity gradient to x, codes,
    commitment loss)."""
    codes = encode(codec, cfg, x.detach())
    x_q = decode(codec, cfg, codes)
    commit = cfg.commit_weight * torch.mean((x - x_q.detach()) ** 2)
    x_st = x + (x_q - x).detach()
    return x_st, codes, commit


@torch.no_grad()
def ema_update(codec: RVQ, cfg: RVQConfig, x: torch.Tensor) -> RVQ:
    """One EMA k-means step over frames x [N, dim], in place (JAX donates its params).

    Per quantizer: assign the residuals, EMA the per-code counts and vector sums, and
    move each code to ema_sum / ema_count; a dead code (count <= 1e-3) keeps its place.
    The next stage's residuals subtract the old book at the same assignments."""
    books, counts, sums = codec.codebooks, codec.ema_count, codec.ema_sum
    d = cfg.ema_decay
    residual = x
    new_books, new_counts, new_sums = [], [], []
    for qi in range(cfg.num_quantizers):
        book = books[qi]
        idx = _nearest(residual, book)
        onehot = F.one_hot(idx, cfg.codebook_size).to(x.dtype)        # [N, K]
        cnt = counts[qi] * d + onehot.sum(0) * (1 - d)
        vsum = sums[qi] * d + onehot.T @ residual * (1 - d)
        nb = vsum / torch.clamp(cnt[:, None], min=1e-5)
        nb = torch.where(cnt[:, None] > 1e-3, nb, book)
        new_books.append(nb)
        new_counts.append(cnt)
        new_sums.append(vsum)
        residual = residual - book[idx]
    codec.codebooks.copy_(torch.stack(new_books))
    codec.ema_count.copy_(torch.stack(new_counts))
    codec.ema_sum.copy_(torch.stack(new_sums))
    return codec


@torch.no_grad()
def train_codebooks(cfg: RVQConfig, batches, generator: torch.Generator | None = None,
                    device: torch.device | str | None = None) -> tuple[RVQ, list[float]]:
    """EMA k-means over an iterable of [N, dim] frame batches, the codebooks initialized
    from the first. Returns (codec, reconstruction-MSE history)."""
    device = resolve_device(device)
    codec = None
    history = []
    for batch in batches:
        flat = torch.as_tensor(batch, dtype=torch.float32, device=device).reshape(-1, cfg.dim)
        if codec is None:
            codec = init(cfg, generator, data=flat)
        ema_update(codec, cfg, flat)
        rec = decode(codec, cfg, encode(codec, cfg, flat))
        history.append(float(torch.mean((rec - flat) ** 2)))
    return codec, history
