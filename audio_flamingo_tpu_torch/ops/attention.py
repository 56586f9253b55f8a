"""Plain grouped-query attention and its masks.

The same function as ``audio_flamingo_tpu/ops/attention.gqa_attention``: scores and P.V
accumulate in f32 (bf16 inputs are widened, which is exact), the softmax runs in f32 and
the probabilities are rounded to q.dtype before P.V; KV heads are grouped by reshaping q,
never repeated. Decode attention and every non-flash path use it.
"""

from __future__ import annotations

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: torch.Tensor | None = None, scale: float | None = None) -> torch.Tensor:
    """q [b, q_len, nh, hd], k/v [b, kv_len, nkv, hd]; mask bool [b, 1|nh, q_len, kv_len]
    (True = attend). Returns [b, q_len, nh, hd] in q.dtype."""
    b, q_len, nh, hd = q.shape
    kv_len, nkv = k.shape[1], k.shape[2]
    if nh % nkv:
        raise ValueError(f"num_heads {nh} is not a multiple of num_kv_heads {nkv}")
    group = nh // nkv
    if scale is None:
        scale = hd ** -0.5
    qg = q.reshape(b, q_len, nkv, group, hd).float()
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) * scale
    if mask is not None:
        if mask.ndim != 4:
            raise ValueError(f"mask must be rank-4, got {tuple(mask.shape)}")
        if mask.shape[1] == 1:
            m = mask[:, :, None]
        else:
            m = mask.reshape(b, nkv, group, q_len, kv_len)
        scores = scores.masked_fill(~m, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype).float()
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v.float())
    return out.reshape(b, q_len, nh, hd).to(q.dtype)


def causal_mask(q_len: int, kv_len: int, q_offset: int = 0,
                device: torch.device | str | None = None) -> torch.Tensor:
    """Bool [1, 1, q_len, kv_len]: query i (global index q_offset + i) sees keys <= it."""
    q_ids = torch.arange(q_len, device=device)[:, None] + q_offset
    kv_ids = torch.arange(kv_len, device=device)[None, :]
    return (kv_ids <= q_ids)[None, None]
