"""Fused w4 decode-layer suffixes (K6): the hand-written Hopper kernels and their plain
PyTorch versions.

Replaces the Pallas TPU kernels ``audio_flamingo_tpu/ops/pallas/quant4_block.py``
``w4_suffix_a`` (:225), ``w4_suffix_b`` (:288) and their eligibility rule
``suffix_supported`` (:351). A decode layer on a fused w4 tree runs its matmuls in two
calls around the attention:

- A: o-proj + residual, f32 RMSNorm x ln2, gate|up, silu * up -> (act, h)
- B: down-proj + residual, f32 RMSNorm x the next layer's ln1, the next layer's qkv
  -> (h2, qkv_next); the caller adds the qkv bias.

The norm is the Pallas kernel's ``_rms`` (``(h * rsqrt(mean(h^2) + eps)) * f32(w)`` in
f32, the normed row rounded to the dtype only as the next product's input), not the
model's ``rms_norm``. The weights are the layer-stacked w4 dicts of ``ops/quant4.py``,
read in place at the layer's offset. The CUDA source is ``csrc/w4_suffix.cu``: each call
is four launches (the K5 GEMV, a row kernel, the GEMV, a reduce), counted here as one
launch of the suffix.

Dispatch is by the tensors' device: a CPU tensor goes to the plain version; a CUDA tensor
launches the kernels or raises. There is no fallback between the two.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from audio_flamingo_tpu_torch.ops.kernels import _build
from audio_flamingo_tpu_torch.ops.kernels import w4a16_matmul as k5
from audio_flamingo_tpu_torch.ops.kernels.launches import LaunchCounter

MAX_ROWS = 8   # the Pallas kernels' row limit, kept so the port takes the path where JAX does

LAUNCHES_A = LaunchCounter()   # key: (m, layer); inputs: the call's arguments
LAUNCHES_B = LaunchCounter()   # key: (m, layer, next layer); inputs: the call's arguments


def suffix_supported(stacked: dict | None, cfg) -> bool:
    """The two-call path needs the full fused stacked set (qkv, o, mlp.gateup, mlp.down)
    and, as the Pallas kernels did, K/2 a multiple of 128 for d, f and the o-proj's K."""
    if stacked is None or not all(k in stacked for k in ("qkv", "o")):
        return False
    if "mlp" not in stacked or not all(k in stacked["mlp"] for k in ("gateup", "down")):
        return False
    k_o = cfg.num_heads * cfg.resolved_head_dim()
    return all((k // 2) % 128 == 0 for k in (cfg.hidden_size, cfg.intermediate_size, k_o))


def _rms(h: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    var = (h * h).mean(dim=-1, keepdim=True)
    return (h * torch.rsqrt(var + eps)) * w.float()


def _layer(p: dict, layer: int):
    return p["w_p"][layer], p["gscale"][layer]


def w4_suffix_a_reference(attn2d, h_res, ln2_w, o_p, gu_p, layer: int, eps: float = 1e-6):
    """Plain version of suffix A -> (act [m, F], h [m, D]) in attn2d.dtype."""
    dt = attn2d.dtype
    h = k5.w4a16_product_f32(attn2d, *_layer(o_p, layer)) + h_res.float()
    gu = k5.w4a16_product_f32(_rms(h, ln2_w, eps).to(dt), *_layer(gu_p, layer))
    f = gu.shape[-1] // 2
    return (F.silu(gu[:, :f]) * gu[:, f:]).to(dt), h.to(dt)


def w4_suffix_b_reference(act, h, ln1_next, down_p, qkv_p, layer: int, next_layer: int,
                          eps: float = 1e-6):
    """Plain version of suffix B -> (h2 [m, D], qkv_next [m, Nqkv]) in act.dtype."""
    dt = act.dtype
    h2 = k5.w4a16_product_f32(act, *_layer(down_p, layer)) + h.float()
    qkv = k5.w4a16_product_f32(_rms(h2, ln1_next, eps).to(dt), *_layer(qkv_p, next_layer))
    return h2.to(dt), qkv.to(dt)


def _check(x, res, norm_w, first, second, layers, what: str) -> tuple[int, int]:
    """Validate a suffix call; returns the two products' group sizes."""
    m = x.shape[0]
    if not 0 < m <= MAX_ROWS:
        raise ValueError(f"{what} takes 1..{MAX_ROWS} rows, got {m}")
    if res.ndim != 2 or res.shape[0] != m or res.dtype != x.dtype or res.device != x.device:
        raise ValueError(f"{what}: residual {tuple(res.shape)} {res.dtype} does not match "
                         f"x {tuple(x.shape)} {x.dtype}")
    d = res.shape[1]
    for p, layer in zip((first, second), layers):
        if p["w_p"].ndim != 3 or not 0 <= layer < p["w_p"].shape[0]:
            raise ValueError(f"{what}: layer {layer} of stacked w_p {tuple(p['w_p'].shape)}")
    g1 = k5.check_operands(x, *_layer(first, layers[0]))
    if first["w_p"].shape[2] != d or norm_w.shape != (d,):
        raise ValueError(f"{what}: first product's N {first['w_p'].shape[2]} or norm weight "
                         f"{tuple(norm_w.shape)} != hidden size {d}")
    g2 = k5.check_operands(res, *_layer(second, layers[1]))
    return g1, g2


def _stacked_ptrs(p: dict, layer: int) -> tuple[int, int]:
    w_p, gscale = p["w_p"], p["gscale"]
    if not (w_p.is_contiguous() and gscale.is_contiguous()):
        raise ValueError("stacked w_p and gscale must be contiguous (read in place)")
    return (w_p.data_ptr() + layer * w_p.stride(0) * w_p.element_size(),
            gscale.data_ptr() + layer * gscale.stride(0) * gscale.element_size())


def _prepare(x, groups, products):
    """Shared CUDA set-up: library, splits per product, scratch (hn, partials)."""
    if x.device.type != "cuda":
        raise ValueError(f"w4 suffixes run on cuda (kernels) or cpu (reference), not {x.device}")
    if max(groups) > k5.MAX_GROUP:
        raise ValueError(f"the CUDA kernels take groups up to {k5.MAX_GROUP}, got {groups}")
    m = x.shape[0]
    splits = [k5.split_k(n, kp // g) for (kp, n), g in zip(products, groups)]
    scratch = max(s * m * n for s, (_, n) in zip(splits, products))
    return (_build.load_library(), splits,
            torch.empty(scratch, dtype=torch.float32, device=x.device))


def w4_suffix_a(attn2d: torch.Tensor, h_res: torch.Tensor, ln2_w: torch.Tensor, o_p: dict,
                gu_p: dict, layer: int, eps: float = 1e-6):
    """(attn_out [m, K_o], h [m, D]) -> (act [m, F], h [m, D]): o-proj + residual + f32
    RMSNorm x ln2 + gate|up + silu * up, for layer ``layer`` of the stacked w4 dicts."""
    layer = int(layer)
    g_o, g_g = _check(attn2d, h_res, ln2_w, o_p, gu_p, (layer, layer), "w4_suffix_a")
    if attn2d.device.type == "cpu":
        return w4_suffix_a_reference(attn2d, h_res, ln2_w, o_p, gu_p, layer, eps)
    m, k_o = attn2d.shape
    d = h_res.shape[1]
    n_gu = gu_p["w_p"].shape[2]
    lib, (s_o, s_g), partials = _prepare(attn2d, (g_o, g_g), ((k_o // 2, d), (d // 2, n_gu)))
    attn2d, h_res = attn2d.contiguous(), h_res.contiguous()
    act = torch.empty((m, n_gu // 2), dtype=attn2d.dtype, device=attn2d.device)
    h_out = torch.empty_like(h_res)
    hn = torch.empty_like(h_res)
    norm_w = ln2_w.float().contiguous()
    with torch.cuda.device(attn2d.device):
        stream = torch.cuda.current_stream(attn2d.device).cuda_stream
        start = LAUNCHES_A.start(attn2d.device)
        err = lib.af_w4_suffix_a(attn2d.data_ptr(), h_res.data_ptr(), norm_w.data_ptr(),
                                 *_stacked_ptrs(o_p, layer), *_stacked_ptrs(gu_p, layer),
                                 act.data_ptr(), h_out.data_ptr(), hn.data_ptr(),
                                 partials.data_ptr(), k5.DTYPE_CODES[attn2d.dtype], m, k_o, d,
                                 n_gu // 2, g_o, g_g, s_o, s_g, float(eps), stream)
    if err != 0:
        raise RuntimeError(f"w4_suffix_a kernel launch failed with CUDA error {err}")
    LAUNCHES_A.record((m, layer), attn2d.device, start,
                      (attn2d, h_res, ln2_w, o_p, gu_p, layer, eps))
    return act, h_out


def w4_suffix_b(act: torch.Tensor, h: torch.Tensor, ln1_next: torch.Tensor, down_p: dict,
                qkv_p: dict, layer: int, next_layer: int, eps: float = 1e-6):
    """(act [m, F], h [m, D]) -> (h2 [m, D], qkv_next [m, Nqkv]): down-proj (layer
    ``layer``) + residual + f32 RMSNorm x ln1_next + qkv of layer ``next_layer``."""
    layer, next_layer = int(layer), int(next_layer)
    g_d, g_q = _check(act, h, ln1_next, down_p, qkv_p, (layer, next_layer), "w4_suffix_b")
    if act.device.type == "cpu":
        return w4_suffix_b_reference(act, h, ln1_next, down_p, qkv_p, layer, next_layer, eps)
    m, f = act.shape
    d = h.shape[1]
    n_qkv = qkv_p["w_p"].shape[2]
    lib, (s_d, s_q), partials = _prepare(act, (g_d, g_q), ((f // 2, d), (d // 2, n_qkv)))
    act, h = act.contiguous(), h.contiguous()
    h_out = torch.empty_like(h)
    hn = torch.empty_like(h)
    qkv = torch.empty((m, n_qkv), dtype=act.dtype, device=act.device)
    norm_w = ln1_next.float().contiguous()
    with torch.cuda.device(act.device):
        stream = torch.cuda.current_stream(act.device).cuda_stream
        start = LAUNCHES_B.start(act.device)
        err = lib.af_w4_suffix_b(act.data_ptr(), h.data_ptr(), norm_w.data_ptr(),
                                 *_stacked_ptrs(down_p, layer), *_stacked_ptrs(qkv_p, next_layer),
                                 h_out.data_ptr(), qkv.data_ptr(), hn.data_ptr(),
                                 partials.data_ptr(), k5.DTYPE_CODES[act.dtype], m, f, d, n_qkv,
                                 g_d, g_q, s_d, s_q, float(eps), stream)
    if err != 0:
        raise RuntimeError(f"w4_suffix_b kernel launch failed with CUDA error {err}")
    LAUNCHES_B.record((m, layer, next_layer), act.device, start,
                      (act, h, ln1_next, down_p, qkv_p, layer, next_layer, eps))
    return h_out, qkv
