"""Weight-only int4 quantization (w4a16, group-wise scales), as
``audio_flamingo_tpu/ops/quant4.py``.

Scales are per group of ``group_size`` input rows per output column, symmetric, codes in
[-7, 7]. Packing is the "halves" layout: for a [K, N] matrix the packed int8 array has
K/2 rows, where row i holds w[i] in the LOW nibble and w[i + K/2] in the HIGH nibble, so
a product is

    y = sum over groups of (x[:, lo rows] @ lo codes) * s_lo + (x[:, hi rows] @ hi codes) * s_hi

with the group scales ``gscale [K/G, N]`` (low-half groups first, then the high half)
applied to the f32 partial products. ``q4_matmul`` keeps the JAX package's dispatch rule
word for word: the kernel (K5, ``ops/kernels/w4a16_matmul.py``) for ``m <= 256`` rows and
``n % min(512, n) == 0``, else the weights are dequantized to x.dtype for a plain
product. The two routes round differently in bf16 (the kernel scales the f32 partial
products; the dequant route rounds ``w_q * s`` to bf16), so taking JAX's route on every
call is what makes the port match it.
"""

from __future__ import annotations

import torch

from audio_flamingo_tpu_torch.ops import quant
from audio_flamingo_tpu_torch.ops.kernels import w4a16_matmul as k5

DEFAULT_GROUP = 128
KERNEL_MAX_ROWS = 256   # decode-side row threshold of the kernel route (JAX _PALLAS_MAX_ROWS)


def supports_w4(k: int, group_size: int = DEFAULT_GROUP) -> bool:
    """Halves packing with group alignment needs K/2 to divide into whole groups."""
    return k % (2 * group_size) == 0


def pack_w4(w_q: torch.Tensor) -> torch.Tensor:
    """int (-8..7) [..., K, N] -> packed int8 [..., K/2, N] (halves layout)."""
    k = w_q.shape[-2]
    if k % 2:
        raise ValueError(f"K = {k} is odd")
    lo = w_q[..., : k // 2, :].to(torch.int32)
    hi = w_q[..., k // 2:, :].to(torch.int32)
    return ((hi << 4) | (lo & 0x0F)).to(torch.int8)


def unpack_w4(w_p: torch.Tensor) -> torch.Tensor:
    """packed int8 [..., K/2, N] -> int8 values (-8..7) [..., K, N]."""
    return torch.cat([k5.low_nibble(w_p), k5.high_nibble(w_p)], dim=-2).to(torch.int8)


def quantize_linear_w4(w: torch.Tensor, group_size: int = DEFAULT_GROUP) -> dict:
    """[K, N] (or stacked [L, K, N]) float -> {'w_p': int8 [.., K/2, N],
    'gscale': f32 [.., K/G, N]}, both contiguous: s = max|w_group| / 7 (a true division on
    every device), w_q = round(w / s) in [-7, 7]."""
    k, n = w.shape[-2], w.shape[-1]
    if not supports_w4(k, group_size):
        raise ValueError(f"K = {k} does not split into whole groups of {group_size} per half")
    lead = w.shape[:-2]
    wf = w.float().reshape(*lead, k // group_size, group_size, n)
    gscale = quant.true_div(torch.clamp(wf.abs().amax(dim=-2), min=1e-8), 7.0)
    w_q = torch.clamp(torch.round(wf / gscale.unsqueeze(-2)), -7, 7)
    # contiguous whatever w's strides (a transposed Linear weight keeps them through the
    # elementwise steps): K5 reads the codes row-major and would copy them on every call
    return {"w_p": pack_w4(w_q.reshape(*lead, k, n).to(torch.int8)).contiguous(),
            "gscale": gscale.contiguous()}


def dequantize_w4(p: dict, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Packed dict -> [.., K, N] weights in ``dtype``: each code times its f32 group scale
    in f32, rounded once. Each half is unpacked in int8 (as the JAX package's
    ``_sign_extend_low/high``) and scaled by broadcasting, so no int32 or full-size f32
    copy of the matrix is made."""
    w_p, gscale = p["w_p"], p["gscale"]
    lead, (kp, n) = w_p.shape[:-2], w_p.shape[-2:]
    ng = gscale.shape[-2] // 2
    out = torch.empty((*lead, 2 * kp, n), dtype=dtype, device=w_p.device)
    for half, codes in ((0, (w_p << 4) >> 4), (1, w_p >> 4)):
        scaled = (codes.reshape(*lead, ng, kp // ng, n)
                  * gscale[..., half * ng:(half + 1) * ng, None, :])
        out[..., half * kp:(half + 1) * kp, :] = scaled.reshape(*lead, kp, n)
    return out


def _dequant_product(x2: torch.Tensor, p: dict) -> torch.Tensor:
    return (x2 @ dequantize_w4(p, dtype=x2.dtype)).to(x2.dtype)


def _kernel_route(m: int, n: int) -> bool:
    return m <= KERNEL_MAX_ROWS and n % min(512, n) == 0


def q4_matmul(x: torch.Tensor, p: dict) -> torch.Tensor:
    """[..., K] @ w4-packed [K, N] -> [..., N] in x.dtype (JAX's route, see the module)."""
    x2 = x.reshape(-1, x.shape[-1])
    if _kernel_route(x2.shape[0], p["w_p"].shape[-1]):
        y = k5.w4a16_matmul(x2, p["w_p"], p["gscale"])
    else:
        y = _dequant_product(x2, p)
    return y.reshape(*x.shape[:-1], y.shape[-1])


def q4_matmul_stacked(x: torch.Tensor, p: dict, layer: int) -> torch.Tensor:
    """[..., K] @ layer ``layer`` of a stacked w4 dict {'w_p' [L, K/2, N], 'gscale'
    [L, K/G, N] (, 'b' [L, N])} -> [..., N], bias included. The kernel route reads the
    layer in place (a pointer offset into the stacks); no slice is copied."""
    x2 = x.reshape(-1, x.shape[-1])
    if _kernel_route(x2.shape[0], p["w_p"].shape[-1]):
        y = k5.w4a16_matmul_stacked(x2, p["w_p"], p["gscale"], layer)
    else:
        y = _dequant_product(x2, {"w_p": p["w_p"][layer], "gscale": p["gscale"][layer]})
    if "b" in p:
        y = y + p["b"][layer].to(y.dtype)
    return y.reshape(*x.shape[:-1], y.shape[-1])


def quantize_lm_params_w4(state: dict, group_size: int = DEFAULT_GROUP, fuse: bool = True,
                          head_w4: bool = False) -> dict:
    """The float LM's state dict (port names) -> the JAX package's w4 tree.

    Layer linears go to int4; the embedding (a gather) and lm_head stay int8, lm_head in
    int4 only with ``head_w4``. A linear whose K does not split into groups falls back to
    int8. With ``fuse`` (and an aligned hidden size) q|k|v become one ``qkv`` matrix and
    gate|up one ``mlp.gateup``: groups run along K and columns are independent, so the
    codes equal separate quantization."""
    layers = quant.float_layer_leaves(state)

    def quant_any(w):
        if supports_w4(w.shape[-2], group_size):
            return quantize_linear_w4(w, group_size)
        return quant.quantize_linear(w)

    if fuse and supports_w4(state["layers.0.q_proj.weight"].shape[1], group_size):
        names = [quant.LINEARS[n] for n in ("q", "k", "v")]
        qkv_w = (torch.cat(ws, dim=1) for ws in zip(
            *(quant.layer_weights(state, n) for n in names)))
        layers["qkv"] = quant.quantize_per_layer(
            lambda w: quantize_linear_w4(w, group_size), qkv_w)
        if "layers.0.q_proj.bias" in state:
            layers["qkv"]["b"] = torch.cat([quant.stack_layers(state, f"{n}.bias")
                                            for n in names], dim=-1)
        layers["o"] = quant.quantized_linear_tree(state, "o_proj", quant_any)
        gate, up = (quant.layer_weights(state, quant.MLP[n]) for n in ("gate", "up"))
        layers["mlp"] = {
            "gateup": quant.quantize_per_layer(
                lambda w: quantize_linear_w4(w, group_size),
                (torch.cat([g, u], dim=1) for g, u in zip(gate, up))),
            "down": quant.quantize_per_layer(quant_any,
                                             quant.layer_weights(state, "down_proj")),
        }
    else:
        for name, module in quant.LINEARS.items():
            layers[name] = quant.quantized_linear_tree(state, module, quant_any)
        layers["mlp"] = {name: quant.quantize_per_layer(quant_any,
                                                        quant.layer_weights(state, module))
                         for name, module in quant.MLP.items()}
    out = {"layers": layers, **quant.head_and_embed(state)}
    if "lm_head" in state:
        head = state["lm_head"].t()
        out["lm_head"] = (quantize_linear_w4(head, group_size)
                          if head_w4 and supports_w4(head.shape[0], group_size)
                          else quant.quantize_linear(head))
    return out


def random_quantized_lm_w4(generator: torch.Generator, cfg, device: torch.device | str,
                           group_size: int = DEFAULT_GROUP, fuse: bool = True,
                           head_w4: bool = False) -> dict:
    """Random w4 LM tree in the layout of ``quantize_lm_params_w4``, made on ``device``
    without float weights: packed bytes uniform over int8, group scales 0.02 / 7, int8
    embedding and head codes in [-127, 127] with scales 0.02 / 127."""
    hd = cfg.resolved_head_dim()
    d, f, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    n_q, n_kv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    kw = dict(device=device)

    def q4lin(a, b, lead=(L,)):
        if not supports_w4(a, group_size):
            raise ValueError(f"K = {a} does not split into groups of {group_size}")
        return {"w_p": torch.randint(-128, 128, (*lead, a // 2, b), dtype=torch.int8,
                                     generator=generator, **kw),
                "gscale": torch.full((*lead, a // group_size, b), 0.02 / 7.0, **kw)}

    def int8_table(a, b, n_scales):
        return {"w_q": torch.randint(-127, 128, (a, b), dtype=torch.int8,
                                     generator=generator, **kw),
                "scale": torch.full((n_scales,), 0.02 / 127.0, **kw)}

    if fuse:
        layers = {"qkv": q4lin(d, n_q + 2 * n_kv), "o": q4lin(n_q, d),
                  "mlp": {"gateup": q4lin(d, 2 * f), "down": q4lin(f, d)}}
        if cfg.attention_bias:
            layers["qkv"]["b"] = torch.zeros((L, n_q + 2 * n_kv), **kw)
    else:
        layers = {"q": q4lin(d, n_q), "k": q4lin(d, n_kv), "v": q4lin(d, n_kv),
                  "o": q4lin(n_q, d),
                  "mlp": {"gate": q4lin(d, f), "up": q4lin(d, f), "down": q4lin(f, d)}}
        if cfg.attention_bias:
            for name, n in (("q", n_q), ("k", n_kv), ("v", n_kv)):
                layers[name]["b"] = torch.zeros((L, n), **kw)
    layers["ln1_w"] = torch.ones((L, d), **kw)
    layers["ln2_w"] = torch.ones((L, d), **kw)
    params = {"embed": int8_table(cfg.vocab_size, d, cfg.vocab_size), "layers": layers,
              "ln_f_w": torch.ones((d,), **kw)}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = (q4lin(d, cfg.vocab_size, lead=()) if head_w4
                             else int8_table(d, cfg.vocab_size, cfg.vocab_size))
    return params
