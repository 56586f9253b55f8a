"""Qwen2 / Qwen2.5 decoder, as ``audio_flamingo_tpu/models/qwen2.py``.

RMSNorm pre-norm layers, q/k/v biases and a bias-free o_proj, RoPE (rotate_half),
SwiGLU MLP, a fixed-capacity KV cache written at an offset (slot s holds absolute
position s), and the per-layer sliding-window gate (layer i slides iff
``sliding_window`` is set and i >= ``max_window_layers``). ``forward`` takes input
embeddings so audio tokens can be scattered in upstream (models/af3.py).

Attention goes to the flash-attention kernel only on a fresh multi-token prefill with a
purely causal mask (no extra mask, no sliding layer), as in the JAX ``forward``; every
other call (decode, warm cache, masked) uses plain ``gqa_attention``.

Unlike the JAX cache, ``KVCache`` is updated in place: prefill and decode write their
K/V into the preallocated tensors and advance ``index``, so no step copies the cache.

Two weight layouts share ``forward``: ``Qwen2`` (float ``nn.Linear`` layers, torch
layout) and ``QuantQwen2``, a quantized LM held in the JAX package's tree layout (layer
leaves stacked on [L], linears [in, out]): int8 ``{w_q, scale}`` linears
(``ops/quant.py``), int4 ``{w_p, gscale}`` linears (``ops/quant4.py``), fused ``qkv`` and
``mlp.gateup`` when quantized with ``fuse``, an int8 per-row embedding and an int8 or int4
head. A fused w4 tree decodes one token at two suffix calls per layer (K6,
``ops/kernels/w4_suffix.py``) under the JAX condition: a cache, one position, at most 8
rows, no sliding layer and ``suffix_supported``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from audio_flamingo_tpu_torch.config import Qwen2Config
from audio_flamingo_tpu_torch.ops.attention import gqa_attention
from audio_flamingo_tpu_torch.ops.kernels.flash_attention import flash_attention
from audio_flamingo_tpu_torch.ops.kernels.w4_suffix import (suffix_supported, w4_suffix_a,
                                                            w4_suffix_b)
from audio_flamingo_tpu_torch.ops.mlp import swiglu_mlp
from audio_flamingo_tpu_torch.ops.norms import Norm, rms_norm
from audio_flamingo_tpu_torch.ops.quant import int8_mm, q_matmul
from audio_flamingo_tpu_torch.ops.quant4 import q4_matmul, q4_matmul_stacked
from audio_flamingo_tpu_torch.ops.rope import apply_rope, rope_cos_sin


@dataclass
class KVCache:
    """k, v: [num_layers, batch, capacity, num_kv_heads, head_dim]; index: filled slots."""

    k: torch.Tensor
    v: torch.Tensor
    index: int = 0

    @property
    def capacity(self) -> int:
        return self.k.shape[2]


def init_cache(cfg: Qwen2Config, batch: int, capacity: int, dtype: torch.dtype,
               device: torch.device | str) -> KVCache:
    shape = (cfg.num_layers, batch, capacity, cfg.num_kv_heads, cfg.resolved_head_dim())
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: Qwen2Config, **factory):
        super().__init__()
        d, f, hd = cfg.hidden_size, cfg.intermediate_size, cfg.resolved_head_dim()
        bias = cfg.attention_bias
        self.input_layernorm = Norm(d, bias=False, **factory)
        self.q_proj = nn.Linear(d, cfg.num_heads * hd, bias=bias, **factory)
        self.k_proj = nn.Linear(d, cfg.num_kv_heads * hd, bias=bias, **factory)
        self.v_proj = nn.Linear(d, cfg.num_kv_heads * hd, bias=bias, **factory)
        self.o_proj = nn.Linear(cfg.num_heads * hd, d, bias=False, **factory)
        self.post_attention_layernorm = Norm(d, bias=False, **factory)
        self.gate_proj = nn.Linear(d, f, bias=False, **factory)
        self.up_proj = nn.Linear(d, f, bias=False, **factory)
        self.down_proj = nn.Linear(f, d, bias=False, **factory)


class Qwen2(nn.Module):
    def __init__(self, cfg: Qwen2Config, **factory):
        super().__init__()
        self.embed_tokens = nn.Parameter(torch.empty(cfg.vocab_size, cfg.hidden_size, **factory))
        self.layers = nn.ModuleList(DecoderLayer(cfg, **factory) for _ in range(cfg.num_layers))
        self.norm = Norm(cfg.hidden_size, bias=False, **factory)
        self.lm_head = (None if cfg.tie_word_embeddings else
                        nn.Parameter(torch.empty(cfg.vocab_size, cfg.hidden_size, **factory)))


@torch.no_grad()
def init_(lm: Qwen2, generator: torch.Generator) -> None:
    """The JAX init's distributions: Normal(0, 0.5 / sqrt(fan_in)) linears, zero biases,
    unit norms, Normal(0, 0.02) embedding and head."""
    for layer in lm.layers:
        for lin in (layer.q_proj, layer.k_proj, layer.v_proj, layer.o_proj,
                    layer.gate_proj, layer.up_proj, layer.down_proj):
            lin.weight.normal_(0.0, 0.5 * lin.in_features ** -0.5, generator=generator)
            if lin.bias is not None:
                lin.bias.zero_()
        layer.input_layernorm.weight.fill_(1.0)
        layer.post_attention_layernorm.weight.fill_(1.0)
    lm.norm.weight.fill_(1.0)
    lm.embed_tokens.normal_(0.0, 0.02, generator=generator)
    if lm.lm_head is not None:
        lm.lm_head.normal_(0.0, 0.02, generator=generator)


class TensorTree(nn.Module):
    """A nested dict of tensors as a module: dict keys become submodules and tensors
    buffers, so ``state_dict()`` names are the tree's paths (``layers.qkv.w_p``) and
    ``.to()`` moves every leaf. Read like the dict: ``p["w_p"]``, ``"b" in p``."""

    def __init__(self, tree: dict):
        super().__init__()
        for key, value in tree.items():
            if isinstance(value, dict):
                self.add_module(key, TensorTree(value))
            else:
                self.register_buffer(key, value)

    def __contains__(self, key: str) -> bool:
        return key in self._modules or key in self._buffers

    def __getitem__(self, key: str):
        return getattr(self, key)


class QuantQwen2(TensorTree):
    """The quantized LM: ``embed``, ``layers``, ``ln_f_w`` (and ``lm_head`` if untied) in
    the JAX tree layout. Norm weights and biases are in the compute dtype, scales f32."""

    @property
    def dtype(self) -> torch.dtype:
        return self.ln_f_w.dtype


def flatten(tree: dict, prefix: str = "") -> dict:
    """{'a': {'b': tensor}} -> {prefix + 'a.b': tensor}."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(flatten(value, f"{prefix}{key}."))
        else:
            out[prefix + key] = value
    return out


def unflatten(state: dict) -> dict:
    """{'a.b.c': tensor} -> {'a': {'b': {'c': tensor}}}."""
    tree: dict = {}
    for name, value in state.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def quantized_lm(tree: dict, compute_dtype: torch.dtype, device) -> QuantQwen2:
    """A quantized tree (``ops/quant.py`` / ``ops/quant4.py`` layout) -> QuantQwen2 on
    ``device``: float leaves in ``compute_dtype`` except the scales ('scale', 'gscale'),
    which stay f32 (the JAX ``_cast_f32_leaves`` rule); integer codes as they are."""
    def cast(node: dict) -> dict:
        out = {}
        for key, value in node.items():
            if isinstance(value, dict):
                out[key] = cast(value)
            elif key in ("scale", "gscale"):
                out[key] = value.to(device=device, dtype=torch.float32)
            elif value.is_floating_point():
                out[key] = value.to(device=device, dtype=compute_dtype)
            else:
                out[key] = value.to(device=device)
        return out
    return QuantQwen2(cast(tree))


def split_stacked_w4(layers: TensorTree) -> dict | None:
    """The layer-stacked w4 nodes of a fused tree (qkv / o / mlp.gateup / mlp.down that
    carry 'w_p'), or None for a tree without 'qkv' (as JAX ``split_stacked_w4``)."""
    if "qkv" not in layers:
        return None
    big = {k: v for k, v in layers.named_children() if k != "mlp" and "w_p" in v}
    mlp = {k: v for k, v in layers["mlp"].named_children() if "w_p" in v}
    if mlp:
        big["mlp"] = mlp
    return big or None


def _qlinear(x: torch.Tensor, p: TensorTree, layer: int) -> torch.Tensor:
    """Layer ``layer`` of a stacked quantized linear (int4 or int8), bias included."""
    if "w_p" in p:
        return q4_matmul_stacked(x, p, layer)
    y = q_matmul(x, {"w_q": p["w_q"][layer], "scale": p["scale"][layer]})
    return y + p["b"][layer].to(x.dtype) if "b" in p else y


def layer_norm_weights(lm, i: int) -> tuple[torch.Tensor, torch.Tensor]:
    if isinstance(lm, QuantQwen2):
        return lm.layers["ln1_w"][i], lm.layers["ln2_w"][i]
    layer = lm.layers[i]
    return layer.input_layernorm.weight, layer.post_attention_layernorm.weight


def qkv_proj(hn: torch.Tensor, lm, cfg: Qwen2Config, i: int):
    """q/k/v projections of layer i under either layout -> [b,s,nh,hd], [b,s,nkv,hd] x 2."""
    b, s, _ = hn.shape
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim()
    if isinstance(lm, Qwen2):
        def proj(lin):
            y = F.linear(hn, lin.weight)
            return y if lin.bias is None else y + lin.bias
        layer = lm.layers[i]
        q, k, v = proj(layer.q_proj), proj(layer.k_proj), proj(layer.v_proj)
    elif "qkv" in lm.layers:
        y = _qlinear(hn, lm.layers["qkv"], i)
        q, k, v = y[..., : nh * hd], y[..., nh * hd: (nh + nkv) * hd], y[..., (nh + nkv) * hd:]
    else:
        q, k, v = (_qlinear(hn, lm.layers[n], i) for n in ("q", "k", "v"))
    return q.reshape(b, s, nh, hd), k.reshape(b, s, nkv, hd), v.reshape(b, s, nkv, hd)


def o_proj(attn2d: torch.Tensor, lm, i: int) -> torch.Tensor:
    if isinstance(lm, Qwen2):
        return F.linear(attn2d, lm.layers[i].o_proj.weight)
    return _qlinear(attn2d, lm.layers["o"], i)


def mlp_forward(hn: torch.Tensor, lm, cfg: Qwen2Config, i: int) -> torch.Tensor:
    """SwiGLU MLP of layer i under either layout."""
    if isinstance(lm, Qwen2):
        layer = lm.layers[i]
        return swiglu_mlp(hn, layer.gate_proj.weight, layer.up_proj.weight,
                          layer.down_proj.weight)
    mlp = lm.layers["mlp"]
    if "gateup" in mlp:
        f = cfg.intermediate_size
        gu = _qlinear(hn, mlp["gateup"], i)
        act = F.silu(gu[..., :f]) * gu[..., f:]
    else:
        act = F.silu(_qlinear(hn, mlp["gate"], i)) * _qlinear(hn, mlp["up"], i)
    return _qlinear(act, mlp["down"], i)


def embed(lm, token_ids: torch.Tensor) -> torch.Tensor:
    """Token ids -> embeddings in the compute dtype (an int8 row times its scale)."""
    if isinstance(lm, Qwen2):
        return F.embedding(token_ids, lm.embed_tokens)
    emb = lm.embed
    rows = emb["w_q"][token_ids].float() * emb["scale"][token_ids][..., None]
    return rows.to(lm.dtype)


def unembed(lm, hidden: torch.Tensor) -> torch.Tensor:
    """hidden -> f32 logits, through lm_head or the tied embedding.

    A bf16 head on the card is multiplied as it is, accumulating and writing f32, so no
    f32 copy of the [vocab, d] head is made per step. bf16 products are exact in f32, so
    this is the reference's upcast-then-multiply up to the order of the sums. An int8
    head (or tied int8 embedding) goes through ``int8_mm`` the same way and is then
    scaled; an int4 head through ``q4_matmul`` on the f32 hidden state, as in JAX."""
    if isinstance(lm, QuantQwen2):
        h = hidden.reshape(-1, hidden.shape[-1])
        tied = "lm_head" not in lm
        head = lm.embed if tied else lm.lm_head
        if "w_p" in head:
            logits = q4_matmul(h.float(), head).float()
        else:
            logits = int8_mm(h, head["w_q"].t() if tied else head["w_q"]) * head["scale"].float()
        return logits.reshape(*hidden.shape[:-1], logits.shape[-1])
    head = lm.embed_tokens if lm.lm_head is None else lm.lm_head
    if head.device.type != "cuda" or head.dtype == torch.float32 or hidden.dtype != head.dtype:
        return F.linear(hidden.float(), head.float())
    h = hidden.reshape(-1, hidden.shape[-1])
    logits = torch.mm(h, head.t(), out_dtype=torch.float32)
    return logits.reshape(*hidden.shape[:-1], head.shape[0])


def _attend(q, k, v, cache: KVCache | None, layer_idx: int, mask, use_flash: bool):
    """Write this step's K/V into the cache (if any) and attend: flash over the block's
    own K/V on a fresh prefill, else plain attention over the whole cache."""
    s = q.shape[1]
    if cache is not None:
        ck, cv = cache.k[layer_idx], cache.v[layer_idx]
        ck[:, cache.index: cache.index + s] = k
        cv[:, cache.index: cache.index + s] = v
        if not use_flash:
            # the block's own K/V is the whole context only on a fresh prefill
            k, v = ck, cv
    return flash_attention(q, k, v, causal=True) if use_flash else gqa_attention(q, k, v, mask=mask)


def _layer_forward(x, lm, i: int, cfg: Qwen2Config, cos, sin, mask, cache: KVCache | None,
                   flash_ok: bool) -> torch.Tensor:
    b, s, _ = x.shape
    ln1, ln2 = layer_norm_weights(lm, i)
    q, k, v = qkv_proj(rms_norm(x, ln1, cfg.rms_norm_eps), lm, cfg, i)
    q, k = apply_rope(q, k, cos, sin)
    attn = _attend(q, k, v, cache, i, mask, flash_ok and s > 1)
    x = x + o_proj(attn.reshape(b, s, -1), lm, i)
    return x + mlp_forward(rms_norm(x, ln2, cfg.rms_norm_eps), lm, cfg, i)


def w4_suffix_seed(lm: QuantQwen2, cfg: Qwen2Config, stacked: dict, x: torch.Tensor):
    """Layer 0's input norm and fused qkv [b, s, n_qkv] (bias included), which seed the
    suffix decode: every later layer's qkv comes from the previous layer's suffix B."""
    hn0 = rms_norm(x, lm.layers["ln1_w"][0], cfg.rms_norm_eps)
    return q4_matmul_stacked(hn0, stacked["qkv"], 0)


def w4_suffix_layer_step(h, y, lm: QuantQwen2, idx: int, *, cfg: Qwen2Config, stacked: dict,
                         cos, sin, attend):
    """One layer of the two-call w4 decode (s == 1): this layer's precomputed qkv ``y``
    [b, s, n_qkv] -> rope -> ``attend(q, k, v)`` -> suffix A (o + residual + norm +
    gate|up + act) -> suffix B (down + residual + the next layer's norm and qkv, bias
    added here). Returns (h2 [b, s, d], y_next [b, s, n_qkv])."""
    b, s, d = h.shape
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim()
    eps = cfg.rms_norm_eps
    q = y[..., : nh * hd].reshape(b, s, nh, hd)
    k = y[..., nh * hd: (nh + nkv) * hd].reshape(b, s, nkv, hd)
    v = y[..., (nh + nkv) * hd:].reshape(b, s, nkv, hd)
    q, k = apply_rope(q, k, cos, sin)
    attn2d = attend(q, k, v).reshape(b, nh * hd).to(h.dtype)
    act, h_mid = w4_suffix_a(attn2d, h.reshape(b, d), lm.layers["ln2_w"][idx], stacked["o"],
                             stacked["mlp"]["gateup"], idx, eps=eps)
    nxt = min(idx + 1, cfg.num_layers - 1)
    h2, y_next = w4_suffix_b(act, h_mid, lm.layers["ln1_w"][nxt], stacked["mlp"]["down"],
                             stacked["qkv"], idx, nxt, eps=eps)
    if "b" in stacked["qkv"]:
        y_next = y_next + stacked["qkv"]["b"][nxt].to(y_next.dtype)
    return h2.reshape(b, s, d), y_next[:, None, :]


def _forward_w4_suffix(lm: QuantQwen2, cfg: Qwen2Config, x, cache: KVCache, mask, cos, sin,
                       stacked: dict):
    """Decode forward of a fused w4 tree at two suffix calls per layer, plus one K5 call
    for layer 0's qkv. Attention stays the plain ``gqa_attention`` over the cache."""
    y = w4_suffix_seed(lm, cfg, stacked, x)
    for i in range(cfg.num_layers):
        x, y = w4_suffix_layer_step(
            x, y, lm, i, cfg=cfg, stacked=stacked, cos=cos, sin=sin,
            attend=lambda q, k, v, i=i: _attend(q, k, v, cache, i, mask, False))
    cache.index += x.shape[1]
    return rms_norm(x, lm.ln_f_w, cfg.rms_norm_eps), cache


def forward(lm: Qwen2 | QuantQwen2, cfg: Qwen2Config, embeds: torch.Tensor,
            positions: torch.Tensor, cache: KVCache | None = None,
            extra_mask: torch.Tensor | None = None,
            is_prefill: bool = False) -> tuple[torch.Tensor, KVCache | None]:
    """Run the decoder stack on input embeddings [b, s, d] at absolute positions [b, s].

    With a cache, this step's K/V is written at ``cache.index`` and attention spans the
    cache (causal by absolute position); the cache is advanced by s and returned.
    ``extra_mask`` [b, 1, s, kv_len] is AND-ed onto the causal mask. ``is_prefill``
    certifies cache.index == 0, which lets the flash kernel attend over the block's own
    K/V. A fused w4 LM decodes through the suffix kernels where JAX does. Returns
    (final-normed hidden states, cache).
    """
    b, s, _ = embeds.shape
    cos, sin = rope_cos_sin(positions, cfg.resolved_head_dim(), cfg.rope_theta)
    sliding = cfg.sliding_window is not None and cfg.max_window_layers < cfg.num_layers
    q_pos = positions[:, None, :, None]
    if cache is not None:
        if cache.index + s > cache.capacity:
            raise ValueError(f"KV cache of {cache.capacity} slots cannot take "
                             f"{cache.index} + {s} positions")
        kv_pos = torch.arange(cache.capacity, device=embeds.device)[None, None, None, :]
    else:
        kv_pos = positions[:, None, None, :]
    mask = kv_pos <= q_pos
    sw_mask = mask & (kv_pos > q_pos - cfg.sliding_window) if sliding else None
    if extra_mask is not None:
        mask = mask & extra_mask
        if sliding:
            sw_mask = sw_mask & extra_mask
    flash_ok = (cfg.use_flash and extra_mask is None and not sliding
                and (cache is None or is_prefill))
    quantized = isinstance(lm, QuantQwen2)
    stacked = split_stacked_w4(lm.layers) if quantized else None
    if (stacked is not None and cache is not None and s == 1 and b <= 8 and not sliding
            and suffix_supported(stacked, cfg)):
        return _forward_w4_suffix(lm, cfg, embeds, cache, mask, cos, sin, stacked)
    x = embeds
    for i in range(cfg.num_layers):
        layer_mask = sw_mask if sliding and i >= cfg.max_window_layers else mask
        x = _layer_forward(x, lm, i, cfg, cos, sin, layer_mask, cache, flash_ok)
    if cache is not None:
        cache.index += s
    final = lm.ln_f_w if quantized else lm.norm.weight
    return rms_norm(x, final, cfg.rms_norm_eps), cache
