"""Qwen2 / Qwen2.5 decoder, as ``audio_flamingo_tpu/models/qwen2.py``.

RMSNorm pre-norm layers, q/k/v biases and a bias-free o_proj, RoPE (rotate_half),
SwiGLU MLP, a fixed-capacity KV cache written at an offset (slot s holds absolute
position s), and the per-layer sliding-window gate (layer i slides iff
``sliding_window`` is set and i >= ``max_window_layers``). ``forward`` takes input
embeddings so audio tokens can be scattered in upstream (models/af3.py).

Attention goes to the flash-attention kernel only on a fresh multi-token prefill with a
purely causal mask (no extra mask, no sliding layer), as in the JAX ``forward``; every
other call (decode, warm cache, masked) uses plain ``gqa_attention``. ``a8_attention``
sends that fresh prefill to the int8-QK kernel (K8) instead.

``a8_prefill`` on an int8 LM runs every multi-token layer's products w8a8 (per-token int8
activations, ``ops/quant.q_matmul_a8q``), as JAX does; decode (one token) and the
helpers the engines call (``qkv_proj``, ``o_proj``, ``mlp_forward``) stay w8a16.

Unlike the JAX caches, ``KVCache`` and the int8 ``Q8KVCache`` are updated in place:
prefill and decode write their K/V (int8 codes and per-token scales for ``Q8KVCache``)
into the preallocated tensors and advance ``index``, so no step copies the cache. As in
JAX, ``index`` lives on the device (a 0-dim int64 tensor): the K/V are written at it by
``index_copy_`` and it is advanced by ``add_``, so a decode step reads nothing back to the
host and can be captured in a CUDA graph (``runtime/generate.py``). The capacity check
reads ``host_index``, the same count kept on the host by whoever advances the cache. Over a
``Q8KVCache`` attention reads the codes with the scales folded in after the dots
(``gqa_attention_q8``), except on a fresh flash prefill, which attends over the block's
own float K/V as JAX does.

Two weight layouts share ``forward``: ``Qwen2`` (float ``nn.Linear`` layers, torch
layout) and ``QuantQwen2``, a quantized LM held in the JAX package's tree layout (layer
leaves stacked on [L], linears [in, out]): int8 ``{w_q, scale}`` linears
(``ops/quant.py``), int4 ``{w_p, gscale}`` linears (``ops/quant4.py``), fused ``qkv`` and
``mlp.gateup`` when quantized with ``fuse``, an int8 per-row embedding and an int8 or int4
head. A fused w4 tree decodes one token at two suffix calls per layer (K6,
``ops/kernels/w4_suffix.py``) under the JAX condition: a cache, one position, at most 8
rows, no sliding layer and ``suffix_supported``.

LoRA / QLoRA adapters (``models/lora.py``) sit on the float linears or in the quantized tree;
every linear of either layout adds ``(x a) b s`` after its product and before its bias
(``_flinear``, ``_finish``), the grouped K4 launch (q|k|v, gate|up) included.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from audio_flamingo_tpu_torch.config import Qwen2Config
from audio_flamingo_tpu_torch.ops.attention import gqa_attention, gqa_attention_q8
from audio_flamingo_tpu_torch.ops.kernels.flash_attention import flash_attention
from audio_flamingo_tpu_torch.ops.kernels.flash_attention_a8 import flash_attention_a8
from audio_flamingo_tpu_torch.ops.kernels.w4_suffix import (MAX_ROWS, suffix_supported,
                                                            w4_suffix_a, w4_suffix_b)
from audio_flamingo_tpu_torch.ops.lora import lora_delta
from audio_flamingo_tpu_torch.ops.norms import Norm, rms_norm
from audio_flamingo_tpu_torch.ops.quant import (div127, mm_f32, q_matmul, q_matmul_a8q,
                                                q_matmul_group,
                                                quantize_act)
from audio_flamingo_tpu_torch.ops.quant4 import q4_matmul, q4_matmul_stacked
from audio_flamingo_tpu_torch.ops.remat import remat_wrap
from audio_flamingo_tpu_torch.ops.rope import apply_rope, rope_cos_sin


class _DeviceIndex:
    """The filled-slot count of a cache: ``index`` a 0-dim int64 tensor on the cache's device
    (a Python int given at construction is placed there) and ``host_index`` the same count
    on the host, for the capacity check; a device ``index`` must come with its
    ``host_index``. ``advance`` and ``rewind`` move both without reading the device."""

    def __post_init__(self):
        if isinstance(self.index, torch.Tensor):
            if self.host_index is None:
                raise ValueError("a device index needs its host_index")
        else:
            self.host_index = int(self.index)
            self.index = torch.full((), self.host_index, dtype=torch.long,
                                    device=self._codes().device)

    def advance(self, n: int) -> None:
        self.index.add_(n)
        self.host_index += n

    def rewind(self, n: int) -> None:
        self.index.fill_(n)
        self.host_index = n

    @property
    def batch(self) -> int:
        return self._codes().shape[1]

    @property
    def capacity(self) -> int:
        return self._codes().shape[2]


@dataclass
class KVCache(_DeviceIndex):
    """k, v: [num_layers, batch, capacity, num_kv_heads, head_dim]; index: filled slots."""

    k: torch.Tensor
    v: torch.Tensor
    index: torch.Tensor | int = 0
    host_index: int | None = None

    def _codes(self) -> torch.Tensor:
        return self.k


@dataclass
class Q8KVCache(_DeviceIndex):
    """The dense int8 KV cache (JAX ``Q8KVCache``): k_q, v_q int8 [num_layers, batch,
    capacity, num_kv_heads, head_dim] with per-(position, head) f32 scales k_scale,
    v_scale [num_layers, batch, capacity, num_kv_heads]; index: filled slots."""

    k_q: torch.Tensor
    v_q: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor
    index: torch.Tensor | int = 0
    host_index: int | None = None

    def _codes(self) -> torch.Tensor:
        return self.k_q


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., nkv, hd] -> (int8 codes, f32 scales [..., nkv]): per token and head, scale =
    max(amax, 1e-6) / 127 (a true division on every device), codes round(x / scale) half
    to even, clipped to +-127 (the JAX ``_quantize_kv`` :78 of the int8 KV caches)."""
    xf = x.float()
    scale = div127(xf.abs().amax(dim=-1).clamp(min=1e-6))
    q = torch.round(xf / scale[..., None]).clamp(-127, 127)
    return q.to(torch.int8), scale


def init_cache(cfg: Qwen2Config, batch: int, capacity: int, dtype: torch.dtype,
               device: torch.device | str) -> KVCache:
    shape = (cfg.num_layers, batch, capacity, cfg.num_kv_heads, cfg.resolved_head_dim())
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def init_cache_q8(cfg: Qwen2Config, batch: int, capacity: int,
                  device: torch.device | str) -> Q8KVCache:
    """Zero codes and unit scales, as JAX ``init_cache_q8``."""
    shape = (cfg.num_layers, batch, capacity, cfg.num_kv_heads, cfg.resolved_head_dim())
    return Q8KVCache(k_q=torch.zeros(shape, dtype=torch.int8, device=device),
                     v_q=torch.zeros(shape, dtype=torch.int8, device=device),
                     k_scale=torch.ones(shape[:-1], device=device),
                     v_scale=torch.ones(shape[:-1], device=device))


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
            elif key.startswith("lora_"):
                # LoRA adapters (models/lora.py) are parameters, so that training can reach them
                self.register_parameter(key, nn.Parameter(value, requires_grad=False))
            else:
                self.register_buffer(key, value)

    def __contains__(self, key: str) -> bool:
        return key in self._modules or key in self._buffers or key in self._parameters

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


def cast_quantized(tree: dict, compute_dtype: torch.dtype, device) -> dict:
    """A quantized tree on ``device``: float leaves in ``compute_dtype`` except the scales
    ('scale', 'gscale') and LoRA adapters ('lora_*'), which stay f32 (the JAX
    ``_cast_f32_leaves`` rule); integer codes as they are."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out[key] = cast_quantized(value, compute_dtype, device)
        elif key in ("scale", "gscale") or key.startswith("lora_"):
            out[key] = value.to(device=device, dtype=torch.float32)
        elif value.is_floating_point():
            out[key] = value.to(device=device, dtype=compute_dtype)
        else:
            out[key] = value.to(device=device)
    return out


def quantized_lm(tree: dict, compute_dtype: torch.dtype, device) -> QuantQwen2:
    """A quantized tree (``ops/quant.py`` / ``ops/quant4.py`` layout) -> QuantQwen2 on
    ``device``, cast by ``cast_quantized``."""
    return QuantQwen2(cast_quantized(tree, compute_dtype, device))


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


def _finish(y: torch.Tensor, x: torch.Tensor, p: TensorTree, layer: int) -> torch.Tensor:
    """A stacked linear's product y of x, then its LoRA adapters' delta (in f32, cast to
    y's dtype) and its bias, in JAX ``_linear``'s order."""
    if "lora_a" in p:
        y = y + lora_delta(x, p, layer).to(y.dtype)
    return y + p["b"][layer].to(y.dtype) if "b" in p else y


def _qlinear(x: torch.Tensor, p: TensorTree, layer: int) -> torch.Tensor:
    """Layer ``layer`` of a stacked quantized linear (int4 or int8), adapters and bias
    included."""
    if "w_p" in p:
        y = q4_matmul_stacked(x, {"w_p": p["w_p"], "gscale": p["gscale"]}, layer)
    else:
        y = q_matmul(x, {"w_q": p["w_q"][layer], "scale": p["scale"][layer]})
    return _finish(y, x, p, layer)


def _qlinears(x: torch.Tensor, ps: list, layer: int) -> list[torch.Tensor]:
    """Layer ``layer`` of stacked int8 linears that share x (q|k|v, gate|up) through
    ``q_matmul_group`` (one K4 launch at decode sizes); each product's adapters and bias
    are added after it."""
    ys = q_matmul_group(x, [{"w_q": p["w_q"][layer], "scale": p["scale"][layer]} for p in ps])
    return [_finish(y, x, p, layer) for y, p in zip(ys, ps)]


def _flinear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """A float linear: the product in x's dtype, the adapters' delta, then the bias."""
    y = F.linear(x, lin.weight)
    if hasattr(lin, "lora_a"):
        y = y + lora_delta(x, lin).to(y.dtype)
    return y if lin.bias is None else y + lin.bias


def _int8(*ps) -> bool:
    return all("w_q" in p for p in ps)


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
        layer = lm.layers[i]
        q, k, v = (_flinear(hn, lin) for lin in (layer.q_proj, layer.k_proj, layer.v_proj))
    elif "qkv" in lm.layers:
        y = _qlinear(hn, lm.layers["qkv"], i)
        q, k, v = y[..., : nh * hd], y[..., nh * hd: (nh + nkv) * hd], y[..., (nh + nkv) * hd:]
    elif _int8(*(lm.layers[n] for n in ("q", "k", "v"))):
        q, k, v = _qlinears(hn, [lm.layers[n] for n in ("q", "k", "v")], i)
    else:
        q, k, v = (_qlinear(hn, lm.layers[n], i) for n in ("q", "k", "v"))
    return q.reshape(b, s, nh, hd), k.reshape(b, s, nkv, hd), v.reshape(b, s, nkv, hd)


def o_proj(attn2d: torch.Tensor, lm, i: int) -> torch.Tensor:
    if isinstance(lm, Qwen2):
        return _flinear(attn2d, lm.layers[i].o_proj)
    return _qlinear(attn2d, lm.layers["o"], i)


def mlp_forward(hn: torch.Tensor, lm, cfg: Qwen2Config, i: int) -> torch.Tensor:
    """SwiGLU MLP of layer i under either layout."""
    if isinstance(lm, Qwen2):
        layer = lm.layers[i]
        act = F.silu(_flinear(hn, layer.gate_proj)) * _flinear(hn, layer.up_proj)
        return _flinear(act, layer.down_proj)
    mlp = lm.layers["mlp"]
    if "gateup" in mlp:
        f = cfg.intermediate_size
        gu = _qlinear(hn, mlp["gateup"], i)
        act = F.silu(gu[..., :f]) * gu[..., f:]
    elif _int8(mlp["gate"], mlp["up"]):
        gate, up = _qlinears(hn, [mlp["gate"], mlp["up"]], i)
        act = F.silu(gate) * up
    else:
        act = F.silu(_qlinear(hn, mlp["gate"], i)) * _qlinear(hn, mlp["up"], i)
    return _qlinear(act, mlp["down"], i)


def _gather_ids(token_ids: torch.Tensor, rows: int) -> torch.Tensor:
    return torch.where(token_ids < 0, token_ids + rows, token_ids).clamp(0, rows - 1)


def embed(lm, token_ids: torch.Tensor) -> torch.Tensor:
    """Token ids -> embeddings in the compute dtype (an int8 row times its scale). Ids are
    read as JAX's gather reads them: a negative id counts from the end and an id past the
    vocabulary reads the last row (an engine feeds its EOS id to finished rows and bucket
    padding, and a decode step past a row's end its EOS id, which may lie outside a test
    vocab or be negative)."""
    if isinstance(lm, Qwen2):
        return F.embedding(_gather_ids(token_ids, lm.embed_tokens.shape[0]), lm.embed_tokens)
    emb = lm.embed
    token_ids = _gather_ids(token_ids, emb["w_q"].shape[0])
    rows = emb["w_q"][token_ids].float() * emb["scale"][token_ids][..., None]
    return rows.to(lm.dtype)


def unembed(lm, hidden: torch.Tensor) -> torch.Tensor:
    """hidden -> f32 logits, through lm_head or the tied embedding.

    A bf16 head on the card is multiplied as it is, accumulating and writing f32, so no
    f32 copy of the [vocab, d] head is made per step. bf16 products are exact in f32, so
    this is the reference's upcast-then-multiply up to the order of the sums. An int8
    head (or the transposed view of a tied int8 embedding, not copied) goes through
    ``q_matmul`` with f32 output (K4 at decode sizes): a bf16 hidden state widens exactly,
    so this is JAX's f32 head. An int4 head goes through ``q4_matmul`` on the f32 hidden
    state, as in JAX. The float and int8 heads pass gradients to ``hidden``."""
    if isinstance(lm, QuantQwen2):
        h = hidden.reshape(-1, hidden.shape[-1])
        tied = "lm_head" not in lm
        head = lm.embed if tied else lm.lm_head
        if "w_p" in head:
            logits = q4_matmul(h.float(), head).float()
        else:
            logits = q_matmul(h, {"w_q": head["w_q"].t() if tied else head["w_q"],
                                  "scale": head["scale"]}, out_dtype=torch.float32)
        return logits.reshape(*hidden.shape[:-1], logits.shape[-1])
    head = lm.embed_tokens if lm.lm_head is None else lm.lm_head
    logits = mm_f32(hidden.reshape(-1, hidden.shape[-1]), head.t())
    return logits.reshape(*hidden.shape[:-1], head.shape[0])


def _attend(q, k, v, cache: KVCache | Q8KVCache | None, layer_idx: int, mask,
            use_flash: bool, a8_attention: bool = False, slots: torch.Tensor | None = None):
    """Write this step's K/V into the cache (if any; quantized per token and head for a
    ``Q8KVCache``) at ``slots`` ([s] int64 on the device, from the cache's device index)
    and attend: flash over the block's own K/V on a fresh prefill (the int8-QK K8 with
    ``a8_attention``, at JAX's default blocks), else plain attention over the whole cache
    (``gqa_attention_q8`` over the codes of a ``Q8KVCache``)."""
    if isinstance(cache, Q8KVCache):
        for codes, scales, x in ((cache.k_q, cache.k_scale, k), (cache.v_q, cache.v_scale, v)):
            x_q, x_scale = quantize_kv(x)
            codes[layer_idx].index_copy_(1, slots, x_q)
            scales[layer_idx].index_copy_(1, slots, x_scale)
        if not use_flash:
            return gqa_attention_q8(q, cache.k_q[layer_idx], cache.v_q[layer_idx],
                                    cache.k_scale[layer_idx], cache.v_scale[layer_idx],
                                    mask=mask)
    elif cache is not None:
        ck, cv = cache.k[layer_idx], cache.v[layer_idx]
        ck.index_copy_(1, slots, k.to(ck.dtype))
        cv.index_copy_(1, slots, v.to(cv.dtype))
        if not use_flash:
            # the block's own K/V is the whole context only on a fresh prefill
            k, v = ck, cv
    if not use_flash:
        return gqa_attention(q, k, v, mask=mask)
    if a8_attention:
        return flash_attention_a8(q, k, v, causal=True)
    return flash_attention(q, k, v, causal=True)


def _qlinear_a8(xq_xs, x: torch.Tensor, p: TensorTree, layer: int) -> torch.Tensor:
    """Layer ``layer`` of a stacked int8 linear on pre-quantized activations (w8a8); the
    adapters' delta (of the float x) and the bias are added in x.dtype (JAX
    ``_linear_shared_a8``)."""
    y = q_matmul_a8q(*xq_xs, {"w_q": p["w_q"][layer], "scale": p["scale"][layer]},
                     out_dtype=x.dtype)
    return _finish(y, x, p, layer)


def _linear_a8(x: torch.Tensor, p: TensorTree, layer: int) -> torch.Tensor:
    """An int8 linear under a8 quantizes its own input; int4 stays weight-only (JAX
    ``_linear(..., a8=True)``)."""
    if "w_q" in p:
        return _qlinear_a8(quantize_act(x), x, p, layer)
    return _qlinear(x, p, layer)


def _layer_forward_a8(x, lm: QuantQwen2, i: int, cfg: Qwen2Config, cos, sin, mask,
                      cache: KVCache | Q8KVCache | None, flash_ok: bool,
                      slots: torch.Tensor | None = None) -> torch.Tensor:
    """A multi-token layer of an int8 LM under ``a8_prefill`` (JAX ``_layer_forward`` with
    a8): q/k/v share one activation quantization, gate/up another, o and down quantize
    their own input."""
    b, s, _ = x.shape
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim()
    layers = lm.layers
    h = rms_norm(x, layers["ln1_w"][i], cfg.rms_norm_eps)
    if "q" in layers and "w_q" in layers["q"]:
        hq = quantize_act(h)
        q, k, v = (_qlinear_a8(hq, h, layers[n], i) for n in ("q", "k", "v"))
        q, k, v = (q.reshape(b, s, nh, hd), k.reshape(b, s, nkv, hd),
                   v.reshape(b, s, nkv, hd))
    else:
        q, k, v = qkv_proj(h, lm, cfg, i)
    q, k = apply_rope(q, k, cos, sin)
    attn = _attend(q, k, v, cache, i, mask, flash_ok and s > 1, cfg.a8_attention, slots)
    x = x + _linear_a8(attn.reshape(b, s, -1), layers["o"], i)
    h = rms_norm(x, layers["ln2_w"][i], cfg.rms_norm_eps)
    mlp = layers["mlp"]
    if "gate" not in mlp or "w_q" not in mlp["gate"]:
        return x + mlp_forward(h, lm, cfg, i)
    hq = quantize_act(h)
    act = F.silu(_qlinear_a8(hq, h, mlp["gate"], i)) * _qlinear_a8(hq, h, mlp["up"], i)
    return x + _linear_a8(act, mlp["down"], i)


def _layer_forward(x, lm, i: int, cfg: Qwen2Config, cos, sin, mask,
                   cache: KVCache | Q8KVCache | None, flash_ok: bool,
                   slots: torch.Tensor | None = None) -> torch.Tensor:
    b, s, _ = x.shape
    if cfg.a8_prefill and s > 1 and isinstance(lm, QuantQwen2):
        return _layer_forward_a8(x, lm, i, cfg, cos, sin, mask, cache, flash_ok, slots)
    ln1, ln2 = layer_norm_weights(lm, i)
    q, k, v = qkv_proj(rms_norm(x, ln1, cfg.rms_norm_eps), lm, cfg, i)
    q, k = apply_rope(q, k, cos, sin)
    attn = _attend(q, k, v, cache, i, mask, flash_ok and s > 1, cfg.a8_attention, slots)
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


def _forward_w4_suffix(lm: QuantQwen2, cfg: Qwen2Config, x, cache: KVCache | Q8KVCache,
                       mask, cos, sin, stacked: dict, slots: torch.Tensor):
    """Decode forward of a fused w4 tree at two suffix calls per layer, plus one K5 call
    for layer 0's qkv. Attention stays plain, over the cache of either kind (``_attend``)."""
    y = w4_suffix_seed(lm, cfg, stacked, x)
    for i in range(cfg.num_layers):
        x, y = w4_suffix_layer_step(
            x, y, lm, i, cfg=cfg, stacked=stacked, cos=cos, sin=sin,
            attend=lambda q, k, v, i=i: _attend(q, k, v, cache, i, mask, False, slots=slots))
    cache.advance(x.shape[1])
    return rms_norm(x, lm.ln_f_w, cfg.rms_norm_eps), cache


def forward_attend(lm: Qwen2 | QuantQwen2, cfg: Qwen2Config, x: torch.Tensor, cos, sin,
                   attend_layer) -> torch.Tensor:
    """The decoder stack on x [b, s, d] for the engines' caches: layer i attends through
    ``attend_layer(i)(q, k, v)`` -> [b, s, nh, hd], which also writes the cache (pages,
    slots). A fused w4 tree at one token and at most MAX_ROWS rows takes the two suffix
    calls per layer, as JAX does. Returns the final-normed hidden states."""
    b, s, _ = x.shape
    eps = cfg.rms_norm_eps
    quantized = isinstance(lm, QuantQwen2)
    stacked = split_stacked_w4(lm.layers) if quantized else None
    if stacked is not None and s == 1 and b <= MAX_ROWS and suffix_supported(stacked, cfg):
        # layer i's qkv comes from layer i-1's suffix B; attention stays with the caller
        y = w4_suffix_seed(lm, cfg, stacked, x)
        for i in range(cfg.num_layers):
            x, y = w4_suffix_layer_step(x, y, lm, i, cfg=cfg, stacked=stacked, cos=cos,
                                        sin=sin, attend=attend_layer(i))
    else:
        for i in range(cfg.num_layers):
            x = layer_attend(x, lm, i, cfg, cos, sin, attend_layer(i))
    return rms_norm(x, lm.ln_f_w if quantized else lm.norm.weight, eps)


def layer_attend(x: torch.Tensor, lm, i: int, cfg: Qwen2Config, cos, sin, attend) -> torch.Tensor:
    """Layer i on x [b, s, d] with its attention through ``attend(q, k, v)`` -> [b, s, nh,
    hd] (which writes the caller's cache)."""
    b, s, _ = x.shape
    ln1, ln2 = layer_norm_weights(lm, i)
    q, k, v = qkv_proj(rms_norm(x, ln1, cfg.rms_norm_eps), lm, cfg, i)
    q, k = apply_rope(q, k, cos, sin)
    x = x + o_proj(attend(q, k, v).reshape(b, s, -1).to(x.dtype), lm, i)
    return x + mlp_forward(rms_norm(x, ln2, cfg.rms_norm_eps), lm, cfg, i)


def forward(lm: Qwen2 | QuantQwen2, cfg: Qwen2Config, embeds: torch.Tensor,
            positions: torch.Tensor, cache: KVCache | Q8KVCache | None = None,
            extra_mask: torch.Tensor | None = None,
            is_prefill: bool = False) -> tuple[torch.Tensor, KVCache | Q8KVCache | None]:
    """Run the decoder stack on input embeddings [b, s, d] at absolute positions [b, s].

    With a cache (bf16/f32 ``KVCache`` or int8 ``Q8KVCache``), this step's K/V is written
    at ``cache.index`` (on the device) and attention spans the cache (causal by absolute
    position); the cache is advanced by s and returned. Nothing here reads the device from
    the host: the capacity check uses ``cache.host_index``.
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
        if cache.host_index + s > cache.capacity:
            raise ValueError(f"KV cache of {cache.capacity} slots cannot take "
                             f"{cache.host_index} + {s} positions")
        kv_pos = torch.arange(cache.capacity, device=embeds.device)[None, None, None, :]
        slots = cache.index + torch.arange(s, device=embeds.device)
    else:
        kv_pos, slots = positions[:, None, None, :], None
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
        return _forward_w4_suffix(lm, cfg, embeds, cache, mask, cos, sin, stacked, slots)
    # the cache-free forward is the training path: each layer under cfg.remat
    layer_fn = _layer_forward if cache is not None else remat_wrap(_layer_forward, cfg.remat)
    x = embeds
    for i in range(cfg.num_layers):
        layer_mask = sw_mask if sliding and i >= cfg.max_window_layers else mask
        x = layer_fn(x, lm, i, cfg, cos, sin, layer_mask, cache, flash_ok, slots)
    if cache is not None:
        cache.advance(s)
    final = lm.ln_f_w if quantized else lm.norm.weight
    return rms_norm(x, final, cfg.rms_norm_eps), cache
