"""AF-Whisper audio tower (Whisper-encoder architecture), as
``audio_flamingo_tpu/models/whisper_encoder.py``.

Conv stem (k=3, strides 1 and 2, exact GELU), sinusoid positions, pre-norm layers with
q pre-scaled after its bias and a bias-free k, strictly 3000 mel frames per window,
then AvgPool (stride 2) BEFORE the final LayerNorm. Each 30 s window is a batch row.
Attention goes to the flash-attention kernel (scale=1.0, q is pre-scaled) when
``cfg.use_flash`` is set, to plain ``gqa_attention`` otherwise. Each layer runs under
``remat_wrap(..., cfg.remat)`` (ops/remat.py), and nothing on the path writes in place,
so the stack is differentiable end to end (flash through its backward kernel).

``WhisperEncoder`` holds the weights in torch layouts (Linear [out, in], Conv1d
[out, in, k]); ``apply`` runs them under a config, as the JAX ``apply`` does, in the
weights' dtype (the JAX ``compute_dtype``).

``QuantWhisperEncoder`` is the w8a8 encoder (``load(a8_encoder=True)``): the conv stem,
positions and ln_post as float parameters, the layers as a ``qwen2.TensorTree`` in the
JAX layout (stacked [L, in, out] int8 codes, f32 scales, norms and biases in the compute
dtype), in one of JAX's two layouts (``ops/quant.py``):

- plain (``quantize_encoder_params``, a ``w_q`` per linear): q, k and v share one
  ``quantize_act`` of the LayerNorm output, o, fc1 and fc2 quantize their own input, GELU
  is exact; attention goes to K8 (``block_q=512, block_k=2048``) when ``use_flash`` and
  ``a8_attention`` are set, else as in the float layer;
- fused (``quantize_encoder_params_fused``, a ``qkv`` node): each of the stages "qkv",
  "out" and "mlp" runs its K9 kernel (``ops/kernels/enc_fused.py``) when it is in
  ``cfg.fused_stages`` and its composed torch form otherwise; attention goes to K2. On
  the card the qkv, o, fc1 and fc2 nodes also hold K-major copies of their codes (``w_t``,
  not in ``state_dict``), which the K9 kernels read.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audio_flamingo_tpu_torch.config import WhisperEncoderConfig
from audio_flamingo_tpu_torch.models.qwen2 import TensorTree, cast_quantized
from audio_flamingo_tpu_torch.ops import quant
from audio_flamingo_tpu_torch.ops.attention import gqa_attention
from audio_flamingo_tpu_torch.ops.kernels import enc_fused
from audio_flamingo_tpu_torch.ops.kernels.flash_attention import flash_attention
from audio_flamingo_tpu_torch.ops.kernels.flash_attention_a8 import flash_attention_a8
from audio_flamingo_tpu_torch.ops.mlp import gelu_mlp
from audio_flamingo_tpu_torch.ops.norms import Norm, layer_norm
from audio_flamingo_tpu_torch.ops.remat import remat_wrap


def sinusoid_positions(length: int, channels: int, max_timescale: float = 10_000.0) -> np.ndarray:
    """Whisper sinusoid table: concat([sin, cos], axis=1)."""
    inc = math.log(max_timescale) / (channels // 2 - 1)
    inv = np.exp(-inc * np.arange(channels // 2, dtype=np.float64))
    t = np.arange(length, dtype=np.float64)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: WhisperEncoderConfig, **factory):
        super().__init__()
        d, f = cfg.d_model, cfg.ffn_dim
        self.self_attn_layer_norm = Norm(d, **factory)
        self.q_proj = nn.Linear(d, d, **factory)
        self.k_proj = nn.Linear(d, d, bias=False, **factory)
        self.v_proj = nn.Linear(d, d, **factory)
        self.out_proj = nn.Linear(d, d, **factory)
        self.final_layer_norm = Norm(d, **factory)
        self.fc1 = nn.Linear(d, f, **factory)
        self.fc2 = nn.Linear(f, d, **factory)


class WhisperEncoder(nn.Module):
    def __init__(self, cfg: WhisperEncoderConfig, **factory):
        super().__init__()
        d = cfg.d_model
        self.conv1 = nn.Conv1d(cfg.num_mel_bins, d, 3, padding=1, **factory)
        self.conv2 = nn.Conv1d(d, d, 3, stride=2, padding=1, **factory)
        self.embed_positions = nn.Parameter(torch.empty(cfg.max_source_positions, d, **factory))
        self.layers = nn.ModuleList(EncoderLayer(cfg, **factory) for _ in range(cfg.num_layers))
        self.layer_norm = Norm(d, **factory)


class QuantWhisperEncoder(WhisperEncoder):
    """The encoder with its layers quantized: the float stem, positions and ln_post of
    ``WhisperEncoder`` and ``layers``, a TensorTree of one of the two int8 layouts."""

    def __init__(self, cfg: WhisperEncoderConfig, layers: dict, **factory):
        super().__init__(dataclasses.replace(cfg, num_layers=0), **factory)
        self.layers = TensorTree(layers)

    @property
    def fused(self) -> bool:
        return "qkv" in self.layers

    @property
    def num_layers(self) -> int:
        return self.layers["ln1_w"].shape[0]


@torch.no_grad()
def quantize(enc: WhisperEncoder, cfg: WhisperEncoderConfig, fused: bool = False
             ) -> QuantWhisperEncoder:
    """A float encoder -> its int8 twin on the same device and in the same dtype: the
    plain layout, or with ``fused`` the K9 layout (enable its kernels with
    ``cfg.fused_stages``). The layers are quantized from the float weights as they are."""
    state = enc.state_dict()
    tree = (quant.quantize_encoder_params_fused(state, cfg.head_dim) if fused
            else quant.quantize_encoder_params(state))
    weight = enc.conv1.weight
    return quantized_encoder(cfg, {k: v for k, v in state.items()
                                   if not k.startswith("layers.")},
                             tree, weight.dtype, weight.device)


def quantized_encoder(cfg: WhisperEncoderConfig, float_state: dict, tree: dict,
                      compute_dtype: torch.dtype, device) -> QuantWhisperEncoder:
    """A QuantWhisperEncoder on ``device`` from the float stem's state (conv1, conv2,
    embed_positions, layer_norm) and a quantized layer tree, cast as ``cast_quantized``
    casts a quantized LM."""
    with torch.device("meta"):
        enc = QuantWhisperEncoder(cfg, {}, dtype=compute_dtype)
    enc = enc.to_empty(device=device)
    enc.load_state_dict(float_state)
    enc.layers = TensorTree(cast_quantized(tree, compute_dtype, device))
    if enc.fused and torch.device(device).type == "cuda":
        enc_fused.attach_kmajor(enc.layers)   # K9's K-major weight copies, made once
    return enc.eval().requires_grad_(False)


@torch.no_grad()
def init_(enc: WhisperEncoder, cfg: WhisperEncoderConfig, generator: torch.Generator) -> None:
    """Random weights with the JAX init's distributions (uniform +-1/sqrt(fan_in) linears
    and convs, zero biases, unit norms, sinusoid positions)."""
    def uniform(w, bound):
        w.uniform_(-bound, bound, generator=generator)

    uniform(enc.conv1.weight, (1.0 / (cfg.num_mel_bins * 3)) ** 0.5)
    uniform(enc.conv2.weight, (1.0 / (cfg.d_model * 3)) ** 0.5)
    enc.embed_positions.copy_(torch.from_numpy(
        sinusoid_positions(cfg.max_source_positions, cfg.d_model)))
    for layer in enc.layers:
        for lin in (layer.q_proj, layer.k_proj, layer.v_proj, layer.out_proj,
                    layer.fc1, layer.fc2):
            uniform(lin.weight, lin.in_features ** -0.5)
    for name, p in enc.named_parameters():
        if name.endswith("bias"):
            p.zero_()
        elif name.endswith("norm.weight"):
            p.fill_(1.0)


def _layer_forward(x: torch.Tensor, layer: EncoderLayer, cfg: WhisperEncoderConfig) -> torch.Tensor:
    b, s, d = x.shape
    nh, hd = cfg.num_heads, cfg.head_dim
    ln = layer.self_attn_layer_norm
    h = layer_norm(x, ln.weight, ln.bias)
    q = ((F.linear(h, layer.q_proj.weight) + layer.q_proj.bias) * (hd ** -0.5)).reshape(b, s, nh, hd)
    k = F.linear(h, layer.k_proj.weight).reshape(b, s, nh, hd)
    v = (F.linear(h, layer.v_proj.weight) + layer.v_proj.bias).reshape(b, s, nh, hd)
    if cfg.use_flash:
        attn = flash_attention(q, k, v, scale=1.0)
    else:
        attn = gqa_attention(q, k, v, scale=1.0)
    x = x + (F.linear(attn.reshape(b, s, d), layer.out_proj.weight) + layer.out_proj.bias)
    ln = layer.final_layer_norm
    h = layer_norm(x, ln.weight, ln.bias)
    return x + gelu_mlp(h, layer.fc1.weight, layer.fc1.bias, layer.fc2.weight, layer.fc2.bias,
                        activation=cfg.activation)


def _lin(p: TensorTree, i: int) -> dict:
    """Layer i of a stacked int8 linear, as ``ops/quant`` takes it."""
    return {"w_q": p["w_q"][i], "scale": p["scale"][i]}


def _bias(p: TensorTree, i: int, dtype: torch.dtype) -> torch.Tensor:
    return p["b"][i].to(dtype)


def _layer_forward_a8(x: torch.Tensor, lp: TensorTree, i: int,
                      cfg: WhisperEncoderConfig) -> torch.Tensor:
    """The plain int8 layout (JAX ``_layer_forward`` with ``w_q`` linears)."""
    b, s, d = x.shape
    nh, hd = cfg.num_heads, cfg.head_dim
    h = layer_norm(x, lp["ln1_w"][i], lp["ln1_b"][i])
    hq = quant.quantize_act(h)   # one quantization shared by q, k and v
    q = ((quant.q_matmul_a8q(*hq, _lin(lp["q"], i), out_dtype=h.dtype)
          + _bias(lp["q"], i, h.dtype)) * (hd ** -0.5)).reshape(b, s, nh, hd)
    k = quant.q_matmul_a8q(*hq, _lin(lp["k"], i), out_dtype=h.dtype).reshape(b, s, nh, hd)
    v = (quant.q_matmul_a8q(*hq, _lin(lp["v"], i), out_dtype=h.dtype)
         + _bias(lp["v"], i, h.dtype)).reshape(b, s, nh, hd)
    if cfg.use_flash and cfg.a8_attention:
        attn = flash_attention_a8(q, k, v, scale=1.0, block_q=512, block_k=2048)
    elif cfg.use_flash:
        attn = flash_attention(q, k, v, scale=1.0)
    else:
        attn = gqa_attention(q, k, v, scale=1.0)
    attn = attn.reshape(b, s, d)
    x = x + (quant.q_matmul_a8(attn, _lin(lp["o"], i)) + _bias(lp["o"], i, x.dtype))
    h = layer_norm(x, lp["ln2_w"][i], lp["ln2_b"][i])
    act = quant.q_matmul_a8(h, _lin(lp["fc1"], i)) + _bias(lp["fc1"], i, h.dtype)
    act = F.gelu(act) if cfg.activation == "gelu" else F.relu(act)
    return x + (quant.q_matmul_a8(act, _lin(lp["fc2"], i)) + _bias(lp["fc2"], i, act.dtype))


def stage_qkv(xf: torch.Tensor, lp: TensorTree, i: int, fused: bool) -> torch.Tensor:
    """LayerNorm -> quant -> fused q|k|v int8 product + bias: K9 ``enc_ln_qkv``, or its
    composed torch form."""
    ln_w, ln_b, p = lp["ln1_w"][i], lp["ln1_b"][i], lp["qkv"]
    if fused:
        return enc_fused.enc_ln_qkv(xf, ln_w, ln_b, p["w_q"][i], p["scale"][i], p["b"][i],
                                    w_t=p["w_t"][i] if "w_t" in p else None)
    h = layer_norm(xf, ln_w, ln_b)
    return (quant.q_matmul_a8q(*quant.quantize_act(h), _lin(p, i), out_dtype=h.dtype)
            + _bias(p, i, h.dtype))


def stage_out(ao: torch.Tensor, xf: torch.Tensor, lp: TensorTree, i: int, fused: bool):
    """o-proj + residual -> (x2, int8 codes and f32 scales of LayerNorm(x2)): K9
    ``enc_out_ln``, or its composed torch form."""
    ln_w, ln_b, p = lp["ln2_w"][i], lp["ln2_b"][i], lp["o"]
    if fused:
        return enc_fused.enc_out_ln(ao, xf, p["w_q"][i], p["scale"][i], p["b"][i], ln_w, ln_b,
                                    w_t=p["w_t"][i] if "w_t" in p else None)
    x2 = (xf + quant.q_matmul_a8q(*quant.quantize_act(ao), _lin(p, i), out_dtype=ao.dtype)
          + _bias(p, i, ao.dtype))
    return (x2, *quant.quantize_act(layer_norm(x2, ln_w, ln_b)))


def stage_mlp(hq: torch.Tensor, hs: torch.Tensor, x2: torch.Tensor, lp: TensorTree, i: int,
              ffn_dim: int, fused: bool) -> torch.Tensor:
    """x2 + fc2(quant(gelu(fc1(h)))): K9 ``enc_mlp`` (re-quantization per 2560-wide f
    tile), or its composed torch form (per row, exact GELU)."""
    p1, p2 = lp["fc1"], lp["fc2"]
    if fused:
        kmajor = (p1["w_t"][i], p2["w_t"][i]) if "w_t" in p1 else None
        return enc_fused.enc_mlp(hq, hs, p1["w_q"][i], p1["scale"][i], p1["b"][i],
                                 p2["w_q"][i], p2["scale"][i], p2["b"][i], x2,
                                 f_tile=largest_divisor_tile(ffn_dim, enc_fused.MLP_F_TILE),
                                 kmajor=kmajor)
    g = quant.q_matmul_a8q(hq, hs, _lin(p1, i), out_dtype=x2.dtype) + _bias(p1, i, x2.dtype)
    gq, gs = quant.quantize_act(F.gelu(g.float()).to(x2.dtype))
    return (x2 + quant.q_matmul_a8q(gq, gs, _lin(p2, i), out_dtype=x2.dtype)
            + _bias(p2, i, x2.dtype))


def _layer_forward_fused(x: torch.Tensor, lp: TensorTree, i: int,
                         cfg: WhisperEncoderConfig) -> torch.Tensor:
    """The fused int8 layout (JAX ``_layer_forward_fused``): each stage through K9 when it
    is in ``cfg.fused_stages``, else through its composed form; attention through K2."""
    if cfg.activation != "gelu":
        raise ValueError("the fused int8 encoder layer computes exact GELU only")
    b, s, d = x.shape
    nh, hd = cfg.num_heads, cfg.head_dim
    xf = x.reshape(b * s, d)
    qkv = stage_qkv(xf, lp, i, "qkv" in cfg.fused_stages)
    q, k, v = (t.reshape(b, s, nh, hd) for t in qkv.split(d, dim=-1))
    if cfg.use_flash:
        attn = flash_attention(q, k, v, scale=1.0)
    else:
        attn = gqa_attention(q, k, v, scale=1.0)
    x2, hq, hs = stage_out(attn.reshape(b * s, d), xf, lp, i, "out" in cfg.fused_stages)
    x3 = stage_mlp(hq, hs, x2, lp, i, cfg.ffn_dim, "mlp" in cfg.fused_stages)
    return x3.reshape(b, s, d)


def largest_divisor_tile(n: int, cap: int) -> int:
    """Largest divisor of n that is <= cap (enc_mlp needs ffn_dim % f_tile == 0)."""
    for t in range(min(n, cap), 0, -1):
        if n % t == 0:
            return t
    return 1


def pool_output(x: torch.Tensor, stride: int) -> torch.Tensor:
    """AvgPool1d(stride, stride) over time."""
    if stride == 1:
        return x
    n, t, d = x.shape
    return x.reshape(n, t // stride, stride, d).mean(dim=2)


def apply(enc: WhisperEncoder, cfg: WhisperEncoderConfig, mels: torch.Tensor) -> torch.Tensor:
    """[num_windows, 2 * max_source_positions, num_mel_bins] -> [num_windows, T/pool, d],
    computed in the weights' dtype."""
    n, frames, n_mels = mels.shape
    if frames != 2 * cfg.max_source_positions or n_mels != cfg.num_mel_bins:
        raise ValueError(f"expected [N, {2 * cfg.max_source_positions}, {cfg.num_mel_bins}] "
                         f"mels, got {tuple(mels.shape)}")
    x = mels.to(enc.conv1.weight.dtype).transpose(1, 2)             # [N, M, frames]
    x = F.gelu(F.conv1d(x, enc.conv1.weight, padding=1) + enc.conv1.bias[:, None])
    x = F.gelu(F.conv1d(x, enc.conv2.weight, stride=2, padding=1) + enc.conv2.bias[:, None])
    x = x.transpose(1, 2) + enc.embed_positions[None]
    if isinstance(enc, QuantWhisperEncoder):
        fwd = _layer_forward_fused if enc.fused else _layer_forward_a8
        layer_fn = remat_wrap(lambda h, i: fwd(h, enc.layers, i, cfg), cfg.remat)
        for i in range(enc.num_layers):
            x = layer_fn(x, i)
    else:
        layer_fn = remat_wrap(lambda h, layer: _layer_forward(h, layer, cfg), cfg.remat)
        for layer in enc.layers:
            x = layer_fn(x, layer)
    x = pool_output(x, cfg.pool_stride)
    return layer_norm(x, enc.layer_norm.weight, enc.layer_norm.bias)
