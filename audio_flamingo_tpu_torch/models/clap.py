"""CLAP / HTSAT audio tower (AF1/AF2's encoder), as ``audio_flamingo_tpu/models/clap.py``:
a Swin transformer over log-mel images.

``ClapAudioTower(cfg).encode(mels, is_longer) -> {"pooled", "embeds"}``:

- eval-mode BatchNorm over the mel bins, then ``reshape_mel2img``: the 1001 frames
  resized to spec_size x freq_ratio through a constant bicubic matrix (torch's bicubic,
  align_corners=True), folded into a spec_size x spec_size image;
- the patch embed (a strided conv) of the global channel and, with fusion, the three
  local crops through ``mel_conv`` laid side by side crop-major along the width and fused
  by attentional feature fusion (``_aff``) where ``is_longer``;
- the Swin stages: window attention with the relative position bias, shifted windows
  (roll and the -100 mask) on every second block where the resolution exceeds the
  window, patch merging between stages;
- the final norm, the mean pool (``pooled``), the 2-layer ReLU projection and its L2
  normalisation (``embeds``, the AF1/AF2 window embedding).

Weights are torch layouts: linears [out, in], convs OIHW (JAX's HWIO permuted once, in
``io/convert.clap_params_from_jax``). Activations run channels-last ([B, H, W, C]) as in
JAX. Products accumulate in f32 and round to the activations' dtype, as JAX's
``preferred_element_type=f32``; the softmax runs in f32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audio_flamingo_tpu_torch.config import ClapAudioConfig
from audio_flamingo_tpu_torch.ops.attention import bmm_f32
from audio_flamingo_tpu_torch.ops.mlp import gelu_mlp
from audio_flamingo_tpu_torch.ops.norms import Norm, layer_norm

NEG = -100.0  # Swin shifted-window mask value (HF modeling_clap.py:588)


# ------------------------------------------------------------------ host-side constants

def bicubic_interp_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Torch bicubic align_corners=True 1D interpolation as a matrix [n_out, n_in]."""
    a = -0.75

    def cubic(x):
        x = abs(x)
        if x <= 1:
            return (a + 2) * x ** 3 - (a + 3) * x ** 2 + 1
        if x < 2:
            return a * x ** 3 - 5 * a * x ** 2 + 8 * a * x - 4 * a
        return 0.0

    w = np.zeros((n_out, n_in), np.float64)
    if n_out == 1:
        w[0, 0] = 1.0
        return w
    scale = (n_in - 1) / (n_out - 1)
    for i in range(n_out):
        src = i * scale
        f = int(np.floor(src))
        for k in range(-1, 3):
            idx = min(max(f + k, 0), n_in - 1)
            w[i, idx] += cubic(src - (f + k))
    return w


def relative_position_index(window: int) -> np.ndarray:
    """[w*w, w*w] indices into the (2w-1)^2 bias table (HF modeling_clap.py:383-394)."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)


def shifted_window_mask(height: int, width: int, window: int, shift: int) -> np.ndarray:
    """[num_windows, w*w, w*w] additive mask (0 / -100) for SW-MSA."""
    img = np.zeros((height, width), np.int32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    wins = img.reshape(height // window, window, width // window, window)
    wins = wins.transpose(0, 2, 1, 3).reshape(-1, window * window)
    diff = wins[:, None, :] - wins[:, :, None]
    return np.where(diff != 0, NEG, 0.0).astype(np.float32)


# --------------------------------------------------------------------------- modules

class BatchNorm(nn.Module):
    """Eval-mode batch norm statistics and affine over the last axis."""

    def __init__(self, c: int, **factory):
        super().__init__()
        self.mean = nn.Parameter(torch.empty(c, **factory))
        self.var = nn.Parameter(torch.empty(c, **factory))
        self.weight = nn.Parameter(torch.empty(c, **factory))
        self.bias = nn.Parameter(torch.empty(c, **factory))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int, mlp_ratio: float, **factory):
        super().__init__()
        f = int(dim * mlp_ratio)
        self.ln1 = Norm(dim, **factory)
        self.q = nn.Linear(dim, dim, **factory)
        self.k = nn.Linear(dim, dim, **factory)
        self.v = nn.Linear(dim, dim, **factory)
        self.o = nn.Linear(dim, dim, **factory)
        self.bias_table = nn.Parameter(torch.empty((2 * window - 1) ** 2, num_heads, **factory))
        self.ln2 = Norm(dim, **factory)
        self.fc1 = nn.Linear(dim, f, **factory)
        self.fc2 = nn.Linear(f, dim, **factory)


class PatchMerge(nn.Module):
    def __init__(self, dim: int, **factory):
        super().__init__()
        self.norm = Norm(4 * dim, **factory)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False, **factory)


class AFFBranch(nn.Module):
    def __init__(self, d: int, inter: int, **factory):
        super().__init__()
        self.c1 = nn.Linear(d, inter, **factory)
        self.bn1 = BatchNorm(inter, **factory)
        self.c2 = nn.Linear(inter, d, **factory)
        self.bn2 = BatchNorm(d, **factory)


class PatchEmbed(nn.Module):
    def __init__(self, cfg: ClapAudioConfig, **factory):
        super().__init__()
        d0, ps = cfg.patch_embed_dim, cfg.patch_size
        self.proj = nn.Conv2d(1, d0, ps, stride=cfg.patch_stride, **factory)
        self.norm = Norm(d0, **factory)
        if cfg.enable_fusion:
            self.mel_conv = nn.Conv2d(1, d0, (ps, ps * 3),
                                      stride=(cfg.patch_stride, cfg.patch_stride * 3), **factory)
            self.aff_local = AFFBranch(d0, d0 // 4, **factory)
            self.aff_global = AFFBranch(d0, d0 // 4, **factory)


class Stage(nn.Module):
    def __init__(self, cfg: ClapAudioConfig, i: int, **factory):
        super().__init__()
        dim = cfg.patch_embed_dim * 2 ** i
        self.blocks = nn.ModuleList(
            SwinBlock(dim, cfg.num_heads[i], cfg.window_size, cfg.mlp_ratio, **factory)
            for _ in range(cfg.depths[i]))
        self.downsample = (PatchMerge(dim, **factory) if i < len(cfg.depths) - 1 else None)


class ClapAudioTower(nn.Module):
    """The HTSAT tower's weights and its constants (window masks, relative position
    indices, bicubic matrices per input length); ``encode`` is the forward."""

    def __init__(self, cfg: ClapAudioConfig, **factory):
        super().__init__()
        self.cfg = cfg
        self.freq_ratio = cfg.spec_size // cfg.num_mel_bins
        grid = cfg.spec_size // cfg.patch_stride
        feat = cfg.patch_embed_dim * 2 ** (len(cfg.depths) - 1)
        self.batch_norm = BatchNorm(cfg.num_mel_bins, **factory)
        self.patch_embed = PatchEmbed(cfg, **factory)
        self.stages = nn.ModuleList(Stage(cfg, i, **factory) for i in range(len(cfg.depths)))
        self.norm = Norm(feat, **factory)
        self.proj_fc1 = nn.Linear(feat, cfg.projection_dim, **factory)
        self.proj_fc2 = nn.Linear(cfg.projection_dim, cfg.projection_dim, **factory)
        self.resolutions = [(grid // 2 ** i, grid // 2 ** i) for i in range(len(cfg.depths))]
        self._rel_idx = relative_position_index(cfg.window_size)
        self._interp: dict = {}      # (frames, device, dtype) -> bicubic matrix
        self._consts: dict = {}      # device -> (rel_idx, masks)

    def constants(self, device: torch.device):
        """The relative position index and each stage's shift mask (None where the stage
        does not shift) on ``device``, made once."""
        if device not in self._consts:
            cfg = self.cfg
            masks = []
            for h, w in self.resolutions:
                masks.append(None if min(h, w) <= cfg.window_size else torch.tensor(
                    shifted_window_mask(h, w, cfg.window_size, cfg.window_size // 2),
                    device=device))
            self._consts[device] = (torch.tensor(self._rel_idx, device=device), masks)
        return self._consts[device]

    def interp(self, t: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
        key = (t, device, dtype)
        if key not in self._interp:
            self._interp[key] = torch.tensor(
                bicubic_interp_matrix(t, self.cfg.spec_size * self.freq_ratio)
                .astype(np.float32), device=device).to(dtype)
        return self._interp[key]

    @torch.inference_mode()
    def encode(self, mels: torch.Tensor, is_longer: torch.Tensor | None = None) -> dict:
        """mels [B, C, T, F] (C = 1 plain / 4 fusion) -> {'pooled': [B, features],
        'embeds': [B, projection_dim] L2-normalised}. is_longer: [B] or [B, 1] bool; the
        fusion branch runs only with 4 channels, fusion enabled and is_longer given."""
        return encode(self, mels, is_longer)


@torch.no_grad()
def init_(tower: ClapAudioTower, generator: torch.Generator) -> None:
    """The JAX init's distributions: Normal(0, 0.5 / sqrt(fan_in)) linears, zero biases,
    Normal(0, 0.02) convs, zero bias tables, unit norms, identity batch norms."""
    for mod in tower.modules():
        if isinstance(mod, nn.Linear):
            mod.weight.normal_(0.0, 0.5 * mod.in_features ** -0.5, generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Conv2d):
            mod.weight.normal_(0.0, 0.02, generator=generator)
            mod.bias.zero_()
        elif isinstance(mod, Norm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, BatchNorm):
            mod.mean.zero_()
            mod.var.fill_(1.0)
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, SwinBlock):
            mod.bias_table.zero_()


def build(cfg: ClapAudioConfig, device: torch.device | str, dtype: torch.dtype) -> ClapAudioTower:
    """An HTSAT tower's weights (uninitialized) allocated on ``device`` in ``dtype``."""
    with torch.device("meta"):
        tower = ClapAudioTower(cfg, dtype=dtype)
    return tower.to_empty(device=device).eval().requires_grad_(False)


# -------------------------------------------------------------------------- forward

def _linear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    y = F.linear(x, lin.weight.to(x.dtype))
    return y if lin.bias is None else y + lin.bias.to(x.dtype)


def _bn(x: torch.Tensor, bn: BatchNorm, eps: float = 1e-5) -> torch.Tensor:
    """Eval-mode batch norm over the last axis, in f32."""
    inv = torch.rsqrt(bn.var.float() + eps)
    return ((x.float() - bn.mean.float()) * inv * bn.weight.float()
            + bn.bias.float()).to(x.dtype)


def _conv(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """NCHW conv without padding -> NHWC output, bias added in x's dtype."""
    y = F.conv2d(x, conv.weight.to(x.dtype), stride=conv.stride)
    return y.permute(0, 2, 3, 1) + conv.bias.to(x.dtype)


def _window_attention(x, bp: SwinBlock, num_heads: int, rel_idx, mask):
    """x: [nW, w*w, C]; mask: [num_window_types, w*w, w*w] or None."""
    nw, t, c = x.shape
    hd = c // num_heads

    def heads(y):
        return y.reshape(nw, t, num_heads, hd).transpose(1, 2).reshape(nw * num_heads, t, hd)

    q, k, v = heads(_linear(x, bp.q)), heads(_linear(x, bp.k)), heads(_linear(x, bp.v))
    scores = bmm_f32(q, k.transpose(1, 2)).view(nw, num_heads, t, t) * (hd ** -0.5)
    bias = bp.bias_table[rel_idx.reshape(-1)].reshape(t, t, num_heads)
    scores = scores + bias.permute(2, 0, 1)[None].float()
    if mask is not None:
        n_types = mask.shape[0]
        scores = (scores.view(nw // n_types, n_types, num_heads, t, t)
                  + mask[None, :, None].float()).view(nw, num_heads, t, t)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = bmm_f32(probs.view(nw * num_heads, t, t), v).to(x.dtype)
    out = out.view(nw, num_heads, t, hd).transpose(1, 2).reshape(nw, t, c)
    return _linear(out, bp.o)


def _swin_block(x, bp: SwinBlock, h: int, w: int, num_heads: int, window: int, shift: int,
                rel_idx, mask):
    """x: [B, H*W, C]."""
    b, _, c = x.shape
    shortcut = x
    x = layer_norm(x, bp.ln1.weight, bp.ln1.bias).reshape(b, h, w, c)
    if shift > 0:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
    x = x.reshape(b, h // window, window, w // window, window, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)
    x = _window_attention(x, bp, num_heads, rel_idx, mask)
    x = x.reshape(b, h // window, w // window, window, window, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)
    if shift > 0:
        x = torch.roll(x, (shift, shift), dims=(1, 2))
    x = shortcut + x.reshape(b, h * w, c)
    hmid = layer_norm(x, bp.ln2.weight, bp.ln2.bias)
    return x + gelu_mlp(hmid, bp.fc1.weight.to(x.dtype), bp.fc1.bias, bp.fc2.weight.to(x.dtype),
                        bp.fc2.bias)


def _patch_merge(x, dp: PatchMerge, h: int, w: int):
    b, _, c = x.shape
    x = x.reshape(b, h, w, c)
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                  dim=-1)
    x = x.reshape(b, (h // 2) * (w // 2), 4 * c)
    x = layer_norm(x, dp.norm.weight, dp.norm.bias)
    return _linear(x, dp.reduction)


def reshape_mel2img(x: torch.Tensor, cfg: ClapAudioConfig, interp: torch.Tensor) -> torch.Tensor:
    """[B, C, T, F] normalized mels -> [B, C, spec, spec] (HF modeling_clap.py:824-858)."""
    b, c, t, f = x.shape
    freq_ratio = cfg.spec_size // cfg.num_mel_bins
    spec_w = cfg.spec_size * freq_ratio
    if t != spec_w:
        x = torch.matmul(interp, x)
    x = x.reshape(b, c * freq_ratio, spec_w // freq_ratio, f).transpose(2, 3)
    return x.reshape(b, c, f * freq_ratio, spec_w // freq_ratio)


def _aff_branch(x, br: AFFBranch):
    y = _bn(_linear(x, br.c1), br.bn1)
    return _bn(_linear(F.relu(y), br.c2), br.bn2)


def _aff(hidden, residual, pe: PatchEmbed):
    """Attentional feature fusion on [B, H, W, C] (HF modeling_clap.py:225-264)."""
    x = hidden + residual
    gate = torch.sigmoid(_aff_branch(x, pe.aff_local)
                         + _aff_branch(x.mean(dim=(1, 2), keepdim=True), pe.aff_global))
    return 2 * hidden * gate + 2 * residual * (1 - gate)


def encode(tower: ClapAudioTower, mels: torch.Tensor,
           is_longer: torch.Tensor | None = None) -> dict:
    cfg = tower.cfg
    dtype = tower.proj_fc1.weight.dtype
    mels = mels.to(dtype)
    b, c, t, f = mels.shape
    rel_idx, masks = tower.constants(mels.device)
    x = _bn(mels, tower.batch_norm)
    x = reshape_mel2img(x, cfg, tower.interp(t, mels.device, dtype))    # [B, C, S, S]

    pe = tower.patch_embed
    h0 = _conv(x[:, 0:1], pe.proj)                                       # [B, gh, gw, d0]
    if cfg.enable_fusion and c == 4 and is_longer is not None:
        # the 3 local crops through mel_conv, laid crop-major along the width
        lh = _conv(x[:, 1:].reshape(b * 3, 1, cfg.spec_size, cfg.spec_size), pe.mel_conv)
        gh, gw, gc = h0.shape[1], h0.shape[2], h0.shape[3]
        lh = lh.reshape(b, 3, gh, lh.shape[2], gc).transpose(1, 2).reshape(b, gh, -1, gc)
        lh = F.pad(lh, (0, 0, 0, max(0, gw - lh.shape[2])))[:, :, :gw]
        fused = _aff(h0, lh, pe)
        h0 = torch.where(is_longer.reshape(b, 1, 1, 1).to(mels.device), fused, h0)
    grid = cfg.spec_size // cfg.patch_stride
    x = layer_norm(h0.reshape(b, grid * grid, -1), pe.norm.weight, pe.norm.bias)

    for i, stage in enumerate(tower.stages):
        h, w = tower.resolutions[i]
        for j, bp in enumerate(stage.blocks):
            shift = 0 if min(h, w) <= cfg.window_size or j % 2 == 0 else cfg.window_size // 2
            x = _swin_block(x, bp, h, w, cfg.num_heads[i], cfg.window_size, shift, rel_idx,
                            masks[i] if shift > 0 else None)
        if stage.downsample is not None:
            x = _patch_merge(x, stage.downsample, h, w)

    x = layer_norm(x, tower.norm.weight, tower.norm.bias)
    pooled = x.mean(dim=1)
    proj = _linear(F.relu(_linear(pooled, tower.proj_fc1)), tower.proj_fc2)
    embeds = proj / torch.linalg.vector_norm(proj, dim=-1, keepdim=True)
    return {"pooled": pooled, "embeds": embeds}
