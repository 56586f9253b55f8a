"""Host code and numerics around the redesigned fused w4 suffixes (K6) and log-mel (K1).

K6 is one persistent launch per suffix: each product cut into (column tile, K split)
work items that the blocks walk, the splits added in split order by the tile's last
split, the norm's per-tile sums of squares added in tile order. Here: the plain version
that follows that order against JAX's Pallas kernels (interpret mode, f32), the plan's
coverage of every (tile, split) at the 7B and the small shapes, and the C constants the
wrapper mirrors. K1 runs its products in 3xTF32 on the tensor cores: a CPU emulation of
those products (TF32 rounding by bit operations) through the plain steps against JAX's
fused log-mel, the base split's layout as the kernel reads it, and the tiling's coverage
of every frame, bin and mel of a 30 s window.
"""

import dataclasses
import os
import re
from unittest import mock

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from audio_flamingo_tpu.audio import mel as jmel
from audio_flamingo_tpu.config import MelConfig as JMelConfig
from audio_flamingo_tpu.config import Qwen2Config as JQwen2Config
from audio_flamingo_tpu.models import qwen2 as jqwen2
from audio_flamingo_tpu.ops import quant4 as jquant4
from audio_flamingo_tpu.ops.pallas import quant4_block as jblock
from audio_flamingo_tpu_torch.audio import mel as tmel
from audio_flamingo_tpu_torch.config import AF3Config, MelConfig
from audio_flamingo_tpu_torch.models import qwen2
from audio_flamingo_tpu_torch.ops.kernels import _build
from audio_flamingo_tpu_torch.ops.kernels import log_mel as lm
from audio_flamingo_tpu_torch.ops.kernels import w4_suffix as k6
from audio_flamingo_tpu_torch.ops.kernels import w4a16_matmul as k5

jax.config.update("jax_default_matmul_precision", "highest")
torch.set_num_threads(2)

TOL = 1e-5                 # tests/test_torch_w4_suffix.py: f32, relative to max|y| per output
EPS = 1e-6
MEL_TOL = (5e-4, 1e-4)     # chip_smoke's K1 limit: |x - plain| <= 5e-4 + 1e-4 |plain|

JCFG = JQwen2Config(vocab_size=128, hidden_size=256, intermediate_size=512, num_layers=2,
                    num_heads=4, num_kv_heads=2, head_dim=64, tie_word_embeddings=True)
jinit = jax.jit(jqwen2.init, static_argnums=1)
jquantize_w4 = jax.jit(jquant4.quantize_lm_params_w4, static_argnames=("group_size", "fuse"))


def _csrc_constant(source: str, name: str) -> int:
    with open(os.path.join(_build.CSRC, source)) as f:
        m = re.search(rf"constexpr (?:int|unsigned|size_t) {name} = (\d+);", f.read())
    assert m, f"{name} not in {source}"
    return int(m.group(1))


# ------------------------------------------------------------------ K6: the kernel's order

def _phase_partials(x: torch.Tensor, p: dict, layer: int, pp) -> torch.Tensor:
    """The f32 partial sums of each split, [splits, m, ld]: per split, its groups' products
    (low half against the low codes, high against the high, each times its scale) summed
    in group order, as a work item accumulates them."""
    w_p, gscale = (p["w_p"][layer], p["gscale"][layer])
    xf = x.float()
    parts = []
    for s in range(pp.splits):
        g0, g1 = s * pp.per, min(pp.ng, (s + 1) * pp.per)
        acc = torch.zeros((x.shape[0], pp.ld), dtype=torch.float32, device=x.device)
        for gi in range(g0, g1):
            rows = slice(gi * pp.group, (gi + 1) * pp.group)
            lo = k5.low_nibble(w_p[rows]).float()
            hi = k5.high_nibble(w_p[rows]).float()
            acc = acc + ((xf[:, rows] @ lo) * gscale[gi] + (xf[:, pp.kp:][:, rows] @ hi)
                         * gscale[pp.ng + gi])
        parts.append(acc)
    return torch.stack(parts)


def _split_sum(parts: torch.Tensor) -> torch.Tensor:
    out = parts[0]
    for s in range(1, parts.shape[0]):
        out = out + parts[s]
    return out


def _order_norm(h: torch.Tensor, norm_w: torch.Tensor, eps: float, pp):
    """hn from h in f32 as the kernel forms it: per-row sums of h^2 per 128-column tile
    (the slots [m, tiles]), added in tile order, then (h * rsqrt(sum / d + eps)) * w."""
    d = h.shape[1]
    ss = torch.zeros((h.shape[0], 1), dtype=torch.float32, device=h.device)
    for t in range(pp.tiles):
        ss = ss + (h[:, t * k6.BLOCK_N:(t + 1) * k6.BLOCK_N] ** 2).sum(-1, keepdim=True)
    return (h * torch.rsqrt(ss / d + eps)) * norm_w.float()


def order_reference_a(attn2d, h_res, ln2_w, o_p, gu_p, layer: int, pl,
                      eps: float = 1e-6):
    """Suffix A in the persistent kernel's order of sums under plan ``pl`` -> (act, h)."""
    dt = attn2d.dtype
    h = _split_sum(_phase_partials(attn2d, o_p, layer, pl.first)) + h_res.float()
    hn = _order_norm(h, ln2_w, eps, pl.first).to(dt)
    gu = _split_sum(_phase_partials(hn, gu_p, layer, pl.second))
    f = pl.second.n
    return (gu[:, :f] / (1 + torch.exp(-gu[:, :f])) * gu[:, f:]).to(dt), h.to(dt)


def order_reference_b(act, h, ln1_next, down_p, qkv_p, layer: int, next_layer: int,
                      pl, eps: float = 1e-6):
    """Suffix B in the persistent kernel's order of sums under plan ``pl`` -> (h2, qkv)."""
    dt = act.dtype
    h2 = _split_sum(_phase_partials(act, down_p, layer, pl.first)) + h.float()
    hn = _order_norm(h2, ln1_next, eps, pl.first).to(dt)
    qkv = _split_sum(_phase_partials(hn, qkv_p, next_layer, pl.second))
    return h2.to(dt), qkv.to(dt)


def _trees(group: int):
    """The same fused w4 layers in JAX (jnp) and in the port, norm weights away from 1."""
    layers = jquantize_w4(jinit(jax.random.PRNGKey(5), JCFG), group_size=group)["layers"]
    rng = np.random.default_rng(group + 1)
    for name in ("ln1_w", "ln2_w"):
        layers[name] = jnp.asarray(1.0 + 0.5 * rng.standard_normal(layers[name].shape),
                                   jnp.float32)
    tree = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), layers)
    port = qwen2.quantized_lm({"layers": tree, "ln_f_w": torch.ones(256)}, torch.float32,
                              "cpu").layers
    return layers, port


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=TOL * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("group", [64, 128])
@pytest.mark.parametrize("m", [1, 3, 8])
def test_order_reference_matches_jax(group, m):
    jl, tl = _trees(group)
    st = qwen2.split_stacked_w4(tl)
    rng = np.random.default_rng(10 + m)
    d, f, k_o = 256, 512, 256
    attn = rng.normal(size=(m, k_o)).astype(np.float32)
    h = rng.normal(size=(m, d)).astype(np.float32)
    # a grid of 64 blocks: every product splits K as far as its groups allow
    pa = k6.plan(m, k_o, d, f, group, group, True, 64)
    for layer in (0, 1):
        nxt = min(layer + 1, 1)
        pb = k6.plan(m, f, d, st["qkv"]["w_p"].shape[2], group, group, False, 64)
        j_act, j_h = jblock.w4_suffix_a(jnp.asarray(attn), jnp.asarray(h), jl["ln2_w"][layer],
                                        jl["o"], jl["mlp"]["gateup"], jnp.int32(layer), eps=EPS)
        t_act, t_h = order_reference_a(torch.from_numpy(attn), torch.from_numpy(h),
                                          tl["ln2_w"][layer], st["o"], st["mlp"]["gateup"],
                                          layer, pa, eps=EPS)
        _close(t_act, j_act)
        _close(t_h, j_h)
        act = np.asarray(j_act)
        j_h2, j_qkv = jblock.w4_suffix_b(jnp.asarray(act), j_h, jl["ln1_w"][nxt],
                                         jl["mlp"]["down"], jl["qkv"], jnp.int32(layer),
                                         jnp.int32(nxt), eps=EPS)
        t_h2, t_qkv = order_reference_b(torch.from_numpy(act),
                                           torch.from_numpy(np.array(j_h)), tl["ln1_w"][nxt],
                                           st["mlp"]["down"], st["qkv"], layer, nxt, pb,
                                           eps=EPS)
        _close(t_h2, j_h2)
        _close(t_qkv, j_qkv)


def test_order_reference_splits_for_real():
    """The plans the order test runs do split K, so the split-order sums are exercised."""
    pa = k6.plan(1, 256, 256, 512, 64, 64, True, 64)
    assert pa.first.splits == pa.second.splits == 2 and pa.first.tiles == 2
    pb = k6.plan(1, 512, 256, 512, 128, 128, False, 64)
    assert pb.first.splits == 2 and pb.second.splits == 1


# ------------------------------------------------------------------ K6: the work-item plan

# (m, k1, d, n2, group1, group2, gated): the 7B suffixes A and B, the test trees', the tiny
# LM's (hidden 64, intermediate 128; its own group of 32)
SHAPES = [(1, 3584, 3584, 18944, 128, 128, True), (8, 3584, 3584, 18944, 128, 128, True),
          (1, 18944, 3584, 4608, 128, 128, False), (8, 18944, 3584, 4608, 128, 128, False),
          (3, 256, 256, 512, 64, 64, True), (3, 512, 256, 512, 128, 128, False),
          (2, 256, 64, 128, 32, 32, True), (2, 128, 64, 128, 32, 32, False)]
BLOCKS = [1, 3, 132, 528, 660, 792, 924, 1056, 1584]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("blocks", BLOCKS)
def test_k6_plan_covers_every_tile_and_split_once(shape, blocks):
    m, k1, d, n2, g1, g2, gated = shape
    pl = k6.plan(m, k1, d, n2, g1, g2, gated, blocks)
    for pp, kp, n, group in ((pl.first, k1 // 2, d, g1), (pl.second, d // 2, n2, g2)):
        assert pp.kp == kp and pp.n == n and pp.group == group
        seen = []
        for b in range(blocks):
            mine = list(k6.block_items(pp.items, blocks, b))
            assert len(mine) <= -(-pp.items // blocks)           # the plan's longest share
            seen.extend(mine)
        assert sorted(seen) == list(range(pp.items))            # each item once
        pairs, groups = set(), {}
        for i in range(pp.items):
            t, s, gr = pp.item(i)
            pairs.add((t, s))
            groups.setdefault(t, []).extend(gr)
            assert len(gr) >= 1 and len(gr) * group <= max(k6.X_ROWS, group)   # fits xbuf
        assert pairs == {(t, s) for t in range(pp.tiles) for s in range(pp.splits)}
        for t in range(pp.tiles):                                # whole groups, each once
            assert groups[t] == list(range(kp // group))
        assert pp.tiles * k6.BLOCK_N >= n > (pp.tiles - 1) * k6.BLOCK_N


def test_k6_gate_tile_is_paired_with_its_up_tile():
    pl = k6.plan(1, 3584, 3584, 18944, 128, 128, True, 792)
    gu = pl.second
    assert (gu.segs, gu.n, gu.ld) == (2, 18944, 2 * 18944)
    # a work item's two segments are gate columns [128 t, 128 t + 128) and the up columns
    # f further on, so its ticket's last split holds both halves of silu(gate) * up
    for i in (0, 1, gu.items - 1):
        t, _, _ = gu.item(i)
        gate = range(t * k6.BLOCK_N, min(gu.n, (t + 1) * k6.BLOCK_N))
        up = [gu.n + c for c in gate]
        assert all(c < gu.n for c in gate) and all(gu.n <= c < gu.ld for c in up)
    b = k6.plan(1, 18944, 3584, 4608, 128, 128, False, 792).second
    assert (b.segs, b.ld) == (1, 4608)


@pytest.mark.parametrize("blocks", BLOCKS)
@pytest.mark.parametrize("m", [1, 8])
def test_k6_plan_takes_the_least_longest_share(blocks, m):
    """No split of whole groups gives the critical path fewer ring stages (the longest
    block's items, each its stages plus a fixed cost, then the splits' sum: m x splits
    partial sums per thread of a tile's last split in phase 2, splits in phase 1, where
    the blocks share the rows); a tie goes to fewer splits."""
    for kp, n, segs, group in ((1792, 3584, 1, 128), (1792, 18944, 2, 128),
                               (9472, 3584, 1, 128), (1792, 4608, 1, 128)):
        pp = k6.phase_plan(kp, n, segs, group, blocks, m)
        ng, tiles = kp // group, -(-n // k5.BLOCK_N)

        def cost(per):
            splits = -(-ng // per)
            return (-(-tiles * splits // blocks) * (segs * per * group // 32 + k6.ITEM_STAGES)
                    + -(-splits * m * segs // k6.FINISH_LOADS) * k6.FINISH_ROUND_STAGES)

        options = range(1, min(max(1, k6.X_ROWS // group), ng) + 1)
        best = min(cost(p) for p in options)
        assert cost(pp.per) == best
        assert pp.per == max(p for p in options if cost(p) == best)


def test_k6_scratch_and_control_layout():
    pl = k6.plan(8, 3584, 3584, 18944, 128, 128, True, 792)
    f, s = pl.first, pl.second
    assert pl.scratch_floats == (f.splits * 8 * 3584 + s.splits * 8 * 2 * 18944 + 8 * 3584
                                 + f.tiles * 8)
    assert pl.control_ints == 2 + s.tiles <= k6.CONTROL_INTS
    # the partial sums' float2 stores stay 8-byte aligned at each region's start
    assert (f.splits * 8 * f.ld) % 2 == 0 and (s.splits * 8 * s.ld) % 2 == 0


def test_k6_constants_match_the_source():
    assert _csrc_constant("w4_suffix.cu", "kXRows") == k6.X_ROWS
    assert _csrc_constant("w4_suffix.cu", "kMaxRows") == k6.MAX_ROWS
    assert _csrc_constant("w4_suffix.cu", "kControl") == k6.CONTROL_INTS
    assert _csrc_constant("w4_mma.cuh", "kBN") == k6.BLOCK_N == k5.BLOCK_N
    assert _csrc_constant("w4_mma.cuh", "kRows") == k5.STAGE_ROWS
    assert _csrc_constant("w4_mma.cuh", "kMaxGroup") == k5.MAX_GROUP


def test_k6_cuda_path_refuses_cpu_before_loading_the_library(monkeypatch):
    def no_library(*a, **k):
        raise AssertionError("the kernel library was loaded for CPU tensors")

    monkeypatch.setattr(_build, "load_library", no_library)
    x = torch.zeros(1, 256)
    with pytest.raises(ValueError, match="run on cuda"):
        k6._prepare(x, (128, 128), ((128, 256), (128, 1024)), gated=True)
    with pytest.raises(ValueError, match="run on cuda"):
        k6._prepare(x, (128, 128), ((256, 256), (128, 384)), gated=False)


# ------------------------------------------------------------------ K1: 3xTF32

def log_mel_3xtf32(wins: torch.Tensor, dft_cos: torch.Tensor, dft_sin: torch.Tensor,
                   mel_weights: torch.Tensor, hop: int, frames_per_window: int) -> torch.Tensor:
    """The kernel's products in plain PyTorch: every operand split by ``tf32_split``,
    each product a_lo b_hi + a_hi b_lo + a_hi b_hi with f32 sums (the sums' order is the
    library's, not the MMA's), then the plain steps: the card's numerics on the CPU."""
    def mm3(a, b):
        ah, al = lm.tf32_split(a)
        bh, bl = lm.tf32_split(b)
        return al @ bh + ah @ bl + ah @ bh

    n_fft = dft_cos.shape[0]
    half = n_fft // 2
    padded = F.pad(wins[:, None], (half, half), mode="reflect")[:, 0]
    frames = padded.unfold(-1, n_fft, hop)[:, :frames_per_window]
    re = mm3(frames, dft_cos)
    im = mm3(frames, dft_sin)
    power = re * re + im * im
    log_spec = torch.log10(torch.clamp(mm3(power, mel_weights), min=1e-10))
    mx = log_spec.amax(dim=(1, 2), keepdim=True)
    log_spec = torch.maximum(log_spec, mx - 8.0)
    return (log_spec + 4.0) / 4.0


def _jax_fused_log_mel(*args):
    """The Pallas kernel in interpreter mode, as tests/test_stft_mel_pallas.py runs it."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    with mock.patch.object(pl, "pallas_call", patched):
        from audio_flamingo_tpu.ops.pallas.stft_mel import fused_log_mel

        return np.asarray(fused_log_mel(*args))


def _wav(seed, n, tone=True):
    rng = np.random.default_rng(seed)
    if not tone:
        return (rng.normal(size=n) * 0.1).astype(np.float32)
    t = np.arange(n) / 16000.0
    return (0.3 * np.sin(2 * np.pi * 440.0 * t) + 0.05 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("tone", [True, False])
def test_k1_3xtf32_emulation_matches_jax(tone):
    cfg = MelConfig(num_mel_bins=128)
    jf = jmel.WhisperMelFrontend(JMelConfig(num_mel_bins=128))
    tf = tmel.WhisperMelFrontend(cfg, device="cpu")
    wins = _wav(7, 480_000, tone)[None]
    want = _jax_fused_log_mel(jnp.asarray(wins), jf.dft_cos, jf.dft_sin, jf.mel_weights,
                              cfg.hop_length, 3000)
    got = log_mel_3xtf32(torch.from_numpy(wins), tf.dft_cos, tf.dft_sin, tf.mel_weights,
                            cfg.hop_length, 3000).numpy()
    assert got.shape == want.shape == (1, 3000, 128)
    np.testing.assert_allclose(got, want, atol=MEL_TOL[0], rtol=MEL_TOL[1])
    plain = lm.log_mel_reference(torch.from_numpy(wins), tf.dft_cos, tf.dft_sin,
                                 tf.mel_weights, cfg.hop_length, 3000).numpy()
    np.testing.assert_allclose(got, plain, atol=MEL_TOL[0], rtol=MEL_TOL[1])


def test_tf32_split_is_exact_rounding():
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(50_000) * 10.0 ** rng.integers(-8, 8, 50_000))
                         .astype(np.float32))
    hi, lo = lm.tf32_split(x)
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0   # 10 mantissa bits
    # hi is x to nearest, ties away from zero: within half an ulp of TF32
    xd, hd = x.double(), hi.double()
    assert bool(((xd - hd).abs() <= 2.0 ** -11 * xd.abs() * (1 + 1e-12)).all())
    # hi + lo keeps about 21 bits of x
    assert bool(((xd - hd - lo.double()).abs() <= 2.0 ** -21 * xd.abs()).all())
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])        # halfway: away from 0
    assert lm.tf32_split(tie)[0].tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]


def test_k1_prepared_bases_are_the_split_bases_in_the_kernels_layout():
    fe = tmel.WhisperMelFrontend(MelConfig(num_mel_bins=128), device="cpu")
    kb = fe.kernel_bases
    assert fe.kernel_bases is kb                               # made once per frontend
    n_fft, n_bins = fe.dft_cos.shape
    ks = n_fft // 8
    assert kb.dft.shape == (2, ks, 2, 2, lm.KERNEL_MAX_BINS, 4)
    assert kb.mel.shape == (lm.KERNEL_MAX_BINS // 8, 2, 2, lm.KERNEL_MAX_MELS, 4)
    for name, base in (("cos", fe.dft_cos), ("sin", fe.dft_sin)):
        hi, lo = lm.tf32_split(base)
        c = 0 if name == "cos" else 1
        for p in range(2):
            rows = slice(c * lm.PASS_BINS, (c + 1) * lm.PASS_BINS)
            bins = slice(p * lm.PASS_BINS, min(n_bins, (p + 1) * lm.PASS_BINS))
            nb = bins.stop - bins.start
            for hl, part in enumerate((hi, lo)):
                got = kb.dft[p, :, hl, :, rows].permute(0, 1, 3, 2).reshape(n_fft, -1)
                assert torch.equal(got[:, :nb], part[:, bins])
                assert not got[:, nb:].any()                   # padded bins are 0
    hi, lo = lm.tf32_split(fe.mel_weights)
    for hl, part in enumerate((hi, lo)):
        got = kb.mel[:, hl].permute(0, 1, 3, 2).reshape(lm.KERNEL_MAX_BINS, -1)
        assert torch.equal(got[:n_bins, :128], part) and not got[n_bins:].any()


def test_k1_tiling_covers_a_30s_window():
    cfg = MelConfig(num_mel_bins=128)
    hop, n_fft, frames, n_bins = cfg.hop_length, cfg.n_fft, 3000, cfg.n_fft // 2 + 1
    tf, mt_rows = lm.TILE_FRAMES, 16
    # frames: blocks of 64, in each two frame groups of two 16-row m-tiles
    rows = sorted(b * tf + fg * 32 + mt * mt_rows + r for b in range(-(-frames // tf))
                  for fg in range(2) for mt in range(2) for r in range(mt_rows))
    assert rows == list(range(-(-frames // tf) * tf)) and rows[-1] + 1 >= frames
    # bins: two passes of 104; warp cg takes n-tiles 6 cg .. 6 cg + 6, the second warp
    # leaving its first to the first warp; each bin stored once, every real bin covered
    stored = []
    for p in range(2):
        for cg in range(2):
            nt0 = cg * (lm.PASS_BINS // 8 - 7)
            for nt in range(7):
                if cg == 1 and nt == 0:
                    continue
                stored.extend(p * lm.PASS_BINS + (nt0 + nt) * 8 + c for c in range(8))
    assert sorted(stored) == list(range(lm.KERNEL_MAX_BINS)) and n_bins <= lm.KERNEL_MAX_BINS
    # mels: two groups of 64 in 8 n-tiles
    mels = sorted(cg * 64 + nt * 8 + c for cg in range(2) for nt in range(8) for c in range(8))
    assert mels == list(range(lm.KERNEL_MAX_MELS))
    # the skewed signal layout: frame row f's k-step ks starts where padded sample
    # hop f + 8 ks was stored, and a k-step never crosses a hop
    assert hop % 8 == 0 and n_fft % 8 == 0
    for f in range(tf):
        for ks in range(n_fft // 8):
            s = hop * f + 8 * ks
            kernel = (hop + 4) * f + 8 * ks + 4 * (8 * ks // hop)
            assert kernel == s + 4 * (s // hop) == (s + 7) + 4 * ((s + 7) // hop) - 7
    seg = (tf - 1) * hop + n_fft
    assert (hop + 4) * (tf - 1) + n_fft - 1 + 4 * ((n_fft - 1) // hop) < seg + 4 * (-(-seg // hop))


def test_k1_wrapper_takes_prepared_bases_and_the_cpu_ignores_them():
    fe = tmel.WhisperMelFrontend(MelConfig(num_mel_bins=128), use_pallas=True, device="cpu")
    wins = torch.from_numpy(_wav(3, 480_000))[None]
    args = (wins, fe.dft_cos, fe.dft_sin, fe.mel_weights, 160, 3000)
    lm.LAUNCHES.reset()
    out = lm.fused_log_mel(*args, bases=fe.kernel_bases)
    assert torch.equal(out, lm.log_mel_reference(*args)) and lm.LAUNCHES.count == 0
    assert torch.equal(fe(wins[0].numpy()), out)


def test_tiny_config_mel_takes_the_kernel_shapes():
    mc = AF3Config.tiny().mel if hasattr(AF3Config.tiny(), "mel") else MelConfig()
    for cfg in (mc, MelConfig(num_mel_bins=128)):
        assert cfg.hop_length % 8 == 0 and cfg.n_fft % 8 == 0
        assert cfg.n_fft // 2 + 1 <= lm.KERNEL_MAX_BINS and cfg.num_mel_bins <= lm.KERNEL_MAX_MELS
        assert dataclasses.is_dataclass(cfg)
