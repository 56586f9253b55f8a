"""What the Hopper redesigns of the int8-QK flash attention (K8) and the w8a16 matmul (K4)
rest on, checked on the CPU: the integer tile maximum equals the maximum of the rounded
scores for rowc of either sign; the plain body reads V in the CUDA prelude's layout (the
caller's [B, Tk, Hkv, D], read in place) as in the torch prelude's; the CUDA prelude's
host-side plan (padded sizes, chunks, grids, strides, shared memory) at the LM's, the
encoder's and a ragged shape, and what it refuses; a CPU tensor never loads the library;
K4's grouped launch (``w8a16_matmul_group``) against JAX's ``w8a16_matmul`` per product in
interpret mode; its split plan at the 7B shapes; its cached plan's refusals; and an int8
decode step's K4 calls (q|k|v and gate|up one call each)."""

import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from audio_flamingo_tpu_torch import config as C
from audio_flamingo_tpu_torch.models import qwen2
from audio_flamingo_tpu_torch.ops import quant
from audio_flamingo_tpu_torch.ops.kernels import _build
from audio_flamingo_tpu_torch.ops.kernels import flash_attention_a8 as fa8
from audio_flamingo_tpu_torch.ops.kernels import w8a16_matmul as k4

jax.config.update("jax_default_matmul_precision", "highest")
torch.set_num_threads(2)


# ------------------------------------------------------------------ K8
@pytest.mark.parametrize("sign", [1.0, -1.0, 0.0])
@pytest.mark.parametrize("seed", [0, 1])
def test_integer_tile_max_is_the_max_of_the_rounded_scores(seed, sign):
    """Random int32 scores (|s| < 2^24, as |q_i8 . k_i8| <= 127^2 D) and rowc of one sign
    per row (sign 0: mixed): the tile maximum from the integer extremes equals the
    maximum of float(s) * rowc over each tile's visible keys, bit for bit; a tile with no
    visible key gives -inf."""
    rng = np.random.default_rng(seed)
    rows, n_tiles, bk = 64, 3, 128
    s = rng.integers(-(2 ** 24) + 1, 2 ** 24, size=(rows, n_tiles * bk)).astype(np.float32)
    s[:, :5] = rng.integers(-3, 4, size=(rows, 5))          # near-equal small scores
    mag = np.exp(rng.uniform(-30, 5, size=rows)).astype(np.float32)
    sgn = np.sign(rng.normal(size=rows)) if sign == 0.0 else np.full(rows, sign)
    rowc = (mag * sgn).astype(np.float32)
    visible = rng.uniform(size=(rows, n_tiles * bk)) < 0.7
    visible[0, :bk] = False                                 # a tile with no visible key
    ts, tr, tv = torch.from_numpy(s), torch.from_numpy(rowc), torch.from_numpy(visible)
    got = fa8.tile_max(ts, tr, tv, n_tiles)
    scores = (ts * tr[:, None]).masked_fill(~tv, float("-inf"))
    want = scores.reshape(rows, n_tiles, bk).amax(-1)
    assert torch.equal(got, want)
    assert got[0, 0] == float("-inf")


def test_plain_body_reads_v_in_the_cuda_prelude_layout():
    """The CUDA prelude hands the body the caller's bf16 v [B, Tk, Hkv, D] (keys past Tk
    never read); the plain body gives the same o from it as from the torch prelude's
    padded [B*Hkv, tk_pad, D] copy."""
    rng = np.random.default_rng(7)
    b, tq, tk, h, hkv, d = 1, 70, 150, 4, 2, 64
    q = torch.from_numpy(rng.normal(size=(b, tq, h, d)).astype(np.float32)).bfloat16()
    k = torch.from_numpy(rng.normal(size=(b, tk, hkv, d)).astype(np.float32)).bfloat16()
    v = torch.from_numpy(rng.normal(size=(b, tk, hkv, d)).astype(np.float32)).bfloat16()
    pre = fa8.prelude(q, k, v, causal=True, q_offset=80, block_q=128, block_k=128)
    assert pre.v.shape == (b * hkv, 256, d) and pre.v_bthd().shape == (b, 256, hkv, d)
    in_place = dataclasses.replace(pre, v=v)
    assert in_place.v_bthd() is v
    assert torch.equal(fa8.flash_attention_a8_reference(in_place),
                       fa8.flash_attention_a8_reference(pre))


def _strides(shape):
    return torch.empty(shape, device="meta").stride()


@pytest.mark.parametrize("q_shape,k_shape,block_k,want", [
    # the LM's prefill: bq 512 over 1024 rows, one 1024-key tile
    ((1, 1024, 28, 128), (1, 1024, 4, 128), 1024,
     dict(bq=512, bk=1024, tq_pad=1024, tk_pad=1024, nchunk=4, body_grid=(7, 4, 16))),
    # the LM at 10 minutes: 16 tiles of 1024 keys
    ((1, 16384, 28, 128), (1, 16384, 4, 128), 1024,
     dict(bq=512, bk=1024, tq_pad=16384, tk_pad=16384, nchunk=64, body_grid=(7, 4, 256))),
    # the encoder: one 1536-key tile over 1500 keys, 20 windows
    ((20, 1500, 20, 64), (20, 1500, 20, 64), 2048,
     dict(bq=512, bk=1536, tq_pad=1536, tk_pad=1536, nchunk=6, body_grid=(1, 400, 24))),
    # ragged: 100 rows over 300 keys
    ((1, 100, 28, 128), (1, 300, 4, 128), 1024,
     dict(bq=128, bk=384, tq_pad=128, tk_pad=384, nchunk=2, body_grid=(7, 4, 2))),
])
def test_cuda_prelude_plan(q_shape, k_shape, block_k, want):
    qs = (q_shape[0], q_shape[1], q_shape[2] * 3, q_shape[3])      # q a view of a fused qkv
    q_strides = (qs[1] * qs[2] * qs[3], qs[2] * qs[3], qs[3], 1)
    pl_ = fa8.plan(q_shape, q_strides, k_shape, _strides(k_shape), k_shape, _strides(k_shape),
                   block_q=512, block_k=block_k)
    for key, val in want.items():
        assert getattr(pl_, key) == val, key
    b, tq, h, d = q_shape
    hkv = k_shape[2]
    assert pl_.q_strides == q_strides[:3] and pl_.k_strides == _strides(k_shape)[:3]
    assert pl_.stats_grid == (want["nchunk"], b * hkv)
    assert pl_.codes_blocks == (-(-b * h * want["tq_pad"] // fa8.Q_ROWS),
                                b * hkv * want["tk_pad"] // fa8.CODE_ROWS)
    assert pl_.body_smem == fa8.body_smem_bytes(d) <= 227 * 1024 // 2   # two blocks an SM
    assert pl_.nchunk * fa8.PRELUDE_KEYS >= k_shape[1] > (pl_.nchunk - 1) * fa8.PRELUDE_KEYS


def test_cuda_prelude_plan_refusals():
    lm_q, lm_k = (1, 64, 4, 128), (1, 64, 2, 128)
    ok = dict(block_q=512, block_k=1024)
    with pytest.raises(ValueError, match="head dims"):
        fa8.plan((1, 64, 4, 96), _strides((1, 64, 4, 96)), (1, 64, 2, 96),
                 _strides((1, 64, 2, 96)), (1, 64, 2, 96), _strides((1, 64, 2, 96)), **ok)
    with pytest.raises(ValueError, match="contiguous last dim"):
        fa8.plan(lm_q, (32768, 512, 1, 4), lm_k, _strides(lm_k), lm_k, _strides(lm_k), **ok)
    # any key tile streams through the ring: a 2048-key tile at D 128 plans as well
    big = fa8.plan((1, 4096, 4, 128), _strides((1, 4096, 4, 128)), (1, 4096, 2, 128),
                   _strides((1, 4096, 2, 128)), (1, 4096, 2, 128), _strides((1, 4096, 2, 128)),
                   block_q=512, block_k=2048)
    assert big.bk == 2048 and big.body_grid == (2, 2, 64)


def test_cpu_tensors_never_load_the_library(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("the kernel library was loaded for CPU tensors")

    monkeypatch.setattr(_build, "load_library", refuse)
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               for s in ((1, 40, 4, 64), (1, 40, 2, 64), (1, 40, 2, 64)))
    assert fa8.flash_attention_a8(q, k, v, causal=True).shape == (1, 40, 4, 64)
    with pytest.raises(ValueError, match="cuda"):
        fa8.prelude_kernel(q, k, v)
    x = torch.ones((2, 64))
    p = quant.quantize_linear(torch.ones((64, 32)))
    assert len(k4.w8a16_matmul_group(x, [p, p])) == 2
    assert k4.w8a16_matmul(x, p["w_q"], p["scale"]).shape == (2, 32)


# ------------------------------------------------------------------ K4
def _jax_kernel(x, w_q, scale, **blocks):
    """JAX's Pallas w8a16_matmul in interpret mode."""
    from audio_flamingo_tpu.ops.pallas.quant_matmul import w8a16_matmul

    orig = pl.pallas_call

    def patched(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    with mock.patch.object(pl, "pallas_call", patched):
        return np.asarray(w8a16_matmul(x, w_q, scale, **blocks).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 3, 8, 17])
def test_group_matches_jax_per_product(m, dtype):
    """Two products sharing x (as q|k or gate|up): each output of the grouped call
    against JAX's kernel on that product, f32 within 1e-5 of max|ref|, bf16 within one
    output rounding (2^-7 |ref| + 2^-9 max|ref|)."""
    rng = np.random.default_rng(m)
    k = 64
    x = rng.normal(size=(m, k)).astype(np.float32)
    prods = [{"w_q": rng.integers(-127, 128, size=(k, n)).astype(np.int8),
              "scale": rng.uniform(0.001, 0.02, size=(n,)).astype(np.float32)}
             for n in (64, 32)]
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = k4.w8a16_matmul_group(tx, [{n: torch.from_numpy(a) for n, a in p.items()}
                                     for p in prods])
    assert [g.shape for g in got] == [(m, 64), (m, 32)] and got[0].dtype == tx.dtype
    for g, p in zip(got, prods):
        want = _jax_kernel(jnp.asarray(x).astype(dtype), jnp.asarray(p["w_q"]),
                           jnp.asarray(p["scale"]), block_n=32, block_k=32)
        diff, mx = np.abs(g.float().numpy() - want), np.abs(want).max()
        if dtype == "float32":
            assert diff.max() <= 1e-5 * mx
        else:
            assert (diff <= 2.0 ** -7 * np.abs(want) + 2.0 ** -9 * mx).all()


@pytest.mark.parametrize("m", [1, 8, 32])
@pytest.mark.parametrize("k,ns", [(3584, (3584, 512, 512)), (3584, (3584,)),
                                  (3584, (18944, 18944)), (18944, (3584,)), (3584, (152064,))])
def test_k4_plan_splits_k_in_whole_units_at_7b_shapes(k, ns, m):
    """The 7B int8 LM's launches (q|k|v, o, gate|up, down, the head): K split in whole
    32-row stages, no split empty, the grid filled where K allows, the split tiles within
    the counters."""
    rows = k4.split_k(k, ns, m)
    splits = -(-k // rows)
    assert rows % k4.STAGE_ROWS == 0 and (splits - 1) * rows < k <= splits * rows
    tiles = sum(-(-n // k4.BLOCK_N) for n in ns) * -(-m // k4.rows_per_block(m, torch.bfloat16))
    assert splits == 1 or tiles * (splits - 1) < k4.TARGET_BLOCKS
    assert 2 * tiles * splits >= min(k4.TARGET_BLOCKS, tiles * k // k4.STAGE_ROWS)
    assert splits == 1 or tiles <= k4.COUNTERS


def test_group_plan_refusals_and_cache():
    x = torch.ones((2, 64), dtype=torch.bfloat16)
    ok = {"w_q": torch.ones((64, 32), dtype=torch.int8), "scale": torch.ones(32)}
    pl_ = k4._group_plan(x, [(ok["w_q"], ok["scale"])] * 2, torch.bfloat16)
    assert pl_.ns == (32, 32) and pl_.col0 == (0, 32) and pl_.ldo == 64
    assert k4._group_plan(x, [(ok["w_q"], ok["scale"])] * 2, torch.bfloat16) is pl_
    cases = [
        ([(ok["w_q"], ok["scale"])] * 5, "1 to 4"),
        ([(torch.ones((64, 24), dtype=torch.int8), torch.ones(24))], "N % 16"),
        ([(torch.ones((48, 32), dtype=torch.int8), torch.ones(32))], "do not agree"),
        ([(torch.ones((32, 64), dtype=torch.int8).t(), torch.ones(32))], "row-major"),
        ([(ok["w_q"], torch.ones(64)[::2])], "contiguous"),
    ]
    for prods, msg in cases:
        with pytest.raises(ValueError, match=msg):
            k4._group_plan(x, prods, torch.bfloat16)
    with pytest.raises(ValueError, match="runs on cuda"):
        k4.w8a16_matmul_group(x.to("meta"), [{n: t.to("meta") for n, t in ok.items()}])


def test_int8_step_groups_qkv_and_gate_up(monkeypatch):
    """One int8 decode step of a 2-layer LM: q|k|v and gate|up go to K4 in one call each
    (4 calls a layer and the head), with the outputs of the per-product route."""
    cfg = C.Qwen2Config(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2,
                        num_heads=4, num_kv_heads=2, tie_word_embeddings=False)
    with torch.device("meta"):
        flm = qwen2.Qwen2(cfg, dtype=torch.float32)
    flm = flm.to_empty(device="cpu")
    qwen2.init_(flm, torch.Generator().manual_seed(0))
    lm = qwen2.quantized_lm(quant.quantize_lm_params(flm.state_dict()), torch.float32, "cpu")
    calls = []
    real_group, real_one = k4.w8a16_matmul_group, k4.w8a16_matmul
    monkeypatch.setattr(k4, "w8a16_matmul_group", lambda x, ps, *a: calls.append(len(ps))
                        or real_group(x, ps, *a))
    monkeypatch.setattr(k4, "w8a16_matmul", lambda x, *a: calls.append(1) or real_one(x, *a))
    x = qwen2.embed(lm, torch.tensor([[3]]))
    cache = qwen2.init_cache(cfg, 1, 8, torch.float32, "cpu")
    h, _ = qwen2.forward(lm, cfg, x, torch.zeros((1, 1), dtype=torch.long), cache=cache)
    logits = qwen2.unembed(lm, h[:, 0])
    assert calls == [3, 1, 2, 1] * cfg.num_layers + [1]
    monkeypatch.setattr(quant, "KERNEL_MAX_ROWS", 0)     # every product on its own route
    calls.clear()
    cache = qwen2.init_cache(cfg, 1, 8, torch.float32, "cpu")
    h2, _ = qwen2.forward(lm, cfg, x, torch.zeros((1, 1), dtype=torch.long), cache=cache)
    assert calls == [] and torch.allclose(h2, h, rtol=0, atol=1e-6 * h.abs().max().item())
    assert torch.isfinite(logits).all()
