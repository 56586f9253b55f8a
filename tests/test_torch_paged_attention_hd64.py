"""K3 at OPT's head dim 64 (AF1's paged engine): the plain version against the JAX Pallas
kernel in interpret mode and its dense reference at hd 64, scale 1 (OPT scales q before
the product), g = 1 (decode) and g' = 5 (a k = 4 verify folded into the group axis), over
f32, bf16 and int8 pools, every row including a length-0 one; the split's plan at hd 64;
the shared memory each kernel instantiation asks for (a model of the CUDA source's sizes,
read from its constants) within the card's limit for every head dim, dtype pair and head
tile; and the wrapper's refusal of any other head dim on a CUDA call."""

import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_flamingo_tpu.ops.pallas import paged_attention as jpa
from audio_flamingo_tpu_torch.ops.kernels import _build
from audio_flamingo_tpu_torch.ops.kernels import paged_attention as pa

jax.config.update("jax_default_matmul_precision", "highest")
torch.set_num_threads(2)

TOL = 2e-5           # |port - JAX| on o, m, l relative to max(1, max|JAX|)
BF16_TOL = 2e-3      # bf16 q over a bf16 pool: |port - JAX| / max|JAX o| (p rounded to bf16)
L, NB, BLOCK, NKV, HD, B, MP = 2, 12, 32, 4, 64, 4, 5
LENGTHS = [0, 20, 70, MP * BLOCK]


def _inputs(kind: str, g: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(B, NKV, g, HD)) * HD ** -0.5).astype(np.float32)   # pre-scaled
    if kind == "int8":
        k = rng.integers(-127, 128, size=(L, NB, BLOCK, NKV, HD)).astype(np.int8)
        v = rng.integers(-127, 128, size=(L, NB, BLOCK, NKV, HD)).astype(np.int8)
        ks = rng.uniform(0.001, 0.02, size=(L, NB, BLOCK, NKV)).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, size=(L, NB, BLOCK, NKV)).astype(np.float32)
    else:
        k = rng.normal(size=(L, NB, BLOCK, NKV, HD)).astype(np.float32)
        v = rng.normal(size=(L, NB, BLOCK, NKV, HD)).astype(np.float32)
        ks = vs = None
    tables = np.full((B, MP), -1, np.int32)
    ids = rng.permutation(np.arange(1, NB))
    ptr = 0
    for b, n_tok in enumerate(LENGTHS):
        n = -(-n_tok // BLOCK)
        tables[b, :n] = ids[ptr: ptr + n]
        ptr += n
    return q, k, v, ks, vs, tables, np.asarray(LENGTHS, np.int32)


def _jax(q, k, v, ks, vs, tables, lengths, layer, q_dt=jnp.float32, pool_dt=jnp.float32,
         fn=jpa.paged_attention):
    pool_dt = jnp.int8 if k.dtype == np.int8 else pool_dt
    kw = {} if ks is None else dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    out = fn(jnp.asarray(q, q_dt), jnp.asarray(k, pool_dt), jnp.asarray(v, pool_dt),
             jnp.asarray(tables), jnp.asarray(lengths), jnp.asarray(layer), scale=1.0, **kw)
    return [np.asarray(x, np.float32) for x in out]


def _port(q, k, v, ks, vs, tables, lengths, layer, q_dt=torch.float32, pool_dt=torch.float32,
          fn=pa.paged_attention):
    pool_dt = torch.int8 if k.dtype == np.int8 else pool_dt
    t = lambda x: None if x is None else torch.from_numpy(x)
    out = fn(t(q).to(q_dt), t(k).to(pool_dt), t(v).to(pool_dt), t(tables), t(lengths), layer,
             k_scale=t(ks), v_scale=t(vs), scale=1.0)
    return [x.float().numpy() for x in out]


def _close(got, want, tol=TOL):
    for g, w, name in zip(got, want, "oml"):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=tol * max(1.0, np.abs(w).max()), rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("g", [1, 5])
@pytest.mark.parametrize("pool", ["float32", "bfloat16", "int8"])
def test_plain_matches_jax_kernel_and_reference_at_hd64(g, pool):
    """f32 q over an f32, bf16 or int8 pool (the f32 engine's pools) at layer 1: the plain
    version within 2e-5 of JAX's kernel on every row and of its dense reference on the rows
    with keys (normalized; the reference gives a length-0 row p = 1 on masked keys)."""
    kind = "int8" if pool == "int8" else "float"
    args = _inputs(kind, g, seed=g)
    pdt = getattr(jnp, pool)
    got = _port(*args, 1, pool_dt=getattr(torch, pool))
    _close(got, _jax(*args, 1, pool_dt=pdt))
    assert not got[0][0].any() and not got[2][0].any()
    assert (got[1][0] == np.float32(pa.NEG_INF)).all()
    o_r, _, l_r = _jax(*args, 1, pool_dt=pdt, fn=jpa.paged_attention_reference)
    np.testing.assert_allclose(got[0][1:] / got[2][1:, ..., None], o_r[1:] / l_r[1:, ..., None],
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("g", [1, 5])
def test_bf16_pool_rounds_p_as_the_jax_kernel_at_hd64(g):
    args = _inputs("float", g, seed=10 + g)
    want = _jax(*args, 0, q_dt=jnp.bfloat16, pool_dt=jnp.bfloat16)
    got = _port(*args, 0, q_dt=torch.bfloat16, pool_dt=torch.bfloat16)
    assert np.abs(got[0] - want[0]).max() <= BF16_TOL * np.abs(want[0]).max()
    np.testing.assert_allclose(got[1], want[1], atol=TOL * np.abs(want[1]).max(), rtol=0)


def test_verify_fold_merges_as_jax_at_hd64():
    """A 5-token verify block at g = 1: the folded call's triple merged with the block's
    own triangle (merge_block_tokens) equals JAX's on every row."""
    q, k, v, ks, vs, tables, lengths = _inputs("int8", 5, seed=20)
    rng = np.random.default_rng(21)
    kb = rng.normal(size=(B, 5, NKV, HD)).astype(np.float32)
    vb = rng.normal(size=(B, 5, NKV, HD)).astype(np.float32)
    fold_np = lambda x: np.swapaxes(x.reshape(B, NKV, 5, 1, *x.shape[3:]), 1, 2)
    qg = fold_np(q)
    jo, jm, jl = (fold_np(x) for x in _jax(q, k, v, ks, vs, tables, lengths, 0))
    want = np.asarray(jpa.merge_block_tokens(jnp.asarray(qg), jnp.asarray(kb), jnp.asarray(vb),
                                             jnp.asarray(jo), jnp.asarray(jm), jnp.asarray(jl),
                                             scale=1.0))
    po, pm, pl = (torch.from_numpy(fold_np(x)) for x in _port(q, k, v, ks, vs, tables,
                                                              lengths, 0))
    got = pa.merge_block_tokens(torch.from_numpy(qg), torch.from_numpy(kb),
                                torch.from_numpy(vb), po, pm, pl, scale=1.0).numpy()
    np.testing.assert_allclose(got, want, atol=TOL * max(1.0, np.abs(want).max()), rtol=0)


def test_plan_at_hd64():
    """AF1's engine shape (B 4, nkv 32, hd 64, 128-token pages, 16 entries): the parts'
    o take hd 64 floats a row, and the parts' o stay 16-byte aligned."""
    for g in (1, 5):
        pl = pa.plan(4, 32, g, 64, 128, 16, 4)
        bkg = 4 * 32 * g
        assert pl.part_o == bkg * pl.parts * 64 and pl.part_ml == bkg * pl.parts
        assert pl.floats == bkg * (16 * 2 * 64 + pl.parts * (64 + 2)) + pl.pmax
        assert (pl.scores + pl.pmax) % 4 == 0


def _constant(name: str) -> int:
    with open(os.path.join(_build.CSRC, "paged_attention.cu")) as f:
        m = re.search(rf"constexpr (?:int|size_t) {name} = (\d+);", f.read())
    assert m, name
    return int(m.group(1))


def _smem(q_item: int, kv_item: int, hd: int, kt: int, pages_per_part: int) -> tuple:
    """(score_kernel, attend_kernel) dynamic shared memory as csrc/paged_attention.cu sizes
    it (row_bytes, stage_bytes, kstage_bytes, q_smem, score_smem, attend_smem)."""
    c, tile, stages, warps = _constant("kC"), _constant("kTile"), _constant("kStages"), 8
    pad = _constant("kPad")
    mma = q_item == 2 and kv_item == 2
    row = hd * kv_item + (16 if mma else (0 if hd * kv_item % 128 == pad else pad))
    stage = c * row + c * tile * kt * 4 + c * 4
    kstage = stage if kt == 1 else c * row + c * 4
    if mma:
        q_smem = tile * hd * 4 if kt == 1 else tile * kt * (hd + 8) * 2
    else:
        q_smem = tile * kt * hd * 4
    kg = tile * kt
    score = stages * kstage + q_smem + warps * kg * 4
    attend = stages * stage + c * kg * 4 + (pages_per_part + 1) * kg * 4 + warps * kg * 4
    return score, attend


@pytest.mark.parametrize("hd", [64, 128])
def test_every_instantiation_fits_the_shared_memory_limit(hd):
    """Every (q, pool) pair the kernel takes, one head tile (g <= 8) and eight (g <= 64),
    at a part of 64 table entries: both kernels within the card's limit (less the 16
    bytes the launch keeps back), so the hd-64 kernels launch wherever the hd-128 ones do."""
    limit = _constant("kSmemLimit")
    assert hd in pa.KERNEL_HEAD_DIMS
    for q_item, kv_item in ((4, 4), (4, 2), (2, 2), (4, 1), (2, 1)):
        for kt in (1, 8):
            score, attend = _smem(q_item, kv_item, hd, kt, 64)
            assert score + 16 <= limit and attend + 16 <= limit, (q_item, kv_item, kt)
    # hd 64 asks for no more than hd 128 in any case
    if hd == 64:
        for q_item, kv_item in ((4, 4), (2, 2), (2, 1)):
            assert all(a <= b for a, b in zip(_smem(q_item, kv_item, 64, 1, 16),
                                              _smem(q_item, kv_item, 128, 1, 16)))


def test_kernel_refuses_other_head_dims():
    """The CUDA call's argument check (run before any launch): hd 64 and 128 pass, 96 and
    256 are refused, as are groups past KERNEL_MAX_GROUP; the CPU plain version takes any
    hd."""
    for hd in pa.KERNEL_HEAD_DIMS:
        pa.check_kernel_shape(hd, 1)
        pa.check_kernel_shape(hd, pa.KERNEL_MAX_GROUP)
    for hd, g in ((96, 1), (256, 1), (64, pa.KERNEL_MAX_GROUP + 1), (64, 0)):
        with pytest.raises(ValueError, match="hd"):
            pa.check_kernel_shape(hd, g)
    q = torch.zeros((1, 1, 1, 96))
    pool = torch.zeros((2, 8, 1, 96))
    o, m, l = pa.paged_attention(q, pool, pool, torch.tensor([[1]], dtype=torch.int32),
                                 torch.tensor([3], dtype=torch.int32), scale=1.0)
    assert o.shape == (1, 1, 1, 96) and float(l[0, 0, 0]) == 3.0
