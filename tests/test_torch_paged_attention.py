"""K3's plain version (the port's paged-attention decode, ops/kernels/paged_attention.py)
against the JAX Pallas kernel run in interpret mode, on the same numpy-seeded inputs:
every row including a length-0 one, partial last pages, tables shuffled over the pool,
stacked and sliced pools, f32 / bf16 / int8 pools; plus the dense reference,
merge_current_token, and the wrapper's refusals."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_flamingo_tpu.ops.pallas import paged_attention as jpa
from audio_flamingo_tpu_torch.ops.kernels import paged_attention as pa

jax.config.update("jax_default_matmul_precision", "highest")
torch.set_num_threads(2)

TOL = 2e-5           # f32: |port - JAX| on o, m, l and the merged output
BF16_TOL = 2e-3      # bf16: |port - JAX| / max|JAX o| on o (p rounded to bf16 both sides)
L, NB, BLOCK, NKV, HD, B, G, MP = 3, 16, 128, 2, 128, 4, 3, 6
LENGTHS = [0, 70, 300, MP * BLOCK]   # empty, one partial page, full + partial, all full


def _inputs(kind: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, NKV, G, HD)).astype(np.float32)
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


def _jax(q, k, v, ks, vs, tables, lengths, layer, dtype=jnp.float32, fn=jpa.paged_attention):
    pool_dt = jnp.int8 if k.dtype == np.int8 else dtype
    kw = {} if ks is None else dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    out = fn(jnp.asarray(q, dtype), jnp.asarray(k, pool_dt), jnp.asarray(v, pool_dt),
             jnp.asarray(tables), jnp.asarray(lengths), jnp.asarray(layer), **kw)
    return [np.asarray(x) for x in out]


def _port(q, k, v, ks, vs, tables, lengths, layer, dtype=torch.float32, fn=pa.paged_attention,
          sliced=False):
    pool_dt = torch.int8 if k.dtype == np.int8 else dtype
    kt, vt = torch.from_numpy(k).to(pool_dt), torch.from_numpy(v).to(pool_dt)
    kst = None if ks is None else torch.from_numpy(ks)
    vst = None if vs is None else torch.from_numpy(vs)
    if sliced:
        kt, vt = kt[layer], vt[layer]
        kst = None if kst is None else kst[layer]
        vst = None if vst is None else vst[layer]
    out = fn(torch.from_numpy(q).to(dtype), kt, vt, torch.from_numpy(tables),
             torch.from_numpy(lengths), None if sliced else layer, k_scale=kst, v_scale=vst)
    return [x.numpy() for x in out]


@pytest.fixture(scope="module")
def jax_f32():
    """JAX kernel outputs per (pool kind, layer), computed once for the module."""
    out = {}
    for kind in ("float", "int8"):
        args = _inputs(kind)
        for layer in (0, 2):
            out[(kind, layer)] = _jax(*args, layer)
    return out


@pytest.mark.parametrize("kind", ["float", "int8"])
@pytest.mark.parametrize("layer", [0, 2])
def test_plain_matches_jax_kernel_every_row(jax_f32, kind, layer):
    args = _inputs(kind)
    want = jax_f32[(kind, layer)]
    got = _port(*args, layer)
    for g, w, name in zip(got, want, "oml"):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=TOL * max(1.0, np.abs(w).max()), rtol=0,
                                   err_msg=name)
    # the length-0 row is the kernel's initial state
    assert not got[0][0].any() and not got[2][0].any()
    assert (got[1][0] == np.float32(pa.NEG_INF)).all()


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_plain_matches_dense_reference_on_rows_with_keys(kind):
    args = _inputs(kind, seed=1)
    o, m, l = _port(*args, 1)
    o_r, m_r, l_r = _port(*args, 1, fn=pa.paged_attention_reference)
    # the port's dense reference is JAX's, value for value
    for g, w in zip((o_r, m_r, l_r), _jax(*args, 1, fn=jpa.paged_attention_reference)):
        np.testing.assert_allclose(g, w, atol=TOL * max(1.0, np.abs(w).max()), rtol=0)
    np.testing.assert_allclose(o[1:] / l[1:, ..., None], o_r[1:] / l_r[1:, ..., None],
                               atol=TOL, rtol=0)


def test_bf16_pool_rounds_p_as_the_jax_kernel():
    args = _inputs("float", seed=2)
    want = _jax(*args, 1, dtype=jnp.bfloat16)
    got = _port(*args, 1, dtype=torch.bfloat16)
    scale = np.abs(want[0]).max()
    assert np.abs(got[0] - want[0]).max() <= BF16_TOL * scale
    np.testing.assert_allclose(got[1], want[1], atol=TOL * np.abs(want[1]).max(), rtol=0)
    np.testing.assert_allclose(got[2], want[2], atol=BF16_TOL * np.abs(want[2]).max(), rtol=0)


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_stacked_pool_equals_sliced_pool(kind):
    args = _inputs(kind, seed=3)
    for layer in (0, 2):
        stacked = _port(*args, layer)
        sliced = _port(*args, layer, sliced=True)
        for a, b in zip(stacked, sliced):
            np.testing.assert_array_equal(a, b)


def test_merge_current_token_matches_jax_on_every_row():
    """Kernel triple + the current token, port vs JAX, every row (the length-0 row
    included: its merged output is the current token's value)."""
    args = _inputs("float", seed=4)
    rng = np.random.default_rng(5)
    k_cur = rng.normal(size=(B, NKV, HD)).astype(np.float32)
    v_cur = rng.normal(size=(B, NKV, HD)).astype(np.float32)
    jo, jm, jl = _jax(*args, 0)
    want = np.asarray(jpa.merge_current_token(jnp.asarray(args[0]), jnp.asarray(k_cur),
                                              jnp.asarray(v_cur), jo, jm, jl))
    o, m, l = (torch.from_numpy(x) for x in _port(*args, 0))
    got = pa.merge_current_token(torch.from_numpy(args[0]), torch.from_numpy(k_cur),
                                 torch.from_numpy(v_cur), o, m, l).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    np.testing.assert_allclose(got[0], np.broadcast_to(v_cur[0][:, None], got[0].shape),
                               atol=1e-6, rtol=0)
    # the dense reference's triple differs on the empty row but merges to the same value
    ro, rm, rl = (torch.from_numpy(x) for x in _port(*args, 0, fn=pa.paged_attention_reference))
    merged_ref = pa.merge_current_token(torch.from_numpy(args[0]), torch.from_numpy(k_cur),
                                        torch.from_numpy(v_cur), ro, rm, rl).numpy()
    np.testing.assert_allclose(merged_ref, got, atol=TOL, rtol=0)


def test_wrapper_refuses_misuse():
    q, k, v, ks, vs, tables, lengths = (None if x is None else torch.from_numpy(x)
                                        for x in _inputs("int8", seed=6))
    with pytest.raises(ValueError, match="k_scale"):
        pa.paged_attention(q, k, v, tables, lengths, 0)
    with pytest.raises(ValueError, match="layer_idx"):
        pa.paged_attention(q, k, v, tables, lengths, k_scale=ks, v_scale=vs)
    with pytest.raises(TypeError):
        pa.paged_attention(q.double(), k, v, tables, lengths, 0, k_scale=ks, v_scale=vs)
    with pytest.raises(TypeError):   # an f32 pool cannot serve bf16 queries
        pa.paged_attention(q.to(torch.bfloat16), k.float(), v.float(), tables, lengths, 0)
    # a tensor on neither the CPU nor a card reaches no plain version and no kernel
    meta = [t.to("meta") for t in (q, k, v, tables, lengths)]
    with pytest.raises(ValueError, match="cuda"):
        pa.paged_attention(*meta, 0, k_scale=ks.to("meta"), v_scale=vs.to("meta"))
    assert pa.LAUNCHES.count == 0
