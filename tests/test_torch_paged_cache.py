"""The port's paged KV cache (runtime/paged_cache.py) against the JAX package at f32, on
the same numpy-seeded weights, pages and tables: ``paged_decode_step`` logits within
1e-4 and the K/V it writes, ``paged_decode_chunk`` greedy ids exact, with f32, bf16 and
int8 pools; the fused w4 suffix branch; the install, restore and suffix-prefill helpers;
``BlockAllocator``; and ``quantize_kv``."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_flamingo_tpu.config import Qwen2Config as JQwen2Config
from audio_flamingo_tpu.models import qwen2 as jqwen2
from audio_flamingo_tpu.ops import quant4 as jquant4
from audio_flamingo_tpu.ops.sampling import SamplingParams as JSamplingParams
from audio_flamingo_tpu.ops.sampling import row_sampling as j_row_sampling
from audio_flamingo_tpu.runtime import paged_cache as jpc
from audio_flamingo_tpu_torch import config as C
from audio_flamingo_tpu_torch.io.convert import lm_params_from_jax
from audio_flamingo_tpu_torch.models import qwen2
from audio_flamingo_tpu_torch.ops.sampling import SamplingParams, row_sampling
from audio_flamingo_tpu_torch.runtime import paged_cache as pc

jax.config.update("jax_default_matmul_precision", "highest")
torch.set_num_threads(2)

LOGITS_TOL = 1e-4
KV_TOL = 1e-5            # f32 / bf16 K and V written by a decode step
SCALE_RTOL = 1e-6        # int8 pools' per-token scales
BLOCK, MAX_BLOCKS, NUM_BLOCKS = 8, 4, 12
JLM = JQwen2Config(vocab_size=96, hidden_size=48, intermediate_size=96, num_layers=2,
                   num_heads=4, num_kv_heads=2, tie_word_embeddings=True)
# a fused-w4 tree that suffix_supported accepts (K/2 a multiple of 128 for d, f and o)
JLM_W4 = JQwen2Config(vocab_size=128, hidden_size=256, intermediate_size=512, num_layers=2,
                      num_heads=4, num_kv_heads=2, head_dim=64, tie_word_embeddings=False)
POOLS = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16),
         "int8": (jnp.int8, torch.int8)}
LENGTHS = [5, 13, 0]      # a partial page, one full page and a partial one, an empty row


def _cfg(j):
    names = [f.name for f in dataclasses.fields(C.Qwen2Config)]
    return C.Qwen2Config(**{name: getattr(j, name) for name in names})


def _float_lm(jp, cfg):
    with torch.device("meta"):
        lm = qwen2.Qwen2(cfg, dtype=torch.float32)
    lm = lm.to_empty(device="cpu")
    lm.load_state_dict(lm_params_from_jax(jax.tree.map(np.asarray, jp), cfg))
    return lm.eval()


@pytest.fixture(scope="module")
def lms():
    jp = jax.jit(jqwen2.init, static_argnums=1)(jax.random.PRNGKey(0), JLM)
    return jp, _float_lm(jp, _cfg(JLM))


@pytest.fixture(scope="module")
def w4_lms():
    jp = jax.jit(jqwen2.init, static_argnums=1)(jax.random.PRNGKey(3), JLM_W4)
    jq = jax.jit(jquant4.quantize_lm_params_w4, static_argnames=("group_size",))(
        jp, group_size=64)
    cfg = _cfg(JLM_W4)
    lm = qwen2.quantized_lm(qwen2.unflatten(lm_params_from_jax(jq, cfg)), torch.float32, "cpu")
    return jq, lm


def _pool_state(jcfg, kind: str, seed: int):
    """Numpy pools holding random context for LENGTHS rows in shuffled pages."""
    rng = np.random.default_rng(seed)
    hd = jcfg.resolved_head_dim()
    shape = (jcfg.num_layers, NUM_BLOCKS, BLOCK, jcfg.num_kv_heads, hd)
    if kind == "int8":
        k = rng.integers(-127, 128, size=shape).astype(np.int8)
        v = rng.integers(-127, 128, size=shape).astype(np.int8)
        ks = rng.uniform(0.002, 0.01, size=shape[:-1]).astype(np.float32)
        vs = rng.uniform(0.002, 0.01, size=shape[:-1]).astype(np.float32)
    else:
        k = rng.normal(size=shape).astype(np.float32)
        v = rng.normal(size=shape).astype(np.float32)
        ks = vs = None
    tables = np.full((len(LENGTHS), MAX_BLOCKS), -1, np.int32)
    ids = rng.permutation(np.arange(1, NUM_BLOCKS))
    ptr = 0
    for b, n_tok in enumerate(LENGTHS):
        n = -(-(n_tok + 6) // BLOCK)     # pages for the context and the steps to come
        tables[b, :n] = ids[ptr: ptr + n]
        ptr += n
    return k, v, ks, vs, tables, np.asarray(LENGTHS, np.int32)


def _caches(jcfg, kind: str, seed: int = 0):
    k, v, ks, vs, tables, lengths = _pool_state(jcfg, kind, seed)
    jdt, tdt = POOLS[kind]
    jc = jpc.PagedKV(jnp.asarray(k, jdt), jnp.asarray(v, jdt), jnp.asarray(tables),
                     jnp.asarray(lengths), None if ks is None else jnp.asarray(ks),
                     None if vs is None else jnp.asarray(vs))
    tc = pc.PagedKV(torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt),
                    torch.from_numpy(tables), torch.from_numpy(lengths),
                    None if ks is None else torch.from_numpy(ks),
                    None if vs is None else torch.from_numpy(vs))
    return jc, tc


def _assert_pools_close(tc, jc):
    """The port's pool against JAX's after the same writes. int8: codes within one code
    and scales within SCALE_RTOL (the K/V going in differ by f32 round-off, and JAX's
    jitted quantizer may turn /127 into a product)."""
    if tc.quantized:
        for t, j in ((tc.k, jc.k), (tc.v, jc.v)):
            assert np.abs(t.numpy().astype(np.int32) - np.asarray(j).astype(np.int32)).max() <= 1
        for t, j in ((tc.k_scale, jc.k_scale), (tc.v_scale, jc.v_scale)):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=SCALE_RTOL, atol=0)
    else:
        np.testing.assert_allclose(tc.k.float().numpy(), np.asarray(jc.k, np.float32),
                                   atol=KV_TOL, rtol=KV_TOL)
        np.testing.assert_allclose(tc.v.float().numpy(), np.asarray(jc.v, np.float32),
                                   atol=KV_TOL, rtol=KV_TOL)


@pytest.mark.parametrize("kind", list(POOLS))
def test_decode_step_matches_jax(lms, kind):
    jp, lm = lms
    jc, tc = _caches(JLM, kind)
    tokens = np.asarray([3, 50, 7], np.int32)
    for step in range(3):
        jc, jl = jpc.paged_decode_step(jp, JLM, jc, jnp.asarray(tokens),
                                       compute_dtype=jnp.float32)
        tc, tl = pc.paged_decode_step(lm, _cfg(JLM), tc, torch.from_numpy(tokens).long())
        want = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), want, atol=LOGITS_TOL, rtol=0,
                                   err_msg=f"step {step}")
        assert (tl.numpy().argmax(-1) == want.argmax(-1)).all()
        np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
        tokens = want.argmax(-1).astype(np.int32)
    _assert_pools_close(tc, jc)


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_decode_chunk_matches_jax(lms, kind):
    """Greedy chunk of 5 steps, the third row already done (it keeps its length and
    emits EOS); ids exact, lengths and done flags equal."""
    jp, lm = lms
    jc, tc = _caches(JLM, kind, seed=1)
    eos, chunk = 95, 5
    tokens = np.asarray([11, 12, eos], np.int32)
    done = np.asarray([False, False, True])
    min_left = np.asarray([2, 0, 0], np.int32)
    jrows = j_row_sampling([JSamplingParams(greedy=True)] * 3)
    jc, jtok, jdone, _, jout, _, _ = jpc.paged_decode_chunk(
        jp, JLM, jc, jnp.asarray(tokens), jnp.asarray(done), jax.random.PRNGKey(0), jrows,
        jnp.asarray(min_left), chunk=chunk, eos_token_id=eos, compute_dtype=jnp.float32,
        use_min_new=True)
    tc, ttok, tdone, tout, _, _ = pc.paged_decode_chunk(
        lm, _cfg(JLM), tc, torch.from_numpy(tokens).long(), torch.from_numpy(done), None,
        row_sampling([SamplingParams(greedy=True)] * 3), torch.from_numpy(min_left).long(),
        chunk=chunk, eos_token_id=eos, use_min_new=True)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    assert int(tc.lengths[2]) == 0 and (tout[2] == eos).all()
    assert len(set(tout[:2].flatten().tolist())) > 1


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_w4_suffix_branch_matches_jax(w4_lms, monkeypatch, kind):
    """A fused w4 LM decodes through the two suffix calls per layer with K3 inside."""
    jq, lm = w4_lms
    calls = []
    real = qwen2.w4_suffix_a
    monkeypatch.setattr(qwen2, "w4_suffix_a", lambda *a, **k: calls.append(1) or real(*a, **k))
    jc, tc = _caches(JLM_W4, kind, seed=2)
    tokens = np.asarray([5, 77, 9], np.int32)
    for step in range(2):
        jc, jl = jpc.paged_decode_step(jq, JLM_W4, jc, jnp.asarray(tokens),
                                       compute_dtype=jnp.float32)
        tc, tl = pc.paged_decode_step(lm, _cfg(JLM_W4), tc, torch.from_numpy(tokens).long())
        want = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), want, atol=LOGITS_TOL, rtol=0,
                                   err_msg=f"step {step}")
        tokens = want.argmax(-1).astype(np.int32)
        assert (tl.numpy().argmax(-1) == tokens).all()
    assert len(calls) == 2 * JLM_W4.num_layers


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_install_restore_and_suffix_prefill_match_jax(lms, kind):
    jp, lm = lms
    cfg = _cfg(JLM)
    rng = np.random.default_rng(4)
    hd = JLM.resolved_head_dim()
    jc = jpc.init_paged(JLM, 2, NUM_BLOCKS, BLOCK, MAX_BLOCKS, dtype=POOLS[kind][0])
    tc = pc.init_paged(cfg, 2, NUM_BLOCKS, BLOCK, MAX_BLOCKS, dtype=POOLS[kind][1])
    # paged_install_prefill: a 2-page prefill into row 1 of a shuffled table
    kv_shape = (JLM.num_layers, 1, 2 * BLOCK, JLM.num_kv_heads, hd)
    sub = rng.normal(size=(2, *kv_shape)).astype(np.float32)
    table = np.asarray([7, 3, -1, -1], np.int32)
    jc = jpc.paged_install_prefill(jc, jnp.asarray(1), jnp.asarray(sub[0]), jnp.asarray(sub[1]),
                                   jnp.asarray(table), jnp.asarray(11), JLM,
                                   compute_dtype=jnp.float32)
    tc = pc.paged_install_prefill(tc, 1, torch.from_numpy(sub[0]), torch.from_numpy(sub[1]),
                                  torch.from_numpy(table), 11)
    np.testing.assert_array_equal(tc.block_tables.numpy(), np.asarray(jc.block_tables))
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    _assert_pools_close(tc, jc)
    # paged_install_pages: one more page elsewhere
    page = rng.normal(size=(2, JLM.num_layers, 1, BLOCK, JLM.num_kv_heads, hd)).astype(np.float32)
    jc = jpc.paged_install_pages(jc, jnp.asarray(page[0]), jnp.asarray(page[1]),
                                 jnp.asarray([5], jnp.int32), JLM, compute_dtype=jnp.float32)
    pc.paged_install_pages(tc, torch.from_numpy(page[0]), torch.from_numpy(page[1]), [5])
    _assert_pools_close(tc, jc)
    # paged_restore_pages: pages swapped out and back into other page ids
    k_host, v_host = tc.k[:, [7, 3]].clone(), tc.v[:, [7, 3]].clone()
    ks_host = None if kind != "int8" else tc.k_scale[:, [7, 3]].clone()
    vs_host = None if kind != "int8" else tc.v_scale[:, [7, 3]].clone()
    jc = jpc.paged_restore_pages(jc, jnp.asarray(k_host.numpy()), jnp.asarray(v_host.numpy()),
                                 None if ks_host is None else jnp.asarray(ks_host.numpy()),
                                 None if vs_host is None else jnp.asarray(vs_host.numpy()),
                                 jnp.asarray([9, 10], jnp.int32))
    pc.paged_restore_pages(tc, k_host, v_host, ks_host, vs_host, [9, 10])
    assert torch.equal(tc.k[:, 9], tc.k[:, 7]) and torch.equal(tc.v[:, 10], tc.v[:, 3])
    _assert_pools_close(tc, jc)
    # paged_prefill_suffix: a 6-token suffix over the 2 restored prefix pages
    emb = rng.normal(size=(1, BLOCK, JLM.hidden_size)).astype(np.float32)
    jk, jv, jl = jpc.paged_prefill_suffix(jp, JLM, jc, jnp.asarray([9, 10], jnp.int32),
                                          jnp.asarray(emb), jnp.asarray(2 * BLOCK + 6),
                                          n_prefix_pages=2, suffix_len=BLOCK,
                                          compute_dtype=jnp.float32)
    tk, tv, tl = pc.paged_prefill_suffix(lm, cfg, tc, [9, 10], torch.from_numpy(emb),
                                         2 * BLOCK + 6, n_prefix_pages=2, suffix_len=BLOCK)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGITS_TOL, rtol=0)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=KV_TOL, rtol=KV_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=KV_TOL, rtol=KV_TOL)
    # with no prefix it is a fresh prefill
    jk0, _, jl0 = jpc.paged_prefill_suffix(jp, JLM, jc, jnp.zeros((0,), jnp.int32),
                                           jnp.asarray(emb), jnp.asarray(6), n_prefix_pages=0,
                                           suffix_len=BLOCK, compute_dtype=jnp.float32)
    tk0, _, tl0 = pc.paged_prefill_suffix(lm, cfg, tc, [], torch.from_numpy(emb), 6,
                                          n_prefix_pages=0, suffix_len=BLOCK)
    np.testing.assert_allclose(tl0.numpy(), np.asarray(jl0), atol=LOGITS_TOL, rtol=0)
    np.testing.assert_allclose(tk0.numpy(), np.asarray(jk0), atol=KV_TOL, rtol=KV_TOL)


def test_block_allocator_matches_jax():
    ja, ta = jpc.BlockAllocator(num_blocks=6, reserve=1), pc.BlockAllocator(num_blocks=6, reserve=1)
    assert ta.free == ja.free and 0 not in ta.free
    for n in (2, 1):
        assert ta.alloc(n) == ja.alloc(n)
    ta.release([4, -1, 2])
    ja.release([4, -1, 2])
    assert ta.free == ja.free
    assert ta.alloc(3) == ja.alloc(3)
    with pytest.raises(MemoryError):
        ta.alloc(10)


def test_quantize_kv_matches_jax_eagerly():
    """Bit-identical codes and scales against JAX run eagerly (under jit XLA may turn the
    division by 127 into a product)."""
    x = np.random.default_rng(5).normal(size=(3, 7, 2, 16)).astype(np.float32) * 3
    x[0, 0, 0] = 0.0            # an all-zero token takes the 1e-6 floor
    with jax.disable_jit():
        jq, js = jqwen2._quantize_kv(jnp.asarray(x))
    tq, ts = qwen2.quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
