"""The dense int8 KV cache against the JAX package at f32: ``quantize_kv`` codes and
scales bit-identical to eager JAX ``_quantize_kv``, ``gqa_attention_q8`` against JAX's
(f32 within 1e-5 of max|ref|, bf16 within one output rounding), ``init_cache_q8``, and
tiny LMs (int8 untied with a flash prefill, int8 tied, float, int8 under ``a8_prefill``,
and the fused w4 tree through its suffix decode) prefilling and decoding 8 greedy steps
on ``Q8KVCache`` against JAX ``forward`` with its ``Q8KVCache``: logits within 1e-4 of
max|logit|, ids token-exact."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_flamingo_tpu.config import Qwen2Config as JQwen2Config
from audio_flamingo_tpu.models import qwen2 as jqwen2
from audio_flamingo_tpu.ops import quant as jquant
from audio_flamingo_tpu.ops import quant4 as jquant4
from audio_flamingo_tpu.ops.attention import gqa_attention_q8 as j_gqa_attention_q8
from audio_flamingo_tpu_torch import config as C
from audio_flamingo_tpu_torch.io.convert import lm_params_from_jax
from audio_flamingo_tpu_torch.models import qwen2
from audio_flamingo_tpu_torch.ops.attention import gqa_attention_q8

jax.config.update("jax_default_matmul_precision", "highest")
torch.set_num_threads(2)

LOGITS_TOL = 1e-4
JLM = JQwen2Config(vocab_size=128, hidden_size=256, intermediate_size=512, num_layers=2,
                   num_heads=4, num_kv_heads=2, head_dim=64, tie_word_embeddings=False)


def _pick(cls, obj):
    return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)})


@pytest.mark.parametrize("shape", [(2, 5, 2, 16), (1, 33, 4, 64)])
def test_quantize_kv_matches_eager_jax(shape):
    rng = np.random.default_rng(len(shape) + shape[1])
    x = (rng.normal(size=shape) * rng.uniform(0.01, 4.0, size=shape[:-1] + (1,))
         ).astype(np.float32)
    x[0, 0] = 0.0                       # zero rows: the scale's 1e-6 floor
    jq, js = jqwen2._quantize_kv(jnp.asarray(x))
    tq, ts = qwen2.quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _q8_inputs(b, q_len, nh, nkv, hd, kv_len, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, q_len, nh, hd)).astype(np.float32)
    k_q, v_q = (rng.integers(-127, 128, size=(b, kv_len, nkv, hd)).astype(np.int8)
                for _ in range(2))
    k_s, v_s = (rng.uniform(0.002, 0.03, size=(b, kv_len, nkv)).astype(np.float32)
                for _ in range(2))
    return q, k_q, v_q, k_s, v_s


@pytest.mark.parametrize("mask_kind", ["none", "causal", "per_head"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_attention_q8_matches_jax(dtype, mask_kind):
    b, q_len, nh, nkv, hd, kv_len = 2, 3, 8, 2, 32, 20
    q, k_q, v_q, k_s, v_s = _q8_inputs(b, q_len, nh, nkv, hd, kv_len, seed=7)
    mask = None
    if mask_kind == "causal":      # queries at positions 10-12 of a 20-slot cache
        mask = (np.arange(kv_len)[None, None, None, :]
                <= (10 + np.arange(q_len))[None, None, :, None]).repeat(b, 0)
    elif mask_kind == "per_head":
        mask = np.random.default_rng(8).uniform(size=(b, nh, q_len, kv_len)) < 0.7
        mask[..., 0] = True
    jq = jnp.asarray(q).astype(dtype)
    want = np.asarray(j_gqa_attention_q8(
        jq, jnp.asarray(k_q), jnp.asarray(v_q), jnp.asarray(k_s), jnp.asarray(v_s),
        mask=None if mask is None else jnp.asarray(mask)).astype(jnp.float32))
    tq = torch.from_numpy(q).to(getattr(torch, dtype))
    got = gqa_attention_q8(tq, *(torch.from_numpy(a) for a in (k_q, v_q, k_s, v_s)),
                           mask=None if mask is None else torch.from_numpy(mask.copy()))
    assert got.dtype == tq.dtype and got.shape == (b, q_len, nh, hd)
    diff, scale = np.abs(got.float().numpy() - want), np.abs(want).max()
    if dtype == "float32":
        assert diff.max() <= 1e-5 * scale
    else:
        assert (diff <= 2.0 ** -7 * np.abs(want) + 2.0 ** -9 * scale).all()


def test_init_cache_q8_matches_jax_layout():
    cfg = _pick(C.Qwen2Config, JLM)
    jc = jqwen2.init_cache_q8(JLM, 3, 24)
    tc = qwen2.init_cache_q8(cfg, 3, 24, "cpu")
    for t, j in ((tc.k_q, jc.k_q), (tc.v_q, jc.v_q), (tc.k_scale, jc.k_scale),
                 (tc.v_scale, jc.v_scale)):
        assert t.shape == j.shape and str(t.dtype).split(".")[-1] == str(j.dtype)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert tc.index == int(jc.index) == 0 and tc.capacity == jc.capacity == 24


@pytest.fixture(scope="module")
def trees():
    """JAX params of JLM: float, int8 (untied and tied) and fused w4 (group 64)."""
    init = jax.jit(jqwen2.init, static_argnums=1)
    tied = dataclasses.replace(JLM, tie_word_embeddings=True)
    fp = init(jax.random.PRNGKey(2), JLM)
    return {
        "float": (JLM, fp),
        "int8": (JLM, jax.jit(jquant.quantize_lm_params)(fp)),
        "int8_tied": (tied, jax.jit(jquant.quantize_lm_params)(init(jax.random.PRNGKey(3), tied))),
        "w4": (JLM, jax.jit(jquant4.quantize_lm_params_w4, static_argnames=("group_size",))(
            fp, group_size=64)),
    }


def _port_lm(jcfg, jp):
    cfg = _pick(C.Qwen2Config, jcfg)
    state = lm_params_from_jax(jax.tree.map(np.asarray, jp), cfg)
    if "ln_f_w" in state:
        return qwen2.quantized_lm(qwen2.unflatten(state), torch.float32, "cpu")
    with torch.device("meta"):
        lm = qwen2.Qwen2(cfg, dtype=torch.float32)
    lm = lm.to_empty(device="cpu")
    lm.load_state_dict(state)
    return lm.eval()


# (tree, config flags): flash prefill (the block's float K/V) or plain prefill over the
# cache's codes; a8_prefill runs the multi-token products w8a8 on the same cache
CASES = {"int8_flash": ("int8", dict(use_flash=True)),
         "int8_tied": ("int8_tied", dict()),
         "float_flash": ("float", dict(use_flash=True)),
         "int8_a8": ("int8", dict(a8_prefill=True)),
         "w4_suffix": ("w4", dict(use_flash=True))}


@pytest.mark.parametrize("case", list(CASES))
def test_lm_decodes_on_q8_cache_like_jax(trees, monkeypatch, case):
    tree, flags = CASES[case]
    jcfg, jp = trees[tree]
    jcfg = dataclasses.replace(jcfg, **flags)
    cfg = _pick(C.Qwen2Config, jcfg)
    lm = _port_lm(jcfg, jp)
    suffix_calls = []
    real = qwen2.w4_suffix_a
    monkeypatch.setattr(qwen2, "w4_suffix_a", lambda *a, **k: suffix_calls.append(1)
                        or real(*a, **k))
    b, t0, cap, steps = 2, 12, 32, 8
    ids = np.random.default_rng(1).integers(0, jcfg.vocab_size, (b, t0)).astype(np.int32)
    jcache = jqwen2.init_cache_q8(jcfg, b, cap)
    tcache = qwen2.init_cache_q8(cfg, b, cap, "cpu")
    jx = jqwen2.embed(jp, jnp.asarray(ids), dtype=jnp.float32)
    with torch.inference_mode():
        tx = qwen2.embed(lm, torch.from_numpy(ids).long())
    got_ids, want_ids = [], []
    for step in range(steps + 1):     # the prefill, then 8 greedy decode steps
        s = jx.shape[1]
        pos = np.broadcast_to(np.arange(tcache.index, tcache.index + s), (b, s)).astype(np.int32)
        jh, jcache = jqwen2.forward(jp, jcfg, jx, jnp.asarray(pos), cache=jcache,
                                    is_prefill=step == 0)
        want = np.asarray(jqwen2.unembed(jp, jcfg, jh[:, -1]))
        with torch.inference_mode():
            th, tcache = qwen2.forward(lm, cfg, tx, torch.from_numpy(pos).long(), cache=tcache,
                                       is_prefill=step == 0)
            got = qwen2.unembed(lm, th[:, -1]).numpy()
        assert np.abs(got - want).max() <= LOGITS_TOL * np.abs(want).max(), f"step {step}"
        got_ids.append(got.argmax(-1))
        want_ids.append(want.argmax(-1))
        nxt = want.argmax(-1)
        jx = jqwen2.embed(jp, jnp.asarray(nxt)[:, None], dtype=jnp.float32)
        with torch.inference_mode():
            tx = qwen2.embed(lm, torch.from_numpy(nxt).long()[:, None])
    np.testing.assert_array_equal(np.stack(got_ids), np.stack(want_ids))
    assert tcache.index == int(jcache.index) == t0 + steps
    # the same codes (one code of slack where an f32 difference crosses a rounding edge)
    # and scales in every written slot; the K/V quantized there carry the f32 differences
    # the logits are held to
    for t, j in ((tcache.k_q, jcache.k_q), (tcache.v_q, jcache.v_q)):
        assert np.abs(t.numpy().astype(np.int32) - np.asarray(j).astype(np.int32)).max() <= 1
    for t, j in ((tcache.k_scale, jcache.k_scale), (tcache.v_scale, jcache.v_scale)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=LOGITS_TOL, atol=0)
    assert len(suffix_calls) == (steps * jcfg.num_layers if tree == "w4" else 0)


def test_q8_cache_capacity_is_checked(trees):
    jcfg, jp = trees["int8"]
    cfg = _pick(C.Qwen2Config, jcfg)
    lm = _port_lm(jcfg, jp)
    cache = qwen2.init_cache_q8(cfg, 1, 4, "cpu")
    x = qwen2.embed(lm, torch.zeros((1, 5), dtype=torch.long))
    with pytest.raises(ValueError, match="cannot take"):
        qwen2.forward(lm, cfg, x, torch.arange(5)[None], cache=cache)
