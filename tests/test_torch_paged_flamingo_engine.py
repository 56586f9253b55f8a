"""The port's paged AF1/AF2 engine (runtime/paged_flamingo_engine.PagedFlamingoEngine)
against JAX's PagedFlamingoEngine at f32 on the same numpy-seeded weights and requests
(JAX's Pallas kernel in interpret mode where its engine calls it): greedy ids token for
token on AF2 (float, int8, fused-w4 trees) and AF1 (OPT, head dim 8 here), f32, bf16 and
int8 pools, pool pressure (preemption and resume), history processors, media isolation on
a reused row, the prefix cache keyed by ids and the media digest, chunked prefill, the
attn_impl pins, and speculation with a text-only Qwen2 draft (greedy exact on f32 and int8
pools, the sampled rule's greedy limit). The tiny models are made lively
(tests/test_torch_flamingo.py) and the ids are required to vary."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_flamingo_tpu.ops.sampling import SamplingParams as JSamplingParams
from audio_flamingo_tpu.runtime import flamingo_engine as jfe
from audio_flamingo_tpu.runtime import paged_flamingo_engine as jpfe
from audio_flamingo_tpu_torch.ops.kernels import paged_attention as pa
from audio_flamingo_tpu_torch.ops.sampling import SamplingParams
from audio_flamingo_tpu_torch.runtime import flamingo_engine as fe
from audio_flamingo_tpu_torch.runtime import paged_flamingo_engine as pfe
from test_torch_flamingo import models
from test_torch_flamingo_engine import _assert_equal_and_varied, _requests, _spec

jax.config.update("jax_default_matmul_precision", "highest")
torch.set_num_threads(2)

EOS = 3
N_MEDIA, WPM = 1, 4
ENGINE = dict(num_rows=2, num_blocks=24, block_size=16, max_blocks_per_seq=8, chunk=4)
KV = {None: (None, None), "bf16": (jnp.bfloat16, torch.bfloat16), "int8": (jnp.int8, torch.int8)}


def _engines(layout: str, reqs, max_new: int, kv=None, jax_kw=None, port_kw=None, samplings=None,
             rounds: list | None = None, **kw):
    """Both paged engines on the same requests (submitted at once, or in ``rounds`` of
    request indices, each run to the end) -> (JAX results, port results, both engines)."""
    jcfg, params, cfg, model = models(layout)
    common = dict(ENGINE, eos_token_id=EOS, n_media=N_MEDIA, windows_per_media=WPM, **kw)
    jeng = jpfe.PagedFlamingoEngine(params=params, cfg=jcfg, compute_dtype=jnp.float32,
                                    kv_dtype=KV[kv][0], **common, **(jax_kw or {}))
    peng = pfe.PagedFlamingoEngine(model=model, cfg=cfg, device="cpu", kv_dtype=KV[kv][1],
                                   **common, **(port_kw or {}))
    out = []
    for eng, req_cls, sp_cls in ((jeng, jfe.FlamingoRequest, JSamplingParams),
                                 (peng, fe.FlamingoRequest, SamplingParams)):
        for part in rounds or [range(len(reqs))]:
            for i in part:
                ids, wins = reqs[i]
                sp = None if samplings is None else sp_cls(**samplings[i])
                eng.submit(req_cls(request_id=f"r{i}", ids=ids, window_embeds=wins,
                                   max_new_tokens=max_new, sampling=sp))
            results = eng.run_until_done()
        out.append(dict(results))
    return out[0], out[1], (jeng, peng)


@pytest.mark.parametrize("layout,kv", [("float", None), ("opt", None), ("float", "bf16"),
                                       ("float", "int8"), ("opt", "int8"), ("int8", None),
                                       ("w4", None)])
def test_paged_engine_matches_jax(layout, kv):
    vocab = models(layout)[2].lm.vocab_size
    want, got, (_, eng) = _engines(layout, _requests(4, vocab, seed=0, lengths=[5, 8, 11, 14]),
                                   10, kv=kv)
    _assert_equal_and_varied(want, got)
    assert len(eng.allocator.free) == eng.num_blocks - 1 and not eng.active


def test_paged_engine_pool_pressure_preempts():
    """Three rows growing past their prompt pages in a 26-page pool: preemption swaps rows
    (pages and media) to the host and resumes them; every stream is JAX's."""
    reqs = _requests(3, 96, seed=2, lengths=[100, 109, 118])
    want, got, (jeng, eng) = _engines("float", reqs, 40, num_rows=3, num_blocks=26,
                                      max_blocks_per_seq=16)
    assert eng.preemptions > 0 and jeng.preemptions > 0, "sized to force preemption"
    assert not eng.swapped and not eng.queue
    _assert_equal_and_varied(want, got)


def test_paged_engine_history_processors():
    samplings = [dict(greedy=True, repetition_penalty=1.3), dict(greedy=True,
                                                                 no_repeat_ngram_size=2),
                 dict(greedy=True)]
    want, got, _ = _engines("float", _requests(3, 96, seed=6, lengths=[5, 8, 11]), 10,
                            samplings=samplings)
    _assert_equal_and_varied(want, got)


def test_paged_engine_media_isolation():
    """One row, one prompt, two clips in turn: the row serves the second clip's media."""
    (ids, wins_a), (_, wins_b) = _requests(2, 96, seed=3, lengths=[6, 6])
    want, got, _ = _engines("opt", [(ids, wins_a), (ids, wins_b)], 8, num_rows=1)
    assert got == want and got["r0"] != got["r1"]


def test_paged_engine_prefix_cache_exact_and_audio_isolated():
    """A shared 128-token prefix with the same clip hits the prefix store and stays JAX's;
    the same ids with another clip must miss (keys fold in the media digest)."""
    rng = np.random.default_rng(5)
    prefix = rng.integers(0, 96, size=(1, 128)).astype(np.int32)
    ids_a = np.concatenate([prefix, rng.integers(0, 96, size=(1, 16)).astype(np.int32)], 1)
    ids_b = np.concatenate([prefix, rng.integers(0, 96, size=(1, 24)).astype(np.int32)], 1)
    wins, wins2 = (rng.normal(size=(1, N_MEDIA, WPM, 16)).astype(np.float32) for _ in range(2))
    reqs = [(ids_a, wins), (ids_b, wins), (ids_b, wins2)]
    want, got, (jeng, eng) = _engines("float", reqs, 8, rounds=[[0], [1], [2]], num_blocks=48,
                                      max_blocks_per_seq=16, prefix_cache=True)
    _assert_equal_and_varied(want, got)
    assert eng.store.hits == jeng.store.hits > 0
    assert eng.store.misses == jeng.store.misses


def test_paged_engine_chunked_prefill_exact():
    """A 120-token prompt prefilled 32 tokens a round (media transformed once) beside a
    short request that decodes in between."""
    want, got, _ = _engines("float", _requests(2, 96, seed=6, lengths=[120, 6]), 8,
                            max_blocks_per_seq=12, prefill_chunk=32)
    _assert_equal_and_varied(want, got)


@pytest.mark.parametrize("attn_impl", ["kernel", "dense"])
def test_paged_engine_attn_impl_pins(attn_impl, monkeypatch):
    """Both pins give JAX's ids; "auto" and "kernel" call paged_attention for every pool,
    "dense" the dense reference."""
    calls = {"kernel": 0, "dense": 0}
    real = {"kernel": pa.paged_attention, "dense": pa.paged_attention_reference}

    def counted(name):
        def fn(*a, **k):
            calls[name] += 1
            return real[name](*a, **k)
        return fn
    monkeypatch.setattr(pfe, "paged_attention", counted("kernel"))
    monkeypatch.setattr(pfe, "paged_attention_reference", counted("dense"))
    want, got, _ = _engines("float", _requests(2, 96, seed=7, lengths=[5, 9]), 8,
                            jax_kw=dict(attn_impl=attn_impl), port_kw=dict(attn_impl=attn_impl))
    _assert_equal_and_varied(want, got)
    other = "dense" if attn_impl == "kernel" else "kernel"
    assert calls[attn_impl] > 0 and calls[other] == 0
    with pytest.raises(ValueError, match="attn_impl"):
        pfe.PagedFlamingoEngine(model=models("float")[3], cfg=models("float")[2], device="cpu",
                                attn_impl="pallas")


@pytest.mark.parametrize("layout,kv", [("float", None), ("float", "int8"), ("opt", None)])
def test_paged_xattn_spec_greedy_exact(layout, kv):
    """Greedy speculation through the paged verify (k + 1 tokens folded into K3's group
    axis) with a random draft: JAX's speculating engine's ids, and the plain engine's."""
    jkw, pkw = _spec(3, 2)
    reqs = _requests(3, 96, seed=7, lengths=[5, 7, 9])
    want, got, (_, eng) = _engines(layout, reqs, 8, kv=kv, num_blocks=32, preempt=False,
                                   jax_kw=jkw, port_kw=pkw)
    _assert_equal_and_varied(want, got)
    assert eng.spec_stats["round_slots"] > 0
    plain = _engines(layout, reqs, 8, kv=kv, num_blocks=32, preempt=False)[1]
    assert plain == got


def test_paged_xattn_spec_sampled_greedy_limit():
    jkw, pkw = _spec(2, 2)
    sp = dict(greedy=False, temperature=1e-4, top_k=1)
    want = _engines("float", _requests(1, 96, seed=8, lengths=[6]), 8, num_rows=1)[0]
    _, got, (_, eng) = _engines(
        "float", _requests(1, 96, seed=8, lengths=[6]), 8, num_rows=1, num_blocks=32,
        preempt=False, jax_kw=dict(sampling=JSamplingParams(**sp), **jkw),
        port_kw=dict(sampling=SamplingParams(**sp), **pkw))
    _assert_equal_and_varied(want, got)
    assert fe.speculating(eng)
    with pytest.raises(ValueError, match="preempt=False"):
        pfe.PagedFlamingoEngine(model=models("float")[3], cfg=models("float")[2], device="cpu",
                                **pkw)


def _pool(layout: str, kv: str | None, seed: int):
    """A random pool (f32 or int8 with scales) of 2 rows x 3 pages of 16, shuffled tables,
    rows of 21 and 40 tokens, as numpy: (k, v, ks, vs, tables, lengths)."""
    from audio_flamingo_tpu_torch.runtime.flamingo_engine import kv_geometry

    cfg = models(layout)[2]
    nkv, hd, _, _ = kv_geometry(cfg)
    rng = np.random.default_rng(seed)
    shape = (cfg.lm.num_layers, 8, 16, nkv, hd)
    if kv == "int8":
        k, v = (rng.integers(-127, 128, size=shape).astype(np.int8) for _ in range(2))
        ks, vs = (rng.uniform(0.002, 0.02, size=shape[:-1]).astype(np.float32)
                  for _ in range(2))
    else:
        k, v = (rng.normal(size=shape).astype(np.float32) * 0.5 for _ in range(2))
        ks = vs = None
    tables = np.full((2, 4), -1, np.int32)
    tables[0, :2], tables[1, :3] = [5, 2], [7, 1, 3]
    return k, v, ks, vs, tables, np.array([21, 40], np.int32)


@pytest.mark.parametrize("layout,kv,s", [("float", None, 1), ("opt", None, 1),
                                         ("float", "int8", 1), ("opt", "int8", 4),
                                         ("float", None, 4)])
def test_paged_step_and_verify_match_jax(layout, kv, s):
    """One decode step (s = 1) and a 4-token verify through the pages against JAX's
    _xattn_paged_step / _xattn_paged_verify on the same pool: logits within 1e-4 of
    max|logit|, the pool written alike (int8: codes equal, scales within 1e-5)."""
    from audio_flamingo_tpu.runtime import paged_cache as jpc
    from audio_flamingo_tpu_torch.runtime.paged_cache import PagedKV

    jcfg, params, cfg, model = models(layout)
    k, v, ks, vs, tables, lengths = _pool(layout, kv, seed=9)
    rng = np.random.default_rng(10)
    tokens = rng.integers(0, cfg.lm.vocab_size, size=(2, s)).astype(np.int32)
    media = rng.normal(size=(2, 4, 16)).astype(np.float32)
    jcache = jpc.PagedKV(*(None if a is None else jnp.asarray(a)
                           for a in (k, v, tables, lengths, ks, vs)))
    pcache = PagedKV(*(None if a is None else torch.from_numpy(a.copy())
                       for a in (k, v, tables, lengths, ks, vs)))
    if s == 1:
        jc, want = jpfe._xattn_paged_step(params, jcfg, jcache, jnp.asarray(media),
                                          jnp.asarray(tokens[:, 0]), jnp.float32)
        pc, got = pfe.xattn_paged_step(model, cfg, pcache, torch.from_numpy(media),
                                       torch.from_numpy(tokens[:, 0]).long())
    else:
        jc, want = jpfe._xattn_paged_verify(params, jcfg, jcache, jnp.asarray(media),
                                            jnp.asarray(tokens), jnp.float32)
        pc, got = pfe.xattn_paged_verify(model, cfg, pcache, torch.from_numpy(media),
                                         torch.from_numpy(tokens).long())
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * np.abs(want).max(), rtol=0)
    np.testing.assert_array_equal(pc.lengths.numpy(), np.asarray(jc.lengths))
    if kv == "int8":
        np.testing.assert_array_equal(pc.k.numpy(), np.asarray(jc.k))
        # XLA's jitted division by 127 goes through its reciprocal: an ulp or two apart
        np.testing.assert_allclose(pc.v_scale.numpy(), np.asarray(jc.v_scale), rtol=1e-5,
                                   atol=0)
    else:
        np.testing.assert_allclose(pc.v.numpy(), np.asarray(jc.v), atol=1e-5, rtol=0)
