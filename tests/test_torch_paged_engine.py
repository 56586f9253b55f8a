"""The port's PagedEngine (runtime/paged_engine.py) against the JAX PagedEngine at f32, on
the same numpy-seeded weights and requests: greedy outputs token for token over the
5-prompt case, an int8 pool, pool exhaustion with preemption, prefix caching (text and
audio, with the encoder skipped on a hit), chunked prefill, per-request sampling, the
EOS floor, stop sequences, logprobs (1e-4), streaming and request metrics; the port's
engine also against its own single-request ``generate``; the pool fully released."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_flamingo_tpu.config import AF3Config as JAF3Config
from audio_flamingo_tpu.config import Qwen2Config as JQwen2Config
from audio_flamingo_tpu.config import WhisperEncoderConfig as JEncoderConfig
from audio_flamingo_tpu.models import af3 as jaf3
from audio_flamingo_tpu.ops.sampling import SamplingParams as JSamplingParams
from audio_flamingo_tpu.runtime.engine import Request as JRequest
from audio_flamingo_tpu.runtime.paged_engine import PagedEngine as JPagedEngine
from audio_flamingo_tpu_torch import config as C
from audio_flamingo_tpu_torch.io.convert import params_from_jax
from audio_flamingo_tpu_torch.models import af3
from audio_flamingo_tpu_torch.ops.sampling import SamplingParams
from audio_flamingo_tpu_torch.runtime import generate as tgen
from audio_flamingo_tpu_torch.runtime.beam_lane import BeamRequest
from audio_flamingo_tpu_torch.runtime.engine import Request
from audio_flamingo_tpu_torch.runtime.paged_engine import PagedEngine
from audio_flamingo_tpu_torch.utils.metrics import MetricsLogger

jax.config.update("jax_default_matmul_precision", "highest")
torch.set_num_threads(2)

LP_TOL = 1e-4
EOS, BLOCK, MAX_BLOCKS = 127, 8, 4
ENCODER = JEncoderConfig(num_mel_bins=16, d_model=32, num_layers=1, num_heads=4, ffn_dim=64,
                         max_source_positions=12)
# the configurations of tests/test_paged_cache.py and tests/test_prefix_cache.py
CFG_A = JAF3Config(encoder=ENCODER, audio_token_id=90, lm=JQwen2Config(
    vocab_size=96, hidden_size=48, intermediate_size=96, num_layers=2, num_heads=4,
    num_kv_heads=2, tie_word_embeddings=True))
CFG_B = JAF3Config(encoder=ENCODER, audio_token_id=120, lm=JQwen2Config(
    vocab_size=128, hidden_size=48, intermediate_size=96, num_layers=2, num_heads=4,
    num_kv_heads=2, tie_word_embeddings=True))


def _port_cfg(j):
    pick = lambda cls, obj: cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)})
    return C.AF3Config(encoder=pick(C.WhisperEncoderConfig, j.encoder),
                       lm=pick(C.Qwen2Config, j.lm), audio_token_id=j.audio_token_id)


def _models(jcfg, seed):
    params = jaf3.init(jax.random.PRNGKey(seed), jcfg)
    cfg = _port_cfg(jcfg)
    model = af3.build(cfg, "cpu", torch.float32)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), cfg))
    return jcfg, params, cfg, model


@pytest.fixture(scope="module")
def model_a():
    return _models(CFG_A, 1)


@pytest.fixture(scope="module")
def model_b():
    return _models(CFG_B, 0)


def _reqs(specs):
    """[(request_id, ids, kwargs)] -> (JAX requests, port requests), fresh each call."""
    def build(cls, sp_cls):
        out = []
        for rid, ids, kw in specs:
            kw = dict(kw)
            if kw.get("sampling") is not None:
                kw["sampling"] = sp_cls(**kw["sampling"])
            out.append(cls(request_id=rid, ids=ids.copy(), **kw))
        return out
    return build(JRequest, JSamplingParams), build(Request, SamplingParams)


def _run_both(models, specs, sampling=None, with_jax=True, **kw):
    """The same requests through the JAX engine (unless with_jax is False) and the
    port's -> (JAX engine, its results, port engine, its results, both request lists)."""
    jcfg, params, cfg, model = models
    sampling = sampling or dict(greedy=True)
    jreqs, treqs = _reqs(specs)
    je = want = None
    if with_jax:
        jkw = {k: jnp.int8 if v is torch.int8 else v for k, v in kw.items()}
        if "metrics" in jkw:
            jkw["metrics"] = MetricsLogger(verbose=False)
        je = JPagedEngine(params=params, cfg=jcfg, eos_token_id=EOS, compute_dtype=jnp.float32,
                          sampling=JSamplingParams(**sampling), **jkw)
        for r in jreqs:
            je.submit(r)
        want = je.run_until_done()
    te = PagedEngine(model=model, cfg=cfg, eos_token_id=EOS, device="cpu",
                     sampling=SamplingParams(**sampling), **kw)
    for r in treqs:
        te.submit(r)
    return je, want, te, te.run_until_done(), jreqs, treqs


def _generate(models, ids, max_new_tokens):
    _, _, cfg, model = models
    out = tgen.generate(model, cfg, torch.from_numpy(ids).long(), None,
                        max_new_tokens=max_new_tokens, eos_token_id=EOS,
                        capacity=MAX_BLOCKS * BLOCK)
    return out.tokens[0, : int(out.lengths[0])].tolist()


def _assert_prefixes_of_generate(models, specs, results):
    for rid, ids, kw in specs:
        want = _generate(models, ids, kw["max_new_tokens"])
        got = results[rid]
        n = min(len(want), len(got))
        assert n >= 1 and got[:n] == want[:n], (rid, got, want)


SMALL = dict(num_rows=2, num_blocks=12, block_size=BLOCK, max_blocks_per_seq=MAX_BLOCKS,
             chunk=4)


def test_five_prompts_match_jax_and_generate(model_a):
    rng = np.random.default_rng(3)
    specs = [(f"p{i}", rng.integers(0, 90, size=(1, 4 + i)).astype(np.int32),
              dict(max_new_tokens=10)) for i in range(5)]
    je, want, te, got, _, _ = _run_both(model_a, specs, **SMALL)
    assert got == want and set(got) == {f"p{i}" for i in range(5)}
    assert len(te.allocator.free) == 11 == len(je.allocator.free)
    _assert_prefixes_of_generate(model_a, specs, got)


def test_int8_pool_matches_jax(model_a):
    rng = np.random.default_rng(9)
    specs = [(f"p{i}", rng.integers(0, 90, size=(1, 5 + i)).astype(np.int32),
              dict(max_new_tokens=8)) for i in range(3)]
    _, want, te, got, _, _ = _run_both(model_a, specs, kv_dtype=torch.int8, **SMALL)
    assert got == want
    assert te.cache.k.dtype == torch.int8 and len(te.allocator.free) == 11


def test_pool_exhaustion_matches_jax(model_a):
    """Three rows want to outgrow a 5-page pool (tests/test_paged_cache.py:305): rows
    that fill their capacity finish early, as in JAX; prefixes exact, every page back."""
    rng = np.random.default_rng(5)
    specs = [(f"p{i}", rng.integers(0, 90, size=(1, 6)).astype(np.int32),
              dict(max_new_tokens=3 * BLOCK)) for i in range(3)]
    je, want, te, got, _, _ = _run_both(model_a, specs, num_rows=3, num_blocks=6,
                                        block_size=BLOCK, max_blocks_per_seq=MAX_BLOCKS,
                                        chunk=4)
    assert got == want and te.preemptions == je.preemptions
    assert len(te.allocator.free) == 5 and not te.swapped
    _assert_prefixes_of_generate(model_a, specs, got)


@pytest.mark.parametrize("kv_dtype", [None, torch.int8])
def test_preemption_resume_matches_jax(model_b, kv_dtype):
    """A 26-page pool for three rows growing past their 128-token buckets
    (tests/test_preemption.py): rows swap to host memory and resume; the tokens equal
    JAX's and the unpressured engine's, and the pool comes back whole."""
    rng = np.random.default_rng(21)
    specs = [(f"r{i}", rng.integers(0, 120, (1, 100 + 9 * i)).astype(np.int32),
              dict(max_new_tokens=48)) for i in range(3)]
    geometry = dict(num_rows=3, block_size=16, max_blocks_per_seq=16, chunk=4,
                    kv_dtype=kv_dtype)
    je, want, te, got, _, _ = _run_both(model_b, specs, with_jax=kv_dtype is None,
                                        num_blocks=26, **geometry)
    _, _, _, big, _, _ = _run_both(model_b, specs, with_jax=False, num_blocks=64, **geometry)
    assert got == big and (want is None or got == want)
    assert te.preemptions > 0 and (je is None or te.preemptions == je.preemptions)
    assert not te.swapped and not te.queue and len(te.allocator.free) == te.num_blocks - 1
    if kv_dtype is None:
        # preempt=False: starved rows finish early instead, as in JAX, prefix-exact
        je, want, te, cut, _, _ = _run_both(model_b, specs, num_blocks=26, preempt=False,
                                            **geometry)
        assert cut == want and te.preemptions == 0 == je.preemptions
        assert all(big[k][: len(v)] == v for k, v in cut.items())
        assert len(te.allocator.free) == te.num_blocks - 1


def _prefix_workload(rng):
    shared = rng.integers(0, 120, (1, 17)).astype(np.int32)
    return [("a", shared, dict(max_new_tokens=8)),
            ("b", shared.copy(), dict(max_new_tokens=8)),                  # full hit
            ("c", np.concatenate([shared[:, :16], rng.integers(0, 120, (1, 5))], axis=1)
             .astype(np.int32), dict(max_new_tokens=8)),                  # partial hit
            ("d", rng.integers(0, 120, (1, 9)).astype(np.int32), dict(max_new_tokens=8))]


PREFIX = dict(num_rows=2, num_blocks=24, block_size=BLOCK, max_blocks_per_seq=MAX_BLOCKS,
              chunk=4)


def test_prefix_cache_matches_jax_and_the_plain_engine(model_b):
    specs = _prefix_workload(np.random.default_rng(5))
    je, want, te, got, _, _ = _run_both(model_b, specs, prefix_cache=True, **PREFIX)
    _, _, _, plain, _, _ = _run_both(model_b, specs, with_jax=False, **PREFIX)
    assert got == want == plain
    assert te.store.hits == je.store.hits > 0 and te.store.misses == je.store.misses
    owned = {e[0] for e in te.store.entries.values()}
    assert owned.isdisjoint(te.allocator.free)
    assert len(owned) + len(te.allocator.free) == te.num_blocks - 1
    # the pool survives an offload to host memory: the warm prefix still hits
    te.offload_pool()
    assert te.cache is None
    te.restore_pool()
    hits = te.store.hits
    te.submit(Request(request_id="e", ids=specs[0][1].copy(), max_new_tokens=8))
    assert te.run_until_done()["e"] == got["a"] and te.store.hits > hits


def test_audio_prefix_hit_skips_the_encoder(model_b, monkeypatch):
    jcfg = model_b[0]
    rng = np.random.default_rng(6)
    ntok = jcfg.encoder.max_source_positions // jcfg.encoder.pool_stride
    ids = np.concatenate([np.full((1, ntok), jcfg.audio_token_id),
                          rng.integers(0, 120, (1, 12))], axis=1).astype(np.int32)
    mels = rng.normal(size=(1, 1, 2 * jcfg.encoder.max_source_positions,
                            jcfg.encoder.num_mel_bins)).astype(np.float32)
    specs = [(f"r{i}", ids, dict(max_new_tokens=6, mels=mels)) for i in range(2)]
    encoded = []
    real = af3.encode_audio
    monkeypatch.setattr(af3, "encode_audio", lambda *a: encoded.append(1) or real(*a))
    je, want, te, got, _, _ = _run_both(model_b, specs, prefix_cache=True, **PREFIX)
    assert got == want and te.store.hits == je.store.hits > 0
    assert len(encoded) == 1      # the second request's audio rides in on shared pages
    # a fresh engine without the cache runs the encoder for both, to the same tokens
    encoded.clear()
    _, _, _, plain, _, _ = _run_both(model_b, specs, with_jax=False, **PREFIX)
    assert plain == got and len(encoded) == 2


def test_chunked_prefill_matches_jax(model_b):
    """A 27-token prompt (with audio) prefilled 16 tokens per round while a short row
    decodes; the same tokens as JAX and as the unchunked engine."""
    jcfg = model_b[0]
    rng = np.random.default_rng(11)
    ntok = jcfg.encoder.max_source_positions // jcfg.encoder.pool_stride
    long_ids = np.concatenate([rng.integers(0, 120, (1, 3)), np.full((1, ntok), 120),
                               rng.integers(0, 120, (1, 18))], axis=1).astype(np.int32)
    mels = rng.normal(size=(1, 1, 2 * jcfg.encoder.max_source_positions,
                            jcfg.encoder.num_mel_bins)).astype(np.float32)
    specs = [("short", rng.integers(0, 120, (1, 5)).astype(np.int32), dict(max_new_tokens=8)),
             ("long", long_ids, dict(max_new_tokens=4, mels=mels))]
    _, want, te, got, _, _ = _run_both(model_b, specs, prefill_chunk=16, **PREFIX)
    _, _, _, whole, _, _ = _run_both(model_b, specs, with_jax=False, **PREFIX)
    assert got == want == whole and te.prefilling is None
    assert len(te.allocator.free) == te.num_blocks - 1


def test_request_options_match_jax(model_b):
    """One hot-sampling engine: greedy and top_k=1 overrides reproduce greedy tokens; an
    EOS floor, a stop sequence, logprobs, streaming and metrics as in JAX."""
    rng = np.random.default_rng(12)
    ids = [rng.integers(0, 120, (1, 6 + i)).astype(np.int32) for i in range(4)]
    plain = [(f"r{i}", x, dict(max_new_tokens=8)) for i, x in enumerate(ids)]
    _, greedy, _, tgreedy, _, _ = _run_both(model_b, plain, **PREFIX)
    assert tgreedy == greedy
    stop = greedy["r3"][2:4]          # fires within r3's greedy output
    streamed: dict[str, list] = {f"r{i}": [] for i in range(4)}
    specs = [("r0", ids[0], dict(max_new_tokens=8, sampling=dict(greedy=True),
                                 logprobs=True)),
             ("r1", ids[1], dict(max_new_tokens=8, sampling=dict(greedy=False, top_k=1),
                                 min_new_tokens=3)),
             ("r2", ids[2], dict(max_new_tokens=8)),
             ("r3", ids[3], dict(max_new_tokens=8, sampling=dict(greedy=True), stop=[stop]))]
    sink = MetricsLogger(verbose=False)
    je, want, te, got, jreqs, treqs = _run_both(
        model_b, specs, sampling=dict(greedy=False, temperature=5.0), metrics=sink, **PREFIX)
    assert got["r0"] == want["r0"] == greedy["r0"]
    assert got["r1"] == want["r1"] and EOS not in got["r1"][:3]
    assert got["r3"] == want["r3"] and got["r3"][-2:] == stop and len(got["r3"]) <= 4
    assert len(got["r2"]) >= 1 and all(0 <= t < 128 for t in got["r2"])
    np.testing.assert_allclose(treqs[0].token_logprobs, jreqs[0].token_logprobs,
                               atol=LP_TOL, rtol=0)
    assert len(treqs[0].token_logprobs) == len(got["r0"])
    assert set(te.request_metrics) == set(got) and len(sink.records) == 4
    for rid, m in te.request_metrics.items():
        assert m["tokens"] == len(got[rid]) and m["total_s"] >= m["ttft_s"] > 0
    # streaming: the callbacks deliver exactly the final tokens
    eng = PagedEngine(model=model_b[3], cfg=model_b[2], eos_token_id=EOS, device="cpu",
                      **PREFIX)
    for rid, x, kw in specs:
        eng.submit(Request(request_id=rid, ids=x.copy(), **{
            **kw, "sampling": None if "sampling" not in kw else SamplingParams(**kw["sampling"])},
            on_tokens=lambda toks, rid=rid: streamed[rid].extend(toks)))
    final = eng.run_until_done()
    assert all(streamed[rid] == toks for rid, toks in final.items())
    assert len(eng.allocator.free) == eng.num_blocks - 1


def test_unported_options_and_the_device_rule(model_b, monkeypatch):
    _, _, cfg, model = model_b
    # speculation is ported: a draft is taken (preempt=False), its dense cache made
    spec = PagedEngine(model=model, cfg=cfg, device="cpu", draft_params=model.lm,
                       draft_cfg=cfg.lm, preempt=False)
    assert spec.d_cache is not None and spec._step_budget() == 4 * (4 + 1)
    eng = PagedEngine(model=model, cfg=cfg, device="cpu", **PREFIX)
    with pytest.raises(ValueError, match="window_embeds"):   # AF1/AF2 windows: the xattn lane's
        eng.submit_beam(BeamRequest(request_id="b", ids=np.zeros((1, 4), np.int32),
                                    window_embeds=np.zeros((1, 1, 4, 16), np.float32)))
    with pytest.raises(ValueError, match="capacity"):
        eng.submit(Request(request_id="x", ids=np.zeros((1, 40), np.int32)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedEngine(model=model, cfg=cfg)
