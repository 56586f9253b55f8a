"""The port's AF1/AF2 slot engine (runtime/flamingo_engine.FlamingoEngine) against JAX's
FlamingoEngine at f32 on the same numpy-seeded weights and requests: greedy ids token for
token on AF2 (Qwen2: float, int8 and fused-w4 trees) and AF1 (OPT), more requests than
slots, a reused slot that must serve its new request's media, speculation with a
text-only Qwen2 draft (greedy exact, slot reuse, the sampled rule's greedy limit,
accept_sim's mechanics) and the request refusals. The tiny models are made lively
(tests/test_torch_flamingo.py) and the ids are required to vary."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_flamingo_tpu.config import Qwen2Config as JQwen2Config
from audio_flamingo_tpu.models import qwen2 as jqwen2
from audio_flamingo_tpu.ops.sampling import SamplingParams as JSamplingParams
from audio_flamingo_tpu.runtime import flamingo_engine as jfe
from audio_flamingo_tpu_torch import config as C
from audio_flamingo_tpu_torch.io.convert import lm_params_from_jax
from audio_flamingo_tpu_torch.models import qwen2
from audio_flamingo_tpu_torch.ops.sampling import SamplingParams
from audio_flamingo_tpu_torch.runtime import flamingo_engine as fe
from test_torch_flamingo import models

jax.config.update("jax_default_matmul_precision", "highest")
torch.set_num_threads(2)

EOS = 3
N_MEDIA, WPM = 1, 4
JDRAFT = JQwen2Config(vocab_size=96, hidden_size=24, intermediate_size=48, num_layers=1,
                      num_heads=4, num_kv_heads=2, tie_word_embeddings=True)


def _requests(n: int, vocab: int, seed: int, lengths=None):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        t = lengths[i] if lengths else 4 + i
        out.append((rng.integers(0, vocab, size=(1, t)).astype(np.int32),
                    rng.normal(size=(1, N_MEDIA, WPM, 16)).astype(np.float32)))
    return out


def _engines(layout: str, reqs, max_new: int, jax_kw=None, port_kw=None, **kw):
    """Both engines on the same requests -> (JAX results, port results, port engine)."""
    jcfg, params, cfg, model = models(layout)
    jax_kw, port_kw = dict(kw, **(jax_kw or {})), dict(kw, **(port_kw or {}))
    common = dict(eos_token_id=EOS, n_media=N_MEDIA, windows_per_media=WPM)
    jeng = jfe.FlamingoEngine(params=params, cfg=jcfg, compute_dtype=jnp.float32, **common,
                              **jax_kw)
    peng = fe.FlamingoEngine(model=model, cfg=cfg, device="cpu", **common, **port_kw)
    for eng, req_cls in ((jeng, jfe.FlamingoRequest), (peng, fe.FlamingoRequest)):
        for i, (ids, wins) in enumerate(reqs):
            eng.submit(req_cls(request_id=f"r{i}", ids=ids, window_embeds=wins,
                               max_new_tokens=max_new))
    return jeng.run_until_done(), peng.run_until_done(), peng


def _assert_equal_and_varied(want: dict, got: dict):
    assert set(got) == set(want)
    for rid in want:
        assert got[rid] == want[rid], (rid, got[rid], want[rid])
    assert len({t for toks in want.values() for t in toks}) > 2, "constant ids test little"


GREEDY = dict(num_slots=2, capacity=256, chunk=4)


@pytest.mark.parametrize("layout", ["float", "opt", "int8", "w4"])
def test_engine_matches_jax(layout):
    """4 requests over 2 slots, each row at its own offset, AF2's trees and AF1."""
    vocab = models(layout)[2].lm.vocab_size
    want, got, eng = _engines(layout, _requests(4, vocab, seed=0), 10,
                              jax_kw=dict(sampling=JSamplingParams(greedy=True)),
                              port_kw=dict(sampling=SamplingParams(greedy=True)), **GREEDY)
    _assert_equal_and_varied(want, got)
    assert not eng.active and not eng.queue


def test_slot_reuse_does_not_leak_media():
    """One slot, one prompt, two clips: the reused slot serves the second clip's media."""
    (ids, wins_a), (_, wins_b) = _requests(2, 96, seed=1, lengths=[6, 6])
    want, got, _ = _engines("float", [(ids, wins_a), (ids, wins_b)], 8,
                            num_slots=1, capacity=256, chunk=4)
    assert got == want
    assert got["r0"] != got["r1"], "the two clips gave one answer: the check saw nothing"


def _draft():
    jdraft = jax.tree.map(np.asarray, jqwen2.init(jax.random.PRNGKey(11), JDRAFT))
    dcfg = C.Qwen2Config(**{f: getattr(JDRAFT, f) for f in C.Qwen2Config.__dataclass_fields__})
    draft = qwen2.Qwen2(dcfg, dtype=torch.float32).requires_grad_(False)
    draft.load_state_dict(lm_params_from_jax(jdraft, dcfg))
    return jdraft, draft, dcfg


def _spec(k: int, rounds: int, **kw):
    jdraft, draft, dcfg = _draft()
    return (dict(draft_params=jdraft, draft_cfg=JDRAFT, spec_k=k, spec_rounds=rounds, **kw),
            dict(draft_params=draft, draft_cfg=dcfg, spec_k=k, spec_rounds=rounds, **kw))


@pytest.mark.parametrize("layout", ["float", "opt"])
def test_xattn_spec_greedy_exact(layout):
    """Greedy speculation with a random (adversarial) draft: JAX's engine's ids, which are
    target-only greedy's."""
    jkw, pkw = _spec(3, 2)
    want, got, eng = _engines(layout, _requests(3, 96, seed=2), 10,
                              jax_kw=dict(sampling=JSamplingParams(greedy=True), **jkw),
                              port_kw=dict(sampling=SamplingParams(greedy=True), **pkw),
                              **GREEDY)
    _assert_equal_and_varied(want, got)
    assert eng.spec_stats["round_slots"] > 0
    plain = _engines(layout, _requests(3, 96, seed=2), 10, **GREEDY)[1]
    assert plain == got


def test_xattn_spec_slot_reuse():
    """More requests than the one slot: reused rows leak no draft K/V, target K/V or media."""
    jkw, pkw = _spec(2, 2)
    want, got, _ = _engines("float", _requests(4, 96, seed=3, lengths=[6] * 4), 8,
                            jax_kw=jkw, port_kw=pkw, num_slots=1, capacity=256, chunk=4)
    _assert_equal_and_varied(want, got)


def test_xattn_spec_sampled_greedy_limit():
    """The Leviathan rule at top_k = 1 and a tiny temperature is plain greedy: JAX's ids."""
    jkw, pkw = _spec(3, 2)
    want = _engines("float", _requests(2, 96, seed=4), 10, **GREEDY)[0]
    _, got, eng = _engines("float", _requests(2, 96, seed=4), 10,
                           jax_kw=dict(sampling=JSamplingParams(greedy=False, temperature=1e-4,
                                                                top_k=1), **jkw),
                           port_kw=dict(sampling=SamplingParams(greedy=False, temperature=1e-4,
                                                                top_k=1), **pkw), **GREEDY)
    _assert_equal_and_varied(want, got)
    assert fe.speculating(eng) and not eng.sampling.greedy


@pytest.mark.parametrize("a", [1.0, 0.0])
def test_xattn_spec_accept_sim_mechanics(a):
    """Bernoulli acceptance injection: a request ends within its budget; at a = 1 every
    round emits k + 1 tokens a row, at a = 0 one."""
    _, pkw = _spec(2, 2, spec_accept_sim=a)
    _, _, cfg, model = models("float")
    eng = fe.FlamingoEngine(model=model, cfg=cfg, device="cpu", num_slots=1, capacity=256,
                            chunk=4, eos_token_id=-1, n_media=N_MEDIA, windows_per_media=WPM,
                            spec_guard=False, **pkw)
    (ids, wins), = _requests(1, 96, seed=5, lengths=[6])
    eng.submit(fe.FlamingoRequest(request_id="x", ids=ids, window_embeds=wins,
                                  max_new_tokens=9))
    out = eng.run_until_done(max_rounds=50)["x"]
    assert 1 <= len(out) <= 9
    st = eng.spec_stats
    assert st["emitted"] == st["round_slots"] * (3 if a == 1.0 else 1)


def test_requests_the_engine_refuses():
    _, pkw = _spec(2, 2)
    _, _, cfg, model = models("float")
    eng = fe.FlamingoEngine(model=model, cfg=cfg, device="cpu", num_slots=1, capacity=128,
                            n_media=N_MEDIA, windows_per_media=WPM, **pkw)
    ids = np.zeros((1, 4), np.int32)
    with pytest.raises(ValueError, match="capacity"):
        eng.submit(fe.FlamingoRequest(request_id="a", ids=np.zeros((1, 200), np.int32)))
    with pytest.raises(ValueError, match="engine's sampling"):
        eng.submit(fe.FlamingoRequest(request_id="b", ids=ids,
                                      sampling=SamplingParams(greedy=False)))
    with pytest.raises(ValueError, match="speculative"):
        eng.submit(fe.FlamingoRequest(request_id="c", ids=ids, min_new_tokens=2))
    assert eng.media.shape == (1, N_MEDIA * WPM, 16) and eng.cache.k.shape[3:] == (2, 8)
    opt_cfg = models("opt")[2]
    opt_eng = fe.FlamingoEngine(model=models("opt")[3], cfg=opt_cfg, device="cpu", num_slots=1,
                                capacity=128)
    assert opt_eng.cache.k.shape[3:] == (4, 8)     # OPT: every head its own KV head


@pytest.mark.parametrize("layout,s", [("float", 1), ("opt", 1), ("int8", 3), ("opt", 3)])
def test_rows_forward_matches_jax(layout, s):
    """The slot engine's per-row forward (a decode step, s = 1, and a 3-token verify block)
    against JAX's _rows_forward_xattn on one random cache, rows at offsets 5 and 17: logits
    within 1e-4 of max|logit|, every row's new K/V written at its own offset."""
    from audio_flamingo_tpu.models import flamingo as jflamingo
    from audio_flamingo_tpu.runtime import engine as jengine
    from audio_flamingo_tpu_torch.models import flamingo
    from audio_flamingo_tpu_torch.runtime.engine import SlotCache

    jcfg, params, cfg, model = models(layout)
    nkv, hd, _, _ = fe.kv_geometry(cfg)
    rng = np.random.default_rng(12)
    shape = (cfg.lm.num_layers, 2, 32, nkv, hd)
    k, v = (rng.normal(size=shape).astype(np.float32) * 0.5 for _ in range(2))
    pos = np.array([5, 17], np.int32)
    tokens = rng.integers(0, cfg.lm.vocab_size, size=(2, s)).astype(np.int32)
    media = rng.normal(size=(2, 4, 16)).astype(np.float32)
    jx = jflamingo._embed(params, jcfg, jnp.asarray(tokens), dtype=jnp.float32)
    jh, jc = jfe._rows_forward_xattn(params, jcfg, jx, jnp.asarray(pos),
                                     jengine.SlotCache(jnp.asarray(k), jnp.asarray(v),
                                                       jnp.asarray(pos)), jnp.asarray(media))
    want = np.asarray(jflamingo._unembed(params, jcfg, jh))
    cache = SlotCache(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()),
                      torch.from_numpy(pos))
    ph, pc = fe._rows_forward_xattn(model, cfg, flamingo._embed(model, cfg,
                                                                torch.from_numpy(tokens).long()),
                                    cache.lengths, cache, torch.from_numpy(media))
    got = flamingo._unembed(model, cfg, ph).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=0)
    np.testing.assert_allclose(pc.k.numpy(), np.asarray(jc.k), atol=1e-5, rtol=0)
