"""The port's slot engine (runtime/engine.BatchEngine), ragged generate and the beam lane
(runtime/beam_lane.py) against JAX at f32 on the same numpy-seeded weights
(AF3Config.tiny()): the engine's results equal JAX's BatchEngine's on the cases of
tests/test_engine.py and tests/test_engine_history_processors.py and on per-request
options (logprobs within 1e-4); the per-row forward, float and fused w4 (the suffix
branch), equals JAX's _rows_forward; generate with a [B] prompt_len equals JAX's ragged
generate; the lane on both engines equals generate_beam on the bucket-padded prompt bit
for bit at chunks 1, 3 and 8 (and JAX's generate_beam token for token) while the
engine's normal requests keep their ids."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_flamingo_tpu.config import AF3Config as JAF3Config
from audio_flamingo_tpu.config import Qwen2Config as JQwen2Config
from audio_flamingo_tpu.models import af3 as jaf3
from audio_flamingo_tpu.models import qwen2 as jqwen2
from audio_flamingo_tpu.ops import quant4 as jquant4
from audio_flamingo_tpu.ops.sampling import SamplingParams as JSamplingParams
from audio_flamingo_tpu.runtime import beam as jbeam
from audio_flamingo_tpu.runtime import engine as jengine
from audio_flamingo_tpu.runtime import generate as jgen
from audio_flamingo_tpu_torch import config as C
from audio_flamingo_tpu_torch.io.convert import lm_params_from_jax, params_from_jax
from audio_flamingo_tpu_torch.models import af3, qwen2
from audio_flamingo_tpu_torch.ops.sampling import SamplingParams
from audio_flamingo_tpu_torch.runtime import beam, engine
from audio_flamingo_tpu_torch.runtime import generate as tgen
from audio_flamingo_tpu_torch.runtime.beam_lane import BeamLane, BeamRequest
from audio_flamingo_tpu_torch.runtime.paged_engine import PagedEngine
from audio_flamingo_tpu_torch.utils.metrics import MetricsLogger

jax.config.update("jax_default_matmul_precision", "highest")
torch.set_num_threads(2)

LP_TOL = 1e-4
HIDDEN_TOL = 1e-4
KV_TOL = 1e-5
EOS = 356                  # emitted mid-sequence by some of the seed-0 greedy rows
JCFG = JAF3Config.tiny()
# a fused-w4 LM that suffix_supported accepts (K/2 a multiple of 128 for d, f and o)
JLM_W4 = JQwen2Config(vocab_size=128, hidden_size=256, intermediate_size=512, num_layers=2,
                      num_heads=4, num_kv_heads=2, head_dim=64, tie_word_embeddings=False)


def _pick(cls, obj):
    return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)})


@pytest.fixture(scope="module")
def models():
    params = jax.tree.map(np.asarray, jaf3.init(jax.random.PRNGKey(0), JCFG))
    cfg = C.AF3Config(encoder=_pick(C.WhisperEncoderConfig, JCFG.encoder),
                      lm=_pick(C.Qwen2Config, JCFG.lm), audio_token_id=JCFG.audio_token_id)
    model = af3.build(cfg, "cpu", torch.float32)
    model.load_state_dict(params_from_jax(params, cfg))
    return params, cfg, model


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 500, (1, n)).astype(np.int32) for n in lengths]


def _audio_request(seed):
    rng = np.random.default_rng(seed)
    n_audio = JCFG.encoder.max_source_positions // JCFG.encoder.pool_stride
    ids = np.concatenate([np.full((1, n_audio), JCFG.audio_token_id),
                          rng.integers(0, 500, (1, 4))], axis=1).astype(np.int32)
    mels = rng.normal(size=(1, 1, 2 * JCFG.encoder.max_source_positions,
                            JCFG.encoder.num_mel_bins)).astype(np.float32)
    return ids, mels


def _run_both(models, specs, engine_kw, sampling=None):
    """The same requests ([(id, ids, mels, kwargs)]) through JAX's BatchEngine and the
    port's -> (JAX results, JAX requests, port engine, port results, port requests)."""
    params, cfg, model = models
    sampling = sampling or dict(greedy=True)

    def reqs(cls, sp):
        out = []
        for rid, ids, mels, kw in specs:
            kw = dict(kw)
            if "sampling" in kw:
                kw["sampling"] = sp(**kw["sampling"])
            out.append(cls(request_id=rid, ids=ids.copy(), mels=mels, **kw))
        return out

    jreqs, treqs = reqs(jengine.Request, JSamplingParams), reqs(engine.Request, SamplingParams)
    je = jengine.BatchEngine(params=params, cfg=JCFG, eos_token_id=EOS,
                             compute_dtype=jnp.float32, sampling=JSamplingParams(**sampling),
                             **engine_kw)
    for r in jreqs:
        je.submit(r)
    want = je.run_until_done()
    te = engine.BatchEngine(model=model, cfg=cfg, eos_token_id=EOS, device="cpu",
                            sampling=SamplingParams(**sampling), **engine_kw)
    for r in treqs:
        te.submit(r)
    return want, jreqs, te, te.run_until_done(), treqs


def _text_specs(seed, lengths, max_new, per_request=None):
    per_request = per_request or [{}] * len(lengths)
    return [(f"r{i}", p, None, dict(max_new_tokens=max_new, **kw))
            for i, (p, kw) in enumerate(zip(_prompts(seed, lengths), per_request))]


ENGINE_CASES = {
    # tests/test_engine.py:41-76: more requests than slots, a reused slot, audio
    "five_prompts_two_slots": (lambda: _text_specs(0, [5, 6, 7, 8, 9], 12),
                               dict(num_slots=2, capacity=256, chunk=4)),
    "slot_reuse_one_slot": (lambda: _text_specs(1, [6, 9], 8),
                            dict(num_slots=1, capacity=256, chunk=4)),
    "audio": (lambda: [("a", *_audio_request(4), dict(max_new_tokens=6))]
              + _text_specs(5, [7], 6), dict(num_slots=2, capacity=1152, chunk=3)),
    # tests/test_engine_history_processors.py:113-162
    "repetition_penalty": (lambda: _text_specs(2, [7, 8, 9], 12, [
        dict(sampling=dict(greedy=True, repetition_penalty=1.3)),
        dict(sampling=dict(greedy=True, repetition_penalty=0.8)),
        dict(sampling=dict(greedy=True))]), dict(num_slots=2, capacity=256, chunk=4)),
    "no_repeat_ngram": (lambda: _text_specs(3, [7, 8], 12, [
        dict(sampling=dict(greedy=True, no_repeat_ngram_size=2)),
        dict(sampling=dict(greedy=True))]), dict(num_slots=2, capacity=256, chunk=4)),
    "penalty_plus_ngram": (lambda: _text_specs(4, [7, 8, 9], 12, [
        dict(sampling=dict(greedy=True, repetition_penalty=1.3, no_repeat_ngram_size=2)),
        dict(sampling=dict(greedy=True, no_repeat_ngram_size=3)),
        dict(sampling=dict(greedy=True, repetition_penalty=1.5))]),
        dict(num_slots=3, capacity=256, chunk=5)),
    # per-request options: the EOS floor, a stop sequence, logprobs
    "options": (lambda: _text_specs(6, [6, 7, 8], 10, [
        dict(min_new_tokens=4), dict(stop=[[153, 153]], logprobs=True), dict(logprobs=True)]),
        dict(num_slots=2, capacity=256, chunk=4)),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_batch_engine_matches_jax(models, case):
    make_specs, engine_kw = ENGINE_CASES[case]
    specs = make_specs()
    want, jreqs, te, got, treqs = _run_both(models, specs, engine_kw)
    assert got == want and set(got) == {s[0] for s in specs}
    for jr, tr in zip(jreqs, treqs):
        if tr.logprobs:
            np.testing.assert_allclose(tr.token_logprobs, jr.token_logprobs, atol=LP_TOL, rtol=0)
            assert len(tr.token_logprobs) == len(tr.tokens)
    assert not te.active and not te.queue and bool(te.done.all())
    assert int(te.cache.lengths.abs().sum()) == 0
    if case == "five_prompts_two_slots":
        # greedy engine output is single-request generate's
        _, cfg, model = models
        for rid, ids, _, kw in specs:
            out = tgen.generate(model, cfg, torch.from_numpy(ids).long(),
                                max_new_tokens=kw["max_new_tokens"], eos_token_id=EOS,
                                capacity=256)
            ref = out.tokens[0, : int(out.lengths[0])].tolist()
            n = min(len(ref), len(got[rid]))
            assert n >= 1 and got[rid][:n] == ref[:n], rid


def test_batch_engine_metrics_and_refusals(models):
    _, cfg, model = models
    sink = MetricsLogger(verbose=False)
    eng = engine.BatchEngine(model=model, cfg=cfg, num_slots=2, capacity=128, chunk=4,
                             eos_token_id=EOS, device="cpu", metrics=sink)
    for rid, ids, _, kw in _text_specs(8, [5, 6], 5):
        eng.submit(engine.Request(request_id=rid, ids=ids, **kw))
    eng.run_until_done()
    assert set(eng.request_metrics) == {"r0", "r1"}
    assert {r["request_id"] for r in sink.records} == {"r0", "r1"}
    assert all(m["ttft_s"] is not None and m["tokens"] >= 1 for m in eng.request_metrics.values())
    # speculation is ported: a draft is taken and its dense cache made
    spec = engine.BatchEngine(model=model, cfg=cfg, device="cpu", draft_params=model.lm,
                              draft_cfg=cfg.lm, num_slots=2, capacity=128)
    assert spec.d_cache is not None and engine.speculating(spec)
    with pytest.raises(ValueError, match="capacity"):
        eng.submit(engine.Request(request_id="x", ids=np.zeros((1, 200), np.int32)))
    with pytest.raises(ValueError, match="window_embeds"):   # AF1/AF2 windows: the xattn lane's
        eng.submit_beam(BeamRequest(request_id="b", ids=np.zeros((1, 4), np.int32),
                                    window_embeds=np.zeros((1, 1, 4, 16), np.float32)))
    with pytest.raises(ValueError, match="num_beams=1"):
        eng.submit_beam(BeamRequest(request_id="b", ids=np.zeros((1, 4), np.int32),
                                    num_beams=1))
    lane = BeamLane(model=model, cfg=cfg, eos_token_id=EOS, family="xattn", device="cpu")
    with pytest.raises(ValueError, match="mels"):             # an xattn lane takes windows
        lane.submit(BeamRequest(request_id="b", ids=np.zeros((1, 4), np.int32),
                                mels=np.zeros((1, 1, 3000, 128), np.float32)))
    with pytest.raises(ValueError, match="family"):
        BeamLane(model=model, cfg=cfg, eos_token_id=EOS, family="vision", device="cpu")


@pytest.fixture(scope="module")
def w4_lms():
    jp = jax.jit(jqwen2.init, static_argnums=1)(jax.random.PRNGKey(3), JLM_W4)
    jq = jax.jit(jquant4.quantize_lm_params_w4, static_argnames=("group_size",))(
        jp, group_size=64)
    cfg = _pick(C.Qwen2Config, JLM_W4)
    lm = qwen2.quantized_lm(qwen2.unflatten(lm_params_from_jax(jq, cfg)), torch.float32, "cpu")
    with torch.device("meta"):
        flm = qwen2.Qwen2(cfg, dtype=torch.float32)
    flm = flm.to_empty(device="cpu")
    flm.load_state_dict(lm_params_from_jax(jax.tree.map(np.asarray, jp), cfg))
    return {"float": (jp, flm.eval()), "w4": (jq, lm)}, cfg


@pytest.mark.parametrize("kind", ["float", "w4"])
def test_rows_forward_matches_jax(w4_lms, monkeypatch, kind):
    """Three rows at their own offsets (one token each, then a block of two): hidden
    states and the K/V written per row. A fused w4 LM at one token takes the two suffix
    calls per layer (K6's plain versions on the CPU), as JAX's _rows_forward does."""
    lms, cfg = w4_lms
    jp, lm = lms[kind]
    calls = []
    real = qwen2.w4_suffix_a
    monkeypatch.setattr(qwen2, "w4_suffix_a", lambda *a, **k: calls.append(1) or real(*a, **k))
    rng = np.random.default_rng(5)
    b, cap = 3, 32
    hd = JLM_W4.resolved_head_dim()
    shape = (JLM_W4.num_layers, b, cap, JLM_W4.num_kv_heads, hd)
    k0 = rng.normal(size=shape).astype(np.float32)
    v0 = rng.normal(size=shape).astype(np.float32)
    lengths = np.asarray([4, 17, 9], np.int32)
    jcache = jengine.SlotCache(jnp.asarray(k0), jnp.asarray(v0), jnp.asarray(lengths))
    tcache = engine.SlotCache(torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy()),
                              torch.from_numpy(lengths.copy()))
    rows_forward = jax.jit(jengine._rows_forward, static_argnums=1)
    for s in (1, 2):
        ids = rng.integers(0, 128, (b, s)).astype(np.int32)
        jx = jqwen2.embed(jp, jnp.asarray(ids), dtype=jnp.float32)
        jh, jcache = rows_forward(jp, JLM_W4, jx, jcache.lengths, jcache)
        with torch.inference_mode():
            tx = qwen2.embed(lm, torch.from_numpy(ids).long())
            th, tcache = engine._rows_forward(lm, cfg, tx, tcache.lengths, tcache)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=HIDDEN_TOL, rtol=0)
        np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k), atol=KV_TOL, rtol=0)
        np.testing.assert_allclose(tcache.v.numpy(), np.asarray(jcache.v), atol=KV_TOL, rtol=0)
        jcache = jcache._replace(lengths=jcache.lengths + s)
        tcache.lengths = tcache.lengths + s
    assert len(calls) == (JLM_W4.num_layers if kind == "w4" else 0)


@pytest.mark.parametrize("sampling", [dict(greedy=True),
                                      dict(greedy=True, repetition_penalty=1.3,
                                           min_new_tokens=3)],
                         ids=["greedy", "penalty_min_new"])
def test_ragged_generate_matches_jax(models, sampling):
    params, cfg, model = models
    prompts = _prompts(9, [5, 9, 7])
    t = 9
    ids = np.stack([np.pad(p[0], (0, t - p.shape[1]), constant_values=EOS) for p in prompts])
    plen = np.asarray([p.shape[1] for p in prompts], np.int32)
    jt, jl = jgen.generate(params, JCFG, jnp.asarray(ids), None, max_new_tokens=10,
                           eos_token_id=EOS, sampling=JSamplingParams(**sampling),
                           compute_dtype=jnp.float32, prompt_len=jnp.asarray(plen))
    out = tgen.generate(model, cfg, torch.from_numpy(ids).long(), max_new_tokens=10,
                        eos_token_id=EOS, sampling=SamplingParams(**sampling),
                        prompt_len=torch.from_numpy(plen))
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(out.lengths.numpy(), np.asarray(jl))
    # each ragged row is the row decoded alone
    for r, p in enumerate(prompts):
        one = tgen.generate(model, cfg, torch.from_numpy(p).long(), max_new_tokens=10,
                            eos_token_id=EOS, sampling=SamplingParams(**sampling))
        assert torch.equal(one.tokens[0], out.tokens[r])


BEAM = dict(num_beams=3, max_new_tokens=8, num_return_sequences=2, length_penalty=1.5)


@pytest.fixture(scope="module")
def beam_refs(models):
    """The beam request's prompt, JAX's generate_beam on it, and the port's generate_beam
    on the bucket-padded prompt (the lane's own prefill shape)."""
    params, cfg, model = models
    ids = _prompts(11, [9])[0]
    js, jsc = jbeam.generate_beam(params, JCFG, jnp.asarray(ids), None, eos_token_id=EOS,
                                  compute_dtype=jnp.float32, **BEAM)
    padded = np.pad(ids, ((0, 0), (0, 128 - ids.shape[1])), constant_values=EOS)
    ts, tsc = beam.generate_beam(model, cfg, torch.from_numpy(padded).long(), eos_token_id=EOS,
                                 prompt_len=ids.shape[1], capacity=256, **BEAM)
    return ids, (np.asarray(js)[0], np.asarray(jsc)[0]), (ts[0].numpy(), tsc[0].numpy())


def _engine(kind, model, cfg):
    if kind == "batch":
        return engine.BatchEngine(model=model, cfg=cfg, num_slots=2, capacity=256, chunk=4,
                                  eos_token_id=EOS, device="cpu")
    return PagedEngine(model=model, cfg=cfg, num_rows=2, num_blocks=24, block_size=16,
                       max_blocks_per_seq=8, chunk=4, eos_token_id=EOS, device="cpu")


@pytest.mark.parametrize("kind", ["batch", "paged"])
@pytest.mark.parametrize("chunk", [1, 3, 8])
def test_beam_lane_equals_generate_beam(models, beam_refs, kind, chunk):
    _, cfg, model = models
    ids, jax_ref, port_ref = beam_refs
    specs = _text_specs(12, [5, 6, 7], 10)

    def serve(with_beam: bool):
        eng = _engine(kind, model, cfg)
        for rid, p, _, kw in specs:
            eng.submit(engine.Request(request_id=rid, ids=p.copy(), **kw))
        if with_beam:
            eng.submit_beam(BeamRequest(request_id="beam", ids=ids.copy(), **BEAM))
            eng.beam_lane.chunk = chunk
        return eng, eng.run_until_done()

    plain, plain_out = serve(False)
    eng, out = serve(True)
    assert out == plain_out and plain.finished_beams == {}
    seqs, scores = eng.finished_beams["beam"]
    assert seqs.shape == (2, BEAM["max_new_tokens"]) and not eng.beam_lane.busy
    np.testing.assert_array_equal(seqs, port_ref[0])       # bit for bit, chunked or not
    np.testing.assert_array_equal(scores, port_ref[1])
    np.testing.assert_array_equal(seqs, jax_ref[0])        # JAX's unpadded search
    np.testing.assert_allclose(scores, jax_ref[1], atol=LP_TOL, rtol=0)


def test_beam_lane_alone_sampled_and_ngram(models):
    """Beam requests with no slot traffic drain run_until_done; a sampled request (its
    own generator, seeded) and an n-gram one equal the one-shot search."""
    _, cfg, model = models
    a, b = _prompts(13, [6, 8])
    reqs = [BeamRequest(request_id="s", ids=a, num_beams=3, max_new_tokens=7, do_sample=True,
                        temperature=0.9, seed=5),
            BeamRequest(request_id="n", ids=b, num_beams=2, max_new_tokens=7,
                        no_repeat_ngram_size=2)]
    eng = _engine("batch", model, cfg)
    for r in reqs:
        eng.submit_beam(r)
    eng.run_until_done()
    for r in reqs:
        padded = np.pad(r.ids, ((0, 0), (0, 128 - r.ids.shape[1])), constant_values=EOS)
        gen = torch.Generator().manual_seed(r.seed) if r.do_sample else None
        want, want_sc = beam.generate_beam(
            model, cfg, torch.from_numpy(padded).long(), prompt_len=r.ids.shape[1],
            capacity=256, num_beams=r.num_beams, max_new_tokens=7, eos_token_id=EOS,
            do_sample=r.do_sample, temperature=r.temperature,
            no_repeat_ngram_size=r.no_repeat_ngram_size, generator=gen)
        got, got_sc = eng.finished_beams[r.request_id]
        np.testing.assert_array_equal(got, want[0].numpy())
        np.testing.assert_array_equal(got_sc, want_sc[0].numpy())
