"""The port's beam search (runtime/beam.py) against JAX's generate_beam at f32 on the same
numpy-seeded weights (AF3Config.tiny(), the final norm scaled by 4 so beams part early):
token-exact sequences and scores within 1e-4 over beam widths 2-4, the three
early-stopping modes, length penalties, the EOS floor, several returned sequences, the
n-gram ban, audio and a batch of two; exact ties in the candidates and in the finished
merge (duplicated head rows), where the port must pick JAX's indices; the sampled beam's
laws; steps after the end change nothing; api.generate(num_beams=3) answers as JAX's API."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_flamingo_tpu.api import AudioFlamingo as JAudioFlamingo
from audio_flamingo_tpu.config import AF3Config as JAF3Config
from audio_flamingo_tpu.models import af3 as jaf3
from audio_flamingo_tpu.runtime import beam as jbeam
from audio_flamingo_tpu_torch import config as C
from audio_flamingo_tpu_torch.api import AudioFlamingo
from audio_flamingo_tpu_torch.io.convert import params_from_jax
from audio_flamingo_tpu_torch.models import af3
from audio_flamingo_tpu_torch.runtime import beam
from audio_flamingo_tpu_torch.runtime.tokenizer import BBPETokenizer

jax.config.update("jax_default_matmul_precision", "highest")
torch.set_num_threads(2)

SCORE_TOL = 1e-4
EOS = 258                 # a token the seed-0 beams emit mid-sequence
MAX_NEW = 10
JCFG = JAF3Config.tiny()


def _port_cfg(j):
    pick = lambda cls, obj: cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)})
    return C.AF3Config(encoder=pick(C.WhisperEncoderConfig, j.encoder),
                       lm=pick(C.Qwen2Config, j.lm), audio_token_id=j.audio_token_id)


def _pair(params):
    cfg = _port_cfg(JCFG)
    model = af3.build(cfg, "cpu", torch.float32)
    model.load_state_dict(params_from_jax(params, cfg))
    return params, cfg, model


@pytest.fixture(scope="module")
def models():
    params = jax.tree.map(np.asarray, jaf3.init(jax.random.PRNGKey(0), JCFG))
    params["lm"]["ln_f_w"] = params["lm"]["ln_f_w"] * 4.0
    return _pair(params)


@pytest.fixture(scope="module")
def tie_models(models):
    """Tokens 120 and 300 get token 234's tied embedding row: their logits equal 234's
    exactly, and beams that differ only by them carry equal scores."""
    params = jax.tree.map(np.copy, models[0])
    emb = params["lm"]["embed"]
    emb[120] = emb[234]
    emb[300] = emb[234]
    return _pair(params)


IDS = np.random.default_rng(0).integers(0, 400, (1, 10))


def _both(models, ids, mels=None, eos=EOS, **kw):
    """(JAX sequences, scores), (port sequences, scores) as numpy."""
    params, cfg, model = models
    kw = dict(max_new_tokens=MAX_NEW, eos_token_id=eos, **kw)
    js, jsc = jbeam.generate_beam(params, JCFG, jnp.asarray(ids, jnp.int32),
                                  None if mels is None else jnp.asarray(mels),
                                  compute_dtype=jnp.float32, **kw)
    ts, tsc = beam.generate_beam(model, cfg, torch.from_numpy(ids).long(),
                                 None if mels is None else torch.from_numpy(mels), **kw)
    return (np.asarray(js), np.asarray(jsc)), (ts.numpy(), tsc.numpy())


def _assert_equal(want, got):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], atol=SCORE_TOL, rtol=0)


def test_top_k_orders_ties_as_jax():
    rng = np.random.default_rng(1)
    cases = [rng.integers(-3, 3, (4, 40)).astype(np.float32),
             np.float32(beam.NEG) + rng.integers(0, 2, (3, 24)).astype(np.float32) * 64,
             np.concatenate([np.full((2, 8), beam.NEG, np.float32),
                             rng.normal(size=(2, 8)).astype(np.float32)], axis=1),
             rng.normal(size=(2, 1000)).astype(np.float32) * 1e3]
    for x in cases:
        for k in (1, 3, 8):
            jv, ji = jax.lax.top_k(jnp.asarray(x), k)
            tv, ti = beam.top_k(torch.from_numpy(x), k)
            np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("kw", [
    dict(num_beams=2),
    dict(num_beams=4, num_return_sequences=4),
    dict(num_beams=3, early_stopping=True),
    dict(num_beams=3, early_stopping="never", length_penalty=1.5),
    dict(num_beams=3, length_penalty=2.0, min_new_tokens=3),
    dict(num_beams=3, no_repeat_ngram_size=2, num_return_sequences=2),
], ids=["k2", "k4_r4", "early_true", "never_lp1.5", "lp2_min_new3", "ngram2_r2"])
def test_generate_beam_matches_jax(models, kw):
    want, got = _both(models, IDS, **kw)
    _assert_equal(want, got)
    assert got[0].shape == (1, kw.get("num_return_sequences", 1), MAX_NEW)


def test_beams_finish_mid_sequence(models):
    """The cases above reach the finished merge before the last step: with
    early_stopping=True the best beam ends in EOS at step 4."""
    _, cfg, model = models
    seqs, _ = beam.generate_beam(model, cfg, torch.from_numpy(IDS), num_beams=3,
                                 max_new_tokens=MAX_NEW, eos_token_id=EOS, early_stopping=True)
    row = seqs[0, 0].tolist()
    assert EOS in row and row.index(EOS) < MAX_NEW - 1
    assert all(t == EOS for t in row[row.index(EOS):])


def test_generate_beam_with_audio_matches_jax(models):
    rng = np.random.default_rng(3)
    n_audio = JCFG.encoder.max_source_positions // JCFG.encoder.pool_stride
    ids = np.concatenate([rng.integers(0, 400, (1, 3)), np.full((1, n_audio), JCFG.audio_token_id),
                          rng.integers(0, 400, (1, 4))], axis=1)
    mels = rng.normal(size=(1, 1, 2 * JCFG.encoder.max_source_positions,
                            JCFG.encoder.num_mel_bins)).astype(np.float32)
    want, got = _both(models, ids, mels, num_beams=4, num_return_sequences=2)
    _assert_equal(want, got)


def test_batch_of_two_matches_jax_and_single_rows(models):
    _, cfg, model = models
    rng = np.random.default_rng(7)
    both = rng.integers(0, 400, (2, 9))
    want, got = _both(models, both, num_beams=3, num_return_sequences=3)
    _assert_equal(want, got)
    for r in range(2):
        s1, sc1 = beam.generate_beam(model, cfg, torch.from_numpy(both[r:r + 1]), num_beams=3,
                                     max_new_tokens=MAX_NEW, eos_token_id=EOS,
                                     num_return_sequences=3)
        np.testing.assert_array_equal(got[0][r], s1[0].numpy())
        np.testing.assert_allclose(got[1][r], sc1[0].numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("kw", [dict(num_beams=3, num_return_sequences=3),
                                dict(num_beams=4, num_return_sequences=4, early_stopping=True)],
                         ids=["k3", "k4_early"])
def test_exact_ties_pick_jax_indices(tie_models, kw):
    """Candidates tie exactly (tokens 120, 234 and 300 share a row; beams that differ only
    by them score equally) and the finished merge ties near NEG wherever fewer than R beams
    finished; the port returns JAX's beams, in JAX's order."""
    emb = tie_models[2].lm.embed_tokens
    assert torch.equal(emb[120], emb[234]) and torch.equal(emb[300], emb[234])
    for eos in (300, 120):
        want, got = _both(tie_models, IDS, eos=eos, **kw)
        _assert_equal(want, got)
        assert {120, 234, 300} & set(got[0].flatten().tolist())


def test_sampled_beam_laws(models):
    """do_sample beams (Gumbel-top-k, multinomial without replacement): near-zero
    temperature is the deterministic search; one seed gives one answer; two seeds give
    two; ids stay in the vocabulary (JAX's draws cannot be matched: tests/test_beam.py
    holds its own sampled beam to the same laws)."""
    _, cfg, model = models
    ids = torch.from_numpy(IDS)
    kw = dict(num_beams=3, max_new_tokens=8, eos_token_id=EOS)
    det, _ = beam.generate_beam(model, cfg, ids, **kw)
    cold, _ = beam.generate_beam(model, cfg, ids, do_sample=True, temperature=1e-4,
                                 generator=torch.Generator().manual_seed(1), **kw)
    assert torch.equal(det, cold)
    outs = []
    for seed in (1, 2):
        a, sa = beam.generate_beam(model, cfg, ids, do_sample=True, temperature=1.5,
                                   generator=torch.Generator().manual_seed(seed), **kw)
        b, sb = beam.generate_beam(model, cfg, ids, do_sample=True, temperature=1.5,
                                   generator=torch.Generator().manual_seed(seed), **kw)
        assert torch.equal(a, b) and torch.equal(sa, sb)
        outs.append(a[0, 0].tolist())
    assert outs[0] != outs[1]
    assert all(0 <= t < cfg.lm.vocab_size for t in outs[0] + outs[1])
    # without a generator a sampled search draws from one seeded 0, as JAX's PRNGKey(0)
    u, _ = beam.generate_beam(model, cfg, ids, do_sample=True, temperature=1.5, **kw)
    v, _ = beam.generate_beam(model, cfg, ids, do_sample=True, temperature=1.5,
                              generator=torch.Generator().manual_seed(0), **kw)
    assert torch.equal(u, v)


@pytest.mark.parametrize("kw,capacity", [
    (dict(early_stopping=True), 128),
    (dict(no_repeat_ngram_size=2, do_sample=True), 128),
    (dict(no_repeat_ngram_size=2), IDS.shape[1] + MAX_NEW)],
    ids=["ended_at_step_5", "stopped_at_step_3", "ran_to_max_new_in_a_full_cache"])
def test_steps_after_the_end_change_no_state(models, kw, capacity):
    """JAX's while_loop runs no body once alive is false; the port's gated step leaves
    every tensor of the state, the cache included, exactly as it was: after the search
    ended by itself (early_stopping=True ends at step 5), after alive was cleared at step
    3 of a sampled search with the n-gram history, and after a search that ran all
    max_new_tokens steps in a cache with no slot to spare (every index of a step past
    the end would fall outside its tensor)."""
    _, cfg, model = models
    spec = beam.BeamSpec(num_beams=3, max_new_tokens=MAX_NEW, eos_token_id=EOS, **kw)
    search = beam.beam_open(model, cfg, torch.from_numpy(IDS), None, IDS.shape[1],
                            capacity=capacity, generator=torch.Generator().manual_seed(0),
                            **spec._asdict())
    st = search.state
    if spec.do_sample:
        search.advance(3)
        with torch.inference_mode():
            st.alive.fill_(False)
    else:
        search.run()
    assert not bool(st.alive)
    assert int(st.i) == MAX_NEW if capacity < 128 else int(st.i) < MAX_NEW
    before = {k: v.clone() for k, v in vars(st).items() if isinstance(v, torch.Tensor)}
    cache_before = (st.cache.k.clone(), st.cache.v.clone(), st.cache.index.clone())
    with torch.inference_mode():
        for _ in range(3):
            beam.beam_body(model.lm, cfg.lm, spec, st)
    for k, v in before.items():
        assert torch.equal(getattr(st, k), v), k
    for a, b in zip((st.cache.k, st.cache.v, st.cache.index), cache_before):
        assert torch.equal(a, b)


def test_api_generate_num_beams_matches_jax():
    jm = JAudioFlamingo.from_random(compute_dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jm.params)
    cfg = _port_cfg(jm.cfg)
    tok = BBPETokenizer(jm.processor.tokenizer.vocab, jm.processor.tokenizer.merges)
    tm = AudioFlamingo.from_state_dict(cfg, params_from_jax(params, cfg), tok,
                                       compute_dtype=torch.float32, device="cpu")
    tone = (0.2 * np.sin(2 * np.pi * 440 * np.arange(16000 * 2) / 16000)).astype(np.float32)
    for kw in (dict(prompt="describe the sound"), dict(sound=tone, prompt="what is it")):
        want = jm.generate(max_new_tokens=6, num_beams=3, length_penalty=1.5, **kw)
        got = tm.generate(max_new_tokens=6, num_beams=3, length_penalty=1.5, **kw)
        assert got == want
    assert tm.last_output is None
    tm.generate(prompt="a", max_new_tokens=3, num_beams=2, chat=True)
    assert [m["role"] for m in tm.history] == ["user", "assistant"]
    with pytest.raises(ValueError, match="mutually exclusive"):
        tm.generate(prompt="x", num_beams=2, stream=True)


def test_af1_af2_beam_variants_raise():
    """The AF1/AF2 variants are ported (tests/test_torch_beam_xattn.py holds them to
    JAX's); they refuse what the AF3 ones refuse."""
    from audio_flamingo_tpu_torch.models import flamingo

    cfg = C.AF2Config(lm=C.Qwen2Config(vocab_size=64, hidden_size=32, intermediate_size=64,
                                       num_layers=1, num_heads=4, num_kv_heads=2),
                      xattn=C.GatedXAttnConfig(num_heads=4, ffn_mult=2),
                      num_audio_transform_layers=1, audio_embed_dim=16)
    model = flamingo.init(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
    ids, wins = torch.zeros((1, 5), dtype=torch.long), torch.zeros((1, 1, 2, 16))
    with pytest.raises(ValueError, match="early_stopping"):
        beam.generate_beam_xattn(model, cfg, ids, wins, num_beams=2, max_new_tokens=3,
                                 eos_token_id=1, early_stopping="sometimes")
    with pytest.raises(ValueError, match="num_return_sequences"):
        beam.generate_beam_xattn(model, cfg, ids, wins, num_beams=2, max_new_tokens=3,
                                 eos_token_id=1, num_return_sequences=3)
    with pytest.raises(ValueError, match="cannot take"):
        beam.beam_open_xattn(model, cfg, ids, wins, 5, num_beams=2, max_new_tokens=3,
                             eos_token_id=1, capacity=6)
    assert beam.beam_advance_xattn is beam.beam_advance
