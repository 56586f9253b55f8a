"""The rest of JAX's generate surface in the port, against the JAX package at f32 on
tests/test_gen_features.py's configuration and prompt: ``stop_sequences`` (tokens and
lengths exact), ``return_logprobs`` (tokens exact, log-probabilities within 1e-5),
``generate_stream`` (the same ids, with the EOS floor and the repetition penalty), the
refusal of stops and logprobs on ragged rows, and ``AudioFlamingo.generate(stream=True)``
against JAX's, text-only and with audio."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_flamingo_tpu.api import AudioFlamingo as JAudioFlamingo
from audio_flamingo_tpu.config import AF3Config as JAF3Config
from audio_flamingo_tpu.config import Qwen2Config as JQwen2Config
from audio_flamingo_tpu.config import WhisperEncoderConfig as JEncoderConfig
from audio_flamingo_tpu.models import af3 as jaf3
from audio_flamingo_tpu.ops.sampling import SamplingParams as JSamplingParams
from audio_flamingo_tpu.runtime import generate as jgen
from audio_flamingo_tpu_torch import config as C
from audio_flamingo_tpu_torch.api import AudioFlamingo
from audio_flamingo_tpu_torch.io.convert import params_from_jax
from audio_flamingo_tpu_torch.models import af3
from audio_flamingo_tpu_torch.ops.sampling import SamplingParams
from audio_flamingo_tpu_torch.runtime import generate as tgen
from audio_flamingo_tpu_torch.runtime.tokenizer import BBPETokenizer

jax.config.update("jax_default_matmul_precision", "highest")
torch.set_num_threads(2)

LP_TOL = 1e-5
MAX_NEW = 10
CFG = JAF3Config(
    encoder=JEncoderConfig(num_mel_bins=16, d_model=32, num_layers=1, num_heads=4,
                           ffn_dim=64, max_source_positions=12),
    lm=JQwen2Config(vocab_size=128, hidden_size=48, intermediate_size=96, num_layers=2,
                    num_heads=4, num_kv_heads=2, tie_word_embeddings=True),
    audio_token_id=120,
)


def _port_cfg(j):
    pick = lambda cls, obj: cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)})
    return C.AF3Config(encoder=pick(C.WhisperEncoderConfig, j.encoder),
                       lm=pick(C.Qwen2Config, j.lm), audio_token_id=j.audio_token_id)


@pytest.fixture(scope="module")
def models():
    params = jaf3.init(jax.random.PRNGKey(0), CFG)
    cfg = _port_cfg(CFG)
    model = af3.build(cfg, "cpu", torch.float32)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), cfg))
    prompt = np.random.default_rng(0).integers(0, 120, (1, 7)).astype(np.int32)
    return params, cfg, model, prompt


def _jax(models, eos, **kw):
    params, _, _, prompt = models
    return jgen.generate(params, CFG, jnp.asarray(prompt), max_new_tokens=MAX_NEW,
                         eos_token_id=eos, capacity=128, compute_dtype=jnp.float32,
                         sampling=JSamplingParams(**kw.pop("sampling", {})), **kw)


def _port(models, eos, **kw):
    _, cfg, model, prompt = models
    return tgen.generate(model, cfg, torch.from_numpy(prompt).long(), max_new_tokens=MAX_NEW,
                         eos_token_id=eos, capacity=128,
                         sampling=SamplingParams(**kw.pop("sampling", {})), **kw)


@pytest.fixture(scope="module")
def base(models):
    """The raw greedy stream (no EOS)."""
    toks, lens = _jax(models, -2)
    return [int(t) for t in np.asarray(toks)[0][: int(lens[0])]]


STOPS = {"mid": lambda b: (tuple(b[2:4]),),
         "never": lambda b: ((121, 122, 123),),
         "two": lambda b: ((121, 122, 123), tuple(b[5:8])),
         "first_token": lambda b: ((b[0],),),
         "longer_than_budget": lambda b: (tuple(b) + (1,),)}


@pytest.mark.parametrize("case", list(STOPS))
def test_stop_sequences_match_jax(models, base, case):
    stops = STOPS[case](base)
    toks, lens = _jax(models, -2, stop_sequences=stops)
    out = _port(models, -2, stop_sequences=stops)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(toks))
    np.testing.assert_array_equal(out.lengths.numpy(), np.asarray(lens))
    if case == "mid":    # stops right after the earliest occurrence, keeping the sequence
        n = int(out.lengths[0])
        assert out.tokens[0, :n].tolist()[-2:] == list(stops[0]) and n < MAX_NEW


# (forced EOS from the greedy stream's index or None, sampling): the EOS floor and the
# warps change the logits the token is sampled from, and so its log-probability
LOGPROB_CASES = {"greedy": (None, {}),
                 "eos_floor": (1, dict(min_new_tokens=5)),
                 "eos_hit": (3, {}),
                 "repetition": (None, dict(repetition_penalty=1.3)),
                 "ngram": (None, dict(no_repeat_ngram_size=2))}


@pytest.mark.parametrize("case", list(LOGPROB_CASES))
def test_logprobs_match_jax(models, base, case):
    eos_at, sampling = LOGPROB_CASES[case]
    eos = -2 if eos_at is None else base[eos_at]
    toks, lens, lp = _jax(models, eos, sampling=dict(sampling), return_logprobs=True)
    out = _port(models, eos, sampling=dict(sampling), return_logprobs=True)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(toks))
    np.testing.assert_array_equal(out.lengths.numpy(), np.asarray(lens))
    assert out.logprobs.dtype == torch.float32 and out.logprobs.shape == (1, MAX_NEW)
    np.testing.assert_allclose(out.logprobs.numpy(), np.asarray(lp), atol=LP_TOL, rtol=0)
    assert (out.logprobs <= 0).all()
    assert _port(models, eos, sampling=dict(sampling)).logprobs is None


def test_stops_and_logprobs_together(models, base):
    stops = (tuple(base[3:5]),)
    toks, lens, lp = _jax(models, base[7], stop_sequences=stops, return_logprobs=True)
    out = _port(models, base[7], stop_sequences=stops, return_logprobs=True)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(toks))
    np.testing.assert_array_equal(out.lengths.numpy(), np.asarray(lens))
    np.testing.assert_allclose(out.logprobs.numpy(), np.asarray(lp), atol=LP_TOL, rtol=0)


STREAM_CASES = {"plain": (None, {}, MAX_NEW),
                "eos_floor": (1, dict(min_new_tokens=5), MAX_NEW),
                "eos_stops": (2, {}, MAX_NEW),
                "repetition": (None, dict(repetition_penalty=1.3), 6)}


@pytest.mark.parametrize("case", list(STREAM_CASES))
def test_generate_stream_matches_jax(models, base, case):
    params, cfg, model, prompt = models
    eos_at, sampling, n = STREAM_CASES[case]
    eos = -2 if eos_at is None else base[eos_at]
    want = list(jgen.generate_stream(params, CFG, jnp.asarray(prompt), max_new_tokens=n,
                                     eos_token_id=eos, sampling=JSamplingParams(**sampling),
                                     compute_dtype=jnp.float32))
    got = list(tgen.generate_stream(model, cfg, torch.from_numpy(prompt).long(),
                                    max_new_tokens=n, eos_token_id=eos,
                                    sampling=SamplingParams(**sampling)))
    assert got == want and all(isinstance(t, int) for t in got)
    if case == "eos_stops":
        assert got[-1] == eos and len(got) == base.index(eos) + 1


def test_ragged_prompt_len_refuses_stops_and_logprobs(models):
    _, cfg, model, prompt = models
    ids = torch.from_numpy(np.concatenate([prompt, prompt])).long()
    ragged = torch.tensor([7, 5])
    for kw in (dict(stop_sequences=((1, 2),)), dict(return_logprobs=True)):
        with pytest.raises(ValueError, match="ragged"):
            tgen.generate(model, cfg, ids, prompt_len=ragged, **kw)
    out = tgen.generate(model, cfg, ids, prompt_len=ragged, max_new_tokens=3)   # now ported
    assert out.tokens.shape == (2, 3)
    with pytest.raises(ValueError, match="batch 1"):
        next(tgen.generate_stream(model, cfg, ids))


@pytest.fixture(scope="module")
def api_models():
    jm = JAudioFlamingo.from_random(compute_dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jm.params)
    cfg = _port_cfg(jm.cfg)
    tok = BBPETokenizer(jm.processor.tokenizer.vocab, jm.processor.tokenizer.merges)
    tm = AudioFlamingo.from_state_dict(cfg, params_from_jax(params, cfg), tok,
                                       compute_dtype=torch.float32, device="cpu")
    return jm, tm


@pytest.mark.parametrize("with_audio", [False, True])
def test_api_generate_stream_matches_jax(api_models, with_audio):
    jm, tm = api_models
    sound = (0.2 * np.sin(2 * np.pi * 440 * np.arange(16000 * 2) / 16000)).astype(np.float32)
    kw = dict(sound=sound if with_audio else None, prompt="Describe the sound.",
              max_new_tokens=6)
    want = list(jm.generate(stream=True, **kw))
    stream = tm.generate(stream=True, **kw)
    assert not isinstance(stream, (str, list))
    assert list(stream) == want and 1 <= len(want) <= 6
    assert tm.history == []
