"""Port's AF3 composition, sampling and generate loop against the JAX package at f32:
af3.logits with audio, greedy AudioFlamingo.generate token-exact (text-only and with a
2 s tone), the sampling warpers on shared logits, and the API's own behaviour."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_flamingo_tpu.api import AudioFlamingo as JAudioFlamingo
from audio_flamingo_tpu.models import af3 as jaf3
from audio_flamingo_tpu.ops import quant as jquant
from audio_flamingo_tpu.ops import sampling as js
from audio_flamingo_tpu.runtime import generate as jgen
from audio_flamingo_tpu.train.data import bucket_tokens as j_bucket_tokens
from audio_flamingo_tpu_torch import config as C
from audio_flamingo_tpu_torch import api
from audio_flamingo_tpu_torch.api import AudioFlamingo
from audio_flamingo_tpu_torch.io.convert import params_from_jax
from audio_flamingo_tpu_torch.models import af3, whisper_encoder
from audio_flamingo_tpu_torch.ops import sampling as ts
from audio_flamingo_tpu_torch.runtime.tokenizer import BBPETokenizer

jax.config.update("jax_default_matmul_precision", "highest")
torch.set_num_threads(2)

TONE = (0.2 * np.sin(2 * np.pi * 440 * np.arange(16000 * 2) / 16000)).astype(np.float32)


def _port_cfg(j):
    pick = lambda cls, obj: cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)})
    return C.AF3Config(encoder=pick(C.WhisperEncoderConfig, j.encoder),
                       lm=pick(C.Qwen2Config, j.lm), audio_token_id=j.audio_token_id)


@pytest.fixture(scope="module")
def models():
    jm = JAudioFlamingo.from_random(compute_dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jm.params)
    cfg = _port_cfg(jm.cfg)
    tok = BBPETokenizer(jm.processor.tokenizer.vocab, jm.processor.tokenizer.merges)
    tm = AudioFlamingo.from_state_dict(cfg, params_from_jax(params, cfg), tok,
                                       compute_dtype=torch.float32, device="cpu")
    return jm, tm


def _jax_ids(jm, prompt, sound, max_new_tokens, sampling):
    """The token ids JAX api.generate decodes (same processor, bucket padding, loop)."""
    text = f"<sound>{prompt}" if sound is not None else prompt
    batch = jm.processor(messages=[{"role": "user", "content": text}],
                         audios=[sound] if sound is not None else None)
    ids = jnp.asarray(batch["ids"])
    mels = jnp.asarray(batch["mels"]) if batch["mels"] is not None else None
    t = ids.shape[1]
    bucket = j_bucket_tokens(t)
    ids = jnp.concatenate([ids, jnp.full((1, bucket - t), jm.eos_token_id, jnp.int32)], 1)
    tokens, lengths = jgen.generate(jm.params, jm.cfg, ids, mels, max_new_tokens=max_new_tokens,
                                    eos_token_id=jm.eos_token_id, sampling=sampling,
                                    rng=jax.random.PRNGKey(0), compute_dtype=jnp.float32,
                                    prompt_len=jnp.asarray(t, jnp.int32))
    return np.asarray(tokens)[0][: int(lengths[0])].tolist()


def test_logits_with_audio_match_jax(models):
    jm, tm = models
    batch = jm.processor(messages=[{"role": "user", "content": "<sound>hi"}], audios=[TONE])
    want = np.asarray(jaf3.logits(jm.params, jm.cfg, jnp.asarray(batch["ids"]),
                                  jnp.asarray(batch["mels"])))
    got = af3.logits(tm.model, tm.cfg, torch.from_numpy(batch["ids"]).long(),
                     torch.from_numpy(np.asarray(batch["mels"]))).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_processor_matches_jax(models):
    jm, tm = models
    msgs = [{"role": "user", "content": "<sound>What is this?"}]
    jb = jm.processor(messages=msgs, audios=[TONE])
    tb = tm.processor(messages=msgs, audios=[TONE])
    np.testing.assert_array_equal(tb["ids"], jb["ids"])
    np.testing.assert_allclose(tb["mels"].numpy(), np.asarray(jb["mels"]), atol=2e-4, rtol=0)


def test_scatter_audio_embeds_matches_jax():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 5, size=(2, 20))
    text, audio = rng.normal(size=(2, 20, 8)), rng.normal(size=(2, 12, 8))
    want = jaf3.scatter_audio_embeds(jnp.asarray(text, jnp.float32), jnp.asarray(ids),
                                     jnp.asarray(audio, jnp.float32), 3)
    got = af3.scatter_audio_embeds(torch.tensor(text, dtype=torch.float32), torch.tensor(ids),
                                   torch.tensor(audio, dtype=torch.float32), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", ["text", "tone", "tone_penalty_min_new"])
def test_greedy_generate_token_exact(models, case):
    jm, tm = models
    sound = None if case == "text" else TONE
    sampling = (dict(repetition_penalty=1.3, min_new_tokens=3)
                if case == "tone_penalty_min_new" else {})
    jtext = jm.generate(sound=sound, prompt="What do you hear?", max_new_tokens=6,
                        sampling=js.SamplingParams(**sampling))
    ttext = tm.generate(sound=sound, prompt="What do you hear?", max_new_tokens=6,
                        sampling=ts.SamplingParams(**sampling))
    want = _jax_ids(jm, "What do you hear?", sound, 6, js.SamplingParams(**sampling))
    out = tm.last_output
    assert out.tokens[0, : int(out.lengths[0])].tolist() == want
    assert ttext == jtext


def test_warpers_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 50)).astype(np.float32) * 3
    hist = rng.integers(-1, 50, size=(3, 7)).astype(np.int32)
    lt, lj = torch.from_numpy(logits), jnp.asarray(logits)
    np.testing.assert_array_equal(ts.apply_top_k(lt, 5).numpy(), np.asarray(js.apply_top_k(lj, 5)))
    np.testing.assert_array_equal(ts.apply_top_p(lt, 0.7).numpy(),
                                  np.asarray(js.apply_top_p(lj, 0.7)))
    np.testing.assert_allclose(
        ts.apply_repetition_penalty(lt, torch.from_numpy(hist), 1.5).numpy(),
        np.asarray(js.apply_repetition_penalty(lj, jnp.asarray(hist), 1.5, 50)), rtol=1e-6)
    blocked = np.array([True, False, True])
    np.testing.assert_array_equal(ts.mask_eos(lt, 4, torch.from_numpy(blocked)).numpy(),
                                  np.asarray(js.mask_eos(lj, 4, jnp.asarray(blocked))))
    np.testing.assert_array_equal(
        ts.sample_token(lt, ts.SamplingParams(), token_history=torch.from_numpy(hist)).numpy(),
        np.asarray(js.sample_token(jax.random.PRNGKey(0), lj, js.SamplingParams(),
                                   token_history=jnp.asarray(hist))))


def test_sampled_generate_is_seeded_and_in_vocab(models):
    _, tm = models
    sp = ts.SamplingParams(greedy=False, temperature=0.8, top_k=50, top_p=0.9)
    a = tm.generate(prompt="sing", max_new_tokens=5, sampling=sp, seed=3)
    ids_a = tm.last_output.tokens.clone()
    b = tm.generate(prompt="sing", max_new_tokens=5, sampling=sp, seed=3)
    assert a == b and torch.equal(ids_a, tm.last_output.tokens)
    assert int(ids_a.max()) < tm.cfg.lm.vocab_size and int(ids_a.min()) >= 0


def test_chat_think_and_unported_options(models):
    _, tm = models
    tm.reset_chat()
    tm.generate(sound=TONE, prompt="first", chat=True, max_new_tokens=2)
    tm.generate(prompt="second", chat=True, think=True, max_new_tokens=2)
    assert [m["role"] for m in tm.history] == ["user", "assistant"] * 2
    assert len(tm.history[0]["audios"]) == 1 and not tm.history[2]["audios"]
    assert tm.history[2]["content"].endswith(tm.THINK_INSTRUCTION)
    tm.reset_chat()
    answer = tm.generate(prompt="x", num_beams=2, max_new_tokens=2)   # now ported
    assert isinstance(answer, str) and tm.last_output is None
    streamed = list(tm.generate(prompt="x", stream=True, max_new_tokens=2))   # now ported
    assert 1 <= len(streamed) <= 2 and all(isinstance(t, int) for t in streamed)
    # speculation is ported: the model as its own draft answers as the plain path does
    want = tm.generate(prompt="x", max_new_tokens=4)
    drafted = dataclasses.replace(tm, draft=tm.model.lm, draft_cfg=tm.cfg.lm)
    assert drafted.generate(prompt="x", max_new_tokens=4) == want
    assert drafted.last_output is None and drafted.last_spec.rounds >= 1


def test_jax_api_arguments_exist_with_jax_defaults():
    """Every argument of the JAX entry points exists in the port with the JAX default, so a
    caller written for the JAX API gets no TypeError."""
    import inspect

    from audio_flamingo_tpu import api as japi
    from audio_flamingo_tpu.audio.mel import WhisperMelFrontend as JWhisperMelFrontend
    from audio_flamingo_tpu.runtime.processor import AF3Processor as JAF3Processor
    from audio_flamingo_tpu_torch.audio.mel import WhisperMelFrontend
    from audio_flamingo_tpu_torch.runtime.processor import AF3Processor

    pairs = [(japi.AudioFlamingo.generate, AudioFlamingo.generate), (japi.load, api.load),
             (JAF3Processor, AF3Processor), (JWhisperMelFrontend.__init__,
                                             WhisperMelFrontend.__init__)]
    for jfn, tfn in pairs:
        tparams = inspect.signature(tfn).parameters
        for name, jp in inspect.signature(jfn).parameters.items():
            assert name in tparams, (tfn, name)
            if name not in ("compute_dtype", "cfg", "frontend"):
                assert tparams[name].default == jp.default, (tfn, name)
    assert ts.SamplingParams._fields[: len(js.SamplingParams._fields)] == js.SamplingParams._fields
    assert ts.SamplingParams()._asdict() == js.SamplingParams()._asdict()


def test_jax_api_arguments_run_at_default_and_raise_otherwise(models, tmp_path):
    _, tm = models
    tm.generate(prompt="x", max_new_tokens=2, length_penalty=1.0, early_stopping=False,
                sampling=ts.SamplingParams(no_repeat_ngram_size=0))
    want = tm.last_output.tokens.clone()
    tm.generate(prompt="x", max_new_tokens=2)
    assert torch.equal(tm.last_output.tokens, want)
    for kw in (dict(length_penalty=0.5), dict(early_stopping=True)):
        # beam-search options: with num_beams == 1 they change nothing, as in JAX
        tm.generate(prompt="x", max_new_tokens=2, **kw)
        assert torch.equal(tm.last_output.tokens, want)
    # the n-gram ban is ported: with n = 1 no generated token repeats a prompt or
    # generated token (its parity with JAX is in test_torch_row_sampling.py)
    tm.generate(prompt="x", max_new_tokens=6, sampling=ts.SamplingParams(no_repeat_ngram_size=1))
    out = tm.last_output.tokens[0, : int(tm.last_output.lengths[0])].tolist()
    prompt_ids = tm.processor(messages=[{"role": "user", "content": "x"}])["ids"][0].tolist()
    assert len(set(out)) == len(out) and not set(out) & set(prompt_ids)
    # the w8a8 options work: a8_prefill without the int8 LM raises, as JAX's assert does;
    # the int8 encoder that a8_encoder loads (JAX's quantize_encoder_params, carried by
    # params_from_jax) answers as JAX's does on the same tree, token for token
    with pytest.raises(ValueError, match="a8_prefill requires"):
        api.load(str(tmp_path), device="cpu", a8_prefill=True)
    jm, _ = models
    jparams = {**jm.params, "encoder": jquant.quantize_encoder_params(jm.params["encoder"])}
    jm8 = dataclasses.replace(jm, params=jparams, history=[])
    tm8 = AudioFlamingo.from_state_dict(
        tm.cfg, params_from_jax(jax.tree.map(np.asarray, jparams), tm.cfg),
        tm.processor.tokenizer, compute_dtype=torch.float32, device="cpu")
    assert isinstance(tm8.model.encoder, whisper_encoder.QuantWhisperEncoder)
    tm8.generate(sound=TONE, prompt="x", max_new_tokens=4)
    got = tm8.last_output.tokens[0, : int(tm8.last_output.lengths[0])].tolist()
    assert got == _jax_ids(jm8, "x", TONE, 4, js.SamplingParams())


def test_generate_reports_processor_time(models):
    _, tm = models
    tm.generate(sound=TONE, prompt="hi", max_new_tokens=2)
    assert tm.last_processor_s is not None and tm.last_processor_s > 0
    assert tm.with_config(tm.cfg).last_processor_s is None
