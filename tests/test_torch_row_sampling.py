"""The port's per-row sampling (ops/sampling.py) against the JAX package: the row warpers
and history processors value for value, ``engine_row_step`` token for token on greedy
rows (with the n-gram ban, repetition penalty, EOS floor, logprobs and the history
append), sampled rows in law against the JAX warp chain's exact distribution, and the
n-gram ban in the port's ``generate`` token-exact against the JAX ``generate`` at f32.
Mirrors tests/test_row_sampling.py."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_flamingo_tpu.config import AF3Config as JAF3Config
from audio_flamingo_tpu.models import af3 as jaf3
from audio_flamingo_tpu.ops import sampling as js
from audio_flamingo_tpu.runtime import generate as jgen
from audio_flamingo_tpu_torch import config as C
from audio_flamingo_tpu_torch.io.convert import params_from_jax
from audio_flamingo_tpu_torch.models import af3
from audio_flamingo_tpu_torch.ops import sampling as ts
from audio_flamingo_tpu_torch.runtime import generate as tgen

jax.config.update("jax_default_matmul_precision", "highest")
torch.set_num_threads(2)

LP_TOL = 1e-5        # f32 log-softmax of the same logits
LAW_TOL = 0.03       # |empirical - exact| per token over 6000 draws (std <= 0.0065)
ROWS = [js.SamplingParams(greedy=True), js.SamplingParams(greedy=False, top_k=3),
        js.SamplingParams(greedy=False, top_p=0.6, temperature=0.7),
        js.SamplingParams(greedy=False, top_k=0, top_p=1.0, temperature=2.0)]


def _t(rows):
    return [ts.SamplingParams(**p._asdict()) for p in rows]


def test_row_warpers_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(4, 40)).astype(np.float32) * 2
    ks = np.asarray([1, 5, 0, -2], np.int32)
    ps = np.asarray([0.1, 0.5, 0.9, 1.0], np.float32)
    np.testing.assert_array_equal(
        ts.apply_top_k_rows(torch.from_numpy(logits), torch.from_numpy(ks).long()).numpy(),
        np.asarray(js.apply_top_k_rows(jnp.asarray(logits), jnp.asarray(ks))))
    np.testing.assert_array_equal(
        ts.apply_top_p_rows(torch.from_numpy(logits), torch.from_numpy(ps)).numpy(),
        np.asarray(js.apply_top_p_rows(jnp.asarray(logits), jnp.asarray(ps))))
    hist = rng.integers(-1, 40, size=(4, 9)).astype(np.int32)
    pen = np.asarray([1.0, 1.3, 0.8, 2.0], np.float32)
    np.testing.assert_array_equal(
        ts.apply_repetition_penalty_rows(torch.from_numpy(logits), torch.from_numpy(hist),
                                         torch.from_numpy(pen)).numpy(),
        np.asarray(js.apply_repetition_penalty_rows(jnp.asarray(logits), jnp.asarray(hist),
                                                    jnp.asarray(pen))))
    got, want = ts.row_sampling(_t(ROWS)), js.row_sampling(ROWS)
    for name, a, b in zip(ts.RowSampling._fields, got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_no_repeat_ngram_rows_match_jax(n):
    rng = np.random.default_rng(n)
    logits = rng.normal(size=(3, 12)).astype(np.float32)
    hist = rng.integers(0, 2, size=(3, 10)).astype(np.int32)    # two ids: n-grams repeat
    lengths = np.asarray([10, 6, 1], np.int32)
    enable = np.asarray([True, True, False])
    got = ts.apply_no_repeat_ngram_rows(torch.from_numpy(logits), torch.from_numpy(hist),
                                        torch.from_numpy(lengths), n, torch.from_numpy(enable))
    want = js.apply_no_repeat_ngram_rows(jnp.asarray(logits), jnp.asarray(hist),
                                         jnp.asarray(lengths), n, jnp.asarray(enable))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() == ts.NEG_INF).any()
    shared = ts.apply_no_repeat_ngram(torch.from_numpy(logits), torch.from_numpy(hist), 8, n)
    np.testing.assert_array_equal(shared.numpy(), np.asarray(js.apply_no_repeat_ngram(
        jnp.asarray(logits), jnp.asarray(hist), jnp.asarray(8, jnp.int32), n)))


@pytest.mark.parametrize("case", ["plain", "processors"])
def test_engine_row_step_matches_jax_on_greedy_rows(case):
    rng = np.random.default_rng(7)
    b, v, h = 4, 16, 12
    logits = rng.normal(size=(b, v)).astype(np.float32) * 3
    hist = np.full((b, h), -1, np.int32)
    hist_len = np.asarray([6, 4, 12, 3], np.int32)
    for r, n in enumerate(hist_len):
        hist[r, :n] = rng.integers(0, 3, size=n)
    done = np.asarray([False, False, False, True])
    min_left = np.asarray([3, 0, 5, 0], np.int32)
    extra = (dict(repetition_penalty=1.5, no_repeat_ngram_size=2) if case == "processors"
             else {})
    rows = [js.SamplingParams(greedy=True, **extra)] * b
    use_pen, ngram_ns = js.processor_flags(rows)
    assert ts.processor_flags(_t(rows)) == (use_pen, ngram_ns)
    kw = dict(eos_token_id=5, mixed_sampling=False, want_logprobs=True, use_min_new=True,
              use_penalty=use_pen, ngram_ns=ngram_ns)
    jn, jlp, jh = js.engine_row_step(jax.random.PRNGKey(0), jnp.asarray(logits),
                                     jnp.asarray(hist), jnp.asarray(hist_len),
                                     js.row_sampling(rows), jnp.asarray(done),
                                     jnp.asarray(min_left), 1, **kw)
    tn, tlp, th = ts.engine_row_step(None, torch.from_numpy(logits), torch.from_numpy(hist).long(),
                                     torch.from_numpy(hist_len).long(), ts.row_sampling(_t(rows)),
                                     torch.from_numpy(done), torch.from_numpy(min_left).long(),
                                     1, **kw)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=LP_TOL, rtol=0)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    assert tn[3] == 5 and tlp[3] == 0.0


def test_sampled_rows_follow_the_jax_law():
    """Each sampled row's draws against the exact distribution of the JAX warp chain
    (temperature -> top-k -> top-p) on that row's logits; the greedy row is the argmax."""
    rng = np.random.default_rng(8)
    v, draws = 8, 6000
    base = rng.normal(size=(len(ROWS), v)).astype(np.float32) * 1.5
    jrows = js.row_sampling(ROWS)
    lg = jnp.asarray(base) / jnp.maximum(jrows.temperature, 1e-6)[:, None]
    lg = js.apply_top_p_rows(js.apply_top_k_rows(lg, jrows.top_k), jrows.top_p)
    exact = np.asarray(jax.nn.softmax(lg, axis=-1))
    rep = torch.from_numpy(np.repeat(base, draws, axis=0))
    rows = ts.row_sampling(_t([p for p in ROWS for _ in range(draws)]))
    gen = torch.Generator().manual_seed(0)
    toks = ts.sample_token_rows(rep, rows, gen).numpy().reshape(len(ROWS), draws)
    assert (toks[0] == base[0].argmax()).all()
    for r in range(1, len(ROWS)):
        freq = np.bincount(toks[r], minlength=v) / draws
        assert np.abs(freq - exact[r]).max() <= LAW_TOL, (r, freq, exact[r])
        assert (freq[exact[r] == 0] == 0).all()


@pytest.fixture(scope="module")
def tiny():
    jcfg = JAF3Config.tiny()
    params = jax.tree.map(np.asarray, jaf3.init(jax.random.PRNGKey(4), jcfg))
    pick = lambda cls, obj: cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)})
    cfg = C.AF3Config(encoder=pick(C.WhisperEncoderConfig, jcfg.encoder),
                      lm=pick(C.Qwen2Config, jcfg.lm), audio_token_id=jcfg.audio_token_id)
    model = af3.build(cfg, "cpu", torch.float32)
    model.load_state_dict(params_from_jax(params, cfg))
    return jcfg, params, cfg, model


@pytest.mark.parametrize("n", [1, 2])
def test_generate_no_repeat_ngram_matches_jax(tiny, n):
    """Greedy generate with the n-gram ban, token-exact against the JAX loop (exact
    prompt, as JAX requires), and the ban holds in the output."""
    jcfg, params, cfg, model = tiny
    ids = np.random.default_rng(9).integers(0, 400, size=(2, 13)).astype(np.int32)
    sp = dict(no_repeat_ngram_size=n)
    jt, jlen = jgen.generate(params, jcfg, jnp.asarray(ids), None, max_new_tokens=12,
                             eos_token_id=-1, sampling=js.SamplingParams(**sp),
                             compute_dtype=jnp.float32)
    out = tgen.generate(model, cfg, torch.from_numpy(ids).long(), None, max_new_tokens=12,
                        eos_token_id=-1, sampling=ts.SamplingParams(**sp))
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(out.lengths.numpy(), np.asarray(jlen))
    for row in np.concatenate([ids, out.tokens.numpy()], axis=1):
        grams = [tuple(row[i:i + n]) for i in range(len(row) - n + 1)]
        generated = grams[ids.shape[1] - n + 1:]
        seen = grams[: ids.shape[1] - n + 1]
        for i, gram in enumerate(generated):   # no generated n-gram repeats an earlier one
            assert gram not in seen + generated[:i]
