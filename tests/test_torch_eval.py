"""The port's eval metrics and harness (eval/metrics.py, eval/harness.py) against the
JAX package's: every metric equal to JAX's exactly on seeded text, ``_score`` on
hand-made pairs, and ``evaluate`` / ``evaluate_batched`` on a tiny AF3 (JAX's weights
crossed through io/convert, the LM's linears x 3 so that greedy ids vary) giving JAX's
answers and scores, the slot engine's answers equal to the sequential ones."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_flamingo_tpu.api import AudioFlamingo as JAudioFlamingo
from audio_flamingo_tpu.config import AF3Config as JAF3Config
from audio_flamingo_tpu.eval import harness as jharness
from audio_flamingo_tpu.eval import metrics as jmetrics
from audio_flamingo_tpu.runtime.tokenizer import BBPETokenizer as JTokenizer
from audio_flamingo_tpu.runtime.tokenizer import train_bpe
from audio_flamingo_tpu_torch import config as C
from audio_flamingo_tpu_torch.api import AudioFlamingo
from audio_flamingo_tpu_torch.eval import harness
from audio_flamingo_tpu_torch.eval import metrics
from audio_flamingo_tpu_torch.io.convert import params_from_jax
from audio_flamingo_tpu_torch.runtime.tokenizer import BBPETokenizer

jax.config.update("jax_default_matmul_precision", "highest")
torch.set_num_threads(2)

WORDS = ["the", "a", "dog", "barks", "Dog,", "piano", "music", "(B)", "A", "c", "plays",
         "soft", "loud!", "<think>why</think>", "it's", "yard.", "E", "birds", "rain", ""]
CORPUS = ["describe the sound of music and speech", "a dog barks in the yard",
          "hello world answer A B"]
NEW_TOKENS = 6


def _texts(rng, n):
    return [" ".join(rng.choice(WORDS, size=int(rng.integers(0, 9)))) for _ in range(n)]


@pytest.mark.parametrize("name", ["normalize_text", "wer", "corpus_wer", "extract_choice",
                                  "mcq_accuracy", "containment_accuracy", "strip_think",
                                  "cider_d"])
def test_metric_equals_jax(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    refs, hyps = _texts(rng, 40), _texts(rng, 40)
    hyps[::5] = refs[::5]                 # some exact hits
    letters = [str(x) for x in rng.choice(list("ABCDE"), size=40)]
    ours, theirs = getattr(metrics, name), getattr(jmetrics, name)
    if name in ("normalize_text", "extract_choice", "strip_think"):
        cases = [(t,) for t in refs + hyps]
    elif name == "wer":
        cases = [(r, h) for r, h in zip(refs, hyps)] + [(r, h, False) for r, h in zip(refs, hyps)]
    elif name == "mcq_accuracy":
        cases = [(letters, hyps), (letters, [f"answer ({x})" for x in letters])]
    elif name == "cider_d":
        multi = [[r, h] for r, h in zip(refs, _texts(rng, 40))]
        cases = [([[r] for r in refs], hyps), (multi, hyps), (multi, refs), ([[r] for r in refs],
                                                                            refs, 3, 4.0)]
    else:
        cases = [(refs, hyps), (refs[:1], refs[:1]), ([], [])]
    for args in cases:
        assert ours(*args) == theirs(*args), args


def test_score_equals_jax():
    by_task = {
        "asr": [("the dog barks", "<think>hm</think>the dog barked"), (["a b c", "x"], "a b c")],
        "mcq": [("B", "I pick (B)"), ("A", "C")],
        "caption": [(["a dog barks", "dog barking loud"], "a dog barks"), ("piano", "rain")],
        "qa": [("Dog", "a dog, it is"), (["yard"], "garden")],
    }
    got, want = harness._score(by_task), jharness._score(by_task)
    assert got == want
    assert 0 < got["asr_wer"] < 1 and got["mcq_acc"] == 0.5 and got["qa_acc"] == 0.5
    assert got["caption_cider_d"] > 0


@pytest.fixture(scope="module")
def models():
    tok = JTokenizer(*train_bpe(CORPUS, 400), use_native=False)
    jcfg = JAF3Config.tiny()
    jcfg = dataclasses.replace(jcfg, lm=dataclasses.replace(jcfg.lm, vocab_size=len(tok.vocab)))
    jm = JAudioFlamingo.from_random(cfg=jcfg, tokenizer=tok, compute_dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jm.params)
    layers = params["lm"]["layers"]
    for name in ("q", "k", "v", "o"):
        layers[name]["w"] = layers[name]["w"] * 3.0
    layers["mlp"] = {k: v * 3.0 for k, v in layers["mlp"].items()}
    jm = dataclasses.replace(jm, params=jax.tree.map(jnp.asarray, params))
    pick = lambda cls, obj: cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)})
    cfg = C.AF3Config(encoder=pick(C.WhisperEncoderConfig, jm.cfg.encoder),
                      lm=pick(C.Qwen2Config, jm.cfg.lm), audio_token_id=jm.cfg.audio_token_id)
    tm = AudioFlamingo.from_state_dict(cfg, params_from_jax(params, cfg),
                                       BBPETokenizer(tok.vocab, tok.merges),
                                       compute_dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(0)
    t = np.arange(16000) / 16000

    def clip(hz):
        return (0.2 * np.sin(2 * np.pi * hz * t) + 0.05 * rng.standard_normal(t.size)).astype(
            np.float32)

    spec = [(clip(220), "Transcribe.", "hello world", "asr"),
            (clip(440), "Choose A or B.", "A", "mcq"),
            (None, "What barks?", "dog", "qa"),
            (clip(660), "Describe.", ["a dog barks", "music plays"], "caption")]
    jex = [jharness.EvalExample(audio=a, prompt=p, target=y, task=k) for a, p, y, k in spec]
    tex = [harness.EvalExample(audio=a, prompt=p, target=y, task=k) for a, p, y, k in spec]
    return jm, tm, jex, tex


def _answers(res):
    return [e["answer"] for e in res.per_example]


def test_evaluate_matches_jax(models):
    jm, tm, jex, tex = models
    want = jharness.evaluate(jm, jex, max_new_tokens=NEW_TOKENS)
    got = harness.evaluate(tm, tex, max_new_tokens=NEW_TOKENS)
    assert _answers(got) == _answers(want)
    assert sum(len(a) for a in _answers(got)) > 0          # the answers are not empty
    assert got.task_scores == want.task_scores == harness._score(
        {e["task"]: [(e["target"], e["answer"])] for e in got.per_example})
    assert got.serving["n_examples"] == 4 and got.serving["p50_total_s"] > 0


def test_evaluate_batched_matches_jax_and_sequential(models):
    jm, tm, jex, tex = models
    kw = dict(max_new_tokens=NEW_TOKENS, num_slots=3, capacity=2048, chunk=4)
    want = jharness.evaluate_batched(jm, jex, **kw)
    got = harness.evaluate_batched(tm, tex, **kw)
    assert _answers(got) == _answers(want)
    assert got.task_scores == want.task_scores
    seq = harness.evaluate(tm, tex, max_new_tokens=NEW_TOKENS)
    assert _answers(got) == _answers(seq) and got.task_scores == seq.task_scores
    assert got.serving["n_examples"] == 4 and got.serving["examples_per_s"] > 0
    think = harness.evaluate_batched(tm, tex[:2], think=True, **kw)
    assert _answers(think) == _answers(jharness.evaluate_batched(jm, jex[:2], think=True, **kw))


def test_generate_past_the_last_token_bucket_runs_unpadded(models, monkeypatch):
    """A prompt longer than the last token bucket (15 minutes of Music Flamingo against
    16,384) runs at its own length: with the buckets cut to (64,), a clip's ~780-token
    prompt answers as the loop does on the exact ids (JAX's generate asks for a negative
    pad there)."""
    from audio_flamingo_tpu_torch import api
    from audio_flamingo_tpu_torch.config import bucket_tokens
    from audio_flamingo_tpu_torch.runtime import generate as tgen

    _, tm, _, tex = models
    monkeypatch.setattr(api, "bucket_tokens", lambda n: bucket_tokens(n, (64,)))
    answer = tm.generate(sound=tex[0].audio, prompt=tex[0].prompt, max_new_tokens=NEW_TOKENS)
    out = tm.last_output
    batch = tm.processor(messages=[{"role": "user", "content": f"<sound>{tex[0].prompt}"}],
                         audios=[tex[0].audio])
    assert batch["ids"].shape[1] > 64
    ref = tgen.generate(tm.model, tm.cfg, torch.from_numpy(batch["ids"]).long(), batch["mels"],
                        max_new_tokens=NEW_TOKENS, eos_token_id=tm.eos_token_id)
    assert out.tokens.tolist() == ref.tokens.tolist()
    assert answer == tm.processor.tokenizer.decode(
        ref.tokens[0, : int(ref.lengths[0])].tolist(), skip_special=True)
