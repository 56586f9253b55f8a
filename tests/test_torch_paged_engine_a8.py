"""The port's PagedEngine on an int8 LM under ``a8_prefill`` against the JAX PagedEngine
at f32, on the same JAX-quantized weights: every multi-token prefill (whole, chunked, or
the suffix after a prefix-cache hit) runs the w8a8 layer forward in both packages and
the decode stays w8a16 (K4's route in the port). Greedy outputs token for token with f32
and int8 pools; the a8 prefill logits within 1e-5 of max|logit| of JAX's, as
tests/test_torch_quant_a8.py holds the a8 LM."""

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
from audio_flamingo_tpu.ops import quant as jquant
from audio_flamingo_tpu.ops.sampling import SamplingParams as JSamplingParams
from audio_flamingo_tpu.runtime import generate as jgen
from audio_flamingo_tpu.runtime.engine import Request as JRequest
from audio_flamingo_tpu.runtime.paged_engine import PagedEngine as JPagedEngine
from audio_flamingo_tpu_torch import config as C
from audio_flamingo_tpu_torch.api import AudioFlamingo
from audio_flamingo_tpu_torch.io.convert import params_from_jax
from audio_flamingo_tpu_torch.models import qwen2
from audio_flamingo_tpu_torch.ops.kernels import w8a16_matmul as k4
from audio_flamingo_tpu_torch.ops.sampling import SamplingParams
from audio_flamingo_tpu_torch.runtime import generate as tgen
from audio_flamingo_tpu_torch.runtime.engine import Request
from audio_flamingo_tpu_torch.runtime.paged_engine import PagedEngine
from audio_flamingo_tpu_torch.runtime.tokenizer import BBPETokenizer, train_bpe

jax.config.update("jax_default_matmul_precision", "highest")
torch.set_num_threads(2)

EOS = 127
CFG = JAF3Config(
    encoder=JEncoderConfig(num_mel_bins=16, d_model=32, num_layers=1, num_heads=4, ffn_dim=64,
                           max_source_positions=12),
    lm=JQwen2Config(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2,
                    num_heads=4, num_kv_heads=2, tie_word_embeddings=False, a8_prefill=True),
    audio_token_id=120)


def _port_cfg(j):
    pick = lambda cls, obj: cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)})
    return C.AF3Config(encoder=pick(C.WhisperEncoderConfig, j.encoder),
                       lm=pick(C.Qwen2Config, j.lm), audio_token_id=j.audio_token_id)


@pytest.fixture(scope="module")
def models():
    params = jaf3.init(jax.random.PRNGKey(6), CFG)
    params["lm"] = jquant.quantize_lm_params(params["lm"])      # eagerly: exact codes
    cfg = _port_cfg(CFG)
    tok = BBPETokenizer(*train_bpe(["describe the sound"], 100))
    tm = AudioFlamingo.from_state_dict(cfg, params_from_jax(jax.tree.map(np.asarray, params),
                                                            cfg), tok, device="cpu")
    assert isinstance(tm.model.lm, qwen2.QuantQwen2) and tm.cfg.lm.a8_prefill
    return params, cfg, tm.model


def _engines(models, **kw):
    params, cfg, model = models
    je = JPagedEngine(params=params, cfg=CFG, eos_token_id=EOS, compute_dtype=jnp.float32,
                      sampling=JSamplingParams(greedy=True),
                      **{k: jnp.int8 if v is torch.int8 else v for k, v in kw.items()})
    te = PagedEngine(model=model, cfg=cfg, eos_token_id=EOS, device="cpu",
                     sampling=SamplingParams(greedy=True), **kw)
    return je, te


def _serve(je, te, specs):
    for eng, cls in ((je, JRequest), (te, Request)):
        for rid, ids, n in specs:
            eng.submit(cls(request_id=rid, ids=ids.copy(), max_new_tokens=n))
    return je.run_until_done(), te.run_until_done()


def _run_both(models, specs, **kw):
    je, te = _engines(models, **kw)
    want, got = _serve(je, te, specs)
    return want, te, got


def _specs(seed, lengths, n=8):
    rng = np.random.default_rng(seed)
    return [(f"p{i}", rng.integers(0, 120, (1, t)).astype(np.int32), n)
            for i, t in enumerate(lengths)]


def test_a8_prefill_logits_match_jax(models):
    params, cfg, model = models
    ids = np.random.default_rng(2).integers(0, 120, (1, 21)).astype(np.int32)
    _, want = jgen.prefill(params, CFG, jnp.asarray(ids), None, 32, jnp.float32)
    _, got = tgen.prefill(model, cfg, torch.from_numpy(ids).long(), None, 32)
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("kv_dtype", [None, torch.int8])
def test_a8_engine_matches_jax(models, monkeypatch, kv_dtype):
    a8_calls, k4_rows = [], []
    real_act, real_k4 = qwen2.quantize_act, k4.w8a16_matmul
    monkeypatch.setattr(qwen2, "quantize_act", lambda x: a8_calls.append(x.shape[-2])
                        or real_act(x))
    monkeypatch.setattr(k4, "w8a16_matmul", lambda x, *a, **kw: k4_rows.append(x.shape[0])
                        or real_k4(x, *a, **kw))
    specs = _specs(11, (6, 13, 30))
    want, te, got = _run_both(models, specs, num_rows=2, num_blocks=16, block_size=8,
                              max_blocks_per_seq=6, chunk=4, kv_dtype=kv_dtype)
    assert got == want and set(got) == {"p0", "p1", "p2"}
    assert a8_calls and min(a8_calls) > 1          # the a8 forward ran on the prefills only
    assert k4_rows and max(k4_rows) <= 2           # decode rows (and heads) on K4's route
    assert len(te.allocator.free) == 15


def test_a8_chunked_and_prefix_prefills_match_jax(models):
    """Chunked prefill of a 40-token prompt and a prefix-cache hit whose suffix prefill
    runs a8 over the shared pages."""
    rng = np.random.default_rng(12)
    shared = rng.integers(0, 120, (1, 24)).astype(np.int32)
    specs = [("a", np.concatenate([shared, rng.integers(0, 120, (1, 16)).astype(np.int32)], 1), 6),
             ("b", np.concatenate([shared, rng.integers(0, 120, (1, 5)).astype(np.int32)], 1), 6)]
    geometry = dict(num_rows=2, num_blocks=24, block_size=8, max_blocks_per_seq=8, chunk=4)
    want, te, got = _run_both(models, specs, prefill_chunk=16, **geometry)
    assert got == want
    je, te = _engines(models, prefix_cache=True, **geometry)
    for spec in specs:     # the second request arrives after the first left its pages
        want, got = _serve(je, te, [spec])
        assert got == want
    assert te.store.hits == je.store.hits > 0
