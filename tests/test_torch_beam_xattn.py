"""The port's AF1/AF2 beam search (runtime/beam.generate_beam_xattn) against JAX's at f32
on the same numpy-seeded weights: sequences equal and scores within 1e-4 on AF2 (Qwen2)
and AF1 (OPT), with HF's options (length penalty, early stopping, the EOS floor, the
n-gram ban, several returned sequences); K = 1 equal to greedy generate; the best beam's
score equal to its teacher-forced log-probability; and the xattn beam lane on both AF1/AF2
engines (FlamingoEngine, PagedFlamingoEngine) beside a normal request, its result equal to
JAX's lane and to generate_beam_xattn on the same bucket-padded prompt, sampled beams
reaching the lane. The tiny models are
made lively (tests/test_torch_flamingo.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_flamingo_tpu.models import flamingo as jflamingo
from audio_flamingo_tpu.ops.sampling import SamplingParams as JSamplingParams
from audio_flamingo_tpu.runtime import beam as jbeam
from audio_flamingo_tpu.runtime import beam_lane as jbeam_lane
from audio_flamingo_tpu.runtime import flamingo_engine as jfe
from audio_flamingo_tpu.runtime import paged_flamingo_engine as jpfe
from audio_flamingo_tpu_torch.models import flamingo
from audio_flamingo_tpu_torch.runtime import beam, beam_lane
from audio_flamingo_tpu_torch.runtime import flamingo_engine as fe
from audio_flamingo_tpu_torch.runtime import paged_flamingo_engine as pfe
from test_torch_flamingo import _ids, _t, _wins, models

jax.config.update("jax_default_matmul_precision", "highest")
torch.set_num_threads(2)

TOL = 1e-4   # f32 beam scores
EOS = 3


def _both(layout: str, ids, wins, **kw):
    """(JAX sequences, scores), (port sequences, scores) as numpy."""
    jcfg, params, cfg, model = models(layout)
    js, jsc = jbeam.generate_beam_xattn(params, jcfg, jnp.asarray(ids), jnp.asarray(wins),
                                        compute_dtype=jnp.float32, **kw)
    ps, psc = beam.generate_beam_xattn(model, cfg, _t(ids).long(), _t(wins), **kw)
    return (np.asarray(js), np.asarray(jsc)), (ps.numpy(), psc.numpy())


@pytest.mark.parametrize("layout,kw", [
    ("float", dict(num_beams=3, num_return_sequences=2, length_penalty=1.2)),
    ("opt", dict(num_beams=3, num_return_sequences=3)),
    ("float", dict(num_beams=4, early_stopping=True, min_new_tokens=3)),
    ("opt", dict(num_beams=2, no_repeat_ngram_size=2, early_stopping="never")),
], ids=["af2-lp", "af1-all", "af2-early-floor", "af1-ngram-never"])
def test_generate_beam_xattn_matches_jax(layout, kw):
    vocab = models(layout)[2].lm.vocab_size
    ids, wins = _ids(2, 7, vocab, seed=20), _wins(2, 2, 3, 16, seed=21)
    (js, jsc), (ps, psc) = _both(layout, ids, wins, max_new_tokens=8, eos_token_id=EOS, **kw)
    np.testing.assert_array_equal(ps, js)
    np.testing.assert_allclose(psc, jsc, atol=TOL, rtol=0)
    assert len(set(js[:, 0].ravel().tolist())) > 2, "constant beams test little"


def test_beam_xattn_beam1_matches_greedy():
    """K = 1 is greedy generate (the port's and JAX's); at K = 4 the best beam's score is
    its teacher-forced log-probability over its length."""
    jcfg, params, cfg, model = models("float")
    ids, wins = _ids(1, 6, 96, seed=22), _wins(1, 1, 4, 16, seed=23)
    greedy = flamingo.generate(model, cfg, _t(ids).long(), _t(wins), max_new_tokens=8,
                               eos_token_id=-2).tokens[0].tolist()
    (js, _), (ps, _) = _both("float", ids, wins, num_beams=1, max_new_tokens=8,
                             eos_token_id=-2)
    assert ps[0, 0].tolist() == greedy == js[0, 0].tolist()
    assert len(set(greedy)) > 1
    seqs, scores = beam.generate_beam_xattn(model, cfg, _t(ids).long(), _t(wins), num_beams=4,
                                            max_new_tokens=6, eos_token_id=-2)
    best = seqs[0, 0]
    lg = flamingo.logits(model, cfg, torch.cat([_t(ids).long(), best[None]], 1), _t(wins))
    lp = torch.log_softmax(lg[0].float(), dim=-1)
    want = sum(float(lp[ids.shape[1] - 1 + i, tok]) for i, tok in enumerate(best.tolist()))
    np.testing.assert_allclose(float(scores[0, 0]), want / len(best), atol=2e-4, rtol=2e-4)


def _serve(engine_kind: str, layout: str, do_sample: bool = False):
    """A normal request and a beam request on JAX's engine and the port's (slot or paged):
    -> (JAX normal ids, port normal ids, JAX beam, port beam, port engine, inputs)."""
    jcfg, params, cfg, model = models(layout)
    vocab = cfg.lm.vocab_size
    beam_ids, norm_ids = _ids(1, 6, vocab, seed=24), _ids(1, 5, vocab, seed=25)
    wins = _wins(1, 1, 3, 16, seed=26)      # padded by the engines to 1 x 4 windows
    common = dict(eos_token_id=EOS, n_media=1, windows_per_media=4, chunk=4)
    if engine_kind == "slot":
        common.update(num_slots=2, capacity=256)
        jeng = jfe.FlamingoEngine(params=params, cfg=jcfg, compute_dtype=jnp.float32,
                                  sampling=JSamplingParams(greedy=True), **common)
        peng = fe.FlamingoEngine(model=model, cfg=cfg, device="cpu", **common)
    else:
        common.update(num_rows=2, num_blocks=32, block_size=16, max_blocks_per_seq=16)
        jeng = jpfe.PagedFlamingoEngine(params=params, cfg=jcfg, compute_dtype=jnp.float32,
                                        sampling=JSamplingParams(greedy=True), **common)
        peng = pfe.PagedFlamingoEngine(model=model, cfg=cfg, device="cpu", **common)
    out = []
    for eng, req_cls, beam_cls in ((jeng, jfe.FlamingoRequest, jbeam_lane.BeamRequest),
                                   (peng, fe.FlamingoRequest, beam_lane.BeamRequest)):
        eng.submit(req_cls(request_id="n0", ids=norm_ids, window_embeds=wins, max_new_tokens=6))
        eng.submit_beam(beam_cls(request_id="beam", ids=beam_ids, window_embeds=wins,
                                 num_beams=3, max_new_tokens=6, num_return_sequences=2,
                                 do_sample=do_sample, temperature=3.0, seed=5))
        out.append((eng.run_until_done()["n0"], eng.finished_beams["beam"]))
    return out[0][0], out[1][0], out[0][1], out[1][1], peng, (beam_ids, wins)


def _bucketed(ids: np.ndarray) -> torch.Tensor:
    """The lane's prompt: right-padded with EOS to its token bucket."""
    pad = np.full((1, 128 - ids.shape[1]), EOS, np.int32)
    return _t(np.concatenate([ids, pad], axis=1)).long()


@pytest.mark.parametrize("engine_kind,layout", [("slot", "float"), ("paged", "float"),
                                                ("paged", "opt")])
def test_flamingo_engines_serve_beam(engine_kind, layout):
    """The lane's (sequences, scores) equal JAX's lane's and generate_beam_xattn's on the
    bucket-padded prompt and the engine's padded windows; the normal request beside it
    keeps JAX's ids."""
    j_norm, p_norm, (j_seqs, j_sc), (p_seqs, p_sc), eng, (ids, wins) = _serve(engine_kind,
                                                                              layout)
    assert p_norm == j_norm and len(set(p_norm)) > 1
    np.testing.assert_array_equal(p_seqs, np.asarray(j_seqs))
    np.testing.assert_allclose(p_sc, np.asarray(j_sc), atol=TOL, rtol=0)
    _, cfg, model = models(layout)[1:]
    want, want_sc = beam.generate_beam_xattn(model, cfg, _bucketed(ids), eng._pad_windows(wins),
                                             num_beams=3, max_new_tokens=6, eos_token_id=EOS,
                                             num_return_sequences=2, prompt_len=ids.shape[1])
    np.testing.assert_array_equal(p_seqs, want[0].numpy())
    np.testing.assert_array_equal(p_sc, want_sc[0].numpy())
    assert not eng.beam_lane.busy and isinstance(eng.beam_lane.active, list)


def test_flamingo_lane_do_sample_plumbed():
    """do_sample and temperature reach the xattn lane: its beams are generate_beam_xattn's
    sampled from the request's seed, and differ from the greedy lane's."""
    *_, (p_seqs, p_sc), eng, (ids, wins) = _serve("slot", "float", do_sample=True)
    _, cfg, model = models("float")[1:]
    want, want_sc = beam.generate_beam_xattn(
        model, cfg, _bucketed(ids), eng._pad_windows(wins), num_beams=3, max_new_tokens=6,
        eos_token_id=EOS, num_return_sequences=2, do_sample=True, temperature=3.0,
        generator=torch.Generator().manual_seed(5), prompt_len=ids.shape[1])
    np.testing.assert_array_equal(p_seqs, want[0].numpy())
    np.testing.assert_array_equal(p_sc, want_sc[0].numpy())
    greedy = _serve("slot", "float")[3][0]
    assert not np.array_equal(p_seqs, greedy)
