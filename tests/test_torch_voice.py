"""The port's voice path (models/tts.py, audio/rvq.py, runtime/voice.py) against JAX's at
f32 on the same numpy-seeded inputs, weights crossed through io/convert
(tts_params_from_jax, rvq_params_from_jax).

Tolerances: TTS values within 1e-5, gradients within 1e-4 (tests/test_tts.py's tiny CFG,
and a speaker + RVQ-head config); RVQ codes equal, decode and quantize within 1e-6 (the
straight-through gradient too), three EMA steps within 1e-5; a session's chunks through
the shipped vocoder within 1e-4 (the trained vocoder's harmonic source, see
tests/test_torch_vocoder.py), its mel through Griffin-Lim exact in shape and finite. The
session takes the port's ``AudioFlamingo.generate(stream=True)`` iterator as its source.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_flamingo_tpu.audio import rvq as jrvq
from audio_flamingo_tpu.models import tts as jtts
from audio_flamingo_tpu.runtime.voice import StreamingTTSSession as JSession
from audio_flamingo_tpu.runtime.voice import speak_stream as jspeak_stream
from audio_flamingo_tpu_torch.audio import rvq
from audio_flamingo_tpu_torch.audio.vocoder import GriffinLim
from audio_flamingo_tpu_torch.io.convert import rvq_params_from_jax, tts_params_from_jax
from audio_flamingo_tpu_torch.models import tts
from audio_flamingo_tpu_torch.runtime.voice import StreamingTTSSession, speak_stream

jax.config.update("jax_default_matmul_precision", "highest")
torch.set_num_threads(2)

TOL, GTOL = 1e-5, 1e-4
SHAPE = dict(d_model=32, ffn_dim=64, chunk_tokens=4, frames_per_chunk=8, state_frames=2)
CFG = dict(vocab_size=128, num_layers=2, num_heads=4, n_mels=16, **SHAPE)
SPK = dict(vocab_size=64, num_layers=1, num_heads=2, n_mels=8, num_speakers=4,
           rvq_quantizers=2, rvq_codebook=16, **SHAPE)
RVQ = dict(dim=8, num_quantizers=2, codebook_size=16)


def _head(kw, seed=0):
    jp = jax.tree.map(np.asarray, jtts.init(jax.random.PRNGKey(seed), jtts.TTSConfig(**kw)))
    cfg = tts.TTSConfig(**kw)
    head = tts.TTSHead(cfg)
    head.load_state_dict(tts_params_from_jax(jp, cfg))
    return jp, jtts.TTSConfig(**kw), head, cfg


@pytest.fixture(scope="module")
def plain():
    return _head(CFG)


@pytest.fixture(scope="module")
def spk():
    return _head(SPK, seed=1)


@pytest.fixture(scope="module")
def codec():
    frames = np.random.default_rng(4).normal(size=(256, 8)).astype(np.float32)
    jp = jax.tree.map(np.asarray, jrvq.init(jax.random.PRNGKey(1), jrvq.RVQConfig(**RVQ),
                                            data=jnp.asarray(frames)))
    c = rvq.RVQ(rvq.RVQConfig(**RVQ))
    c.load_state_dict(rvq_params_from_jax(jp))
    return jp, jrvq.RVQConfig(**RVQ), c, rvq.RVQConfig(**RVQ)


def _inputs(cfg, b=2, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, (b, cfg.chunk_tokens)).astype(np.int32)
    prev = rng.normal(size=(b, cfg.state_frames, cfg.n_mels)).astype(np.float32)
    target = rng.normal(size=(b, cfg.frames_per_chunk, cfg.n_mels)).astype(np.float32)
    return ids, prev, target


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("which", ["plain", "speaker"])
def test_synthesize_chunk_matches_jax(plain, spk, which):
    jp, jcfg, head, cfg = plain if which == "plain" else spk
    ids, prev, _ = _inputs(cfg)
    speaker = None if which == "plain" else np.array([3, 0], np.int32)
    want = np.asarray(jtts.synthesize_chunk(jp, jcfg, jnp.asarray(ids), jnp.asarray(prev),
                                            None if speaker is None else jnp.asarray(speaker)))
    with torch.no_grad():
        got = tts.synthesize_chunk(head, cfg, _t(ids).long(), _t(prev),
                                   None if speaker is None else _t(speaker).long()).numpy()
    assert got.shape == (2, cfg.frames_per_chunk, cfg.n_mels)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_rvq_chunk_logits_matches_jax(spk):
    jp, jcfg, head, cfg = spk
    ids, prev, _ = _inputs(cfg, seed=1)
    want = np.asarray(jtts.rvq_chunk_logits(jp, jcfg, jnp.asarray(ids), jnp.asarray(prev),
                                            jnp.asarray([1, 2])))
    with torch.no_grad():
        got = tts.rvq_chunk_logits(head, cfg, _t(ids).long(), _t(prev),
                                   torch.tensor([1, 2])).numpy()
    assert got.shape == (2, 8, 2, 16)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_synthesize_three_chunks_with_a_partial_tail_matches_jax(plain, spk):
    jp, jcfg, head, cfg = plain
    toks = list(range(3, 13))                      # 10 tokens: 4 + 4 + 2 padded
    want = jtts.synthesize(jp, jcfg, toks)
    got = tts.synthesize(head, cfg, toks)
    assert got.shape == want.shape == (3 * 8, 16)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    jp, jcfg, head, cfg = spk
    want = jtts.synthesize(jp, jcfg, toks, pad_id=5, speaker=jnp.asarray([2]))
    got = tts.synthesize(head, cfg, toks, pad_id=5, speaker=2)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_synthesize_rvq_matches_jax(spk, codec):
    jp, jcfg, head, cfg = spk
    jc, jrcfg, c, rcfg = codec
    toks = list(range(10))
    want = jtts.synthesize_rvq(jp, jcfg, jc, jrcfg, toks, speaker=jnp.asarray([1]))
    got = tts.synthesize_rvq(head, cfg, c, rcfg, toks, speaker=1)
    assert got.shape == want.shape == (3 * 8, 8)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def _grads_close(head, cfg, jgrads):
    want = tts_params_from_jax(jax.tree.map(np.asarray, jgrads), cfg)
    for name, g in want.items():
        got = head.get_parameter(name).grad
        got = torch.zeros_like(g) if got is None else got
        np.testing.assert_allclose(got.numpy(), g.numpy(), atol=GTOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("masked", [False, True])
def test_loss_and_grads_match_jax(spk, masked):
    jp, jcfg, _, cfg = spk
    head = _head(SPK, seed=1)[2]
    ids, prev, target = _inputs(cfg, seed=2)
    speaker = np.array([0, 3], np.int32)
    mask = (np.arange(8)[None] < np.array([[5], [8]])).astype(np.float32) if masked else None
    lj, gj = jax.value_and_grad(jtts.loss)(
        jp, jcfg, jnp.asarray(ids), jnp.asarray(prev), jnp.asarray(target),
        None if mask is None else jnp.asarray(mask), jnp.asarray(speaker))
    lt = tts.loss(head, cfg, _t(ids).long(), _t(prev), _t(target),
                  None if mask is None else _t(mask), _t(speaker).long())
    lt.backward()
    assert abs(float(lt.detach()) - float(lj)) <= TOL
    _grads_close(head, cfg, gj)


def test_rvq_loss_and_grads_match_jax(spk, codec):
    jp, jcfg, _, cfg = spk
    head = _head(SPK, seed=1)[2]
    jc, jrcfg, c, rcfg = codec
    ids, prev, target = _inputs(cfg, seed=3)
    lj, gj = jax.value_and_grad(jtts.rvq_loss)(jp, jcfg, jc, jrcfg, jnp.asarray(ids),
                                               jnp.asarray(prev), jnp.asarray(target),
                                               jnp.asarray([1, 1]))
    lt = tts.rvq_loss(head, cfg, c, rcfg, _t(ids).long(), _t(prev), _t(target),
                      torch.tensor([1, 1]))
    lt.backward()
    assert abs(float(lt.detach()) - float(lj)) <= TOL
    _grads_close(head, cfg, gj)


def test_speaker_ids_need_a_speaker_config(plain):
    _, _, head, cfg = plain
    ids, prev, _ = _inputs(cfg)
    with pytest.raises(ValueError, match="num_speakers"):
        tts.synthesize_chunk(head, cfg, _t(ids).long(), _t(prev), torch.tensor([0, 1]))


def test_init_laws_and_device_rule():
    cfg = tts.TTSConfig(**CFG, num_speakers=2)
    head = tts.init(cfg, torch.Generator().manual_seed(0), device="cpu").requires_grad_(False)
    assert float(head.blocks[0].ln1.weight.min()) == 1.0 and float(head.mel_out.bias.abs().max()) == 0
    assert abs(float(head.embed.std()) - 0.02) < 2e-3
    assert abs(float(head.blocks[1].fc1.weight.std()) - 0.5 / 32 ** 0.5) < 0.01
    same = tts.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(head.state_dict().values(),
                                                  same.state_dict().values()))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tts.init(cfg)


# ------------------------------------------------------------------------------- RVQ

@pytest.mark.parametrize("shape", [(64, 8), (2, 5, 8)])
def test_encode_decode_match_jax(codec, shape):
    jc, jrcfg, c, rcfg = codec
    x = np.random.default_rng(7).normal(size=shape).astype(np.float32)
    want = np.asarray(jrvq.encode(jc, jrcfg, jnp.asarray(x)))
    got = rvq.encode(c, rcfg, _t(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(rvq.decode(c, rcfg, got).numpy(),
                               np.asarray(jrvq.decode(jc, jrcfg, jnp.asarray(want))),
                               atol=1e-6, rtol=0)


def test_quantize_straight_through_matches_jax(codec):
    jc, jrcfg, c, rcfg = codec
    x = np.random.default_rng(8).normal(size=(32, 8)).astype(np.float32)

    def f(x):
        x_q, _, commit = jrvq.quantize(jc, jrcfg, x)
        return jnp.sum(x_q ** 2) + commit

    x_st, codes, commit = jrvq.quantize(jc, jrcfg, jnp.asarray(x))
    gj = np.asarray(jax.grad(f)(jnp.asarray(x)))
    xt = _t(x).requires_grad_(True)
    st, codes_t, commit_t = rvq.quantize(c, rcfg, xt)
    (torch.sum(st ** 2) + commit_t).backward()
    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(codes))
    np.testing.assert_allclose(st.detach().numpy(), np.asarray(x_st), atol=1e-6, rtol=0)
    assert abs(float(commit_t.detach()) - float(commit)) <= 1e-6
    np.testing.assert_allclose(xt.grad.numpy(), gj, atol=1e-6, rtol=0)


def test_three_ema_updates_match_jax(codec):
    jc, jrcfg, _, rcfg = codec
    c = rvq.RVQ(rcfg)
    c.load_state_dict(rvq_params_from_jax(jc))
    jp = jax.tree.map(jnp.asarray, jc)
    rng = np.random.default_rng(9)
    for _ in range(3):
        x = rng.normal(size=(128, 8)).astype(np.float32)
        jp = jrvq.ema_update(jp, jrcfg, jnp.asarray(x))
        assert rvq.ema_update(c, rcfg, _t(x)) is c
    for k, v in rvq_params_from_jax(jax.tree.map(np.asarray, jp)).items():
        np.testing.assert_allclose(getattr(c, k).numpy(), v.numpy(), atol=1e-5, rtol=0, err_msg=k)


def _clustered(rng, n=2048, dim=16, mu=None):
    mu = rng.normal(size=(24, dim)) * 2.0 if mu is None else mu
    return (mu[rng.integers(0, mu.shape[0], n)] + 0.1 * rng.normal(size=(n, dim))).astype(np.float32)


def test_residual_depth_reduces_error_on_the_port():
    """JAX's test_residual_depth_reduces_error, with the port's greedy layer-wise init."""
    x = _t(_clustered(np.random.default_rng(0)))
    errs = []
    for q in (1, 2, 4):
        cfg = rvq.RVQConfig(dim=16, num_quantizers=q, codebook_size=64)
        c = rvq.init(cfg, torch.Generator().manual_seed(0), data=x)
        errs.append(float(torch.mean((rvq.decode(c, cfg, rvq.encode(c, cfg, x)) - x) ** 2)))
    assert errs[0] > errs[1] > errs[2], errs


def test_train_codebooks_improves_on_the_port():
    rng = np.random.default_rng(1)
    mu = rng.normal(size=(24, 16)) * 2.0
    cfg = rvq.RVQConfig(dim=16, num_quantizers=2, codebook_size=32)
    batches = [_clustered(rng, n=1024, mu=mu) for _ in range(30)]
    c, hist = rvq.train_codebooks(cfg, batches, torch.Generator().manual_seed(1), device="cpu")
    assert hist[-1] < 0.5 * hist[0], (hist[0], hist[-1])
    random_c = rvq.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert random_c.codebooks.shape == (2, 32, 16) and float(random_c.ema_count.min()) == 1.0


# ---------------------------------------------------------------------------- session

VOICE = dict(vocab_size=128, num_layers=2, num_heads=4, n_mels=80, **SHAPE)


def test_session_matches_jax_with_the_shipped_vocoder():
    jp, jcfg, head, cfg = _head(VOICE, seed=2)
    toks = [5, 9, 13, 21, 2, 7, 100, 3, 64]           # two full chunks and a flush
    want = list(jspeak_stream(iter(toks), JSession(tts_params=jp, tts_cfg=jcfg)))
    got = list(speak_stream(iter(toks), StreamingTTSSession(tts=head, tts_cfg=cfg,
                                                            device="cpu")))
    assert [g.shape for g in got] == [w.shape for w in want] == [(8 * 160,)] * 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)


def test_session_with_griffin_lim_and_state(plain):
    _, _, head, cfg = plain
    sess = StreamingTTSSession(tts=head, tts_cfg=cfg, device="cpu",
                               vocoder=GriffinLim(n_mels=16, n_iter=2, device="cpu"))
    chunks = list(speak_stream(iter(range(1, 10)), sess))
    assert len(chunks) == 3 and all(np.isfinite(c).all() for c in chunks)
    assert chunks[0].shape == (8 * 160,)
    assert sess.flush() is None and sess._buf == []
    # the state is the last chunk's trailing frames
    want = tts.synthesize(head, cfg, list(range(1, 10)))[-cfg.state_frames:]
    np.testing.assert_allclose(sess._state[0].numpy(), want, atol=1e-6, rtol=0)


def test_session_needs_a_device_without_a_card(plain):
    _, _, head, cfg = plain
    if torch.cuda.is_available():
        pytest.skip("a card is present: no device means CUDA")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingTTSSession(tts=head, tts_cfg=cfg, vocoder=GriffinLim(n_mels=16, device="cpu"))


def test_session_takes_the_api_stream():
    from audio_flamingo_tpu_torch.api import AudioFlamingo
    from audio_flamingo_tpu_torch.config import AF3Config

    model = AudioFlamingo.from_random(AF3Config.tiny(), seed=0, device="cpu")
    cfg = tts.TTSConfig(**{**CFG, "vocab_size": model.cfg.lm.vocab_size})
    head = tts.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    ids = list(model.generate(prompt="Say something.", stream=True, max_new_tokens=9))
    sess = StreamingTTSSession(tts=head, tts_cfg=cfg, device="cpu",
                               vocoder=GriffinLim(n_mels=16, n_iter=1, device="cpu"))
    chunks = list(speak_stream(model.generate(prompt="Say something.", stream=True,
                                              max_new_tokens=9), sess))
    assert len(chunks) == -(-len(ids) // cfg.chunk_tokens)
    want = tts.synthesize(head, cfg, ids)
    np.testing.assert_allclose(sess._state[0].numpy(), want[-cfg.state_frames:], atol=1e-6,
                               rtol=0)
