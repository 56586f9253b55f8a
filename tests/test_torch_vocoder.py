"""The port's vocoders (audio/neural_vocoder.py, audio/vocoder.py, audio/clap_mel.frame_signal)
against JAX's at f32 on the same numpy-seeded inputs and weights crossed through
io/convert.vocoder_params_from_jax (VocoderConfig(channels=64), both layouts).

Tolerances: frames, VocoderMel and the legacy layout's apply and stream within 1e-5; the
harmonic layout's apply, stream and source within 1e-5 on random weights. The harmonic
source follows JAX's jitted arithmetic (XLA's folded constants, its FMA, its cumulative
sums), so it matches to ~6e-8; what stays is the F0 head's conv summing in another order:
one ulp of its output moves f0 by ~6e-5 Hz, which the source integrates over the frames.
The shipped (trained) vocoder amplifies that to ~2e-5 over 64 frames, so its apply is
held at 1e-4. Gradients: the multi-resolution STFT loss's within 1e-4 of max|g|; the
full loss's F0 head within 1e-5 of max|g| and the generator's within 1e-2 of each
tensor's norm (the same source differences, through four upsampling stages); one Adam
step from crossed weights moves the same elements but where a gradient's sign parts.
Griffin-Lim with JAX's first phase injected: 4 rounds within 1e-4 from JAX's magnitude.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_flamingo_tpu.audio import clap_mel as jclap
from audio_flamingo_tpu.audio import neural_vocoder as jnv
from audio_flamingo_tpu.audio.vocoder import GriffinLim as JGriffinLim
from audio_flamingo_tpu_torch.audio import clap_mel
from audio_flamingo_tpu_torch.audio import neural_vocoder as nv
from audio_flamingo_tpu_torch.audio.vocoder import GriffinLim
from audio_flamingo_tpu_torch.io.convert import vocoder_params_from_jax

jax.config.update("jax_default_matmul_precision", "highest")
torch.set_num_threads(2)

JTINY = jnv.VocoderConfig(channels=64)
TINY = nv.VocoderConfig(channels=64)
TOL = 1e-5


def _jparams(harmonic: bool, seed: int = 0):
    return jax.tree.map(np.asarray, jnv.init(jax.random.PRNGKey(seed), JTINY, harmonic=harmonic))


def _port(params, cfg=TINY):
    voc = nv.Vocoder(cfg, harmonic="f0_head" in params)
    voc.load_state_dict(vocoder_params_from_jax(params))
    return voc


@pytest.fixture(scope="module")
def pair():
    return {h: (p, _port(p)) for h in (True, False) for p in (_jparams(h),)}


def _normal(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("n_fft,hop,frames,length", [(400, 160, 24, 4240), (512, 128, 10, 1664),
                                                     (1024, 256, 7, 2000), (256, 64, 3, 100)])
def test_frame_signal_matches_jax(n_fft, hop, frames, length):
    x = _normal((2, length))
    want = np.asarray(jclap.frame_signal(jnp.asarray(x), n_fft, hop, frames))
    got = clap_mel.frame_signal(torch.from_numpy(x), n_fft, hop, frames).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("harmonic", [True, False])
def test_apply_matches_jax(pair, harmonic):
    params, voc = pair[harmonic]
    mel = _normal((2, 24, 80))
    want = np.asarray(jnv.apply(params, JTINY, jnp.asarray(mel)))
    with torch.no_grad():
        got = nv.apply(voc, TINY, torch.from_numpy(mel)).numpy()
    assert got.shape == (2, 24 * 160)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    np.testing.assert_array_equal(got, nv.apply(voc, TINY, torch.from_numpy(mel)).detach().numpy())


def test_apply_with_phase0_matches_jax(pair):
    params, voc = pair[True]
    mel, p0 = _normal((2, 24, 80)), np.array([0.3, 2.0], np.float32)
    want = np.asarray(jnv.apply(params, JTINY, jnp.asarray(mel), phase0=jnp.asarray(p0)))
    with torch.no_grad():
        got = nv.apply(voc, TINY, torch.from_numpy(mel), torch.from_numpy(p0)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_predict_f0_matches_jax(pair):
    params, voc = pair[True]
    mel = _normal((2, 24, 80))
    f0, v = jnv.predict_f0(params, JTINY, jnp.asarray(mel))
    with torch.no_grad():
        f0_t, v_t = nv.predict_f0(voc, TINY, torch.from_numpy(mel))
    np.testing.assert_allclose(f0_t.numpy(), np.asarray(f0), rtol=1e-6, atol=0)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v), atol=1e-6, rtol=0)


@pytest.mark.parametrize("frames", [24, 300, 600])
def test_harmonic_source_matches_jax_past_256_frames(frames):
    """JAX runs the source inside the jitted apply; it is held to that, chunks of 256
    frames and their wrapped totals included."""
    rng = np.random.default_rng(frames)
    f0 = rng.uniform(60, 500, (2, frames)).astype(np.float32)
    voiced = rng.uniform(0, 1, (2, frames)).astype(np.float32)
    p0 = np.array([0.5, 5.0], np.float32)
    src = jax.jit(lambda a, b, c: jnv._harmonic_source(JTINY, a, b, c))
    want = np.asarray(src(f0, voiced, p0))
    got = nv._harmonic_source(TINY, torch.from_numpy(f0), torch.from_numpy(voiced),
                              torch.from_numpy(p0)).numpy()
    assert got.shape == (2, frames * 160)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("n", [5, 16, 17, 40, 256, 300])
def test_cumsum_in_xla_order(n):
    x = np.random.default_rng(n).uniform(0, 6.3, (3, n)).astype(np.float32)
    np.testing.assert_array_equal(nv._cumsum(torch.from_numpy(x)).numpy(),
                                  np.asarray(jnp.cumsum(jnp.asarray(x), axis=1)))


def test_vocoder_mel_matches_jax():
    wav = (0.3 * np.random.default_rng(2).normal(size=(2, 3200))).astype(np.float32)
    want = np.asarray(jnv.VocoderMel(JTINY)(jnp.asarray(wav)))
    got = nv.VocoderMel(TINY, device="cpu")(wav).numpy()
    assert got.shape == (2, 20, 80)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("harmonic", [True, False])
def test_stream_synthesize_uneven_chunks_matches_jax(pair, harmonic):
    params, voc = pair[harmonic]
    mel = _normal((64, 80))
    cuts = [0, 10, 33, 40, 64]
    chunks = [mel[a:b] for a, b in zip(cuts, cuts[1:])]
    want = [np.asarray(c) for c in jnv.stream_synthesize(params, JTINY,
                                                         [jnp.asarray(c) for c in chunks])]
    got = list(nv.stream_synthesize(voc, TINY, chunks))
    assert [g.shape for g in got] == [w.shape for w in want]
    np.testing.assert_allclose(np.concatenate(got), np.concatenate(want), atol=TOL, rtol=0)
    if not harmonic:
        with torch.no_grad():
            full = nv.apply(voc, TINY, torch.from_numpy(mel)[None])[0].numpy()
        np.testing.assert_allclose(np.concatenate(got), full, atol=5e-5, rtol=0)


def test_numpy_corpora_equal_jax():
    for x, y in zip(jnv.synthetic_voice_batch(np.random.default_rng(4), 3, 0.3),
                    nv.synthetic_voice_batch(np.random.default_rng(4), 3, 0.3)):
        np.testing.assert_array_equal(x, y)
    a = jnv.synthetic_speaker_batch(np.random.default_rng(5), [0, 7, 15], 0.4)
    b = nv.synthetic_speaker_batch(np.random.default_rng(5), [0, 7, 15], 0.4)
    np.testing.assert_array_equal(a, b)
    for k, v in jnv.speaker_spec(11).items():
        np.testing.assert_array_equal(nv.speaker_spec(11)[k], v)
    for w in b:
        for x, y in zip(jnv.f0_track(w), nv.f0_track(w)):
            np.testing.assert_array_equal(x, y)
        assert jnv.estimate_f0(w) == nv.estimate_f0(w)


def test_multires_stft_loss_and_grad_match_jax():
    target = jnv.synthetic_speaker_batch(np.random.default_rng(0), [0, 3], 0.2)
    pred = (0.1 * np.random.default_rng(5).normal(size=target.shape)).astype(np.float32)
    lj, gj = jax.value_and_grad(jnv.multires_stft_loss)(jnp.asarray(pred), jnp.asarray(target))
    p = torch.from_numpy(pred).requires_grad_(True)
    lt = nv.multires_stft_loss(p, torch.from_numpy(target))
    lt.backward()
    assert abs(float(lt.detach()) - float(lj)) <= TOL
    gj = np.asarray(gj)
    np.testing.assert_allclose(p.grad.numpy(), gj, atol=1e-4 * np.abs(gj).max(), rtol=0)


def test_loss_and_grads_match_jax(pair):
    """The harmonic layout with F0 targets (the supervised head and the voicing BCE)."""
    params, _ = pair[True]
    voc = _port(params)
    wavs = jnv.synthetic_speaker_batch(np.random.default_rng(0), [0, 3], 0.2)
    mels = np.array(jnv.VocoderMel(JTINY)(jnp.asarray(wavs)))
    tracks = [jnv.f0_track(w) for w in wavs]
    f0t = np.stack([t[0] for t in tracks])
    vt = np.stack([t[1] for t in tracks])
    lj, gj = jax.value_and_grad(jnv.loss)(params, JTINY, jnp.asarray(mels), jnp.asarray(wavs),
                                          jnp.asarray(f0t), jnp.asarray(vt))
    lt = nv.loss(voc, TINY, torch.from_numpy(mels), torch.from_numpy(wavs),
                 torch.from_numpy(f0t), torch.from_numpy(vt))
    lt.backward()
    assert abs(float(lt.detach()) - float(lj)) <= TOL
    want = vocoder_params_from_jax(jax.tree.map(np.asarray, gj))
    for name, g in want.items():
        got = voc.get_parameter(name).grad
        if name.startswith("f0_head"):
            assert float((got - g).abs().max()) <= TOL * float(g.abs().max()), name
        else:
            assert float((got - g).norm()) <= 1e-2 * float(g.norm()), name


def test_one_train_step_matches_jax():
    """One step of JAX's ``train`` (init from PRNGKey(3)) against the port's from the
    crossed initial weights: the same corpus, loss and Adam update. Adam's first step moves
    each element by about lr * sign(g), so an element whose tiny gradient changes sign
    moves the other way (at most 2 lr)."""
    lr = 5e-4
    pj, hj = jnv.train(jax.random.PRNGKey(3), JTINY, steps=1, batch=2, seconds=0.2, lr=lr)
    voc = _port(_jparams(True, seed=3))
    voc, ht = nv.train(TINY, steps=1, batch=2, seconds=0.2, lr=lr, voc=voc)
    assert abs(ht[0] - hj[0]) <= TOL
    want = vocoder_params_from_jax(jax.tree.map(np.asarray, pj))
    off = total = 0
    for name, w in want.items():
        d = (voc.get_parameter(name).detach() - w).abs()
        assert float(d.max()) <= 2 * lr + TOL, name
        off += int((d > TOL).sum())
        total += d.numel()
    assert off <= 1e-3 * total, (off, total)


def test_train_from_a_generator_is_seeded_and_mixes_corpora():
    """``train`` without a vocoder draws one from ``generator``; corpus "mixed" alternates
    the speakers and voice batches. The same seed gives the same weights and losses."""
    runs = [nv.train(TINY, steps=2, batch=2, seconds=0.2, corpus="mixed", device="cpu",
                     generator=torch.Generator().manual_seed(5)) for _ in range(2)]
    (a, ha), (b, hb) = runs
    assert len(ha) == 2 and np.isfinite(ha).all() and ha == hb
    for x, y in zip(a.state_dict().values(), b.state_dict().values()):
        assert torch.equal(x, y)


def test_default_vocoder_trains_without_the_asset(monkeypatch, capsys):
    """Without the shipped asset the first call on a device trains (JAX's fallback), says
    so on stderr, and later calls reuse the result."""
    calls = []

    def fake_train(cfg, *, steps, generator, device):
        calls.append((steps, str(device)))
        return nv.init(TINY, generator=generator, device=device), [1.0]

    monkeypatch.setattr(nv, "ASSET", os.path.join(os.path.dirname(nv.ASSET), "missing.st"))
    monkeypatch.setattr(nv, "train", fake_train)
    monkeypatch.setattr(nv, "_DEFAULT_VOCODERS", {})
    voc = nv.default_vocoder(steps=3, device="cpu")
    assert nv.default_vocoder(steps=3, device="cpu") is voc
    assert calls == [(3, "cpu")]
    assert "training the default neural vocoder (3 steps" in capsys.readouterr().err
    assert not any(p.requires_grad for p in voc.voc.parameters())


@pytest.fixture(scope="module")
def asset():
    from audio_flamingo_tpu.train.checkpoints import import_safetensors

    if not os.path.exists(nv.ASSET):
        pytest.skip("no shipped vocoder asset")
    template = jnv.init(jax.random.PRNGKey(0), jnv.VocoderConfig())
    params = jax.tree.map(np.asarray, import_safetensors(nv.ASSET, template))
    return params, nv.default_vocoder(device="cpu")


def test_default_vocoder_loads_the_asset_as_jax(asset):
    params, voc = asset
    want = vocoder_params_from_jax(params)
    state = voc.voc.state_dict()
    assert set(state) == set(want) and len(want) == 88
    for k, v in want.items():
        assert torch.equal(state[k], v), k
    assert nv.default_vocoder(device="cpu") is voc
    # 64 held-out frames (the evaluation corpus's generator)
    wav, _ = jnv.synthetic_voice_batch(np.random.default_rng(123), 1, 0.64)
    mel = np.asarray(jnv.VocoderMel()(jnp.asarray(wav)))
    assert mel.shape == (1, 64, 80)
    want = np.asarray(jnv.apply(params, jnv.VocoderConfig(), jnp.asarray(mel)))
    got = voc.mel_to_waveform(mel[0])
    np.testing.assert_allclose(got, want[0], atol=1e-4, rtol=0)


def test_evaluation_on_the_asset_matches_jax(asset):
    """The held-out evaluation, on the shipped weights, small: the same corpus, mel MSE and
    envelope correlation within 1e-4 of JAX's, the F0 error within 0.5 Hz."""
    params, voc = asset
    cfg = jnv.VocoderConfig()
    want = jnv.evaluate(params, cfg, n=2, seconds=0.3)
    got = nv.evaluate(voc.voc, voc.cfg, n=2, seconds=0.3)
    assert abs(got["mel_mse"] - want["mel_mse"]) <= 1e-4 * want["mel_mse"], (got, want)
    assert abs(got["f0_mae_hz"] - want["f0_mae_hz"]) <= 0.5, (got, want)
    want = jnv.envelope_correlation(params, cfg, n=2, seconds=0.3, num_speakers=16)
    got = nv.envelope_correlation(voc.voc, voc.cfg, n=2, seconds=0.3, num_speakers=16)
    assert abs(got - want) <= 1e-4, (got, want)


def test_default_vocoder_needs_a_device_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: no device means CUDA")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nv.default_vocoder()


def test_griffin_lim_with_jax_phase_matches_jax():
    """JAX's first phase injected. The rounds from JAX's magnitude: 4 within 1e-4. The
    magnitude itself is an f32 product with the filterbank's pseudo-inverse, whose entries
    cancel: its power is held to 1e-4 of max|power|, and the sqrt of a power near zero is
    steep, so the whole from_phase is held at 1e-3."""
    wav, _ = jnv.synthetic_voice_batch(np.random.default_rng(9), 1, 0.3)
    mel = np.array(jnv.VocoderMel()(jnp.array(wav)))[0]
    jgl = JGriffinLim(n_iter=4)
    want = jgl.mel_to_waveform(jnp.array(mel), seed=0)
    power = np.array(jnp.power(10.0, jnp.array(mel)) @ jgl.mel_pinv)
    mag = np.array(jnp.sqrt(jnp.maximum(jnp.array(power), 0.0)))
    phase = np.array(jax.random.uniform(jax.random.PRNGKey(0), mag.shape, jnp.float32,
                                          -np.pi, np.pi))
    gl = GriffinLim(n_iter=4, device="cpu")
    got = gl.rounds(torch.from_numpy(mag), torch.from_numpy(phase)).numpy()
    assert got.shape == want.shape == (mel.shape[0] * 160,)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    got_power = (torch.pow(10.0, torch.from_numpy(mel)) @ gl.mel_pinv).numpy()
    np.testing.assert_allclose(got_power, power, atol=1e-4 * np.abs(power).max(), rtol=0)
    got = gl.from_phase(torch.from_numpy(mel), torch.from_numpy(phase)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    # the port's own first phase: a torch generator, so another waveform, still finite
    out = gl.mel_to_waveform(torch.from_numpy(mel), seed=0)
    assert out.shape == want.shape and np.isfinite(out).all()
    np.testing.assert_array_equal(out, gl.mel_to_waveform(torch.from_numpy(mel), seed=0))


def test_overlap_add_is_jax_order():
    frames = np.random.default_rng(3).normal(size=(7, 400)).astype(np.float32)
    want = np.zeros(7 * 160 + 400, np.float32)
    for i in range(7):
        want[i * 160: i * 160 + 400] += frames[i]
    from audio_flamingo_tpu_torch.audio.vocoder import overlap_add

    np.testing.assert_array_equal(overlap_add(torch.from_numpy(frames), 160).numpy(), want)


def test_griffin_lim_recovers_tone_frequency():
    """JAX's tone-recovery test (tests/test_tts.py), run on the port."""
    sr = 16_000
    t = np.arange(sr) / sr
    wav = torch.from_numpy((0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32))
    gl = GriffinLim(n_mels=80, n_iter=24, device="cpu")
    padded = torch.nn.functional.pad(wav[None], (200, 200), mode="reflect")
    frames = clap_mel.frame_signal(padded, 400, 160, 100)[0]
    power = (frames @ gl.C) ** 2 + (frames @ gl.S) ** 2
    logmel = torch.log10(torch.clamp(power @ gl.mel, min=1e-10))
    out = gl.mel_to_waveform(logmel)
    assert out.shape == (100 * 160,)
    spec = np.abs(np.fft.rfft(out * np.hanning(len(out))))
    peak_hz = np.argmax(spec) * sr / len(out)
    assert abs(peak_hz - 440) < 15, peak_hz


def test_vocoder_mel_round_trips_through_griffin_lim():
    """JAX's convention test: VocoderMel's log10 mel is the scale GriffinLim inverts."""
    t = np.arange(8000) / 16_000
    wav = (0.4 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    mel = nv.VocoderMel(device="cpu")(wav[None])[0]
    rec = GriffinLim(device="cpu").mel_to_waveform(mel)
    assert abs(nv.estimate_f0(rec) - 220.0) < 12.0
