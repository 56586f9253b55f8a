"""Port's fused log-mel (plain PyTorch version of the CUDA kernel) against the JAX Pallas
kernel in interpret mode and the JAX frontend, at f32; the frontend and processor
switches that route the mel through it."""

from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_flamingo_tpu.audio import mel as jmel
from audio_flamingo_tpu.config import AF3Config as JAF3Config
from audio_flamingo_tpu.config import MelConfig as JMelConfig
from audio_flamingo_tpu.runtime.processor import AF3Processor as JAF3Processor
from audio_flamingo_tpu.runtime.tokenizer import BBPETokenizer as JBBPETokenizer
from audio_flamingo_tpu.runtime.tokenizer import train_bpe as j_train_bpe
from audio_flamingo_tpu_torch.audio import mel as tmel
from audio_flamingo_tpu_torch.config import AF3Config, MelConfig
from audio_flamingo_tpu_torch.ops.kernels import log_mel as tlm
from audio_flamingo_tpu_torch.runtime.processor import AF3Processor
from audio_flamingo_tpu_torch.runtime.tokenizer import BBPETokenizer

jax.config.update("jax_default_matmul_precision", "highest")
torch.set_num_threads(2)


def _jax_fused_log_mel(*args):
    """The Pallas kernel in interpreter mode, as tests/test_stft_mel_pallas.py runs it."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    with mock.patch.object(pl, "pallas_call", patched):
        from audio_flamingo_tpu.ops.pallas.stft_mel import fused_log_mel

        return np.asarray(fused_log_mel(*args))


def _wav(seed, n, tone=True):
    rng = np.random.default_rng(seed)
    if not tone:
        return (rng.normal(size=n) * 0.1).astype(np.float32)
    t = np.arange(n) / 16000.0
    return (0.3 * np.sin(2 * np.pi * 440.0 * t) + 0.05 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("tone", [True, False])
def test_reference_matches_jax_pallas_kernel(tone):
    cfg = MelConfig(num_mel_bins=128)
    jf = jmel.WhisperMelFrontend(JMelConfig(num_mel_bins=128))
    tf = tmel.WhisperMelFrontend(cfg, device="cpu")
    wins = _wav(0, 480_000, tone)[None]
    want = _jax_fused_log_mel(jnp.asarray(wins), jf.dft_cos, jf.dft_sin, jf.mel_weights,
                              cfg.hop_length, 3000)
    got = tlm.log_mel_reference(torch.from_numpy(wins), tf.dft_cos, tf.dft_sin,
                                tf.mel_weights, cfg.hop_length, 3000).numpy()
    assert got.shape == want.shape == (1, 3000, 128)
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-4)
    plain = np.asarray(jf._window_mels(jnp.asarray(wins)))
    np.testing.assert_allclose(got, plain, atol=2e-4, rtol=0)


def test_cpu_tensor_reaches_reference_without_launch():
    fe = tmel.WhisperMelFrontend(MelConfig(num_mel_bins=16), device="cpu")
    wins = torch.from_numpy(_wav(1, 2 * 480_000).reshape(2, 480_000))
    args = (wins, fe.dft_cos, fe.dft_sin, fe.mel_weights, 160, 3000)
    tlm.LAUNCHES.reset()
    out = tlm.fused_log_mel(*args)
    assert torch.equal(out, tlm.log_mel_reference(*args))
    assert tlm.LAUNCHES.count == 0 and not tlm.LAUNCHES.shapes


@pytest.mark.parametrize("bad", ["dtype", "mismatch", "short", "rank"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    fe = tmel.WhisperMelFrontend(MelConfig(num_mel_bins=16), device="cpu")
    wins, c, s, w = torch.zeros(1, 480_000), fe.dft_cos, fe.dft_sin, fe.mel_weights
    if bad == "dtype":
        wins = wins.double()
    elif bad == "mismatch":
        w = w[:100]
    elif bad == "short":
        wins = wins[:, :150]
    elif bad == "rank":
        wins = wins[0]
    with pytest.raises((ValueError, TypeError)):
        tlm.fused_log_mel(wins, c, s, w, 160, 3000)


def test_frontend_use_pallas_equals_plain_on_cpu():
    wav = _wav(2, 2 * 480_000)
    plain = tmel.WhisperMelFrontend(MelConfig(num_mel_bins=128), device="cpu")
    fused = tmel.WhisperMelFrontend(MelConfig(num_mel_bins=128), use_pallas=True, device="cpu")
    assert fused.use_pallas and not plain.use_pallas
    assert torch.equal(fused(wav[None]), plain(wav[None]))


@pytest.mark.parametrize("use_buckets", [False, True])
def test_processor_with_injected_frontend_matches_jax(use_buckets):
    """A 65 s clip is 3 windows, which the buckets round up to 4."""
    vocab, merges = j_train_bpe(["describe the sound of music and speech"], 400)
    jcfg, cfg = JAF3Config.tiny(), AF3Config.tiny()
    jp = JAF3Processor(tokenizer=JBBPETokenizer(vocab, merges), cfg=jcfg,
                       frontend=jmel.WhisperMelFrontend(JMelConfig(num_mel_bins=16)),
                       use_buckets=use_buckets)
    tp = AF3Processor(tokenizer=BBPETokenizer(vocab, merges), cfg=cfg,
                      frontend=tmel.WhisperMelFrontend(MelConfig(num_mel_bins=16),
                                                       use_pallas=True, device="cpu"),
                      use_buckets=use_buckets)
    assert tp.device == torch.device("cpu")
    wav = _wav(3, 65 * 16000)
    msgs = [{"role": "user", "content": "<sound>What is this?"}]
    jb, tb = jp(messages=msgs, audios=[wav]), tp(messages=msgs, audios=[wav])
    assert tb["mels"].shape[1] == (4 if use_buckets else 3)
    np.testing.assert_array_equal(tb["ids"], jb["ids"])
    np.testing.assert_allclose(tb["mels"].numpy(), np.asarray(jb["mels"]), atol=2e-4, rtol=0)


def test_processor_refuses_frontend_and_device_together():
    tok = BBPETokenizer(*j_train_bpe(["describe the sound"], 300))
    fe = tmel.WhisperMelFrontend(MelConfig(num_mel_bins=16), device="cpu")
    with pytest.raises(ValueError, match="not both"):
        AF3Processor(tokenizer=tok, cfg=AF3Config.tiny(), frontend=fe, device="cpu")
