"""Port's log-mel frontend against the JAX frontend (f32)."""

import numpy as np
import pytest
import torch

import jax

from audio_flamingo_tpu.audio import mel as jmel
from audio_flamingo_tpu.config import MelConfig as JMelConfig
from audio_flamingo_tpu_torch.audio import mel as tmel
from audio_flamingo_tpu_torch.config import MelConfig

jax.config.update("jax_default_matmul_precision", "highest")
torch.set_num_threads(2)


def test_filterbank_and_dft_basis_match():
    a = tmel.mel_filter_bank(201, 128, 0.0, 8000.0, 16000)
    b = jmel.mel_filter_bank(201, 128, 0.0, 8000.0, 16000)
    np.testing.assert_allclose(a, b, atol=1e-12, rtol=0)
    for x, y in zip(tmel._windowed_dft_basis(400), jmel._windowed_dft_basis(400)):
        np.testing.assert_allclose(x, y, atol=1e-12, rtol=0)


@pytest.mark.parametrize("n_mels,seconds", [(128, 2.5), (16, 31.0)])
def test_log_mel_matches_jax(n_mels, seconds):
    rng = np.random.default_rng(0)
    t = np.arange(int(seconds * 16000)) / 16000.0
    wav = (0.3 * np.sin(2 * np.pi * 440.0 * t)
           + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
    jf = jmel.WhisperMelFrontend(JMelConfig(num_mel_bins=n_mels))
    tf = tmel.WhisperMelFrontend(MelConfig(num_mel_bins=n_mels), device="cpu")
    padded = tf.pad_or_trim(wav)
    np.testing.assert_array_equal(padded, jf.pad_or_trim(wav))
    want = np.asarray(jf(padded[None]))
    got = tf(padded[None]).numpy()
    assert got.shape == want.shape == (1, 3000 * len(padded) // 480000, n_mels)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


def test_rejects_partial_window():
    with pytest.raises(ValueError):
        tmel.WhisperMelFrontend(MelConfig(num_mel_bins=16), device="cpu")(np.zeros((1, 1000), np.float32))
