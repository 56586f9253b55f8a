"""Port's AF-Whisper encoder against the JAX encoder, tiny config, f32, weights through
io/convert.params_from_jax."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from audio_flamingo_tpu.config import AF3Config as JAF3Config
from audio_flamingo_tpu.models import af3 as jaf3
from audio_flamingo_tpu.models import whisper_encoder as jenc
from audio_flamingo_tpu_torch import config as C
from audio_flamingo_tpu_torch.io.convert import params_from_jax
from audio_flamingo_tpu_torch.models import af3, whisper_encoder

jax.config.update("jax_default_matmul_precision", "highest")
torch.set_num_threads(2)


def _port_cfg(j):
    pick = lambda cls, obj: cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)})
    return C.AF3Config(encoder=pick(C.WhisperEncoderConfig, j.encoder),
                       lm=pick(C.Qwen2Config, j.lm), audio_token_id=j.audio_token_id)


@pytest.fixture(scope="module")
def weights():
    jcfg = JAF3Config.tiny()
    params = jax.tree.map(np.asarray, jaf3.init(jax.random.PRNGKey(0), jcfg))
    cfg = _port_cfg(jcfg)
    model = af3.build(cfg, "cpu", torch.float32)
    model.load_state_dict(params_from_jax(params, cfg))
    return jcfg, params, cfg, model


def test_sinusoid_positions_match():
    np.testing.assert_array_equal(whisper_encoder.sinusoid_positions(1500, 64),
                                  jenc.sinusoid_positions(1500, 64))


@pytest.mark.parametrize("use_flash", [False, True])
def test_encoder_matches_jax(weights, use_flash):
    jcfg, params, cfg, model = weights
    rng = np.random.default_rng(0)
    mels = rng.normal(size=(2, 3000, jcfg.encoder.num_mel_bins)).astype(np.float32)
    want = np.asarray(jenc.apply(params["encoder"], jcfg.encoder, mels))
    ecfg = dataclasses.replace(cfg.encoder, use_flash=use_flash)
    with torch.inference_mode():
        got = whisper_encoder.apply(model.encoder, ecfg, torch.from_numpy(mels)).numpy()
    assert got.shape == want.shape == (2, 750, jcfg.encoder.d_model)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_encode_audio_matches_jax(weights):
    jcfg, params, cfg, model = weights
    mels = np.random.default_rng(1).normal(
        size=(1, 3000, jcfg.encoder.num_mel_bins)).astype(np.float32)
    want = np.asarray(jaf3.encode_audio(params, jcfg, mels))
    with torch.inference_mode():
        got = af3.encode_audio(model, cfg, torch.from_numpy(mels)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_encoder_requires_3000_frames(weights):
    _, _, cfg, model = weights
    with pytest.raises(ValueError):
        whisper_encoder.apply(model.encoder, cfg.encoder, torch.zeros(1, 2999, 16))
