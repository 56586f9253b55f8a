"""Port's CLAP mel frontend and HTSAT tower against the JAX package at f32: the host
constants (filterbanks, DFT basis, bilinear and bicubic matrices, window masks, relative
position indices), the dB mel for fusion and rand_trunc on short and long clips (the same
fusion crops from the same seed), the device window split and the AF2 processor's windows
(f32 and int16 PCM), and the tower's pooled / embeds with and without fusion."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_flamingo_tpu.audio import clap_mel as jclap_mel
from audio_flamingo_tpu.audio import mel as jmel
from audio_flamingo_tpu.config import AF2Config as JAF2Config
from audio_flamingo_tpu.config import ClapAudioConfig as JClapAudioConfig
from audio_flamingo_tpu.config import ClapMelConfig as JClapMelConfig
from audio_flamingo_tpu.models import clap as jclap
from audio_flamingo_tpu.runtime.clap_processor import AF2Processor as JAF2Processor
from audio_flamingo_tpu_torch import config as C
from audio_flamingo_tpu_torch.audio import clap_mel
from audio_flamingo_tpu_torch.audio import mel as tmel
from audio_flamingo_tpu_torch.io.convert import clap_params_from_jax, clap_params_to_jax
from audio_flamingo_tpu_torch.models import clap
from audio_flamingo_tpu_torch.runtime.clap_processor import AF2Processor, bucket_clap_windows
from audio_flamingo_tpu_torch.runtime.tokenizer import BBPETokenizer, train_bpe

jax.config.update("jax_default_matmul_precision", "highest")
torch.set_num_threads(2)

DB_TOL = 1e-3      # dB mel, f32
TOWER_TOL = 1e-4   # pooled / embeds, f32
SR = 48_000


def _pick(cls, obj):
    return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)})


def _clip(seconds: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * seconds)) / SR
    return (0.3 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal(t.size)).astype(np.float32)


# ------------------------------------------------------------------------- host constants

@pytest.mark.parametrize("norm,scale", [(None, "htk"), ("slaney", "slaney")])
def test_filterbanks_match_jax(norm, scale):
    cfg = C.ClapMelConfig()
    args = (cfg.n_fft // 2 + 1, cfg.num_mel_bins, cfg.fmin, cfg.fmax, cfg.sampling_rate)
    got = tmel.mel_filter_bank(*args, norm=norm, mel_scale=scale)
    want = jmel.mel_filter_bank(*args, norm=norm, mel_scale=scale)
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)


def test_dft_basis_matches_jax():
    for got, want in zip(tmel._windowed_dft_basis(1024), jmel._windowed_dft_basis(1024)):
        np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)


@pytest.mark.parametrize("n_in,n_out", [(1201, 1001), (3001, 1001), (1001, 1001), (7, 3)])
def test_bilinear_matrix_matches_jax(n_in, n_out):
    np.testing.assert_allclose(clap_mel._bilinear_matrix(n_in, n_out),
                               jclap_mel._bilinear_matrix(n_in, n_out), atol=1e-12, rtol=0)


@pytest.mark.parametrize("n_in,n_out", [(1001, 1024), (64, 64), (5, 1)])
def test_bicubic_matrix_matches_jax(n_in, n_out):
    np.testing.assert_allclose(clap.bicubic_interp_matrix(n_in, n_out),
                               jclap.bicubic_interp_matrix(n_in, n_out), atol=1e-12, rtol=0)


@pytest.mark.parametrize("h,window", [(16, 4), (64, 8), (32, 8)])
def test_window_constants_match_jax(h, window):
    np.testing.assert_array_equal(clap.relative_position_index(window),
                                  jclap.relative_position_index(window))
    np.testing.assert_array_equal(clap.shifted_window_mask(h, h, window, window // 2),
                                  jclap.shifted_window_mask(h, h, window, window // 2))


# ------------------------------------------------------------------------------ dB mel

def _frontends(seed: int = 0, **kw):
    jcfg = JClapMelConfig(**kw)
    return (jclap_mel.ClapMelFrontend(jcfg, seed=seed),
            clap_mel.ClapMelFrontend(_pick(C.ClapMelConfig, jcfg), seed=seed, device="cpu"))


@pytest.mark.parametrize("truncation", ["fusion", "rand_trunc"])
@pytest.mark.parametrize("seconds", [2.0, 10.0, 13.7])
def test_db_mel_matches_jax(truncation, seconds):
    """Short (tiled), exact and long clips (random crops: the same ones from one seed)."""
    jfe, tfe = _frontends(seed=3, truncation=truncation)
    wav = _clip(seconds, seed=int(seconds * 10))
    for _ in range(2):   # the second call draws the next crops of the same generator
        want, want_longer = jfe(wav)
        got, got_longer = tfe(wav)
        assert got_longer == want_longer
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=DB_TOL, rtol=0)


@pytest.mark.parametrize("padding", ["repeat", "pad"])
def test_db_mel_padding_modes_match_jax(padding):
    jfe, tfe = _frontends(padding=padding)
    wav = _clip(3.3, seed=1)
    np.testing.assert_allclose(tfe(wav)[0].numpy(), jfe(wav)[0], atol=DB_TOL, rtol=0)


@pytest.mark.parametrize("padding", ["repeatpad", "repeat", "pad"])
@pytest.mark.parametrize("seconds,n", [(23.0, 4), (4.0, 2), (30.0, 4)])
def test_window_chunks_match_jax(padding, seconds, n):
    jfe, tfe = _frontends()
    wav = _clip(seconds, seed=2)
    want = np.asarray(jfe.window_chunks_device(jnp.asarray(wav), n, padding))
    got = tfe.window_chunks_device(torch.from_numpy(wav), n, padding)
    np.testing.assert_array_equal(got.numpy(), want)


def _processors():
    vocab, merges = train_bpe(["describe the sound of music"], 300)
    from audio_flamingo_tpu.runtime.tokenizer import BBPETokenizer as JTokenizer

    jcfg = JAF2Config()
    jp = JAF2Processor(tokenizer=JTokenizer(vocab, merges), cfg=jcfg)
    tp = AF2Processor(tokenizer=BBPETokenizer(vocab, merges), cfg=C.AF2Config(), device="cpu")
    return jp, tp


@pytest.mark.parametrize("seconds", [23.0, 7.5])
def test_windows_for_matches_jax_f32(seconds):
    jp, tp = _processors()
    wav = _clip(seconds, seed=4)
    want, want_longer = jp.windows_for(wav)
    got, got_longer = tp.windows_for(wav)
    assert got.shape[0] == bucket_clap_windows(int(np.ceil(seconds / 10)))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=DB_TOL, rtol=0)
    np.testing.assert_array_equal(got_longer.numpy(), want_longer)


def test_windows_for_int16_matches_jax_device_path():
    """int16 PCM is scaled by 1/32768 on the device, as JAX's windows_for_device does."""
    jp, tp = _processors()
    pcm = (np.clip(_clip(12.0, seed=5), -1, 1) * 32767).astype(np.int16)
    want, _ = jp.windows_for_device(pcm)
    got, _ = tp.windows_for(pcm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=DB_TOL, rtol=0)
    f32, _ = tp.windows_for(pcm.astype(np.float32) / 32768.0)
    np.testing.assert_array_equal(got.numpy(), f32.numpy())


def test_processor_ids_and_media_idx_match_jax():
    jp, tp = _processors()
    text = "a <sound> b <sound> c"
    audios = [_clip(2.0, seed=6), _clip(14.0, seed=7)]
    want, got = jp(text=text, audios=audios), tp(text=text, audios=audios)
    np.testing.assert_array_equal(got["ids"], want["ids"])
    np.testing.assert_array_equal(got["media_idx"], want["media_idx"])
    assert tuple(got["mels"].shape) == want["mels"].shape
    np.testing.assert_allclose(got["mels"].numpy(), want["mels"], atol=DB_TOL, rtol=0)
    np.testing.assert_array_equal(got["is_longer"].numpy(), want["is_longer"])


# ------------------------------------------------------------------------------- the tower

SMALL = dict(num_mel_bins=16, spec_size=64, patch_size=4, patch_stride=4, patch_embed_dim=24,
             depths=(2, 2), num_heads=(2, 4), window_size=4, projection_dim=32)


def _perturbed_params(cfg, seed: int):
    """JAX init with every leaf moved (bias tables, norms and batch-norm statistics too),
    so that each weight reaches the output."""
    params = jclap.init(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)

    def move(path, x):
        x = np.asarray(x, np.float32)
        noise = rng.standard_normal(x.shape).astype(np.float32)
        if path[-1].key == "var":
            return np.abs(x + 0.3 * noise) + 0.5
        return x + 0.05 * noise

    return jax.tree_util.tree_map_with_path(move, params)


def _towers(fusion: bool, seed: int = 0):
    jcfg = JClapAudioConfig(enable_fusion=fusion, **SMALL)
    cfg = _pick(C.ClapAudioConfig, jcfg)
    params = _perturbed_params(jcfg, seed)
    tower = clap.build(cfg, "cpu", torch.float32)
    tower.load_state_dict(clap_params_from_jax(params, cfg))
    return jclap.ClapAudioTower(jcfg), params, tower


def _mels(b: int, c: int, t: int, seed: int) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal((b, c, t, 16)) * 10 - 40).astype(np.float32)


def _check_tower(jt, params, tower, mels, is_longer):
    want = jt.encode(params, jnp.asarray(mels),
                     None if is_longer is None else jnp.asarray(is_longer))
    got = tower.encode(torch.from_numpy(mels),
                       None if is_longer is None else torch.from_numpy(is_longer))
    for key in ("pooled", "embeds"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=TOWER_TOL,
                                   rtol=0, err_msg=key)


@pytest.mark.parametrize("t", [1001, 256])
def test_tower_without_fusion_matches_jax(t):
    jt, params, tower = _towers(fusion=False)
    _check_tower(jt, params, tower, _mels(2, 1, t, seed=1), None)


def test_tower_fusion_is_longer_matches_jax():
    """Four channels through mel_conv and the AFF where is_longer, the global mel elsewhere."""
    jt, params, tower = _towers(fusion=True, seed=1)
    _check_tower(jt, params, tower, _mels(2, 4, 1001, seed=2), np.array([[True], [False]]))


def test_tower_fusion_without_is_longer_matches_jax():
    jt, params, tower = _towers(fusion=True, seed=2)
    _check_tower(jt, params, tower, _mels(1, 4, 1001, seed=3), None)


def test_tower_embeds_are_unit_norm():
    _, _, tower = _towers(fusion=True, seed=3)
    out = tower.encode(torch.from_numpy(_mels(3, 4, 1001, seed=4)),
                       torch.tensor([True, False, True]))
    np.testing.assert_allclose(out["embeds"].norm(dim=-1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("fusion", [True, False])
def test_clap_params_round_trip(fusion):
    """clap_params_to_jax inverts clap_params_from_jax (the names JAX's save_af2 writes)."""
    jcfg = JClapAudioConfig(enable_fusion=fusion, **SMALL)
    cfg = _pick(C.ClapAudioConfig, jcfg)
    params = _perturbed_params(jcfg, seed=5)
    back = clap_params_to_jax(clap_params_from_jax(params, cfg), cfg)
    from audio_flamingo_tpu_torch.io.convert import _flat_tree

    flat = _flat_tree(params)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)
