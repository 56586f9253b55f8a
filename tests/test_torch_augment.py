"""The port's augmentation (audio/augment.py) against the JAX package's: given JAX's own
draws (the mask widths and starts its key gives, its noise, its gain in dB), the
apply_* functions give JAX's output within 1e-6; the generator-driven functions mask and
scale as specified and repeat under one seed."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_flamingo_tpu.audio import augment as jaug
from audio_flamingo_tpu_torch.audio import augment as taug

torch.set_num_threads(2)

TOL = 1e-6


def _jax_draws(key, frames, n_mels, nt, frac, nf, max_f):
    """The widths and starts jaug.spec_augment draws from ``key`` (its own order)."""
    max_t = max(1, int(frames * frac))
    keys = iter(jax.random.split(key, 2 * (nt + nf)))
    tw, ts, fw, fs = [], [], [], []
    for _ in range(nt):
        tw.append(int(jax.random.randint(next(keys), (), 0, max_t + 1)))
        ts.append(int(jax.random.randint(next(keys), (), 0, frames)))
    for _ in range(nf):
        fw.append(int(jax.random.randint(next(keys), (), 0, max_f + 1)))
        fs.append(int(jax.random.randint(next(keys), (), 0, n_mels)))
    return taug.SpecAugmentDraws(*(torch.tensor(x, dtype=torch.long) for x in (tw, ts, fw, fs)))


@pytest.mark.parametrize("shape,nt,frac,nf,max_f,seed", [
    ((3000, 128), 2, 0.05, 2, 16, 0),
    ((2, 3, 400, 80), 3, 0.2, 1, 30, 1),
    ((1, 50, 16), 1, 0.5, 4, 8, 2),
])
def test_spec_augment_matches_jax_on_its_draws(shape, nt, frac, nf, max_f, seed):
    mels = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 3 - 1
    key = jax.random.PRNGKey(seed)
    kw = dict(num_time_masks=nt, max_time_frac=frac, num_freq_masks=nf, max_freq_bins=max_f)
    want = np.asarray(jaug.spec_augment(key, jnp.asarray(mels), **kw))
    draws = _jax_draws(key, shape[-2], shape[-1], nt, frac, nf, max_f)
    got = taug.apply_spec_augment(torch.from_numpy(mels), draws).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    assert (got != mels).any() == (want != mels).any()


@pytest.mark.parametrize("shape,snr", [((16000,), 10.0), ((3, 4000), -5.0), ((2, 2, 800), 30.0)])
def test_noise_matches_jax_on_its_noise(shape, snr):
    wav = (0.3 * np.random.default_rng(1).standard_normal(shape)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jaug.add_noise_snr(key, jnp.asarray(wav), snr))
    noise = np.array(jax.random.normal(key, wav.shape, jnp.float32))
    got = taug.apply_noise_snr(torch.from_numpy(wav), torch.from_numpy(noise), snr).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("lo,hi,seed", [(-6.0, 6.0, 0), (-20.0, 3.0, 5)])
def test_gain_matches_jax_on_its_gain(lo, hi, seed):
    wav = (0.5 * np.random.default_rng(2).standard_normal(4000)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jaug.random_gain(key, jnp.asarray(wav), lo, hi))
    g_db = float(jax.random.uniform(key, (), minval=lo, maxval=hi))
    got = taug.apply_gain(torch.from_numpy(wav), g_db).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_generator_spec_augment_masks_as_specified():
    mels = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 600, 64))
                            .astype(np.float32))
    kw = dict(num_time_masks=3, max_time_frac=0.1, num_freq_masks=2, max_freq_bins=12)
    a = taug.spec_augment(torch.Generator().manual_seed(9), mels, **kw)
    b = taug.spec_augment(torch.Generator().manual_seed(9), mels, **kw)
    assert torch.equal(a, b)
    d = taug.spec_augment_draws(torch.Generator().manual_seed(9), 600, 64, **kw)
    assert d.time_width.shape == (3,) and d.freq_width.shape == (2,)
    assert ((0 <= d.time_width) & (d.time_width <= 60)).all()
    assert ((0 <= d.time_start) & (d.time_start < 600)).all()
    assert ((0 <= d.freq_width) & (d.freq_width <= 12)).all()
    assert ((0 <= d.freq_start) & (d.freq_start < 64)).all()
    assert torch.equal(a, taug.apply_spec_augment(mels, d))
    fill = mels.mean(dim=(-2, -1), keepdim=True)
    t = torch.arange(600)[:, None]
    f = torch.arange(64)[None, :]
    cover = torch.zeros(600, 64, dtype=torch.bool)
    for w, s in zip(d.time_width, d.time_start):
        cover |= (t >= s) & (t < s + w)
    for w, s in zip(d.freq_width, d.freq_start):
        cover |= (f >= s) & (f < s + w)
    assert torch.equal(a, torch.where(cover, fill.expand_as(mels), mels))
    # over many seeds some mask is drawn wide, and the untouched cells keep their values
    widths = [taug.spec_augment_draws(torch.Generator().manual_seed(s), 600, 64, **kw)
              .time_width.max().item() for s in range(40)]
    assert max(widths) == 60 and min(widths) < 60


def test_generator_noise_and_gain_scale_as_specified():
    wav = torch.from_numpy((0.2 * np.random.default_rng(4).standard_normal((2, 8000)))
                           .astype(np.float32))
    for snr in (0.0, 12.0, 40.0):
        out = taug.add_noise_snr(torch.Generator().manual_seed(1), wav, snr)
        noise = out - wav
        ratio = 10 * torch.log10(wav.pow(2).mean(-1) / noise.pow(2).mean(-1))
        assert torch.allclose(ratio, torch.full_like(ratio, snr), atol=1e-3)
        assert torch.equal(out, taug.add_noise_snr(torch.Generator().manual_seed(1), wav, snr))
    gains = []
    for s in range(64):
        out = taug.random_gain(torch.Generator().manual_seed(s), wav, -6.0, 6.0)
        g = (out / wav).flatten()
        assert torch.allclose(g, g[:1].expand_as(g), rtol=1e-6)
        gains.append(20 * torch.log10(g[0]).item())
    assert -6.0 - 1e-4 <= min(gains) and max(gains) <= 6.0 + 1e-4
    assert max(gains) - min(gains) > 8.0
