"""The port's w8a8 encoder against the JAX package: K9's three plain versions against
JAX's Pallas kernels (interpret mode), the polynomial GELU, ``largest_divisor_tile``, the
tiny encoder in both int8 layouts and every ``fused_stages`` mix, and the conversion of
both layouts.

JAX's kernels and its encoder ``apply`` are jitted, and under jit XLA may divide by 127
through its reciprocal, so a scale can move by an ulp and flip a code where the port's
eager division does not (and a LayerNorm's sums run in another order). So codes are held
to a share (>= 99 % equal, where JAX's own floor ``_assert_ulp_equal`` in
tests/test_enc_fused.py asks 97 %), scales to 1e-6 relative, and outputs to a band: the
kernels' within one int8 step of a row (2e-2 relative, 1e-2 absolute, JAX's own band),
the encoders' within 1e-2 of max|y| (JAX holds fused against composed to 5e-2).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_flamingo_tpu.config import AF3Config as JAF3Config
from audio_flamingo_tpu.config import WhisperEncoderConfig as JEncoderConfig
from audio_flamingo_tpu.models import af3 as jaf3
from audio_flamingo_tpu.models import whisper_encoder as jenc
from audio_flamingo_tpu.ops import quant as jquant
from audio_flamingo_tpu.ops.pallas import enc_fused as jef
from audio_flamingo_tpu_torch import config as C
from audio_flamingo_tpu_torch.io.convert import params_from_jax
from audio_flamingo_tpu_torch.models import qwen2, whisper_encoder
from audio_flamingo_tpu_torch.ops import quant
from audio_flamingo_tpu_torch.ops.kernels import enc_fused as ef

jax.config.update("jax_default_matmul_precision", "highest")
torch.set_num_threads(2)

D, F = 64, 128


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _qw(rng, a, b):
    w = rng.normal(size=(a, b)) * 0.3
    scale = np.maximum(np.abs(w).max(axis=0), 1e-8) / 127.0
    return np.clip(np.round(w / scale), -127, 127).astype(np.int8), scale.astype(np.float32)


def _rand(rng, *shape, s=0.5):
    return (rng.normal(size=shape) * s).astype(np.float32)


def _close_band(got, want):
    """All within JAX's one-step band; 99 % within a few f32 ulps of a row's scale (an ulp
    of h_scale moves a whole row by ~1e-7) or equal in bf16."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    near = np.abs(got - want) <= 1e-6 * np.abs(want) + 1e-7
    assert near.mean() >= 0.99, near.mean()
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=1e-2)


def _codes_share(got, want) -> float:
    return float((np.asarray(got) == np.asarray(want)).mean())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ln_qkv_matches_jax_kernel(dtype):
    rng = np.random.default_rng(0)
    m = 200   # not a block multiple
    x = _rand(rng, m, D)
    lnw, lnb = _rand(rng, D, s=0.2) + 1.0, _rand(rng, D, s=0.1)
    w_q, scale = _qw(rng, D, 3 * D)
    bias = _rand(rng, 3 * D, s=0.05)
    jx = jnp.asarray(x).astype(dtype)
    want = jef.enc_ln_qkv(jx, jnp.asarray(lnw), jnp.asarray(lnb), jnp.asarray(w_q),
                          jnp.asarray(scale), jnp.asarray(bias), block_m=64)
    tx = _t(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    got = ef.enc_ln_qkv(tx, *(_t(a) for a in (lnw, lnb, w_q, scale, bias)))
    assert got.dtype == tx.dtype and got.shape == (m, 3 * D)
    _close_band(got.float().numpy(), want.astype(jnp.float32))


def test_out_ln_matches_jax_kernel():
    rng = np.random.default_rng(1)
    m = 130
    attn, x = _rand(rng, m, D), _rand(rng, m, D)
    w_q, scale = _qw(rng, D, D)
    bias = _rand(rng, D, s=0.05)
    lnw, lnb = _rand(rng, D, s=0.2) + 1.0, _rand(rng, D, s=0.1)
    jx2, jhq, jhs = jef.enc_out_ln(*(jnp.asarray(a) for a in (attn, x, w_q, scale, bias,
                                                                 lnw, lnb)), block_m=64)
    x2, hq, hs = ef.enc_out_ln(*(_t(a) for a in (attn, x, w_q, scale, bias, lnw, lnb)))
    assert hq.dtype == torch.int8 and hs.shape == (m, 1) and hs.dtype == torch.float32
    _close_band(x2.numpy(), jx2)
    assert _codes_share(hq.numpy(), jhq) >= 0.99
    np.testing.assert_allclose(hs.numpy(), np.asarray(jhs), rtol=1e-6)


def test_out_ln_quantizes_the_unrounded_x2():
    """In bf16, x2 is returned rounded but its LayerNorm is taken of the f32 x2."""
    rng = np.random.default_rng(4)
    m = 40
    args = [_t(_rand(rng, m, D)).bfloat16(), _t(_rand(rng, m, D)).bfloat16(),
            *(_t(a) for a in _qw(rng, D, D)), _t(_rand(rng, D, s=0.05)),
            _t(_rand(rng, D, s=0.2) + 1.0), _t(_rand(rng, D, s=0.1))]
    x2, hq, hs = ef.enc_out_ln(*args)
    aq, a_s = ef.quant_rows(args[0].float())
    x2_f = args[1].float() + ef.i8_dot(aq, args[2]) * a_s * args[3] + args[4]
    want_q, want_s = ef.quant_rows(ef.ln(x2_f, args[5], args[6], 1e-5))
    assert torch.equal(x2, x2_f.bfloat16()) and torch.equal(hq, want_q)
    assert torch.equal(hs, want_s)


@pytest.mark.parametrize("f_tile", [64, 128])
def test_mlp_matches_jax_kernel(f_tile):
    rng = np.random.default_rng(2)
    m = 96
    hq, hs = ef.quant_rows(_t(_rand(rng, m, D)))
    w1, s1 = _qw(rng, D, F)
    b1 = _rand(rng, F, s=0.05)
    w2, s2 = _qw(rng, F, D)
    b2 = _rand(rng, D, s=0.05)
    x2 = _rand(rng, m, D)
    want = jef.enc_mlp(jnp.asarray(hq.numpy()), jnp.asarray(hs.numpy()),
                       *(jnp.asarray(a) for a in (w1, s1, b1, w2, s2, b2, x2)),
                       block_m=32, f_tile=f_tile)
    got = ef.enc_mlp(hq, hs, *(_t(a) for a in (w1, s1, b1, w2, s2, b2, x2)), f_tile=f_tile)
    _close_band(got.numpy(), want)


def test_polynomial_gelu_matches_jax():
    x = np.linspace(-12.0, 12.0, 20001, dtype=np.float32)
    got = ef.gelu(_t(x)).numpy()
    want = np.asarray(jef._gelu(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    exact = torch.nn.functional.gelu(_t(x).double()).numpy()
    assert np.abs(got - exact).max() < 2e-6


def test_largest_divisor_tile_matches_jax():
    for n in (128, 3072, 5120, 97, 1):
        for cap in (1, 64, 2560, 10_000):
            assert whisper_encoder.largest_divisor_tile(n, cap) == jenc._largest_divisor_tile(
                n, cap), (n, cap)


@pytest.fixture(scope="module")
def tiny_encoder():
    """JAX's tiny encoder config and params, mels for two windows, and a tiny JAX LM tree
    (params_from_jax converts whole AF3 trees)."""
    jcfg = JAF3Config.tiny()
    params = jax.tree.map(np.asarray, jax.jit(jaf3.init, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg))
    mels = (np.random.default_rng(3).normal(size=(2, 3000, jcfg.encoder.num_mel_bins))
            * 0.3).astype(np.float32)
    return jcfg.encoder, params["encoder"], mels, params["lm"]


def _port_cfg(jcfg: JEncoderConfig) -> C.WhisperEncoderConfig:
    return C.WhisperEncoderConfig(**{f.name: getattr(jcfg, f.name)
                                     for f in dataclasses.fields(C.WhisperEncoderConfig)})


def _convert(enc: dict, lm: dict) -> dict:
    return params_from_jax({"encoder": enc, "adaptor": {}, "lm": lm}, C.AF3Config.tiny())


def _port_encoder(jp: dict, lm: dict, cfg: C.WhisperEncoderConfig):
    """A quantized JAX encoder tree -> the port's QuantWhisperEncoder, through
    params_from_jax's names."""
    sd = _convert(jp, lm)
    enc = {k[8:]: v for k, v in sd.items() if k.startswith("encoder.")}
    tree = qwen2.unflatten({k[7:]: v for k, v in enc.items() if k.startswith("layers.")})
    return whisper_encoder.quantized_encoder(
        cfg, {k: v for k, v in enc.items() if not k.startswith("layers.")}, tree,
        torch.float32, "cpu")


MIXES = [("plain", dict()), ("plain", dict(use_flash=True)),
         ("plain", dict(use_flash=True, a8_attention=True))] + [
    ("fused", dict(fused_stages=st)) for st in
    [(), ("qkv",), ("out",), ("mlp",), ("qkv", "out", "mlp")]] + [
    ("fused", dict(fused_stages=("qkv", "out", "mlp"), use_flash=True))]


@pytest.mark.parametrize("layout,flags", MIXES)
def test_quantized_encoder_matches_jax(tiny_encoder, layout, flags):
    jcfg, params, mels, lm = tiny_encoder
    jp = (jquant.quantize_encoder_params(params) if layout == "plain"
          else jquant.quantize_encoder_params_fused(params, head_dim=jcfg.head_dim))
    jp = jax.tree.map(np.asarray, jp)
    jc = dataclasses.replace(jcfg, **flags)
    cfg = _port_cfg(jc)
    enc = _port_encoder(jp, lm, cfg)
    assert isinstance(enc, whisper_encoder.QuantWhisperEncoder)
    assert enc.fused == (layout == "fused") and enc.num_layers == jcfg.num_layers
    with torch.inference_mode():
        got = whisper_encoder.apply(enc, cfg, _t(mels)).numpy()
    want = np.asarray(jenc.apply(jax.tree.map(jnp.asarray, jp), jc, jnp.asarray(mels),
                                 compute_dtype=jnp.float32))
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.9999


@pytest.mark.parametrize("fused", [False, True])
def test_quantizers_and_conversion_carry_both_layouts(tiny_encoder, fused):
    """The port's quantizers on the float encoder give JAX's tree bit for bit (codes,
    scales, biases, norms); params_from_jax carries it under encoder.layers.*; and the
    port's ``quantize`` builds the same module."""
    jcfg, params, _, lm = tiny_encoder
    jp = (jquant.quantize_encoder_params_fused(params, head_dim=jcfg.head_dim) if fused
          else jquant.quantize_encoder_params(params))
    want = {k: np.asarray(v) for k, v in qwen2.flatten(jp["layers"]).items()}
    cfg = _port_cfg(jcfg)
    state = {k[8:]: v for k, v in _convert(params, lm).items() if k.startswith("encoder.")}
    tree = (quant.quantize_encoder_params_fused(state, cfg.head_dim) if fused
            else quant.quantize_encoder_params(state))
    got = {k: v.numpy() for k, v in qwen2.flatten(tree).items()}
    carried = {k[15:]: v.numpy() for k, v in _convert(jax.tree.map(np.asarray, jp), lm).items()
               if k.startswith("encoder.layers.")}
    assert got.keys() == want.keys() == carried.keys()
    for k in want:
        assert got[k].dtype == carried[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(carried[k], want[k], err_msg=k)
    float_enc = whisper_encoder.WhisperEncoder(cfg)
    float_enc.load_state_dict(state)
    enc = whisper_encoder.quantize(float_enc, cfg, fused=fused)
    for k, v in qwen2.flatten(tree).items():
        assert torch.equal(enc.layers.get_buffer(k), v), k
    assert enc.fused == fused and next(enc.parameters()).device.type == "cpu"
