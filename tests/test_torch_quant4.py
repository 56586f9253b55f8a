"""Port's int8 / int4 weight quantization and the w4a16 matmul (K5) against the JAX package:
bit-identical codes and scales, the kernel's plain version against the JAX Pallas kernel
(interpret mode) and the dequant route against JAX's XLA route, at f32 within 1e-5 of
max|y|, and the JAX dispatch rule between the two routes."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_flamingo_tpu.config import Qwen2Config as JQwen2Config
from audio_flamingo_tpu.models import qwen2 as jqwen2
from audio_flamingo_tpu.ops import quant as jquant
from audio_flamingo_tpu.ops import quant4 as jquant4
from audio_flamingo_tpu.ops.pallas.quant4_matmul import (w4a16_matmul as jw4a16_matmul,
                                                         w4a16_matmul_stacked as jw4a16_stacked)
from audio_flamingo_tpu_torch import config as C
from audio_flamingo_tpu_torch.io.convert import lm_params_from_jax
from audio_flamingo_tpu_torch.models import qwen2
from audio_flamingo_tpu_torch.ops import quant, quant4
from audio_flamingo_tpu_torch.ops.kernels import w4a16_matmul as k5

jax.config.update("jax_default_matmul_precision", "highest")
torch.set_num_threads(2)

PRODUCT_TOL = 1e-5   # f32, relative to max|y|: one product, sums in another order
# the init under jit (one compile instead of one per eager op); the quantizers stay eager,
# as JAX ``load`` runs them: under jit XLA turns the division by 127 / 7 into a product
jinit = jax.jit(jqwen2.init, static_argnums=1)


def _flat(tree):
    return {k: v if isinstance(v, jax.ShapeDtypeStruct) else np.asarray(v)
            for k, v in qwen2.flatten(tree).items()}


def _assert_trees_equal(got: dict, want: dict):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k in want:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        assert g.dtype == want[k].dtype and g.shape == want[k].shape, k
        np.testing.assert_array_equal(g, want[k], err_msg=k)


def _port_cfg(jcfg):
    return C.Qwen2Config(**{f.name: getattr(jcfg, f.name)
                            for f in dataclasses.fields(C.Qwen2Config)})


def _lm(hidden=256, inter=512, layers=2, head_dim=64, tied=False, seed=0):
    """A JAX LM param tree and the port's float LM state dict of the same weights."""
    jcfg = JQwen2Config(vocab_size=128, hidden_size=hidden, intermediate_size=inter,
                        num_layers=layers, num_heads=4, num_kv_heads=2, head_dim=head_dim,
                        tie_word_embeddings=tied)
    params = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(seed), jcfg))
    return params, lm_params_from_jax(params, _port_cfg(jcfg))


def _packed(rng, k, n, group, lead=()):
    w = rng.normal(size=(*lead, k, n)).astype(np.float32) * 0.05
    p = quant4.quantize_linear_w4(torch.from_numpy(w), group)   # bit-identical to JAX's
    return p["w_p"].numpy(), p["gscale"].numpy()


@pytest.mark.parametrize("lead", [(), (3,)])
def test_pack_unpack_match_jax(lead):
    rng = np.random.default_rng(0)
    w_q = rng.integers(-8, 8, size=(*lead, 64, 40)).astype(np.int8)
    packed = quant4.pack_w4(torch.from_numpy(w_q))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jquant4.pack_w4(jnp.asarray(w_q))))
    np.testing.assert_array_equal(quant4.unpack_w4(packed).numpy(), w_q)


@pytest.mark.parametrize("group,lead,dtype", [(64, (), "float32"), (128, (2,), "float32"),
                                              (64, (), "bfloat16")])
def test_quantize_linear_w4_is_bit_identical(group, lead, dtype):
    rng = np.random.default_rng(1)
    w = jnp.asarray(rng.normal(size=(*lead, 512, 96)) * 0.05, getattr(jnp, dtype))
    want = jquant4.quantize_linear_w4(w, group)
    got = quant4.quantize_linear_w4(torch.from_numpy(np.array(w.astype(jnp.float32)))
                                    .to(getattr(torch, dtype)), group)
    _assert_trees_equal(got, want)
    np.testing.assert_array_equal(quant4.dequantize_w4(got, torch.float32).numpy(),
                                  np.asarray(jquant4.dequantize_w4(want, jnp.float32)))
    # the dequant route's bf16 weights: the same rounding of w_q * s, bit for bit
    np.testing.assert_array_equal(
        quant4.dequantize_w4(got, torch.bfloat16).view(torch.int16).numpy(),
        np.asarray(jquant4.dequantize_w4(want, jnp.bfloat16)).view(np.int16))


@pytest.mark.parametrize("variant", ["fused", "unfused", "head_w4", "unaligned", "int8",
                                     "int8_tied"])
def test_quantize_lm_params_is_bit_identical(variant):
    """Every leaf of the port's tree equals JAX's: codes, scales, norms and biases, the
    int8 fallback of unaligned linears, the fused qkv / gateup and the int4 head."""
    if variant == "unaligned":      # K = 48 does not split into groups: int8 everywhere
        jlm, state = _lm(hidden=48, inter=96, head_dim=None)
    else:
        jlm, state = _lm(tied=variant == "int8_tied")
    if variant.startswith("int8"):
        want = jquant.quantize_lm_params(jlm)
        got = quant.quantize_lm_params(state)
    else:
        kw = dict(group_size=64, fuse=variant != "unfused", head_w4=variant == "head_w4")
        want = jquant4.quantize_lm_params_w4(jlm, **kw)
        got = quant4.quantize_lm_params_w4(state, **kw)
    _assert_trees_equal(got, want)


@pytest.mark.parametrize("m", [1, 5, 256])
@pytest.mark.parametrize("stacked", [False, True])
def test_k5_plain_version_matches_jax_kernel(m, stacked):
    rng = np.random.default_rng(m)
    k, n, group = 512, 1024, 64
    x = rng.normal(size=(m, k)).astype(np.float32)
    if stacked:
        w_p, gscale = _packed(rng, k, n, group, lead=(3,))
        want = jw4a16_stacked(jnp.asarray(x), jnp.asarray(w_p), jnp.asarray(gscale),
                              jnp.int32(2))
        got = k5.w4a16_matmul_stacked(torch.from_numpy(x), torch.from_numpy(w_p),
                                      torch.from_numpy(gscale), 2)
    else:
        w_p, gscale = _packed(rng, k, n, group)
        want = jw4a16_matmul(jnp.asarray(x), jnp.asarray(w_p), jnp.asarray(gscale))
        got = k5.w4a16_matmul(torch.from_numpy(x), torch.from_numpy(w_p),
                              torch.from_numpy(gscale))
    want = np.asarray(want)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=PRODUCT_TOL * np.abs(want).max(), rtol=0)


def test_dequant_route_matches_jax_xla_route():
    """m > 256 rows: both packages dequantize and take a plain product."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 150, 256)).astype(np.float32)
    w_p, gscale = _packed(rng, 256, 384, 128, lead=(2,))
    b = rng.normal(size=(2, 384)).astype(np.float32)
    jp = {"w_p": jnp.asarray(w_p), "gscale": jnp.asarray(gscale), "b": jnp.asarray(b)}
    tp = {"w_p": torch.from_numpy(w_p), "gscale": torch.from_numpy(gscale),
          "b": torch.from_numpy(b)}
    want = np.asarray(jquant4.q4_matmul_stacked(jnp.asarray(x), jp, jnp.int32(1)))
    got = quant4.q4_matmul_stacked(torch.from_numpy(x), tp, 1).numpy()
    np.testing.assert_allclose(got, want, atol=PRODUCT_TOL * np.abs(want).max(), rtol=0)
    want = np.asarray(jquant4.q4_matmul(jnp.asarray(x), {"w_p": jp["w_p"][0],
                                                         "gscale": jp["gscale"][0]}))
    got = quant4.q4_matmul(torch.from_numpy(x), {"w_p": tp["w_p"][0],
                                                 "gscale": tp["gscale"][0]}).numpy()
    np.testing.assert_allclose(got, want, atol=PRODUCT_TOL * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("m,n,kernel", [(1, 512, True), (256, 1024, True), (257, 512, False),
                                        (4, 384, True), (4, 768, False)])
def test_q4_matmul_takes_the_jax_route(monkeypatch, m, n, kernel):
    """The kernel for m <= 256 and n % min(512, n) == 0, else the dequant route."""
    calls = []
    for name in ("w4a16_matmul", "w4a16_matmul_stacked"):
        real = getattr(k5, name)
        monkeypatch.setattr(k5, name, lambda *a, _r=real: calls.append(1) or _r(*a))
    rng = np.random.default_rng(5)
    w_p, gscale = _packed(rng, 256, n, 64, lead=(1,))
    p = {"w_p": torch.from_numpy(w_p), "gscale": torch.from_numpy(gscale)}
    x = torch.from_numpy(rng.normal(size=(m, 256)).astype(np.float32))
    quant4.q4_matmul_stacked(x, p, 0)
    quant4.q4_matmul(x, {"w_p": p["w_p"][0], "gscale": p["gscale"][0]})
    assert len(calls) == (2 if kernel else 0)


def test_k5_wrapper_checks_and_never_launches_for_cpu_tensors():
    rng = np.random.default_rng(6)
    w_p, gscale = (torch.from_numpy(a) for a in _packed(rng, 256, 128, 64, lead=(2,)))
    x = torch.randn(3, 256)
    k5.LAUNCHES.reset()
    k5.w4a16_matmul_stacked(x, w_p, gscale, 1)
    k5.w4a16_matmul(x, w_p[0], gscale[0])
    assert k5.LAUNCHES.count == 0
    with pytest.raises(ValueError):
        k5.w4a16_matmul(torch.randn(3, 128), w_p[0], gscale[0])
    with pytest.raises(TypeError):
        k5.w4a16_matmul(x, w_p[0].to(torch.int32), gscale[0])
    with pytest.raises(IndexError):
        k5.w4a16_matmul_stacked(x, w_p, gscale, 2)


@pytest.mark.parametrize("fuse,head_w4", [(True, False), (False, True)])
def test_random_quantized_lm_layouts_match_jax(fuse, head_w4):
    jcfg = JQwen2Config(vocab_size=96, hidden_size=256, intermediate_size=512, num_layers=2,
                        num_heads=4, num_kv_heads=2, head_dim=64, tie_word_embeddings=False)
    cfg = _port_cfg(jcfg)
    gen = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    for tree, want in (   # JAX's layouts by shape inference only: no values are drawn
            (quant4.random_quantized_lm_w4(gen, cfg, "cpu", 64, fuse, head_w4),
             jax.eval_shape(lambda: jquant4.random_quantized_lm_w4(key, jcfg, 64, fuse,
                                                                   head_w4))),
            (quant.random_quantized_lm(gen, cfg, "cpu"),
             jax.eval_shape(lambda: jquant.random_quantized_lm(key, jcfg)))):
        got, want = qwen2.flatten(tree), _flat(want)
        assert got.keys() == want.keys()
        for k in want:
            assert (tuple(got[k].shape), str(got[k].dtype).split(".")[-1]) == \
                (want[k].shape, str(want[k].dtype)), k
        lm = qwen2.quantized_lm(tree, torch.bfloat16, "cpu")
        assert lm.dtype == torch.bfloat16 and lm.layers["ln1_w"].dtype == torch.bfloat16
        assert lm.embed["scale"].dtype == torch.float32
