"""Port's fused w4 decode suffixes (K6): the plain versions of suffix A and B against the
JAX Pallas kernels (interpret mode) at f32, within 1e-5 of max|y| per output, on the
layer-stacked trees that both packages' quantizers make from the same weights; and the
eligibility rule against JAX ``suffix_supported``."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_flamingo_tpu.config import Qwen2Config as JQwen2Config
from audio_flamingo_tpu.models import qwen2 as jqwen2
from audio_flamingo_tpu.ops import quant4 as jquant4
from audio_flamingo_tpu.ops.pallas import quant4_block as jblock
from audio_flamingo_tpu_torch import config as C
from audio_flamingo_tpu_torch.models import qwen2
from audio_flamingo_tpu_torch.ops.kernels import w4_suffix as k6

jax.config.update("jax_default_matmul_precision", "highest")
torch.set_num_threads(2)

TOL = 1e-5   # f32, relative to max|y| of each output: two products and a norm
EPS = 1e-6

JCFG = JQwen2Config(vocab_size=128, hidden_size=256, intermediate_size=512, num_layers=2,
                    num_heads=4, num_kv_heads=2, head_dim=64, tie_word_embeddings=True)
jinit = jax.jit(jqwen2.init, static_argnums=1)
jquantize_w4 = jax.jit(jquant4.quantize_lm_params_w4, static_argnames=("group_size", "fuse"))
CFG = C.Qwen2Config(**{f.name: getattr(JCFG, f.name) for f in dataclasses.fields(C.Qwen2Config)})


def _trees(group: int):
    """The same fused w4 layers in JAX (jnp) and in the port (QuantQwen2 layers)."""
    layers = jquantize_w4(jinit(jax.random.PRNGKey(3), JCFG), group_size=group)["layers"]
    # norm weights away from 1, so that a weight applied at the wrong point shows
    rng = np.random.default_rng(group)
    for name in ("ln1_w", "ln2_w"):
        layers[name] = jnp.asarray(1.0 + 0.5 * rng.standard_normal(layers[name].shape),
                                   jnp.float32)
    tree = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), layers)
    port = qwen2.quantized_lm({"layers": tree, "ln_f_w": torch.ones(256)}, torch.float32,
                              "cpu").layers
    return layers, port


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=TOL * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("group", [64, 128])
@pytest.mark.parametrize("m", [1, 3, 8])
def test_suffix_a_and_b_match_jax(group, m):
    jl, tl = _trees(group)
    rng = np.random.default_rng(m)
    d, f, k_o = 256, 512, 256
    attn = rng.normal(size=(m, k_o)).astype(np.float32)
    h = rng.normal(size=(m, d)).astype(np.float32)
    st = qwen2.split_stacked_w4(tl)
    for layer in (0, 1):
        j_act, j_h = jblock.w4_suffix_a(jnp.asarray(attn), jnp.asarray(h), jl["ln2_w"][layer],
                                        jl["o"], jl["mlp"]["gateup"], jnp.int32(layer), eps=EPS)
        t_act, t_h = k6.w4_suffix_a(torch.from_numpy(attn), torch.from_numpy(h),
                                    tl["ln2_w"][layer], st["o"], st["mlp"]["gateup"], layer,
                                    eps=EPS)
        _close(t_act, j_act)
        _close(t_h, j_h)
        assert t_act.shape == (m, f)
        # B consumes A's outputs; the last layer computes a discarded qkv for itself
        nxt = min(layer + 1, 1)
        act = np.asarray(j_act)
        j_h2, j_qkv = jblock.w4_suffix_b(jnp.asarray(act), j_h, jl["ln1_w"][nxt],
                                         jl["mlp"]["down"], jl["qkv"], jnp.int32(layer),
                                         jnp.int32(nxt), eps=EPS)
        t_h2, t_qkv = k6.w4_suffix_b(torch.from_numpy(act), torch.from_numpy(np.array(j_h)),
                                     tl["ln1_w"][nxt], st["mlp"]["down"], st["qkv"], layer,
                                     nxt, eps=EPS)
        _close(t_h2, j_h2)
        _close(t_qkv, j_qkv)


def test_suffix_supported_matches_jax():
    for cfg_kw in ({}, {"intermediate_size": 384}, {"hidden_size": 512, "head_dim": 128}):
        jcfg = dataclasses.replace(JCFG, **cfg_kw)
        cfg = dataclasses.replace(CFG, **cfg_kw)
        params = jinit(jax.random.PRNGKey(0), jcfg)
        for kw in (dict(group_size=64), dict(group_size=64, fuse=False)):
            jtree = jquantize_w4(params, **kw)
            jst, _ = jqwen2.split_stacked_w4(jtree["layers"])
            tree = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jtree)
            port = qwen2.quantized_lm(tree, torch.float32, "cpu")
            st = qwen2.split_stacked_w4(port.layers)
            assert (st is None) == (jst is None)
            assert k6.suffix_supported(st, cfg) == jblock.suffix_supported(jst, jcfg), cfg_kw


def test_suffix_wrappers_check_rows_and_never_launch_for_cpu_tensors():
    _, tl = _trees(64)
    st = qwen2.split_stacked_w4(tl)
    k6.LAUNCHES_A.reset()
    k6.LAUNCHES_B.reset()
    act, h = k6.w4_suffix_a(torch.randn(2, 256), torch.randn(2, 256), tl["ln2_w"][0], st["o"],
                            st["mlp"]["gateup"], 0)
    k6.w4_suffix_b(act, h, tl["ln1_w"][1], st["mlp"]["down"], st["qkv"], 0, 1)
    assert k6.LAUNCHES_A.count == k6.LAUNCHES_B.count == 0
    with pytest.raises(ValueError, match="rows"):
        k6.w4_suffix_a(torch.randn(9, 256), torch.randn(9, 256), tl["ln2_w"][0], st["o"],
                       st["mlp"]["gateup"], 0)
    with pytest.raises(ValueError):
        k6.w4_suffix_b(act, h[:1], tl["ln1_w"][1], st["mlp"]["down"], st["qkv"], 0, 1)
    with pytest.raises(ValueError):
        k6.w4_suffix_b(act, h, tl["ln1_w"][1], st["mlp"]["down"], st["qkv"], 0, 2)
