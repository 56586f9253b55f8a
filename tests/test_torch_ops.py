"""Port's norms, RoPE, MLPs and masks against the JAX ops at f32."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_flamingo_tpu.ops import attention as ja
from audio_flamingo_tpu.ops import mlp as jm
from audio_flamingo_tpu.ops import norms as jn
from audio_flamingo_tpu.ops import rope as jr
from audio_flamingo_tpu_torch.config import Qwen2Config
from audio_flamingo_tpu_torch.models import qwen2
from audio_flamingo_tpu_torch.ops import attention as ta
from audio_flamingo_tpu_torch.ops import mlp as tm
from audio_flamingo_tpu_torch.ops import norms as tn
from audio_flamingo_tpu_torch.ops import rope as tr

jax.config.update("jax_default_matmul_precision", "highest")
torch.set_num_threads(2)


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_norms_match_jax():
    x, w, b = _rand(3, 7, 32), _rand(32, seed=1), _rand(32, seed=2)
    np.testing.assert_allclose(tn.rms_norm(*map(torch.from_numpy, (x, w))).numpy(),
                               np.asarray(jn.rms_norm(x, w)), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tn.layer_norm(*map(torch.from_numpy, (x, w, b))).numpy(),
                               np.asarray(jn.layer_norm(x, w, b)), atol=1e-6, rtol=0)


def test_rope_matches_jax():
    pos = np.arange(40, dtype=np.int32)[None].repeat(2, 0) + np.array([[0], [900]], np.int32)
    cos, sin = tr.rope_cos_sin(torch.from_numpy(pos).long(), 16, 1e6)
    jcos, jsin = jr.rope_cos_sin(jnp.asarray(pos), 16, 1e6)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=2e-6, rtol=0)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=2e-6, rtol=0)
    q, k = _rand(2, 40, 4, 16, seed=3), _rand(2, 40, 2, 16, seed=4)
    got = tr.apply_rope(torch.from_numpy(q), torch.from_numpy(k), cos, sin)
    want = jr.apply_rope(jnp.asarray(q), jnp.asarray(k), jcos, jsin)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, rtol=0)


@pytest.mark.parametrize("activation", ["gelu", "relu"])
def test_mlps_match_jax(activation):
    x = _rand(2, 5, 16)
    g, u, d = _rand(16, 32, seed=1), _rand(16, 32, seed=2), _rand(32, 16, seed=3)
    want = jm.swiglu_mlp(jnp.asarray(x), {"gate": g, "up": u, "down": d})
    cfg = Qwen2Config(vocab_size=8, hidden_size=16, intermediate_size=32, num_layers=1,
                      num_heads=2, num_kv_heads=1)
    lm = qwen2.Qwen2(cfg)
    with torch.no_grad():
        for lin, a in zip((lm.layers[0].gate_proj, lm.layers[0].up_proj,
                           lm.layers[0].down_proj), (g, u, d)):
            lin.weight.copy_(torch.from_numpy(a.T.copy()))
        got = qwen2.mlp_forward(torch.from_numpy(x), lm, cfg, 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    b1, b2 = _rand(32, seed=4), _rand(16, seed=5)
    want = jm.gelu_mlp(jnp.asarray(x), {"fc1": g, "fc1_b": b1, "fc2": d, "fc2_b": b2},
                       activation=activation)
    got = tm.gelu_mlp(torch.from_numpy(x), torch.from_numpy(g.T.copy()), torch.from_numpy(b1),
                      torch.from_numpy(d.T.copy()), torch.from_numpy(b2), activation=activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("q_offset", [0, 3])
def test_causal_mask_and_masked_attention_match_jax(q_offset):
    np.testing.assert_array_equal(ta.causal_mask(5, 9, q_offset).numpy(),
                                  np.asarray(ja.causal_mask(5, 9, q_offset)))
    q, k, v = _rand(2, 5, 4, 8), _rand(2, 9, 2, 8, seed=1), _rand(2, 9, 2, 8, seed=2)
    mask = np.random.default_rng(3).random((2, 4, 5, 9)) > 0.3
    mask[..., 0] = True
    want = ja.gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jnp.asarray(mask))
    got = ta.gqa_attention(*map(torch.from_numpy, (q, k, v)), mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6, rtol=0)
