"""Port's flash attention (plain PyTorch version of the CUDA kernel) against the JAX
Pallas kernel in interpret mode and against the plain gqa_attention, at f32."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_flamingo_tpu.ops import attention as jattn
from audio_flamingo_tpu_torch.ops import attention as tattn
from audio_flamingo_tpu_torch.ops.kernels import flash_attention as tfa

jax.config.update("jax_default_matmul_precision", "highest")
torch.set_num_threads(2)


def _jax_flash(q, k, v, **kw):
    """The Pallas kernel in interpreter mode, as tests/test_flash_attention.py runs it."""
    from unittest import mock

    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*a, **kwargs):
        kwargs["interpret"] = True
        return orig(*a, **kwargs)

    with mock.patch.object(pl, "pallas_call", patched):
        from audio_flamingo_tpu.ops.pallas.flash_attention import flash_attention_lse

        return flash_attention_lse(q, k, v, **kw)


def _inputs(seed, b, tq, tk, h, hkv, d):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((b, tq, h, d), (b, tk, hkv, d), (b, tk, hkv, d))]


# (tq, tk, h, hkv, d, causal, q_offset, scale): GQA, causal, unaligned 1500, q_offset
CASES = [
    (256, 256, 4, 2, 32, False, 0, None),
    (256, 256, 4, 2, 32, True, 0, None),
    (1500, 1500, 2, 2, 16, False, 0, 1.0),
    (100, 300, 4, 1, 32, True, 200, None),
    (128, 128, 4, 4, 64, True, 0, None),
]


@pytest.mark.parametrize("tq,tk,h,hkv,d,causal,q_offset,scale", CASES)
def test_reference_matches_jax_flash(tq, tk, h, hkv, d, causal, q_offset, scale):
    q, k, v = _inputs(0, 1, tq, tk, h, hkv, d)
    jo, jlse = _jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                          scale=scale, q_offset=q_offset, block_q=128, block_k=128)
    to, tlse = tfa.flash_attention_lse(torch.from_numpy(q), torch.from_numpy(k),
                                       torch.from_numpy(v), causal=causal, scale=scale,
                                       q_offset=q_offset)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-5, rtol=0)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), atol=2e-5, rtol=0)


@pytest.mark.parametrize("tq,tk,h,hkv,d,causal,q_offset,scale", CASES)
def test_reference_matches_gqa_attention(tq, tk, h, hkv, d, causal, q_offset, scale):
    q, k, v = _inputs(1, 2, tq, tk, h, hkv, d)
    mask = jattn.causal_mask(tq, tk, q_offset=q_offset) if causal else None
    jo = jattn.gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=mask,
                             scale=scale)
    tq_, tk_, tv_ = map(torch.from_numpy, (q, k, v))
    tmask = tattn.causal_mask(tq, tk, q_offset=q_offset) if causal else None
    to = tfa.flash_attention(tq_, tk_, tv_, causal=causal, scale=scale, q_offset=q_offset)
    tg = tattn.gqa_attention(tq_, tk_, tv_, mask=tmask, scale=scale)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-5, rtol=0)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jo), atol=2e-5, rtol=0)


def test_row_without_visible_key_is_zero():
    """q_offset < 0 hides every key from the first rows: o = 0 and lse = -inf, no NaN."""
    q, k, v = map(torch.from_numpy, _inputs(2, 1, 8, 8, 2, 1, 16))
    o, lse = tfa.flash_attention_lse(q, k, v, causal=True, q_offset=-3)
    assert torch.isfinite(o).all()
    assert (o[:, :3] == 0).all() and torch.isneginf(lse[:, :3]).all()
    ref = tattn.gqa_attention(q[:, 3:], k, v, mask=tattn.causal_mask(5, 8, q_offset=0))
    torch.testing.assert_close(o[:, 3:], ref, atol=2e-6, rtol=0)


BF16_BOUND = (2.0 ** -7, 1e-3)   # per element: |o - o_ref| <= 2^-7 |o_ref| + 1e-3


@pytest.mark.parametrize("tq,tk,h,hkv,d,causal,q_offset,scale", CASES)
def test_reference_matches_jax_flash_bf16(tq, tk, h, hkv, d, causal, q_offset, scale):
    """bf16 inputs: both round P to bf16 before P.V against the running max of 64-key
    tiles (the JAX kernel at block_k=64), so the port's plain version stays within the
    bf16 output bound of the JAX kernel (interpret mode) per element."""
    q, k, v = _inputs(5, 1, tq, tk, h, hkv, d)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    jo, jlse = _jax_flash(jq, jk, jv, causal=causal, scale=scale, q_offset=q_offset,
                          block_q=128, block_k=tfa.KV_TILE)
    to, tlse = tfa.flash_attention_lse(*(torch.from_numpy(x).bfloat16() for x in (q, k, v)),
                                       causal=causal, scale=scale, q_offset=q_offset)
    assert to.dtype == torch.bfloat16
    want = np.asarray(jo.astype(jnp.float32))
    diff = np.abs(to.float().numpy() - want)
    rel, floor = BF16_BOUND
    assert (diff <= rel * np.abs(want) + floor).all(), diff.max()
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), atol=1e-4, rtol=0)


def test_reference_rounds_p_to_bf16_before_pv():
    """The bf16 plain version multiplies V by bf16-rounded probabilities and divides by
    the f32 sum of the unrounded ones, as the JAX kernel does (one 64-key tile here, so
    the running max is the row max)."""
    q, k, v = (torch.from_numpy(x).bfloat16() for x in _inputs(6, 1, 16, 40, 2, 2, 16))
    o, _ = tfa.flash_attention_reference(q, k, v)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * 16 ** -0.5
    p = torch.exp(s - s.amax(-1, keepdim=True))
    want = torch.einsum("bhqk,bkhd->bqhd", p.bfloat16().float(), v.float())
    want = want / p.sum(-1).permute(0, 2, 1)[..., None]
    assert torch.equal(o, want.bfloat16())


def test_row_without_visible_key_is_zero_bf16():
    """The same convention in bf16: o = 0 and lse = -inf where no key is visible."""
    q, k, v = (torch.from_numpy(x).bfloat16() for x in _inputs(2, 1, 8, 8, 2, 1, 16))
    o, lse = tfa.flash_attention_lse(q, k, v, causal=True, q_offset=-3)
    assert o.dtype == torch.bfloat16 and torch.isfinite(o.float()).all()
    assert (o[:, :3] == 0).all() and torch.isneginf(lse[:, :3]).all()
    ref, _ = tfa.flash_attention_reference(q[:, 3:], k, v, causal=True)
    assert torch.equal(o[:, 3:], ref)


def test_cpu_dispatch_uses_reference_and_counts_no_launch():
    q, k, v = map(torch.from_numpy, _inputs(3, 1, 16, 16, 2, 2, 16))
    tfa.LAUNCHES.reset()
    o = tfa.flash_attention(q, k, v, causal=True)
    ref, _ = tfa.flash_attention_reference(q, k, v, causal=True)
    assert torch.equal(o, ref)
    assert tfa.LAUNCHES.count == 0 and not tfa.LAUNCHES.shapes


@pytest.mark.parametrize("bad", ["dtype", "mixed", "rank", "heads", "kv_shape", "empty"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q, k, v = map(torch.from_numpy, _inputs(4, 1, 8, 8, 4, 2, 16))
    if bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "mixed":
        q = q.bfloat16()
    elif bad == "rank":
        q = q[0]
    elif bad == "heads":
        k, v = torch.cat([k, k[:, :, :1]], 2), torch.cat([v, v[:, :, :1]], 2)
    elif bad == "kv_shape":
        v = v[:, :4]
    elif bad == "empty":
        q = q[:, :0]
    with pytest.raises((ValueError, TypeError)):
        tfa.flash_attention(q, k, v)
