"""Port's flash-attention backward (the plain version of K7, and the autograd Function
that carries it) against the JAX Pallas backward ``_flash_backward`` in interpret mode,
at f32 with unit-normal inputs, and against autograd of the plain ``gqa_attention``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_flamingo_tpu.ops.pallas import flash_attention as jfa
from audio_flamingo_tpu_torch.ops import attention as tattn
from audio_flamingo_tpu_torch.ops.kernels import flash_attention as tfa

jax.config.update("jax_default_matmul_precision", "highest")
torch.set_num_threads(2)

# the four cases of tests/test_flash_attention.py::test_flash_fused_backward_matches_reference
CASES = [
    dict(b=1, tq=256, tk=256, h=4, hkv=2, d=64, causal=True, q_offset=0),    # GQA causal
    dict(b=2, tq=300, tk=300, h=4, hkv=1, d=64, causal=True, q_offset=0),    # MQA, unaligned
    dict(b=1, tq=128, tk=384, h=2, hkv=2, d=32, causal=True, q_offset=256),  # decode offset
    dict(b=1, tq=200, tk=700, h=4, hkv=4, d=64, causal=False, q_offset=0),   # xattn-like
]
ATOL, RTOL = 5e-5, 1e-4


def _inputs(case, seed=7):
    rng = np.random.default_rng(seed)
    shapes = [(case["b"], case["tq"], case["h"], case["d"]),
              (case["b"], case["tk"], case["hkv"], case["d"]),
              (case["b"], case["tk"], case["hkv"], case["d"]),
              (case["b"], case["tq"], case["h"], case["d"])]          # the cotangent dO
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _jax_vjp(q, k, v, do, g_lse, *, causal, q_offset, scale=None):
    """(dq, dk, dv) from JAX's custom VJP of flash_attention_lse: _flash_backward's two
    Pallas kernels, in interpret mode on the CPU."""
    def fn(q, k, v):
        return jfa.flash_attention_lse(q, k, v, causal=causal, q_offset=q_offset, scale=scale)

    (o, lse), vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    g = jnp.zeros_like(lse) if g_lse is None else jnp.asarray(g_lse)
    return [np.asarray(x) for x in vjp((jnp.asarray(do), g))]


def _port_grads(q, k, v, do, g_lse, *, causal, q_offset, scale=None, dtype=torch.float32):
    """(dq, dk, dv) through the port's flash_attention_lse by autograd."""
    q, k, v = (torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v))
    o, lse = tfa.flash_attention_lse(q, k, v, causal=causal, q_offset=q_offset, scale=scale)
    outs, cots = [o], [torch.from_numpy(do).to(dtype)]
    if g_lse is not None:
        outs.append(lse)
        cots.append(torch.from_numpy(g_lse))
    return torch.autograd.grad(outs, (q, k, v), cots)


@pytest.mark.parametrize("case", CASES, ids=["gqa_causal", "mqa_unaligned", "q_offset",
                                             "noncausal_tk700"])
def test_backward_matches_jax_flash_backward(case):
    q, k, v, do = _inputs(case)
    kw = dict(causal=case["causal"], q_offset=case["q_offset"])
    want = _jax_vjp(q, k, v, do, None, **kw)
    got = _port_grads(q, k, v, do, None, **kw)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL, rtol=RTOL, err_msg=name)


def test_backward_with_lse_cotangent_matches_jax():
    """A nonzero LSE cotangent shifts delta (ds = p (dp - (delta - g_lse)))."""
    case = CASES[0]
    q, k, v, do = _inputs(case, seed=8)
    g_lse = np.random.default_rng(9).normal(size=(case["b"], case["tq"], case["h"])).astype(
        np.float32)
    kw = dict(causal=True, q_offset=0)
    want = _jax_vjp(q, k, v, do, g_lse, **kw)
    got = _port_grads(q, k, v, do, g_lse, **kw)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL, rtol=RTOL, err_msg=name)
    # and the LSE cotangent moved the gradients
    base = _port_grads(q, k, v, do, None, **kw)
    assert (base[0] - got[0]).abs().max() > 1e-2


@pytest.mark.parametrize("case", CASES[:3] + [dict(CASES[3], scale=1.0)],
                         ids=["gqa_causal", "mqa_unaligned", "q_offset", "scale_1"])
def test_autograd_matches_gqa_attention(case):
    q, k, v, do = _inputs(case, seed=3)
    kw = dict(causal=case["causal"], q_offset=case["q_offset"], scale=case.get("scale"))
    got = _port_grads(q, k, v, do, None, **kw)
    tq, tk = case["tq"], case["tk"]
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    mask = tattn.causal_mask(tq, tk, q_offset=case["q_offset"]) if case["causal"] else None
    o = tattn.gqa_attention(qt, kt, vt, mask=mask, scale=kw["scale"])
    want = torch.autograd.grad(o, (qt, kt, vt), torch.from_numpy(do))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=RTOL, msg=name)


def test_backward_reference_is_the_autograd_backward():
    """The public plain backward, called on the forward's (o, lse), is what autograd
    runs on the CPU (bit for bit), and it launches nothing."""
    case = CASES[1]
    q, k, v, do = _inputs(case, seed=4)
    kw = dict(causal=True, q_offset=0)
    got = _port_grads(q, k, v, do, None, **kw)
    qt, kt, vt, dot = map(torch.from_numpy, (q, k, v, do))
    o, lse = tfa.flash_attention_reference(qt, kt, vt, scale=case["d"] ** -0.5, **kw)
    tfa.BWD_LAUNCHES.reset()
    want = tfa.flash_attention_backward(qt, kt, vt, o, lse, dot, scale=case["d"] ** -0.5,
                                        **kw)
    assert tfa.BWD_LAUNCHES.count == 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_without_visible_key_gets_zero_finite_grads(dtype):
    """q_offset = -5 under causal masking: rows 0-4 see no key (lse = -inf). Their dq is
    0, every gradient is finite, and dk/dv equal those of the visible rows alone."""
    rng = np.random.default_rng(5)
    q, k, v, do = (rng.normal(size=s).astype(np.float32)
                   for s in ((1, 40, 4, 16), (1, 40, 2, 16), (1, 40, 2, 16), (1, 40, 4, 16)))
    g_lse = rng.normal(size=(1, 40, 4)).astype(np.float32)
    dq, dk, dv = _port_grads(q, k, v, do, g_lse, causal=True, q_offset=-5, dtype=dtype)
    for g in (dq, dk, dv):
        assert bool(torch.isfinite(g).all())
    assert torch.equal(dq[:, :5], torch.zeros_like(dq[:, :5]))
    # rows 5.. see keys 0..i-5: the same as rows 0.. of a q_offset-0 call on those rows
    rest = _port_grads(q[:, 5:], k, v, do[:, 5:], g_lse[:, 5:], causal=True, q_offset=0,
                       dtype=dtype)
    torch.testing.assert_close(dq[:, 5:], rest[0], atol=0, rtol=0)
    torch.testing.assert_close(dk, rest[1], atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(dv, rest[2], atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("case", [CASES[0], CASES[3]], ids=["gqa_causal", "noncausal"])
def test_bf16_backward_matches_f32_jax_gradient(case):
    """bf16 inputs: the port's bf16 backward (pc and ds rounded to bf16, outputs cast to
    bf16) against JAX's f32 gradient on the same bf16-valued inputs. Limit per element:
    2^-7 |f32 grad| + 2^-6 max|f32 grad| (the bf16 roundings of p, ds and the output)."""
    q, k, v, do = (torch.from_numpy(x).bfloat16().float().numpy() for x in _inputs(case, 11))
    kw = dict(causal=case["causal"], q_offset=case["q_offset"])
    want = _jax_vjp(q, k, v, do, None, **kw)
    got = _port_grads(q, k, v, do, None, dtype=torch.bfloat16, **kw)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16
        err = np.abs(a.float().numpy() - b)
        limit = 2.0 ** -7 * np.abs(b) + 2.0 ** -6 * np.abs(b).max()
        assert (err <= limit).all(), (name, float((err / limit).max()))


def test_only_the_used_output_needs_a_cotangent():
    """flash_attention (o only) and a loss on the LSE alone both differentiate."""
    case = CASES[0]
    q, k, v, do = _inputs(case, seed=12)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = tfa.flash_attention(qt, kt, vt, causal=True)
    assert o.grad_fn is not None
    (o * torch.from_numpy(do)).sum().backward()
    assert all(t.grad is not None and bool(torch.isfinite(t.grad).all()) for t in (qt, kt, vt))
    qt.grad = kt.grad = vt.grad = None
    _, lse = tfa.flash_attention_lse(qt, kt, vt, causal=True)
    lse.sum().backward()
    g_lse = np.ones((case["b"], case["tq"], case["h"]), np.float32)
    want = _jax_vjp(q, k, v, np.zeros_like(do), g_lse, causal=True, q_offset=0)
    for a, b in zip((qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL, rtol=RTOL)
