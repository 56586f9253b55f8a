"""The w8a16 matmul (K4): its plain version against the JAX package's Pallas
``w8a16_matmul`` run in interpret mode (as tests/test_quant.py runs it), f32 within 1e-5
of max|ref| and bf16 within one output rounding (2^-7 |ref| + 2^-9 max|ref|, K5's band);
the f32 output from a bf16 x, the transposed [N, K] layout of a tied embedding and a
layer read in place from a stack; the wrapper's checks; and the port's ``q_matmul`` and
``unembed`` on both routes against JAX's, with the route rule and the input gradient."""

import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from audio_flamingo_tpu.config import Qwen2Config as JQwen2Config
from audio_flamingo_tpu.models import qwen2 as jqwen2
from audio_flamingo_tpu.ops import quant as jquant
from audio_flamingo_tpu_torch import config as C
from audio_flamingo_tpu_torch.io.convert import lm_params_from_jax
from audio_flamingo_tpu_torch.models import qwen2
from audio_flamingo_tpu_torch.ops import quant
from audio_flamingo_tpu_torch.ops.kernels import w8a16_matmul as k4

jax.config.update("jax_default_matmul_precision", "highest")
torch.set_num_threads(2)

F32_TOL = 1e-5                      # of max|ref|: sums in another order
BF16_TOL = (2.0 ** -7, 2.0 ** -9)   # one rounding of the output, plus 2^-9 max|ref|
K, N = 128, 96


def _jax_kernel(x, w_q, scale, **blocks):
    """JAX's Pallas w8a16_matmul in interpret mode."""
    from audio_flamingo_tpu.ops.pallas.quant_matmul import w8a16_matmul

    orig = pl.pallas_call

    def patched(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    with mock.patch.object(pl, "pallas_call", patched):
        return np.asarray(w8a16_matmul(x, w_q, scale, **blocks).astype(jnp.float32))


def _operands(m: int, seed: int = 0, k: int = K, n: int = N):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w_q = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    scale = rng.uniform(0.001, 0.02, size=(n,)).astype(np.float32)
    return x, w_q, scale


def _assert_close(got: np.ndarray, want: np.ndarray, dtype: str) -> None:
    diff = np.abs(got - want)
    scale = np.abs(want).max()
    if dtype == "float32":
        assert diff.max() <= F32_TOL * scale, diff.max() / scale
    else:
        assert (diff <= BF16_TOL[0] * np.abs(want) + BF16_TOL[1] * scale).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 3, 8, 17])
def test_reference_matches_jax_kernel(m, dtype):
    """Four k-steps of 32 and three column blocks of 32 in JAX; rows padded to 8 there."""
    x, w_q, scale = _operands(m, seed=m)
    jx = jnp.asarray(x).astype(dtype)
    want = _jax_kernel(jx, jnp.asarray(w_q), jnp.asarray(scale), block_n=32, block_k=32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = k4.w8a16_matmul(tx, torch.from_numpy(w_q), torch.from_numpy(scale))
    assert got.dtype == tx.dtype and got.shape == (m, N)
    _assert_close(got.float().numpy(), want, dtype)


def test_f32_output_from_bf16_is_jax_f32_head():
    """bf16 x with f32 output: the widened x is exact, so it is JAX's f32 product of
    ``h.astype(f32)`` (the head of unembed)."""
    x, w_q, scale = _operands(5, seed=11)
    xb = torch.from_numpy(x).bfloat16()
    got = k4.w8a16_matmul(xb, torch.from_numpy(w_q), torch.from_numpy(scale), torch.float32)
    jx = jnp.asarray(xb.float().numpy())
    want = _jax_kernel(jx, jnp.asarray(w_q), jnp.asarray(scale), block_n=32, block_k=64)
    assert got.dtype == torch.float32
    _assert_close(got.numpy(), want, "float32")


def test_tied_layout_and_stacked_layer_are_read_in_place():
    """The transposed view of a row-major [N, K] table (a tied embedding) and a layer's
    view of an [L, K, N] stack give the product of the same codes laid out [K, N]."""
    x, w_q, scale = _operands(4, seed=3)
    tx, tw, ts = (torch.from_numpy(a) for a in (x, w_q, scale))
    want = k4.w8a16_matmul_reference(tx, tw.contiguous(), ts)
    table = tw.t().contiguous()                     # [N, K], as an embedding is stored
    assert k4.layout_of(table.t()) == 1 and k4.layout_of(tw) == 0
    np.testing.assert_allclose(k4.w8a16_matmul(tx, table.t(), ts).numpy(), want.numpy(),
                               rtol=0, atol=1e-6 * want.abs().max().item())
    stack = torch.stack([torch.zeros_like(tw), tw, -tw])
    scales = torch.stack([ts, ts, ts])
    got = k4.w8a16_matmul(tx, stack[1], scales[1])
    assert stack[1].data_ptr() == stack.data_ptr() + K * N      # a view, not a copy
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-6 * want.abs().max().item())


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x, w_q, scale = (torch.from_numpy(a) for a in _operands(2))
    with pytest.raises(ValueError, match="neither"):
        k4.layout_of(w_q[:, ::2])
    with pytest.raises(TypeError):
        k4.w8a16_matmul(x, w_q.to(torch.int16), scale)
    with pytest.raises(TypeError):
        k4.w8a16_matmul(x.double(), w_q, scale)
    with pytest.raises(ValueError, match="do not agree"):
        k4.w8a16_matmul(x[:, :-1], w_q, scale)
    with pytest.raises(ValueError, match="no rows"):
        k4.w8a16_matmul(x[:0], w_q, scale)
    # a tensor on neither the CPU nor a card reaches the launcher and raises: no fallback
    with pytest.raises(ValueError, match="runs on cuda"):
        k4.w8a16_matmul(x.to("meta"), w_q.to("meta"), scale.to("meta"))


@pytest.mark.parametrize("k,n,m", [(3584, 512, 1), (3584, 3584, 1), (18944, 3584, 8),
                                   (3584, 152064, 32), (48, 96, 3)])
def test_split_k_covers_k_in_whole_units(k, n, m):
    rows = k4.split_k(k, n, m)
    splits = -(-k // rows)
    assert rows % k4.STAGE_ROWS == 0 and (splits - 1) * rows < k <= splits * rows
    blocks = -(-n // k4.BLOCK_N) * -(-m // k4.rows_per_block(m, torch.bfloat16))
    # enough blocks for the card where K allows it (equal splits may round the count
    # down), and no split without need
    assert 2 * blocks * splits >= min(k4.TARGET_BLOCKS, blocks * -(-k // k4.STAGE_ROWS))
    assert splits == 1 or blocks * (splits - 1) < k4.TARGET_BLOCKS


# ------------------------------------------------------------------ q_matmul and unembed
JLM = JQwen2Config(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2,
                   num_heads=4, num_kv_heads=2, tie_word_embeddings=False)


def _pick(cls, obj):
    return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)})


@pytest.fixture(scope="module")
def int8_lms():
    """A tiny int8 LM, untied and tied, in both packages (quantized by JAX, eagerly)."""
    out = {}
    for tied in (False, True):
        jc = dataclasses.replace(JLM, tie_word_embeddings=tied)
        jp = jquant.quantize_lm_params(jqwen2.init(jax.random.PRNGKey(4), jc))
        lm = qwen2.quantized_lm(qwen2.unflatten(lm_params_from_jax(jp, _pick(C.Qwen2Config, jc))),
                                torch.float32, "cpu")
        out[tied] = (jc, jp, lm)
    return out


def _count_k4(monkeypatch) -> list:
    calls = []
    real = k4.w8a16_matmul
    monkeypatch.setattr(k4, "w8a16_matmul", lambda *a, **kw: calls.append(a[0].shape[0])
                        or real(*a, **kw))
    return calls


@pytest.mark.parametrize("rows", [1, 7, 300])
def test_q_matmul_matches_jax_on_both_routes(int8_lms, monkeypatch, rows):
    """Layer 1's stacked q projection on ``rows`` rows: K4 up to KERNEL_MAX_ROWS rows, the
    library product above, both within 1e-5 of JAX's q_matmul."""
    jc, jp, lm = int8_lms[False]
    calls = _count_k4(monkeypatch)
    x = np.random.default_rng(rows).normal(size=(rows, jc.hidden_size)).astype(np.float32)
    jlin = jax.tree.map(lambda a: a[1], jp["layers"]["q"])
    want = np.asarray(jquant.q_matmul(jnp.asarray(x), jlin))
    got = quant.q_matmul(torch.from_numpy(x), {"w_q": lm.layers["q"]["w_q"][1],
                                               "scale": lm.layers["q"]["scale"][1]})
    _assert_close(got.numpy(), want, "float32")
    assert calls == ([rows] if rows <= quant.KERNEL_MAX_ROWS else [])


@pytest.mark.parametrize("tied", [False, True])
def test_unembed_matches_jax(int8_lms, monkeypatch, tied):
    """The int8 head (untied [d, V], or the tied embedding read as [V, d].t()) through
    K4 with f32 logits, against JAX's unembed of the same hidden state."""
    jc, jp, lm = int8_lms[tied]
    calls = _count_k4(monkeypatch)
    h = np.random.default_rng(5).normal(size=(3, 2, jc.hidden_size)).astype(np.float32)
    want = np.asarray(jqwen2.unembed(jp, jc, jnp.asarray(h)))
    got = qwen2.unembed(lm, torch.from_numpy(h))
    assert got.dtype == torch.float32 and got.shape == (3, 2, jc.vocab_size)
    _assert_close(got.numpy(), want, "float32")
    assert calls == [6]
    # a bf16 hidden state: the f32 head of its exact widening
    hb = torch.from_numpy(h).bfloat16()
    want_b = np.asarray(jqwen2.unembed(jp, jc, jnp.asarray(hb.float().numpy())))
    _assert_close(qwen2.unembed(lm, hb).numpy(), want_b, "float32")


def test_route_rule(int8_lms, monkeypatch):
    """By rows alone: up to KERNEL_MAX_ROWS (at least every decode batch of bench.py's
    decode matrix, 32) on K4, above it the library product; stage 2's 4 x 1024 rows stay
    on the library route."""
    _, _, lm = int8_lms[False]
    calls = _count_k4(monkeypatch)
    p = {"w_q": lm.layers["mlp"]["up"]["w_q"][0], "scale": lm.layers["mlp"]["up"]["scale"][0]}
    limit = quant.KERNEL_MAX_ROWS
    assert 32 <= limit < 4 * 1024
    for rows in (1, limit, limit + 1):
        quant.q_matmul(torch.ones((rows, p["w_q"].shape[0])), p)
    assert calls == [1, limit]


@pytest.mark.parametrize("rows", [4, 300])
def test_input_gradient_matches_jax(int8_lms, rows):
    """The gradient of x through either route is JAX's ``g @ (w_q * scale)^T``."""
    jc, jp, lm = int8_lms[False]
    rng = np.random.default_rng(rows)
    x = rng.normal(size=(rows, jc.hidden_size)).astype(np.float32)
    g = rng.normal(size=(rows, jc.intermediate_size)).astype(np.float32)
    jlin = jax.tree.map(lambda a: a[0], jp["layers"]["mlp"]["gate"])
    _, vjp = jax.vjp(lambda a: jquant.q_matmul(a, jlin), jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    tx = torch.from_numpy(x).requires_grad_(True)
    y = quant.q_matmul(tx, {"w_q": lm.layers["mlp"]["gate"]["w_q"][0],
                            "scale": lm.layers["mlp"]["gate"]["scale"][0]})
    (gx,) = torch.autograd.grad(y, tx, torch.from_numpy(g))
    _assert_close(gx.numpy(), want, "float32")
