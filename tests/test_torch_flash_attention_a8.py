"""The port's int8-QK flash attention (K8's plain version and its prelude) against the
JAX package's ``flash_attention_a8``, whose Pallas kernel runs in interpret mode on the
CPU.

Two comparisons per case:
- the body: the port's prelude outputs (int8 q and k, bf16 v, rowc) fed to both the
  port's plain version and JAX's kernel body ``_a8_kernel`` (through ``pallas_call`` with
  JAX's own block specs). The int32 scores are exact on both sides, so they differ only
  where an exp's last bit rounds p to the other bf16 neighbour, and in the order of f32
  sums: f32 outputs within 1e-5 of max|o| for 99 % of the elements and 5e-4 of max|o| at
  most (one p at the bf16 rounding edge moves o by at most 2^-8 of that key's weight);
  bf16 outputs within one bf16 step, 2^-7 |o| + 2^-9 max|o|.
- end to end: the port's ``flash_attention_a8`` against JAX's jitted one. Under jit XLA
  may divide by 127 through its reciprocal, so a scale can move by an ulp and flip a
  code: the outputs are held to a band of 1e-2 of max|o| (JAX's own tests hold the
  kernel to 4e-2 of the value scale against f32 attention).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from audio_flamingo_tpu.ops.pallas import flash_attention_a8 as jfa8
from audio_flamingo_tpu_torch.ops.kernels import flash_attention_a8 as fa8

jax.config.update("jax_default_matmul_precision", "highest")
torch.set_num_threads(2)

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
JNP = dict(DTYPES.values())


def _inputs(b, tq, tk, h, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, tq, h, d)).astype(np.float32)
    # a common-mode K component, which the prelude's mean removal absorbs
    k = (rng.normal(size=(b, tk, hkv, d)) + 0.5).astype(np.float32)
    v = rng.normal(size=(b, tk, hkv, d)).astype(np.float32)
    return q, k, v


def _jax_body(pre: fa8.Prelude) -> np.ndarray:
    """JAX's kernel body on the port's prelude outputs (JAX flash_attention_a8 :191-222
    with one KV super-tile, which holds here: Tk <= 8192) -> [B, Tq, H, D] f32."""
    b, h, g = pre.batch, pre.heads, pre.heads // pre.kv_heads
    d = pre.q_i8.shape[-1]
    tq, tk = pre.q_i8.shape[1], pre.k_i8.shape[1]
    bq = 128   # the rows are independent: any row block gives the same rows
    kernel = functools.partial(jfa8._a8_kernel, bq=bq, bk=pre.bk, bks=tk, num_super=1,
                               scale=1.0, causal=pre.causal, q_offset=pre.q_offset,
                               kv_len=pre.kv_len)
    if pre.causal:
        def kv_index(i, qi, j):
            return (i // g, jnp.minimum(j, (qi * bq + bq - 1 + pre.q_offset) // tk), 0)
    else:
        def kv_index(i, qi, j):
            return (i // g, j, 0)
    out = pl.pallas_call(
        kernel, grid=(b * h, tq // bq, 1),
        in_specs=[pl.BlockSpec((1, bq, 1), lambda i, qi, j: (i, qi, 0)),
                  pl.BlockSpec((1, bq, d), lambda i, qi, j: (i, qi, 0)),
                  pl.BlockSpec((1, tk, d), kv_index),
                  pl.BlockSpec((1, tk, d), kv_index)],
        out_specs=pl.BlockSpec((1, bq, d), lambda i, qi, j: (i, qi, 0)),
        out_shape=jax.ShapeDtypeStruct((b * h, tq, d), JNP[pre.out_dtype]),
        scratch_shapes=[pltpu.VMEM((bq, 1), jnp.float32), pltpu.VMEM((bq, 1), jnp.float32),
                        pltpu.VMEM((bq, d), jnp.float32)],
        interpret=True,
    )(jnp.asarray(pre.rowc.numpy())[..., None], jnp.asarray(pre.q_i8.numpy()),
      jnp.asarray(pre.k_i8.numpy()), jnp.asarray(pre.v.float().numpy()).astype(jnp.bfloat16))
    out = np.asarray(out.astype(jnp.float32)).reshape(b, h, tq, d).transpose(0, 2, 1, 3)
    return out[:, : pre.tq]


def _assert_body_close(got: np.ndarray, want: np.ndarray, dtype: str) -> None:
    mx = np.abs(want).max()
    diff = np.abs(got - want)
    if dtype == "float32":
        assert (diff <= 1e-5 * mx).mean() >= 0.99, (diff <= 1e-5 * mx).mean()
        assert diff.max() <= 5e-4 * mx, diff.max() / mx
    else:
        assert (diff <= 2.0 ** -7 * np.abs(want) + 2.0 ** -9 * mx).all(), diff.max() / mx


def _check(shape, causal, dtype, *, q_offset=0, block_q=512, block_k=1024, seed=0):
    b, tq, tk, h, hkv, d = shape
    tdt, jdt = DTYPES[dtype]
    q, k, v = (torch.from_numpy(a).to(tdt) for a in _inputs(b, tq, tk, h, hkv, d, seed))
    kw = dict(causal=causal, q_offset=q_offset, block_q=block_q, block_k=block_k)
    pre = fa8.prelude(q, k, v, **kw)
    ref = fa8.flash_attention_a8_reference(pre)
    assert ref.dtype == tdt and ref.shape == (b, tq, h, d)
    ref = ref.float().numpy()
    _assert_body_close(ref, _jax_body(pre), dtype)
    got = fa8.flash_attention_a8(q, k, v, **kw).float().numpy()
    np.testing.assert_array_equal(got, ref)        # the wrapper takes the plain version
    want = np.asarray(jfa8.flash_attention_a8(
        *(jnp.asarray(t.float().numpy()).astype(jdt) for t in (q, k, v)), **kw
    ).astype(jnp.float32))
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()
    return pre, ref


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tq,tk,h,hkv,d,causal", [
    (256, 256, 4, 2, 128, True),     # tests/test_flash_attention_a8.py:42's cases
    (384, 384, 4, 4, 64, False),
    (200, 200, 4, 2, 128, True),
])
def test_matches_jax_at_its_test_cases(tq, tk, h, hkv, d, causal, dtype):
    _check((2, tq, tk, h, hkv, d), causal, dtype, block_q=128, block_k=128)


def test_causal_two_key_tiles_at_default_blocks():
    """Tk > 1024 at the LM's default blocks: p is rounded against the running max of two
    1024-key tiles."""
    pre, _ = _check((1, 1100, 1100, 4, 2, 64), True, "float32", seed=1)
    assert pre.bk == 1024 and -(-pre.kv_len // pre.bk) == 2


def test_encoder_call_with_block_k_2048():
    """The encoder's call (scale 1, block_q 512, block_k 2048): one 384-key tile over 300
    keys."""
    b, t, h, d = 1, 300, 4, 64
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(b, t, t, h, h, d, 2))
    pre = fa8.prelude(q, k, v, scale=1.0, block_q=512, block_k=2048)
    assert pre.bk == 384 and pre.q_i8.shape[1] == 384
    ref = fa8.flash_attention_a8_reference(pre).float().numpy()
    _assert_body_close(ref, _jax_body(pre), "bfloat16")


def test_q_offset_and_rows_without_keys():
    """Causal with a q_offset (a verify block over a warm prefix) matches JAX; with a
    negative offset the first rows see no key and give o = 0 (the port's convention), the
    rest match JAX."""
    _check((1, 100, 300, 4, 2, 64), True, "float32", q_offset=200)
    b, tq, tk, h, hkv, d = 1, 64, 64, 4, 2, 64
    q, k, v = (torch.from_numpy(a) for a in _inputs(b, tq, tk, h, hkv, d, 3))
    pre = fa8.prelude(q, k, v, causal=True, q_offset=-10, block_q=128, block_k=128)
    ref = fa8.flash_attention_a8_reference(pre).numpy()
    assert (ref[:, :10] == 0).all() and np.isfinite(ref).all()
    _assert_body_close(ref[:, 10:], _jax_body(pre)[:, 10:], "float32")


def test_prelude_follows_jax_order():
    """Padding, K mean removal over the valid keys (padded keys stay 0), codes and scales,
    rowc = (qs * ks) * scale, V in bf16."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 130, 130, 4, 2, 64, 4))
    pre = fa8.prelude(q, k, v, causal=True, block_q=512, block_k=1024)
    assert pre.q_i8.shape == (4, 256, 64) and pre.k_i8.shape == (2, 256, 64)
    assert pre.v.dtype == torch.bfloat16 and pre.bk == 256
    assert (pre.k_i8[:, 130:] == 0).all() and (pre.q_i8[:, 130:] == 0).all()
    kh = k.transpose(1, 2).reshape(2, 130, 64)
    kh = kh - kh.mean(dim=1, keepdim=True)
    ks = kh.abs().amax(dim=(1, 2)).clamp(min=1e-6) / 127.0
    assert torch.equal(pre.k_i8[:, :130], torch.round(kh / ks[:, None, None]).to(torch.int8))
    qs = q.transpose(1, 2).reshape(4, 130, 64).abs().amax(-1).clamp(min=1e-6) / 127.0
    want = qs * ks.repeat_interleave(2)[:, None] * 64 ** -0.5
    assert torch.equal(pre.rowc[:, :130], want)


def test_kernel_raises_off_the_card():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 64, 64, 2, 2, 64, 5))
    pre = fa8.prelude(q, k, v)
    with pytest.raises(ValueError, match="cuda"):
        fa8.flash_attention_a8_kernel(pre)
