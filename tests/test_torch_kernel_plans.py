"""Host code around the redesigned w4a16 matmul (K5) and fused encoder MLP (K9 enc_mlp):
K5's split rule and route rules (shared by the w4 suffixes, K6), the alignment copy, the
wrappers' refusals and that a CPU tensor never reaches the kernel library; enc_mlp's
K-major weight copies (equal to the transpose of the JAX layout, kept out of the state
dict, moved with the tree) and that the plain version, which the CPU runs, still reads the
JAX layout: with or without the copies it matches JAX's kernel (interpret mode).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_flamingo_tpu.ops.pallas import enc_fused as jef
from audio_flamingo_tpu_torch import config as C
from audio_flamingo_tpu_torch.models import qwen2, whisper_encoder
from audio_flamingo_tpu_torch.ops import quant
from audio_flamingo_tpu_torch.ops.kernels import _build
from audio_flamingo_tpu_torch.ops.kernels import enc_fused as ef
from audio_flamingo_tpu_torch.ops.kernels import w4_suffix as k6
from audio_flamingo_tpu_torch.ops.kernels import w4a16_matmul as k5

torch.set_num_threads(2)

# the 7B int4 LM's products (packed K/2, N), group 128
SHAPES_7B = [(1792, 4608), (1792, 3584), (1792, 37888), (9472, 3584), (1792, 152064)]


@pytest.mark.parametrize("kp,n", SHAPES_7B)
@pytest.mark.parametrize("m", [1, 3, 8, 16, 40, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k5_plan_splits_k_in_whole_groups(kp, n, m, dtype):
    group = 128
    groups = kp // group
    splits = k5.plan(m, kp, n, group, dtype)
    per = -(-groups // splits)
    assert 1 <= splits <= groups
    assert per * (splits - 1) < groups <= per * splits      # no split is empty
    rows = k5.rows_per_block(m, dtype)
    cols = -(-n // k5.BLOCK_N) * -(-m // rows)               # blocks of one split
    want = min(groups, max(1, -(-k5.TARGET_BLOCKS // cols)))  # about four blocks per SM
    assert splits <= want and splits == -(-groups // -(-groups // want))
    if want == groups:
        assert per == 1                                      # every group its own split


def test_k5_rows_per_block():
    bf16 = [k5.rows_per_block(m, torch.bfloat16) for m in (1, 8, 9, 16, 17, 32, 33, 256)]
    f32 = [k5.rows_per_block(m, torch.float32) for m in (1, 2, 3, 4, 5, 8, 9, 32, 256)]
    assert bf16 == [8, 8, 16, 16, 32, 32, 32, 32]
    assert f32 == [1, 2, 4, 4, 8, 8, 32, 32, 32]


@pytest.mark.parametrize("n,group,ok", [(4608, 128, True), (152064, 128, True), (48, 32, True),
                                        (40, 128, False), (4608, 48, False), (4608, 1024, False),
                                        (4608, 512, True)])
def test_k5_supported_shapes(n, group, ok):
    assert k5.supported(n, group) is ok


def test_k5_aligned_copies_only_a_misaligned_start():
    x = torch.randn(4, 64)
    assert k5.aligned(x) is x
    view = torch.randn(4 * 64 + 1)[1:].view(4, 64)      # starts 4 bytes past an allocation
    assert view.data_ptr() % 16 != 0
    fixed = k5.aligned(view)
    assert fixed.data_ptr() % 16 == 0 and torch.equal(fixed, view)


def test_k5_and_k6_refuse_cpu_launches_and_never_load_the_library(monkeypatch):
    def no_library(*a, **k):
        raise AssertionError("the kernel library was loaded for CPU tensors")

    monkeypatch.setattr(_build, "load_library", no_library)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 256)).astype(np.float32))
    w_p = torch.from_numpy(rng.integers(-128, 128, size=(128, 48), dtype=np.int8))
    gscale = torch.from_numpy(rng.random((2, 48)).astype(np.float32))
    y = k5.w4a16_matmul(x, w_p, gscale)                   # the plain version
    torch.testing.assert_close(y, k5.w4a16_matmul_reference(x, w_p, gscale))
    with pytest.raises(ValueError, match="runs on cuda"):
        k5._launch(x, w_p, gscale, None, 128, 48, 128)
    with pytest.raises(ValueError, match="run on cuda"):
        k6._prepare(x, (128, 128), ((128, 48), (128, 48)))


# ------------------------------------------------------------------ enc_mlp

D, F = 256, 512   # enc_mlp's kernel takes d and f_tile in whole 256-column passes


def _qw(rng, a, b):
    w = rng.normal(size=(a, b)) * 0.3
    scale = np.maximum(np.abs(w).max(axis=0), 1e-8) / 127.0
    return np.clip(np.round(w / scale), -127, 127).astype(np.int8), scale.astype(np.float32)


@pytest.mark.parametrize("lead", [(), (3,)])
def test_mlp_kmajor_is_the_transpose(lead):
    rng = np.random.default_rng(1)
    w1 = torch.from_numpy(rng.integers(-127, 128, size=(*lead, D, F), dtype=np.int8))
    w2 = torch.from_numpy(rng.integers(-127, 128, size=(*lead, F, D), dtype=np.int8))
    w1_t, w2_t = ef.mlp_kmajor(w1, w2)
    assert w1_t.shape == (*lead, F, D) and w2_t.shape == (*lead, D, F)
    assert w1_t.is_contiguous() and w2_t.is_contiguous()
    assert w1_t.dtype == w2_t.dtype == torch.int8
    assert torch.equal(w1_t, w1.transpose(-2, -1)) and torch.equal(w2_t, w2.transpose(-2, -1))


@pytest.mark.parametrize("d,ft,ok", [(1280, 2560, True), (768, 1536, True), (1024, 2048, True),
                                     (384, 1536, False), (1280, 2000, False), (64, 128, False)])
def test_mlp_supported_shapes(d, ft, ok):
    assert ef.mlp_supported(d, ft) is ok


@pytest.mark.parametrize("f_tile", [64, 128])
def test_mlp_plain_version_reads_the_jax_layout_with_or_without_copies(f_tile):
    # the CPU takes the plain version, so any width does; tests/test_torch_enc_fused.py's
    # widths and band (JAX's jitted division may move a row scale by an ulp)
    d, f = 64, 128
    rng = np.random.default_rng(2)
    m = 70
    hq, hs = ef.quant_rows(torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32)))
    w1, s1 = _qw(rng, d, f)
    w2, s2 = _qw(rng, f, d)
    b1 = (rng.normal(size=f) * 0.05).astype(np.float32)
    b2 = (rng.normal(size=d) * 0.05).astype(np.float32)
    x2 = rng.normal(size=(m, d)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (w1, s1, b1, w2, s2, b2, x2)]
    plain = ef.enc_mlp(hq, hs, *args, f_tile=f_tile)
    with_copies = ef.enc_mlp(hq, hs, *args, f_tile=f_tile,
                             kmajor=ef.mlp_kmajor(args[0], args[3]))
    assert torch.equal(plain, with_copies)
    want = jef.enc_mlp(jnp.asarray(hq.numpy()), jnp.asarray(hs.numpy()),
                       *(jnp.asarray(a) for a in (w1, s1, b1, w2, s2, b2, x2)),
                       block_m=32, f_tile=f_tile)
    want = np.asarray(want, np.float32)
    near = np.abs(plain.numpy() - want) <= 1e-6 * np.abs(want) + 1e-7
    assert near.mean() >= 0.99, near.mean()
    np.testing.assert_allclose(plain.numpy(), want, rtol=2e-2, atol=1e-2)


def _fused_encoder(cfg):
    torch.manual_seed(0)
    enc = whisper_encoder.WhisperEncoder(cfg)
    with torch.no_grad():
        for p in enc.parameters():
            p.uniform_(-0.1, 0.1)
    return enc


def test_attached_kmajor_copies_stay_out_of_the_state_dict_and_follow_the_tree():
    cfg = dataclasses.replace(C.AF3Config.tiny().encoder, fused_stages=("qkv", "out", "mlp"))
    enc = whisper_encoder.quantize(_fused_encoder(cfg), cfg, fused=True)
    before = dict(enc.state_dict())
    assert "w_t" not in enc.layers["fc1"]                 # a CPU encoder holds no copies
    ef.attach_mlp_kmajor(enc.layers)
    for name in ("fc1", "fc2"):
        node = enc.layers[name]
        assert "w_t" in node
        assert torch.equal(node["w_t"], node["w_q"].transpose(-2, -1))
    assert enc.state_dict().keys() == before.keys()
    for k, v in before.items():
        assert torch.equal(enc.state_dict()[k], v), k
    moved = enc.to(torch.float64)                          # buffers follow .to()
    assert moved.layers["fc1"]["w_t"].dtype == torch.int8


def test_encoder_output_unchanged_by_the_kmajor_copies():
    cfg = dataclasses.replace(C.AF3Config.tiny().encoder, fused_stages=("qkv", "out", "mlp"))
    enc = whisper_encoder.quantize(_fused_encoder(cfg), cfg, fused=True)
    rng = np.random.default_rng(3)
    mels = torch.from_numpy(rng.normal(size=(1, 2 * cfg.max_source_positions,
                                             cfg.num_mel_bins)).astype(np.float32))
    with torch.inference_mode():
        want = whisper_encoder.apply(enc, cfg, mels)
    ef.attach_mlp_kmajor(enc.layers)
    with torch.inference_mode():
        got = whisper_encoder.apply(enc, cfg, mels)
    assert torch.equal(got, want)


def test_quantized_tree_keys_match_jax_layout_names():
    # the fused quantizer's tree (what the JAX layout holds) carries no K-major copy
    cfg = C.AF3Config.tiny().encoder
    state = _fused_encoder(cfg).state_dict()
    tree = quant.quantize_encoder_params_fused(state, cfg.head_dim)
    assert not any(k.endswith("w_t") for k in qwen2.flatten(tree))


def test_quantize_linear_w4_gives_contiguous_codes_for_a_transposed_weight():
    # K5 reads w_p row-major; a transposed Linear weight must not leave the codes
    # strided (the wrapper would then copy them on every call)
    from audio_flamingo_tpu_torch.ops.quant4 import quantize_linear_w4

    rng = np.random.default_rng(4)
    w = torch.from_numpy(rng.normal(size=(96, 512)).astype(np.float32))
    got = quantize_linear_w4(w.t())
    want = quantize_linear_w4(w.t().contiguous())
    for key in ("w_p", "gscale"):
        assert got[key].is_contiguous(), key
        assert torch.equal(got[key], want[key]), key
