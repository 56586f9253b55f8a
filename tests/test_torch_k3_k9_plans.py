"""Host code around the redesigned paged-attention decode (K3) and the K9 stages enc_ln_qkv
and enc_out_ln: K3's split of a row's table into parts and its f32 scratch layout (as the
CUDA source lays it out), the part-order merge of the plain version's per-part triples
against the unsplit plain version, and K9's K-major weight copies (equal to the transposed
codes, made once per encoder, handed to the wrappers) and the widths its kernels take.
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from audio_flamingo_tpu_torch import config as C
from audio_flamingo_tpu_torch.models import whisper_encoder
from audio_flamingo_tpu_torch.ops.kernels import _build
from audio_flamingo_tpu_torch.ops.kernels import enc_fused as ef
from audio_flamingo_tpu_torch.ops.kernels import paged_attention as pa

torch.set_num_threads(2)

F32_TOL = 1e-5                 # chip_smoke's K3 f32 limit (o/l to max|plain|, m and l relative)
BF16_TOL = (2.0 ** -7, 1e-3)   # chip_smoke's K3 bf16 limit on o/l


def _csrc_constant(source: str, name: str) -> int:
    with open(os.path.join(_build.CSRC, source)) as f:
        m = re.search(rf"constexpr (?:int|size_t) {name} = (\d+);", f.read())
    assert m, f"{name} not in {source}"
    return int(m.group(1))


# ------------------------------------------------------------------ K3: parts and scratch

def test_k3_constants_match_the_source():
    assert _csrc_constant("paged_attention.cu", "kC") == pa.KEYS_PER_STEP
    assert (_csrc_constant("paged_attention.cu", "kHDMin"),
            _csrc_constant("paged_attention.cu", "kHDMax")) == pa.KERNEL_HEAD_DIMS
    assert _csrc_constant("paged_attention.cu", "kMaxG") == pa.KERNEL_MAX_GROUP


def test_k3_plan_at_the_engine_shape():
    # 8a and the serving engine: B 4, nkv 4, g 7, hd 128, 128-token pages, 32 table entries,
    # on 132 SMs at 3 blocks an SM (attend_kernel's occupancy for bf16 over bf16 on an H100,
    # csrc header): 2 pages a part, 16 parts
    parts = pa.parts_for(4, 4, 32, 132, 3)
    assert parts == 16
    pl = pa.plan(4, 4, 7, 128, 128, 32, parts)
    assert (pl.parts, pl.pages_per_part, pl.steps_per_page) == (16, 2, 2)
    bkg = 4 * 4 * 7
    assert pl.scores == bkg * 32 * 2 * 64
    assert pl.pmax == bkg * 32
    assert pl.part_o == bkg * 16 * 128 and pl.part_ml == bkg * 16
    # the C side's requirement: B nkv g (MP ceil(BS / 64) 64 + MP + parts (hd + 2)), the
    # page maxima rounded up to 4 floats
    assert pl.floats == bkg * (32 * 2 * 64 + 32 + 16 * (128 + 2))
    assert pl.floats * 4 < 4 * 2 ** 20   # under 4 MB a call


@pytest.mark.parametrize("b,nkv,mp,sms,bps,want", [
    (4, 4, 32, 132, 3, 16),     # the engine's rows: 2 pages a part
    (4, 4, 1, 132, 3, 1),       # one page: one part
    (1, 1, 32, 132, 3, 32),     # a lone (row, kv head): every entry its own part, parts = MP
    (64, 8, 32, 132, 3, 1),     # B x nkv x MP already fills the card: one part per row
    (8, 4, 32, 132, 1, 4),      # f32 pools: one block an SM, 8 pages a part
    (4, 4, 32, 132, 4, 32),     # 4 blocks an SM: one page a part
])
def test_k3_parts_follow_the_occupancy(b, nkv, mp, sms, bps, want):
    parts = pa.parts_for(b, nkv, mp, sms, bps)
    assert parts == want
    per = -(-mp // parts)
    assert -(-mp // per) == parts                      # whole entries a part, none empty


@pytest.mark.parametrize("mp,parts,per,rounded", [(32, 12, 3, 11), (32, 32, 1, 32),
                                                  (5, 2, 3, 2), (1, 1, 1, 1), (7, 7, 1, 7)])
def test_k3_plan_rounds_to_whole_entries(mp, parts, per, rounded):
    pl = pa.plan(2, 2, 4, 128, 16, mp, parts)
    assert (pl.pages_per_part, pl.parts) == (per, rounded)
    assert pl.steps_per_page == 1                      # 16-token pages: one 64-key step


@pytest.mark.parametrize("b,nkv,g,mp", [(1, 1, 7, 5), (3, 2, 3, 7), (4, 4, 7, 32)])
def test_k3_scratch_keeps_the_parts_o_16_byte_aligned(b, nkv, g, mp):
    pl = pa.plan(b, nkv, g, 128, 128, mp, 1)
    assert pl.pmax % 4 == 0 and b * nkv * g * mp <= pl.pmax < b * nkv * g * mp + 4
    assert (pl.scores + pl.pmax) % 4 == 0 and pl.part_o % 4 == 0


@pytest.mark.parametrize("parts", [0, 33])
def test_k3_plan_refuses_parts_outside_the_table(parts):
    with pytest.raises(ValueError, match="parts"):
        pa.plan(4, 4, 7, 128, 128, 32, parts)


def _paged_case(q_dtype, kv_dtype, lengths, bs=16, mp=6, seed=0):
    rng = np.random.default_rng(seed)
    n_layers, nb, nkv, g, hd = 2, 40, 2, 3, 128
    b = len(lengths)
    shape = (n_layers, nb, bs, nkv, hd)
    if kv_dtype == torch.int8:
        k = torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))
        v = torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))
        ks = torch.from_numpy((rng.random(shape[:-1]) * 0.018 + 0.002).astype(np.float32))
        vs = torch.from_numpy((rng.random(shape[:-1]) * 0.018 + 0.002).astype(np.float32))
    else:
        k = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(kv_dtype)
        v = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(kv_dtype)
        ks = vs = None
    # peaked rows: a few heavy keys move the running max from page to page
    q = torch.from_numpy((2.0 * rng.normal(size=(b, nkv, g, hd))).astype(np.float32)).to(q_dtype)
    tables = torch.full((b, mp), -1, dtype=torch.int32)
    perm = rng.permutation(nb - 1) + 1
    ptr = 0
    for row, n in enumerate(lengths):
        pages = -(-n // bs)
        tables[row, :pages] = torch.from_numpy(perm[ptr:ptr + pages].astype(np.int32))
        ptr += pages
    return q, k, v, tables, torch.tensor(lengths, dtype=torch.int32), ks, vs


PAIRS = [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
         (torch.float32, torch.int8), (torch.bfloat16, torch.bfloat16),
         (torch.bfloat16, torch.int8)]


@pytest.mark.parametrize("q_dtype,kv_dtype", PAIRS)
@pytest.mark.parametrize("per", [1, 2, 4, 6])
def test_k3_part_order_merge_equals_the_unsplit_plain_version(q_dtype, kv_dtype, per):
    # rows: partial pages, a full table, one token, an empty row
    q, k, v, tables, lengths, ks, vs = _paged_case(q_dtype, kv_dtype, [37, 96, 1, 0])
    o, m, l = pa.paged_attention_plain(q, k, v, tables, lengths, 1, k_scale=ks, v_scale=vs)
    parts = pa.paged_attention_parts_plain(q, k, v, tables, lengths, 1, pages_per_part=per,
                                           k_scale=ks, v_scale=vs)
    assert parts[0].shape == (4, 2, -(-6 // per), 3, 128)
    o2, m2, l2 = pa.merge_parts(*parts)
    if per == tables.shape[1]:                         # one part: the plain version's values
        for a, b in ((o2, o), (m2, m), (l2, l)):
            assert torch.equal(a, b)
    keys = lengths > 0
    assert torch.equal(m2[keys], m[keys])              # the prefix maxima are exact
    assert ((l2 - l).abs() / l.clamp(min=1e-30))[keys].max() <= F32_TOL
    out, out2 = o / l.clamp(min=1e-30)[..., None], o2 / l2.clamp(min=1e-30)[..., None]
    diff = (out2 - out)[keys].abs()
    if q_dtype == torch.float32:
        assert diff.max() <= F32_TOL * out[keys].abs().max()
    else:
        assert (diff <= BF16_TOL[0] * out[keys].abs() + BF16_TOL[1]).all()
    empty = ~keys                                      # no key: exactly (0, NEG_INF, 0)
    assert (o2[empty] == 0).all() and (l2[empty] == 0).all()
    assert (m2[empty] == pa.NEG_INF).all()


def test_k3_parts_start_from_the_running_max_of_the_pages_before_them():
    q, k, v, tables, lengths, ks, vs = _paged_case(torch.float32, torch.float32, [96, 40])
    o_s, m_s, l_s = pa.paged_attention_parts_plain(q, k, v, tables, lengths, 0,
                                                   pages_per_part=2)
    # a part's m is the running max after its last page: non-decreasing over live parts
    assert (m_s[0, :, 1:] >= m_s[0, :, :-1]).all()
    # row 1 has 3 pages: parts 0 and 1 live, part 2 empty (0, NEG_INF, 0)
    assert (m_s[1, :, 2] == pa.NEG_INF).all() and (l_s[1, :, 2] == 0).all()
    assert (o_s[1, :, 2] == 0).all()
    assert (l_s[1, :, :2] > 0).all()


def test_k3_merge_is_in_part_order():
    # merge_parts adds the weighted parts one after the other, part 0 first: the same
    # sums whatever order the parts' blocks finished in, since the kernel's merge reads
    # them from the scratch in part order
    rng = np.random.default_rng(5)
    o_s = torch.from_numpy(rng.normal(size=(1, 1, 5, 2, 128)).astype(np.float32))
    m_s = torch.from_numpy(rng.normal(size=(1, 1, 5, 2)).astype(np.float32))
    l_s = torch.from_numpy(rng.random(size=(1, 1, 5, 2)).astype(np.float32))
    o, m, l = pa.merge_parts(o_s, m_s, l_s)
    acc_o, acc_l = torch.zeros_like(o), torch.zeros_like(l)
    for s in range(5):
        w = torch.exp(m_s[:, :, s] - m)
        acc_o = acc_o + o_s[:, :, s] * w[..., None]
        acc_l = acc_l + l_s[:, :, s] * w
    assert torch.equal(o, acc_o) and torch.equal(l, acc_l)
    assert torch.equal(m, m_s.amax(dim=2))


# ------------------------------------------------------------------ K9: copies and widths

def test_k9_constants_match_the_source():
    assert _csrc_constant("enc_fused.cu", "kMlpNC") == ef.MLP_BLOCK_N
    assert _csrc_constant("enc_fused.cu", "kRegD") == ef.MAX_WIDTH


@pytest.mark.parametrize("d,n,want", [
    (1280, 3840, True),        # Whisper-large's encoder, q|k|v
    (64, 128, True),           # the narrowest
    (2048, 6144, True),        # the widest row the registers hold
    (2112, 6336, False),       # past it
    (1280, 3904, False),       # N not a multiple of 128
    (1312, 3840, False),       # d not a multiple of 64
])
def test_k9_ln_qkv_widths(d, n, want):
    assert ef.qkv_supported(d, n) is want


@pytest.mark.parametrize("d,want", [(1280, True), (128, True), (2048, True), (2176, False),
                                    (1344, False), (0, False)])
def test_k9_out_ln_widths(d, want):
    assert ef.out_supported(d) is want


@pytest.mark.parametrize("lead", [(), (3,)])
@pytest.mark.parametrize("shape", [(64, 192), (1280, 3840), (1280, 1280)])
def test_k9_kmajor_is_the_transpose(lead, shape):
    rng = np.random.default_rng(6)
    w = torch.from_numpy(rng.integers(-127, 128, size=(*lead, *shape), dtype=np.int8))
    w_t = ef.kmajor(w)
    assert w_t.shape == (*lead, shape[1], shape[0]) and w_t.is_contiguous()
    assert w_t.dtype == torch.int8
    assert torch.equal(w_t, w.transpose(-2, -1))


def test_k9_wrappers_take_a_given_copy_and_refuse_a_wrong_one():
    rng = np.random.default_rng(7)
    w = torch.from_numpy(rng.integers(-127, 128, size=(64, 192), dtype=np.int8))
    given = ef.kmajor(w)
    assert ef._kmajor_for("enc_ln_qkv", w, given) is given
    made = ef._kmajor_for("enc_ln_qkv", w, None)
    assert torch.equal(made, given) and made is not given
    with pytest.raises(ValueError, match="K-major copy"):
        ef._kmajor_for("enc_out_ln", w, w)              # the JAX layout, not its transpose
    with pytest.raises(ValueError, match="K-major copy"):
        ef._kmajor_for("enc_out_ln", w, given.float())


def _fused_encoder(cfg):
    torch.manual_seed(0)
    enc = whisper_encoder.WhisperEncoder(cfg)
    with torch.no_grad():
        for p in enc.parameters():
            p.uniform_(-0.1, 0.1)
    return enc


def test_k9_copies_attached_once_stay_out_of_the_state_dict():
    cfg = dataclasses.replace(C.AF3Config.tiny().encoder, fused_stages=("qkv", "out", "mlp"))
    enc = whisper_encoder.quantize(_fused_encoder(cfg), cfg, fused=True)
    before = dict(enc.state_dict())
    assert not any("w_t" in enc.layers[n] for n in ("qkv", "o", "fc1", "fc2"))   # CPU: none
    ef.attach_kmajor(enc.layers)
    for name in ("qkv", "o", "fc1", "fc2"):
        node = enc.layers[name]
        assert torch.equal(node["w_t"], node["w_q"].transpose(-2, -1))
    assert enc.state_dict().keys() == before.keys()
    moved = enc.to(torch.float64)                      # buffers follow .to()
    assert moved.layers["qkv"]["w_t"].dtype == torch.int8


def test_k9_stages_hand_the_attached_copies_to_the_wrappers(monkeypatch):
    # every call of a forward gets the tree's own copies (views of the attached buffers),
    # the same storage in every call: made once per encoder, not per call
    cfg = dataclasses.replace(C.AF3Config.tiny().encoder, fused_stages=("qkv", "out", "mlp"))
    enc = whisper_encoder.quantize(_fused_encoder(cfg), cfg, fused=True)
    ef.attach_kmajor(enc.layers)
    seen = []

    def recorder(name, real, key):
        def call(*args, **kw):
            copies = kw[key] if isinstance(kw[key], tuple) else (kw[key],)
            seen.append((name, [c.untyped_storage().data_ptr() for c in copies]))
            return real(*args, **kw)
        return call

    monkeypatch.setattr(ef, "enc_ln_qkv", recorder("qkv", ef.enc_ln_qkv, "w_t"))
    monkeypatch.setattr(ef, "enc_out_ln", recorder("o", ef.enc_out_ln, "w_t"))
    monkeypatch.setattr(ef, "enc_mlp", recorder("fc", ef.enc_mlp, "kmajor"))
    made = []
    real_kmajor = ef.kmajor
    monkeypatch.setattr(ef, "kmajor", lambda w: made.append(1) or real_kmajor(w))
    rng = np.random.default_rng(8)
    mels = torch.from_numpy(rng.normal(size=(1, 2 * cfg.max_source_positions,
                                             cfg.num_mel_bins)).astype(np.float32))
    with torch.inference_mode():
        first = whisper_encoder.apply(enc, cfg, mels)
        second = whisper_encoder.apply(enc, cfg, mels)
    assert torch.equal(first, second)
    assert not made                                    # no copy made inside a forward
    layers = enc.layers
    storages = {"qkv": [layers["qkv"]["w_t"].untyped_storage().data_ptr()],
                "o": [layers["o"]["w_t"].untyped_storage().data_ptr()],
                "fc": [layers["fc1"]["w_t"].untyped_storage().data_ptr(),
                       layers["fc2"]["w_t"].untyped_storage().data_ptr()]}
    n_layers = cfg.num_layers
    assert [name for name, _ in seen].count("qkv") == 2 * n_layers
    for name, ptrs in seen:
        assert ptrs == storages[name], name
