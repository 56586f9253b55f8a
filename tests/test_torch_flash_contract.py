"""The contract the flash kernels (K2 forward, K7 backward) share with their plain
versions and their build: the 64-key tile of the online softmax, the rows the bf16
kernels' cp.async copies take, and a build keyed by the shared header as well as the
sources. Pure Python and source text: no nvcc and no card needed."""

import os
import re
import shutil

import numpy as np
import pytest
import torch

from audio_flamingo_tpu_torch.ops.kernels import _build
from audio_flamingo_tpu_torch.ops.kernels import flash_attention as tfa

torch.set_num_threads(2)


def _source(name: str) -> str:
    with open(os.path.join(_build.CSRC, name)) as f:
        return f.read()


def test_library_path_follows_the_shared_header(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    srcs = sorted(str(p) for p in csrc.glob("*.cu"))
    assert (csrc / "flash_mma.cuh").exists()
    before = _build.library_path("libaf_kernels", srcs, _build.NVCC_FLAGS)
    assert before == _build.library_path("libaf_kernels", srcs, _build.NVCC_FLAGS)
    with open(csrc / "flash_mma.cuh", "a") as f:
        f.write("// edited\n")
    after = _build.library_path("libaf_kernels", srcs, _build.NVCC_FLAGS)
    assert after != before
    # only the .cu files go to nvcc; the header comes in through their #include
    assert all(s.endswith(".cu") for s in srcs)
    assert all('#include "flash_mma.cuh"' in _source(n)
               for n in ("flash_attention.cu", "flash_attention_bwd.cu", "flash_attention_a8.cu"))


@pytest.mark.parametrize("source,constant", [
    ("flash_attention.cu", "kMmaKeys"),      # the bf16 tensor-core forward
    ("flash_attention.cu", "kBK"),           # the f32 forward
    ("flash_attention_bwd.cu", "kMmaTile"),  # the bf16 backward's key and q-row tiles
])
def test_kernel_tile_is_kv_tile(source, constant):
    found = re.findall(rf"constexpr int {constant} = (\d+);", _source(source))
    assert found == [str(tfa.KV_TILE)]


def test_plain_bf16_forward_depends_on_the_tile(monkeypatch):
    """p is rounded to bf16 against the running max of KV_TILE-key tiles; on scores whose
    max moves from tile to tile another tile gives another bf16 output, so a kernel with
    another tile would not match the plain version bit for bit."""
    rng = np.random.default_rng(11)
    b, tq, tk, h, d = 1, 32, 256, 2, 64
    q = torch.from_numpy(rng.normal(size=(b, tq, h, d)).astype(np.float32) * 0.5)
    # keys whose scores drift up along the sequence: the running max moves every tile
    k = rng.normal(size=(b, tk, h, d)).astype(np.float32)
    k += np.linspace(0.0, 1.5, tk, dtype=np.float32)[None, :, None, None] * q.numpy().mean(1,
                                                                                  keepdims=True)
    q, k = q.bfloat16(), torch.from_numpy(k).bfloat16()
    v = torch.from_numpy(rng.normal(size=(b, tk, h, d)).astype(np.float32)).bfloat16()
    o_tile, lse_tile = tfa.flash_attention_reference(q, k, v)
    monkeypatch.setattr(tfa, "KV_TILE", 2 * tfa.KV_TILE)
    o_other, lse_other = tfa.flash_attention_reference(q, k, v)
    assert not torch.equal(o_tile, o_other)
    # the two agree to bf16 rounding: only the rounding point of p moved
    torch.testing.assert_close(o_tile.float(), o_other.float(), atol=2e-2, rtol=0)
    torch.testing.assert_close(lse_tile, lse_other, atol=1e-5, rtol=0)


@pytest.mark.parametrize("view,aligned", [
    ("contiguous", True),
    ("head_slice", True),      # q of a fused [.., 3 H D] projection: offsets of H D
    ("shifted", False),        # a row that starts 2 bytes past a 16-byte boundary
    ("odd_stride", False),     # a time stride that is not a multiple of 8 elements
])
def test_bf16_rows_aligned_contract(view, aligned):
    base = torch.zeros(2, 16, 3 * 4 * 64 + 8, dtype=torch.bfloat16)
    x = {"contiguous": lambda: torch.zeros(2, 16, 4, 64, dtype=torch.bfloat16),
         "head_slice": lambda: base[..., 256:512].unflatten(-1, (4, 64)),
         "shifted": lambda: base[..., 1:257].unflatten(-1, (4, 64)),
         "odd_stride": lambda: torch.zeros(2, 16, 4 * 64 + 4, dtype=torch.bfloat16)[
             ..., :256].unflatten(-1, (4, 64))}[view]()
    assert x.data_ptr() % 2 == 0
    assert tfa._rows_aligned(x) == aligned


@pytest.mark.parametrize("h,hkv,d", [(4, 4, 64), (8, 2, 128)])
def test_score_sums_plain_is_the_sequential_sum(h, hkv, d):
    """score_sums' layout is reference_scores', and on the CPU both of its sums are the
    f32 sum in order d = 0 .. D - 1 (each bf16 product exact in f32): the fmaf chain by
    which the bf16 forward recomputes scores on the card."""
    rng = np.random.default_rng(5)
    b, tq, tk = 2, 9, 13
    q = torch.from_numpy(rng.normal(size=(b, tq, h, d)).astype(np.float32)).bfloat16()
    k = torch.from_numpy(rng.normal(size=(b, tk, hkv, d)).astype(np.float32)).bfloat16()
    s_mma, s_seq = tfa.score_sums(q, k)
    assert s_mma.shape == s_seq.shape == (b, h, tq, tk)
    qn = q.float().numpy()
    kn = k.float().numpy().repeat(h // hkv, axis=2)
    seq = np.zeros((b, h, tq, tk), np.float32)
    for i in range(d):
        seq = (seq + qn[:, :, :, i].transpose(0, 2, 1)[..., None]
               * kn[:, :, :, i].transpose(0, 2, 1)[:, :, None, :]).astype(np.float32)
    np.testing.assert_array_equal(s_seq.numpy(), seq)
    ref = tfa.reference_scores(q, k)
    torch.testing.assert_close(s_mma.view(ref.shape), ref, atol=1e-5, rtol=1e-5)


def test_compiled_library_keeps_its_report(tmp_path, monkeypatch):
    """A cached library returns the compiler's stderr of the build that made it (nvcc's
    ptxas report), and a library without its kept report is built again."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    src = tmp_path / "unit.c"
    src.write_text('#warning "kept report"\nint af_unit(void) { return 7; }\n')
    flags = ("-O1", "-shared", "-fPIC")
    path, seconds, log = _build.compile_library("gcc", flags, [str(src)], "libunit")
    assert seconds is not None and "kept report" in log
    assert _build.compile_library("gcc", flags, [str(src)], "libunit") == (path, None, log)
    os.remove(path + ".log")
    again = _build.compile_library("gcc", flags, [str(src)], "libunit")
    assert again[0] == path and again[1] is not None and "kept report" in again[2]


def test_compiled_library_builds_each_source_then_links(tmp_path, monkeypatch):
    """Every source is compiled by its own process with ``-c`` (started together), then
    one link makes the library; the report holds each source's stderr in order."""
    import ctypes
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    srcs = []
    for name, value in (("one", 1), ("two", 2)):
        src = tmp_path / f"{name}.c"
        src.write_text(f'#warning "from {name}"\nint af_{name}(void) {{ return {value}; }}\n')
        srcs.append(str(src))
    calls = []
    run = _build._run
    monkeypatch.setattr(_build, "_run", lambda cmds: calls.append(cmds) or run(cmds))
    path, seconds, log = _build.compile_library("gcc", ("-O1", "-shared", "-fPIC"), srcs,
                                                "libtwo")
    compiles, links = calls
    assert [cmd[-1] for cmd in compiles] == srcs
    assert all("-c" in cmd and "-shared" not in cmd for cmd in compiles)
    assert len(links) == 1 and "-shared" in links[0]
    assert links[0][-2:] == [cmd[cmd.index("-o") + 1] for cmd in compiles]
    assert log.index("from one") < log.index("from two")
    lib = ctypes.CDLL(path)
    assert (lib.af_one(), lib.af_two()) == (1, 2)
    assert not [p for p in os.listdir(tmp_path / "build") if p.endswith(".o")]
