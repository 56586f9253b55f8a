"""w8a16 matmul (K4): the hand-written Hopper kernel and its plain PyTorch version.

Replaces the Pallas TPU kernel ``audio_flamingo_tpu/ops/pallas/quant_matmul.py``
``w8a16_matmul`` (:44): ``(x [m, K] @ int8 w_q [K, N]) * scale [N]``, accumulated in f32
over all of K, scaled in f32 and rounded once to ``out_dtype`` (x's dtype by default; the
LM head asks for f32 from a bf16 x). One CUDA kernel (``csrc/w8a16_matmul.cu``) takes
the codes in two layouts, told apart by their strides: JAX's row-major ``[K, N]`` (a
layer of a stacked ``[L, K, N]`` tensor is the view ``w_q[layer]``, read in place at its
pointer offset) and the transposed view ``[N, K].t()`` of a tied int8 embedding, read
without a copy. Unlike JAX's kernel it has no block-shape limits: it takes any m, K and
N its loads are aligned for (layout [K, N]: N % 4 == 0; layout [N, K]: K % 16 == 0) and
raises on the rest. Its header states the design and what bounds it on the H100 (the
weight bytes).

Dispatch is by the tensors' device: a CPU tensor goes to the plain version; a CUDA tensor
launches the kernel or raises. There is no fallback between the two.
"""

from __future__ import annotations

import torch

from audio_flamingo_tpu_torch.ops.kernels import _build
from audio_flamingo_tpu_torch.ops.kernels.launches import LaunchCounter

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
BLOCK_N = 512          # columns per block of the [K, N] layout (csrc kBN)
ROW_TILE = 8           # rows of x per block (csrc MT); more rows tile the grid
SPLIT_UNIT = 32        # K rows per split are a multiple of this (csrc kSplitUnit)
TARGET_BLOCKS = 1056   # split K until the grid has about eight blocks per SM (132 SMs)

LAUNCHES = LaunchCounter()   # key: (m, K, N, layout); inputs: (x, w_q, scale, out_dtype)


def w8a16_matmul_reference(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                           out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain version of the kernel: the f32 product of x and the widened codes (exact
    products: codes and bf16 inputs are exact in f32), times the f32 scale, rounded once
    to ``out_dtype`` (default x.dtype)."""
    return ((x.float() @ w_q.float()) * scale.float()).to(out_dtype or x.dtype)


def layout_of(w_q: torch.Tensor) -> int:
    """0 for row-major [K, N] codes, 1 for the transposed view of row-major [N, K] codes;
    any other strides raise (the kernel never copies the weights)."""
    if w_q.is_contiguous():
        return 0
    if w_q.t().is_contiguous():
        return 1
    raise ValueError(f"w_q {tuple(w_q.shape)} with strides {w_q.stride()} is neither "
                     f"row-major [K, N] nor the transpose of a row-major [N, K]")


def check_operands(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                   out_dtype: torch.dtype) -> None:
    if x.ndim != 2 or w_q.ndim != 2 or scale.ndim != 1:
        raise ValueError(f"expected x [m, K], w_q [K, N], scale [N]; got {tuple(x.shape)}, "
                         f"{tuple(w_q.shape)}, {tuple(scale.shape)}")
    if x.shape[1] != w_q.shape[0] or scale.shape[0] != w_q.shape[1]:
        raise ValueError(f"x {tuple(x.shape)}, w_q {tuple(w_q.shape)} and scale "
                         f"{tuple(scale.shape)} do not agree")
    if (x.dtype not in DTYPE_CODES or out_dtype not in DTYPE_CODES
            or w_q.dtype != torch.int8 or scale.dtype != torch.float32):
        raise TypeError(f"expected x and out float32/bfloat16, w_q int8, scale float32; got "
                        f"{x.dtype}, {out_dtype}, {w_q.dtype}, {scale.dtype}")
    if len({x.device, w_q.device, scale.device}) != 1:
        raise ValueError(f"operands on different devices: {x.device}, {w_q.device}, "
                         f"{scale.device}")
    if x.shape[0] == 0:
        raise ValueError("x has no rows")


def split_k(k: int, n: int, m: int) -> int:
    """K rows per split of the [K, N] layout: enough blocks to fill the card, each split
    a whole number of SPLIT_UNIT rows, the splits of nearly equal size."""
    units = -(-k // SPLIT_UNIT)
    blocks = -(-n // BLOCK_N) * -(-m // ROW_TILE)
    want = min(units, max(1, -(-TARGET_BLOCKS // blocks)))
    return -(-units // want) * SPLIT_UNIT


def _launch(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
            out_dtype: torch.dtype) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"w8a16_matmul runs on cuda (kernel) or cpu (reference), "
                         f"not {x.device}")
    layout = layout_of(w_q)
    (m, k), n = x.shape, w_q.shape[1]
    if layout == 0 and (n % 4 or w_q.data_ptr() % 4):
        raise ValueError(f"the [K, N] layout needs N % 4 == 0 and 4-byte aligned codes "
                         f"(N = {n}, address % 4 = {w_q.data_ptr() % 4})")
    if layout == 1 and (k % 16 or w_q.data_ptr() % 16):
        raise ValueError(f"the [N, K] layout needs K % 16 == 0 and 16-byte aligned codes "
                         f"(K = {k}, address % 16 = {w_q.data_ptr() % 16})")
    if not scale.is_contiguous():
        raise ValueError("scale must be contiguous")
    x = x.contiguous()
    rows = split_k(k, n, m) if layout == 0 else k
    splits = -(-k // rows)
    lib = _build.load_library()   # builds csrc/*.cu on first use
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        start = LAUNCHES.start(x.device)
        partials = (None if splits == 1 else
                    torch.empty((splits, m, n), dtype=torch.float32, device=x.device))
        err = lib.af_w8a16_matmul(x.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
                                  out.data_ptr(), 0 if partials is None else partials.data_ptr(),
                                  DTYPE_CODES[x.dtype], DTYPE_CODES[out_dtype], layout, m, k, n,
                                  rows, splits, stream)
    if err != 0:
        raise RuntimeError(f"w8a16_matmul kernel launch failed with CUDA error {err}")
    LAUNCHES.record((m, k, n, layout), x.device, start, (x, w_q, scale, out_dtype))
    return out


def w8a16_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """x [m, K] f32/bf16, w_q int8 [K, N] (row-major, or the transposed view of a row-major
    [N, K]), scale [N] f32 -> [m, N] in ``out_dtype`` (default x.dtype)."""
    out_dtype = out_dtype or x.dtype
    check_operands(x, w_q, scale, out_dtype)
    if x.device.type == "cpu":
        return w8a16_matmul_reference(x, w_q, scale, out_dtype)
    return _launch(x, w_q, scale, out_dtype)
