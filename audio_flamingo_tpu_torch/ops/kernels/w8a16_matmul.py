"""w8a16 matmul (K4): the hand-written Hopper kernel and its plain PyTorch version.

Replaces the Pallas TPU kernel ``audio_flamingo_tpu/ops/pallas/quant_matmul.py``
``w8a16_matmul`` (:44): ``(x [m, K] @ int8 w_q [K, N]) * scale [N]``, accumulated in f32
over all of K, scaled in f32 and rounded once to ``out_dtype`` (x's dtype by default; the
LM head asks for f32 from a bf16 x). The CUDA source is ``csrc/w8a16_matmul.cu``; its
header states the design and what bounds it on the H100 (the weight bytes). The codes
come in two layouts, told apart by their strides: JAX's row-major ``[K, N]`` (a layer of
a stacked ``[L, K, N]`` tensor is the view ``w_q[layer]``, read in place at its pointer
offset; a cp.async ring of code tiles, bf16 x on the tensor cores, f32 x on the CUDA
cores, K split as ``split_k`` says with the last split of a tile adding the partial sums)
and the transposed view ``[N, K].t()`` of a tied int8 embedding, read without a copy.

``w8a16_matmul_group(x, [p, ...])`` multiplies one x with up to ``MAX_PRODUCTS``
products of the ``[K, N]`` layout in one launch (q|k|v, gate|up), each read in place from
its own codes and scales, into one output whose column ranges it returns as views. What
depends on the weights alone (layout, alignment, the split plan, the products' column
offsets) is worked out once per (weights, rows, dtypes) and cached (``_group_plan``), so a
call pays only for x's checks, the output's allocation and the launch. The CUDA kernels
take N % 16 == 0, K % 32 == 0 and 16-byte aligned codes in the ``[K, N]`` layout and K % 16
== 0 in the ``[N, K]`` one (``supported``); a CUDA call outside them raises.

Dispatch is by the tensors' device: a CPU tensor goes to the plain version; a CUDA tensor
launches the kernel or raises. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from audio_flamingo_tpu_torch.ops.kernels import _build
from audio_flamingo_tpu_torch.ops.kernels.launches import LaunchCounter
from audio_flamingo_tpu_torch.ops.kernels.w4a16_matmul import aligned

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
BLOCK_N = 128          # columns per block of the [K, N] layout (csrc kBN)
STAGE_ROWS = 32        # K rows per ring stage (kRows): K is split in whole stages
MAX_PRODUCTS = 4       # products per grouped launch (kMaxProducts)
TARGET_BLOCKS = 264    # split K until the grid has about two blocks per SM (132 SMs)
COUNTERS = 4096        # split tiles one launch may have (one int counter each)

# key: (m, K, (N, ...), layout); inputs: (x, ((w_q, scale), ...), out_dtype)
LAUNCHES = LaunchCounter()


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


def supported(w_q: torch.Tensor, layout: int) -> str | None:
    """Why the CUDA kernels do not take these codes, or None if they do."""
    k, n = w_q.shape
    if layout == 0 and (n % 16 or k % STAGE_ROWS or w_q.data_ptr() % 16):
        return (f"the [K, N] layout needs N % 16 == 0, K % {STAGE_ROWS} == 0 and 16-byte "
                f"aligned codes (K = {k}, N = {n}, address % 16 = {w_q.data_ptr() % 16})")
    if layout == 1 and (k % 16 or w_q.data_ptr() % 16):
        return (f"the [N, K] layout needs K % 16 == 0 and 16-byte aligned codes "
                f"(K = {k}, address % 16 = {w_q.data_ptr() % 16})")
    return None


def rows_per_block(m: int, dtype: torch.dtype) -> int:
    """Rows of x one block holds (more rows tile over grid.z): bf16 on the tensor cores 8,
    16 or 32; f32 on the CUDA cores 1, 2, 4 or 8."""
    if dtype == torch.bfloat16:
        return 8 if m <= 8 else 16 if m <= 16 else 32
    return next(r for r in (1, 2, 4, 8) if m <= r or r == 8)


def split_k(k: int, n, m: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """K rows per split of one launch over N columns (or over the products' columns, a
    tuple): enough blocks to fill the card, each split a whole number of STAGE_ROWS-row
    stages, the splits of nearly equal size (the last may be shorter, never empty)."""
    ns = (n,) if isinstance(n, int) else tuple(n)
    units = -(-k // STAGE_ROWS)
    blocks = sum(-(-n_i // BLOCK_N) for n_i in ns) * -(-m // rows_per_block(m, dtype))
    want = min(units, max(1, -(-TARGET_BLOCKS // blocks)))
    return -(-units // want) * STAGE_ROWS


@dataclass(frozen=True)
class _GroupPlan:
    """What a grouped launch needs that depends only on the weights, the rows and the
    dtypes: each product's N and first output column, the total columns, the split of
    K, and the weights' pointers in the order of the C table."""

    ns: tuple
    col0: tuple
    ldo: int
    rows_per_split: int
    splits: int
    ptrs: tuple            # ((w_q pointer, scale pointer), ...)


_PLANS: dict = {}
_COUNTERS: dict = {}


def _group_plan(x: torch.Tensor, prods, out_dtype: torch.dtype) -> _GroupPlan:
    key = (x.device, x.dtype, out_dtype, tuple(x.shape),
           tuple((w.data_ptr(), w.dtype, tuple(w.shape), w.stride(), s.data_ptr(), s.dtype,
                  tuple(s.shape), s.stride()) for w, s in prods))
    pl = _PLANS.get(key)
    if pl is not None:
        return pl
    if not 1 <= len(prods) <= MAX_PRODUCTS:
        raise ValueError(f"a grouped launch takes 1 to {MAX_PRODUCTS} products, got "
                         f"{len(prods)}")
    ns, col0, ptrs = [], [], []
    for w, s in prods:
        check_operands(x, w, s, out_dtype)
        if layout_of(w) != 0:
            raise ValueError("a grouped launch reads row-major [K, N] codes")
        why = supported(w, 0)
        if why:
            raise ValueError(why)
        if not s.is_contiguous() or s.data_ptr() % 8:
            raise ValueError("scale must be contiguous and 8-byte aligned")
        col0.append(sum(ns))
        ns.append(w.shape[1])
        ptrs.append((w.data_ptr(), s.data_ptr()))
    m, k = x.shape
    rows = split_k(k, ns, m, x.dtype)
    splits = -(-k // rows)
    tiles = sum(-(-n // BLOCK_N) for n in ns) * -(-m // rows_per_block(m, x.dtype))
    if splits > 1 and tiles > COUNTERS:
        raise ValueError(f"{tiles} split tiles exceed the {COUNTERS} counters")
    pl = _GroupPlan(ns=tuple(ns), col0=tuple(col0), ldo=sum(ns), rows_per_split=rows,
                    splits=splits, ptrs=tuple(ptrs))
    if len(_PLANS) >= 4096:
        _PLANS.clear()
    _PLANS[key] = pl
    return pl


def _counters(device: torch.device) -> torch.Tensor:
    """The device's split-tile counters: zero, and left zero by every launch (the last
    split of a tile resets its counter). Launches use them in stream order, so two split
    launches must not run at once on two streams."""
    cnt = _COUNTERS.get(device)
    if cnt is None:
        cnt = _COUNTERS[device] = torch.zeros((COUNTERS,), dtype=torch.int32, device=device)
    return cnt


def _launch_group(x: torch.Tensor, prods, out_dtype: torch.dtype) -> list[torch.Tensor]:
    if x.device.type != "cuda":
        raise ValueError(f"w8a16_matmul runs on cuda (kernel) or cpu (reference), "
                         f"not {x.device}")
    pl = _group_plan(x, prods, out_dtype)
    x = aligned(x.contiguous())
    m, k = x.shape
    lib = _build.load_library()   # builds csrc/*.cu on first use
    out = torch.empty((m, pl.ldo), dtype=out_dtype, device=x.device)
    table = (ctypes.c_int64 * (4 * len(pl.ns)))(*[
        v for (wp, sp), c0, n in zip(pl.ptrs, pl.col0, pl.ns) for v in (wp, sp, c0, n)])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        start = LAUNCHES.start(x.device)
        partials = counters = None
        if pl.splits > 1:
            partials = torch.empty((pl.splits, m, pl.ldo), dtype=torch.float32,
                                   device=x.device)
            counters = _counters(x.device)
        err = lib.af_w8a16_matmul_group(
            x.data_ptr(), ctypes.addressof(table), len(pl.ns), out.data_ptr(),
            0 if partials is None else partials.data_ptr(),
            0 if counters is None else counters.data_ptr(), DTYPE_CODES[x.dtype],
            DTYPE_CODES[out_dtype], m, k, pl.ldo, pl.rows_per_split, pl.splits, stream)
    if err != 0:
        raise RuntimeError(f"w8a16_matmul kernel launch failed with CUDA error {err}")
    LAUNCHES.record((m, k, pl.ns, 0), x.device, start,
                    (x, tuple(prods), out_dtype))
    if len(pl.ns) == 1:
        return [out]
    return [out[:, c0: c0 + n] for c0, n in zip(pl.col0, pl.ns)]


def _launch_nk(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
               out_dtype: torch.dtype) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"w8a16_matmul runs on cuda (kernel) or cpu (reference), "
                         f"not {x.device}")
    why = supported(w_q, 1)
    if why:
        raise ValueError(why)
    if not scale.is_contiguous():
        raise ValueError("scale must be contiguous")
    x = x.contiguous()
    (m, k), n = x.shape, w_q.shape[1]
    lib = _build.load_library()   # builds csrc/*.cu on first use
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        start = LAUNCHES.start(x.device)
        err = lib.af_w8a16_matmul_nk(x.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
                                     out.data_ptr(), DTYPE_CODES[x.dtype],
                                     DTYPE_CODES[out_dtype], m, k, n, stream)
    if err != 0:
        raise RuntimeError(f"w8a16_matmul kernel launch failed with CUDA error {err}")
    LAUNCHES.record((m, k, (n,), 1), x.device, start, (x, ((w_q, scale),), out_dtype))
    return out


def w8a16_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """x [m, K] f32/bf16, w_q int8 [K, N] (row-major, or the transposed view of a row-major
    [N, K]), scale [N] f32 -> [m, N] in ``out_dtype`` (default x.dtype)."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        check_operands(x, w_q, scale, out_dtype)
        return w8a16_matmul_reference(x, w_q, scale, out_dtype)
    if x.device.type == "cuda" and not w_q.is_contiguous():
        check_operands(x, w_q, scale, out_dtype)
        if layout_of(w_q) == 1:
            return _launch_nk(x, w_q, scale, out_dtype)
    return _launch_group(x, ((w_q, scale),), out_dtype)[0]


def w8a16_matmul_group(x: torch.Tensor, products, out_dtype: torch.dtype | None = None
                       ) -> list[torch.Tensor]:
    """x [m, K] f32/bf16 times each product {'w_q': int8 [K, N_i] row-major, 'scale': f32
    [N_i]} -> [x @ w_i * scale_i in ``out_dtype``] (default x.dtype). On the card one
    launch computes them all into one [m, sum N_i] output and returns its column ranges
    as views; on the CPU each is the plain version."""
    out_dtype = out_dtype or x.dtype
    prods = tuple((p["w_q"], p["scale"]) for p in products)
    if x.device.type == "cpu":
        for w_q, scale in prods:
            check_operands(x, w_q, scale, out_dtype)
        return [w8a16_matmul_reference(x, w_q, scale, out_dtype) for w_q, scale in prods]
    return _launch_group(x, prods, out_dtype)
