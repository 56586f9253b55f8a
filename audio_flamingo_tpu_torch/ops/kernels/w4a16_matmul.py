"""w4a16 matmul (K5): the hand-written Hopper kernel and its plain PyTorch version.

Replaces the Pallas TPU kernels ``audio_flamingo_tpu/ops/pallas/quant4_matmul.py``
``w4a16_matmul`` (:164) and ``w4a16_matmul_stacked`` (:98): ``x [m, K] @ w4 [K, N]`` with
the weights packed in the halves layout of ``ops/quant4.py`` (packed row r holds row r in
its low nibble and row r + K/2 in its high nibble) and f32 group scales ``gscale
[K/G, N]`` (low-half groups first) applied to the f32 partial product of each group. One
CUDA kernel (``csrc/w4a16_matmul.cu``) serves both forms: the stacked form passes the
layer's weights and scales as pointer offsets into the stacked buffers, so no slice is
copied. Its header states the design and what bounds it on the H100 (the weight bytes).

Dispatch is by the tensors' device: a CPU tensor goes to the plain version; a CUDA tensor
launches the kernel or raises. There is no fallback between the two.
"""

from __future__ import annotations

import torch

from audio_flamingo_tpu_torch.ops.kernels import _build
from audio_flamingo_tpu_torch.ops.kernels.launches import LaunchCounter

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
BLOCK_N = 512          # columns per block (csrc/w4a16_matmul.cu kBN)
MAX_GROUP = 512        # largest group the kernel stages in shared memory
TARGET_BLOCKS = 1056   # split K until the grid has about eight blocks per SM (132 SMs)

LAUNCHES = LaunchCounter()   # key: (m, K, N, stacked); inputs: (x, w_p, gscale, layer or None)


def low_nibble(w_p: torch.Tensor) -> torch.Tensor:
    """Sign-extended low nibbles of packed int8 codes, as int32."""
    return (w_p.to(torch.int32) << 28) >> 28


def high_nibble(w_p: torch.Tensor) -> torch.Tensor:
    """Sign-extended high nibbles of packed int8 codes, as int32."""
    return (w_p.to(torch.int32) << 24) >> 28


def w4a16_product_f32(x: torch.Tensor, w_p: torch.Tensor, gscale: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, before the output is rounded: per group,
    x's low half times the low codes and x's high half times the high codes, summed in
    f32 (exact products: codes and bf16 inputs are exact in f32), each partial sum times
    its f32 group scale, then the groups summed. -> f32 [m, N]."""
    m, k = x.shape
    kp, n = w_p.shape
    ng = gscale.shape[0] // 2            # groups per half
    g = kp // ng
    xf = x.float()
    out = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    for half, codes in ((0, low_nibble(w_p)), (1, high_nibble(w_p))):
        xs = xf[:, half * kp:(half + 1) * kp].reshape(m, ng, g).transpose(0, 1)   # [ng, m, g]
        parts = torch.bmm(xs, codes.float().reshape(ng, g, n))                     # [ng, m, n]
        out += (parts * gscale[half * ng:(half + 1) * ng, None, :].float()).sum(0)
    return out


def w4a16_matmul_reference(x: torch.Tensor, w_p: torch.Tensor,
                           gscale: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: x [m, K] @ w4 [K/2, N] packed -> [m, N] in x.dtype."""
    return w4a16_product_f32(x, w_p, gscale).to(x.dtype)


def check_operands(x: torch.Tensor, w_p: torch.Tensor, gscale: torch.Tensor) -> int:
    """Validate one layer's operands; returns the group size."""
    if x.ndim != 2 or w_p.ndim != 2 or gscale.ndim != 2:
        raise ValueError(f"expected x [m, K], w_p [K/2, N], gscale [K/G, N]; got "
                         f"{tuple(x.shape)}, {tuple(w_p.shape)}, {tuple(gscale.shape)}")
    m, k = x.shape
    kp, n = w_p.shape
    if k != 2 * kp or gscale.shape[1] != n or gscale.shape[0] % 2 or gscale.shape[0] == 0:
        raise ValueError(f"x {tuple(x.shape)}, w_p {tuple(w_p.shape)} and gscale "
                         f"{tuple(gscale.shape)} do not agree")
    if kp % (gscale.shape[0] // 2):
        raise ValueError(f"K/2 = {kp} is not a whole number of {gscale.shape[0] // 2} groups")
    if x.dtype not in DTYPE_CODES or w_p.dtype != torch.int8 or gscale.dtype != torch.float32:
        raise TypeError(f"expected x float32/bfloat16, w_p int8, gscale float32; got "
                        f"{x.dtype}, {w_p.dtype}, {gscale.dtype}")
    if len({x.device, w_p.device, gscale.device}) != 1:
        raise ValueError(f"operands on different devices: {x.device}, {w_p.device}, "
                         f"{gscale.device}")
    if m == 0:
        raise ValueError("x has no rows")
    return kp // (gscale.shape[0] // 2)


def split_k(n: int, groups_per_half: int, m_tiles: int = 1) -> int:
    """Splits of the K loop: enough blocks to fill the card, each split a whole number of
    groups, the splits of nearly equal size (the last may be shorter)."""
    col_blocks = -(-n // BLOCK_N) * m_tiles
    want = min(groups_per_half, max(1, -(-TARGET_BLOCKS // col_blocks)))
    per = -(-groups_per_half // want)
    return -(-groups_per_half // per)


def _launch(x: torch.Tensor, w_p: torch.Tensor, gscale: torch.Tensor, layer: int | None,
            kp: int, n: int, group: int) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"w4a16_matmul runs on cuda (kernel) or cpu (reference), "
                         f"not {x.device}")
    if group > MAX_GROUP:
        raise ValueError(f"the CUDA kernel takes groups up to {MAX_GROUP} rows, got {group}")
    x = x.contiguous()
    m = x.shape[0]
    w_off = s_off = 0
    if layer is not None:   # the layer's weights and scales in place in the stacks
        w_off = layer * w_p.stride(0) * w_p.element_size()
        s_off = layer * gscale.stride(0) * gscale.element_size()
    lib = _build.load_library()   # builds csrc/*.cu on first use
    splits = split_k(n, kp // group, -(-m // 8))
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        start = LAUNCHES.start(x.device)
        partials = (None if splits == 1 else
                    torch.empty((splits, m, n), dtype=torch.float32, device=x.device))
        err = lib.af_w4a16_matmul(x.data_ptr(), w_p.data_ptr() + w_off,
                                  gscale.data_ptr() + s_off, out.data_ptr(),
                                  0 if partials is None else partials.data_ptr(),
                                  DTYPE_CODES[x.dtype], m, kp, n, group, splits, stream)
    if err != 0:
        raise RuntimeError(f"w4a16_matmul kernel launch failed with CUDA error {err}")
    LAUNCHES.record((m, 2 * kp, n, layer is not None), x.device, start, (x, w_p, gscale, layer))
    return out


def w4a16_matmul(x: torch.Tensor, w_p: torch.Tensor, gscale: torch.Tensor) -> torch.Tensor:
    """x [m, K] f32/bf16, w_p [K/2, N] packed int8, gscale [K/G, N] f32 -> [m, N] in x.dtype."""
    group = check_operands(x, w_p, gscale)
    if x.device.type == "cpu":
        return w4a16_matmul_reference(x, w_p, gscale)
    w_p, gscale = w_p.contiguous(), gscale.contiguous()
    return _launch(x, w_p, gscale, None, w_p.shape[0], w_p.shape[1], group)


def w4a16_matmul_stacked(x: torch.Tensor, w_p: torch.Tensor, gscale: torch.Tensor,
                         layer: int) -> torch.Tensor:
    """x [m, K] @ layer ``layer`` of stacked w_p [L, K/2, N] / gscale [L, K/G, N]."""
    if w_p.ndim != 3 or gscale.ndim != 3 or w_p.shape[0] != gscale.shape[0]:
        raise ValueError(f"expected stacked w_p [L, K/2, N] and gscale [L, K/G, N]; got "
                         f"{tuple(w_p.shape)}, {tuple(gscale.shape)}")
    layer = int(layer)
    if not 0 <= layer < w_p.shape[0]:
        raise IndexError(f"layer {layer} of {w_p.shape[0]}")
    group = check_operands(x, w_p[layer], gscale[layer])
    if x.device.type == "cpu":
        return w4a16_matmul_reference(x, w_p[layer], gscale[layer])
    if not (w_p.is_contiguous() and gscale.is_contiguous()):
        raise ValueError("stacked w_p and gscale must be contiguous (the kernel reads a "
                         "layer in place)")
    return _launch(x, w_p, gscale, layer, w_p.shape[1], w_p.shape[2], group)
