"""Fused w4 decode-layer suffixes (K6): the hand-written Hopper kernel and its plain
PyTorch versions.

Replaces the Pallas TPU kernels ``audio_flamingo_tpu/ops/pallas/quant4_block.py``
``w4_suffix_a`` (:225), ``w4_suffix_b`` (:288) and their eligibility rule
``suffix_supported`` (:351). A decode layer on a fused w4 tree runs its matmuls in two
calls around the attention:

- A: o-proj + residual, f32 RMSNorm x ln2, gate|up, silu * up -> (act, h)
- B: down-proj + residual, f32 RMSNorm x the next layer's ln1, the next layer's qkv
  -> (h2, qkv_next); the caller adds the qkv bias.

The norm is the Pallas kernel's ``_rms`` (``(h * rsqrt(mean(h^2) + eps)) * f32(w)`` in
f32, the normed row rounded to the dtype only as the next product's input), not the
model's ``rms_norm``. The weights are the layer-stacked w4 dicts of ``ops/quant4.py``,
read in place at the layer's offset. The CUDA source is ``csrc/w4_suffix.cu``: each call
is ONE launch of a persistent grid (its header states the design and its bound).
``plan`` is the work-item plan the kernel walks: each product cut into (column tile,
split of whole groups) items, the splits chosen from the grid the card holds.

Dispatch is by the tensors' device: a CPU tensor goes to the plain version; a CUDA tensor
launches the kernel or raises. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch
import torch.nn.functional as F

from audio_flamingo_tpu_torch.ops.kernels import _build
from audio_flamingo_tpu_torch.ops.kernels import w4a16_matmul as k5
from audio_flamingo_tpu_torch.ops.kernels.launches import LaunchCounter

MAX_ROWS = 8   # the Pallas kernels' row limit, kept so the port takes the path where JAX does
BLOCK_N = k5.BLOCK_N   # columns of a work item's tile (csrc/w4_mma.cuh kBN)
X_ROWS = 640           # packed rows of x a block holds, or one group (csrc/w4_suffix.cu kXRows)
ITEM_STAGES = 4        # a work item's fixed cost (ring fill, x, ticket) in ring stages
FINISH_LOADS = 32      # partial sums a thread of a tile's finish loads at once (split_sums)
FINISH_ROUND_STAGES = 1   # one such round trip, in ring stages
CONTROL_INTS = 4096    # per-device barrier words + tickets (csrc/w4_suffix.cu kControl)

LAUNCHES_A = LaunchCounter()   # key: (m, layer); inputs: the call's arguments
LAUNCHES_B = LaunchCounter()   # key: (m, layer, next layer); inputs: the call's arguments


def suffix_supported(stacked: dict | None, cfg) -> bool:
    """The two-call path needs the full fused stacked set (qkv, o, mlp.gateup, mlp.down)
    and, as the Pallas kernels did, K/2 a multiple of 128 for d, f and the o-proj's K."""
    if stacked is None or not all(k in stacked for k in ("qkv", "o")):
        return False
    if "mlp" not in stacked or not all(k in stacked["mlp"] for k in ("gateup", "down")):
        return False
    k_o = cfg.num_heads * cfg.resolved_head_dim()
    return all((k // 2) % 128 == 0 for k in (cfg.hidden_size, cfg.intermediate_size, k_o))


def _rms(h: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    var = (h * h).mean(dim=-1, keepdim=True)
    return (h * torch.rsqrt(var + eps)) * w.float()


def _layer(p: dict, layer: int):
    return p["w_p"][layer], p["gscale"][layer]


def w4_suffix_a_reference(attn2d, h_res, ln2_w, o_p, gu_p, layer: int, eps: float = 1e-6):
    """Plain version of suffix A -> (act [m, F], h [m, D]) in attn2d.dtype."""
    dt = attn2d.dtype
    h = k5.w4a16_product_f32(attn2d, *_layer(o_p, layer)) + h_res.float()
    gu = k5.w4a16_product_f32(_rms(h, ln2_w, eps).to(dt), *_layer(gu_p, layer))
    f = gu.shape[-1] // 2
    return (F.silu(gu[:, :f]) * gu[:, f:]).to(dt), h.to(dt)


def w4_suffix_b_reference(act, h, ln1_next, down_p, qkv_p, layer: int, next_layer: int,
                          eps: float = 1e-6):
    """Plain version of suffix B -> (h2 [m, D], qkv_next [m, Nqkv]) in act.dtype."""
    dt = act.dtype
    h2 = k5.w4a16_product_f32(act, *_layer(down_p, layer)) + h.float()
    qkv = k5.w4a16_product_f32(_rms(h2, ln1_next, eps).to(dt), *_layer(qkv_p, next_layer))
    return h2.to(dt), qkv.to(dt)


def _check(x, res, norm_w, first, second, layers, what: str) -> tuple[int, int]:
    """Validate a suffix call; returns the two products' group sizes."""
    m = x.shape[0]
    if not 0 < m <= MAX_ROWS:
        raise ValueError(f"{what} takes 1..{MAX_ROWS} rows, got {m}")
    if res.ndim != 2 or res.shape[0] != m or res.dtype != x.dtype or res.device != x.device:
        raise ValueError(f"{what}: residual {tuple(res.shape)} {res.dtype} does not match "
                         f"x {tuple(x.shape)} {x.dtype}")
    d = res.shape[1]
    for p, layer in zip((first, second), layers):
        if p["w_p"].ndim != 3 or not 0 <= layer < p["w_p"].shape[0]:
            raise ValueError(f"{what}: layer {layer} of stacked w_p {tuple(p['w_p'].shape)}")
    g1 = k5.check_operands(x, *_layer(first, layers[0]))
    if first["w_p"].shape[2] != d or norm_w.shape != (d,):
        raise ValueError(f"{what}: first product's N {first['w_p'].shape[2]} or norm weight "
                         f"{tuple(norm_w.shape)} != hidden size {d}")
    g2 = k5.check_operands(res, *_layer(second, layers[1]))
    return g1, g2


def _stacked_ptrs(p: dict, layer: int) -> tuple[int, int]:
    w_p, gscale = p["w_p"], p["gscale"]
    if not (w_p.is_contiguous() and gscale.is_contiguous()):
        raise ValueError("stacked w_p and gscale must be contiguous (read in place)")
    return (w_p.data_ptr() + layer * w_p.stride(0) * w_p.element_size(),
            gscale.data_ptr() + layer * gscale.stride(0) * gscale.element_size())


# ------------------------------------------------------------------ the work-item plan

@dataclasses.dataclass(frozen=True)
class PhasePlan:
    """One product of a suffix as the persistent grid walks it: ``kp`` packed rows,
    ``segs`` segments of ``n`` columns (gate|up: 2, gate tile j paired with up tile j),
    ``per`` groups a split (whole groups; the last split may be shorter). Item i is split
    ``i // tiles`` of tile ``i % tiles`` (split-major)."""
    kp: int
    n: int
    segs: int
    group: int
    per: int

    @property
    def ng(self) -> int:
        return self.kp // self.group

    @property
    def splits(self) -> int:
        return -(-self.ng // self.per)

    @property
    def tiles(self) -> int:
        return -(-self.n // BLOCK_N)

    @property
    def items(self) -> int:
        return self.tiles * self.splits

    @property
    def ld(self) -> int:
        """Row stride of the codes, scales and partial sums (gate|up: 2 n)."""
        return self.segs * self.n

    def item(self, i: int) -> tuple[int, int, range]:
        """(tile, split, the split's groups) of item i."""
        s, t = divmod(i, self.tiles)
        return t, s, range(s * self.per, min(self.ng, (s + 1) * self.per))


def phase_plan(kp: int, n: int, segs: int, group: int, blocks: int,
               finish_rows: int = 1) -> PhasePlan:
    """The split that makes the work on the critical path least, in ring stages: a block
    takes ceil(items / blocks) items, each its segments' stages (``per`` groups of group /
    32 stages) plus ITEM_STAGES for the item itself (its ring filling, its x, its ticket);
    then the splits are added: finish_rows x splits (x segs) partial sums per thread
    (phase 2: a tile's last split takes every row; phase 1: the blocks share the rows
    between two barriers, 1), FINISH_LOADS loads to a round trip of FINISH_ROUND_STAGES
    stages. The x of a split must fit the block's buffer (X_ROWS packed rows, or one
    group). Ties go to fewer splits."""
    ng = kp // group
    tiles = -(-n // BLOCK_N)
    per_max = max(1, X_ROWS // group)
    best = None
    for per in range(1, min(per_max, ng) + 1):
        splits = -(-ng // per)
        cost = (-(-tiles * splits // blocks) * (segs * per * (group // k5.STAGE_ROWS)
                                                + ITEM_STAGES)
                + -(-splits * finish_rows * segs // FINISH_LOADS) * FINISH_ROUND_STAGES)
        if best is None or cost <= best[0]:
            best = (cost, per)
    return PhasePlan(kp=kp, n=n, segs=segs, group=group, per=best[1])


def block_items(items: int, blocks: int, b: int) -> range:
    """The items block b of ``blocks`` walks, as the kernel hands them out: b, b + blocks,
    ... (the blocks at work at one time cover whole rows of the weights)."""
    return range(b, items, blocks)


@dataclasses.dataclass(frozen=True)
class SuffixPlan:
    first: PhasePlan
    second: PhasePlan
    blocks: int
    m: int
    d: int

    @property
    def scratch_floats(self) -> int:
        """f32 scratch as the C side lays it out: both phases' partial sums [splits, m,
        ld], h in f32 [m, d], the slots [m, tiles of phase 1]."""
        return (sum(p.splits * self.m * p.ld for p in (self.first, self.second))
                + self.m * self.d + self.first.tiles * self.m)

    @property
    def control_ints(self) -> int:
        """2 barrier words and a ticket per tile of phase 2 (phase 1's splits are added
        by all blocks between two barriers)."""
        return 2 + self.second.tiles


def plan(m: int, k1: int, d: int, n2: int, group1: int, group2: int, gated: bool,
         blocks: int) -> SuffixPlan:
    """The plan of a suffix call: phase 1 is [m, k1] @ [k1, d], phase 2 [m, d] @ [d, n2]
    (gated: [d, 2 n2] read as gate and up tiles in pairs), over ``blocks`` blocks."""
    first = phase_plan(k1 // 2, d, 1, group1, blocks)
    second = phase_plan(d // 2, n2, 2 if gated else 1, group2, blocks, m)
    return SuffixPlan(first=first, second=second, blocks=blocks, m=m, d=d)


# ------------------------------------------------------------------ the CUDA path

_PLANS: dict = {}      # call signature -> (SuffixPlan, groups)
_BLOCKS: dict = {}     # (device, dtype, m, group, gated) -> blocks of the persistent grid
_SCRATCH: dict = {}    # device -> [f32 scratch, ...] (the last is current; earlier ones are
                       # kept so a CUDA graph captured over them stays valid)
_CONTROL: dict = {}    # device -> int32 [CONTROL_INTS], zero and left zero by every launch


def _grid_blocks(lib, device: torch.device, dtype: torch.dtype, m: int, group: int,
                 gated: bool) -> int:
    key = (device, dtype, k5.rows_per_block(m, dtype), group, gated)
    blocks = _BLOCKS.get(key)
    if blocks is None:
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = lib.af_w4_suffix_blocks(k5.DTYPE_CODES[dtype], m, group, int(gated),
                                          ctypes.byref(out))
        if err != 0:
            raise RuntimeError(f"w4 suffix occupancy query failed with CUDA error {err}")
        blocks = _BLOCKS[key] = out.value
    return blocks


def _prepare(x, groups, products, gated: bool = True):
    """Shared CUDA set-up: the library and the call's plan (``products``: the two (packed
    K, N) of the call, gate|up as one product of 2f columns)."""
    if x.device.type != "cuda":
        raise ValueError(f"w4 suffixes run on cuda (kernels) or cpu (reference), not {x.device}")
    if not all(k5.supported(n, g) for (_, n), g in zip(products, groups)):
        raise ValueError(f"the CUDA kernel takes N a multiple of 16 and groups a multiple of "
                         f"{k5.STAGE_ROWS} up to {k5.MAX_GROUP}; got {products}, {groups}")
    lib = _build.load_library()
    m = x.shape[0]
    (kp1, d), (kp2, n2) = products
    if 2 * kp2 != d:
        raise ValueError(f"the second product's K {2 * kp2} != the first's N {d}")
    blocks = _grid_blocks(lib, x.device, x.dtype, m, max(groups), gated)
    pl = plan(m, 2 * kp1, d, n2 // 2 if gated else n2, *groups, gated, blocks)
    if pl.control_ints > CONTROL_INTS:
        raise ValueError(f"{pl.control_ints} tickets exceed the {CONTROL_INTS} control words")
    return lib, pl


def _scratch(device: torch.device, floats: int) -> torch.Tensor:
    bufs = _SCRATCH.setdefault(device, [])
    if not bufs or bufs[-1].numel() < floats:
        bufs.append(torch.empty(floats, dtype=torch.float32, device=device))
    return bufs[-1]


def _control(device: torch.device) -> torch.Tensor:
    c = _CONTROL.get(device)
    if c is None:
        c = _CONTROL[device] = torch.zeros(CONTROL_INTS, dtype=torch.int32, device=device)
    return c


def _call_plan(x, res, norm_w, first, second, layers, what: str, gated: bool):
    """The plan of a CUDA call, validated once per call signature."""
    key = (what, x.shape, x.dtype, x.device, res.shape, res.dtype, res.device,
           norm_w.shape, norm_w.dtype, first["w_p"].shape, first["w_p"].dtype,
           first["gscale"].shape, second["w_p"].shape, second["w_p"].dtype,
           second["gscale"].shape)
    hit = _PLANS.get(key)
    if hit is None:
        groups = _check(x, res, norm_w, first, second, layers, what)
        if norm_w.dtype not in (torch.float32, x.dtype) or norm_w.device != x.device:
            raise ValueError(f"{what}: norm weight {norm_w.dtype} on {norm_w.device}")
        products = ((first["w_p"].shape[1], first["w_p"].shape[2]),
                    (second["w_p"].shape[1], second["w_p"].shape[2]))
        _, pl = _prepare(x, groups, products, gated)
        if len(_PLANS) >= 4096:
            _PLANS.clear()
        hit = _PLANS[key] = (pl, groups)
    for p, layer in zip((first, second), layers):
        if not 0 <= layer < p["w_p"].shape[0]:
            raise ValueError(f"{what}: layer {layer} of stacked w_p {tuple(p['w_p'].shape)}")
    return hit


def _launch(what: str, gated: bool, counter: LaunchCounter, key, x, res, norm_w, first,
            second, layers, eps, inputs):
    (pl, (g1, g2)) = _call_plan(x, res, norm_w, first, second, layers, what, gated)
    # the kernel reads x and the norm weight 4 entries a load
    x, res, norm_w = k5.aligned(x.contiguous()), res.contiguous(), k5.aligned(norm_w.contiguous())
    m, d = res.shape
    n2 = pl.second.n
    h_out = torch.empty_like(res)
    out = torch.empty((m, n2), dtype=x.dtype, device=x.device)
    lib = _build.load_library()
    fn = lib.af_w4_suffix_a if gated else lib.af_w4_suffix_b
    dev = x.device
    with torch.cuda.device(dev):
        scratch, control = _scratch(dev, pl.scratch_floats), _control(dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        start = counter.start(dev)
        o2, o1 = (out, h_out) if gated else (h_out, out)   # A: act, h; B: h2, qkv
        err = fn(x.data_ptr(), res.data_ptr(), norm_w.data_ptr(),
                 *_stacked_ptrs(first, layers[0]), *_stacked_ptrs(second, layers[1]),
                 o2.data_ptr(), o1.data_ptr(), scratch.data_ptr(), control.data_ptr(),
                 k5.DTYPE_CODES[x.dtype], k5.DTYPE_CODES[norm_w.dtype], m, x.shape[1], d, n2,
                 g1, g2, pl.first.per, pl.second.per, float(eps), stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed with CUDA error {err}")
    counter.record(key, dev, start, inputs)
    return out, h_out


def w4_suffix_a(attn2d: torch.Tensor, h_res: torch.Tensor, ln2_w: torch.Tensor, o_p: dict,
                gu_p: dict, layer: int, eps: float = 1e-6):
    """(attn_out [m, K_o], h [m, D]) -> (act [m, F], h [m, D]): o-proj + residual + f32
    RMSNorm x ln2 + gate|up + silu * up, for layer ``layer`` of the stacked w4 dicts."""
    layer = int(layer)
    if attn2d.device.type == "cpu":
        _check(attn2d, h_res, ln2_w, o_p, gu_p, (layer, layer), "w4_suffix_a")
        return w4_suffix_a_reference(attn2d, h_res, ln2_w, o_p, gu_p, layer, eps)
    act, h_out = _launch("w4_suffix_a", True, LAUNCHES_A, (attn2d.shape[0], layer), attn2d,
                         h_res, ln2_w, o_p, gu_p, (layer, layer), eps,
                         (attn2d, h_res, ln2_w, o_p, gu_p, layer, eps))
    return act, h_out


def w4_suffix_b(act: torch.Tensor, h: torch.Tensor, ln1_next: torch.Tensor, down_p: dict,
                qkv_p: dict, layer: int, next_layer: int, eps: float = 1e-6):
    """(act [m, F], h [m, D]) -> (h2 [m, D], qkv_next [m, Nqkv]): down-proj (layer
    ``layer``) + residual + f32 RMSNorm x ln1_next + qkv of layer ``next_layer``."""
    layer, next_layer = int(layer), int(next_layer)
    if act.device.type == "cpu":
        _check(act, h, ln1_next, down_p, qkv_p, (layer, next_layer), "w4_suffix_b")
        return w4_suffix_b_reference(act, h, ln1_next, down_p, qkv_p, layer, next_layer, eps)
    qkv, h_out = _launch("w4_suffix_b", False, LAUNCHES_B, (act.shape[0], layer, next_layer),
                         act, h, ln1_next, down_p, qkv_p, (layer, next_layer), eps,
                         (act, h, ln1_next, down_p, qkv_p, layer, next_layer, eps))
    return h_out, qkv
