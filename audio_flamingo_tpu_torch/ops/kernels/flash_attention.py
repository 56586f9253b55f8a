"""Flash-attention forward: the hand-written Hopper kernel and its plain PyTorch version.

Replaces the Pallas TPU kernel ``audio_flamingo_tpu/ops/pallas/flash_attention.py``
(``_flash_forward`` :258, kernel ``_flash_kernel`` :63, reached from ``flash_attention``
and ``flash_attention_lse``). The CUDA source is ``csrc/flash_attention.cu``; its header
states the kernel's design, what bounds it on the H100 (bf16 tensor-core FLOPs at the
main-path shapes) and what the simple design leaves on the table.

Dispatch is by the tensors' device: a CPU tensor goes to ``flash_attention_reference``;
a CUDA tensor launches the kernel or raises. There is no fallback between the two.
"""

from __future__ import annotations

import collections

import torch

from audio_flamingo_tpu_torch.ops.kernels import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIMS = (64, 128)


class LaunchCounter:
    """Counts kernel launches, in total and by (q shape, k shape, causal).

    Two switches, both off by default, serve measurement: ``timing`` brackets each launch
    with CUDA events (``device_ms`` sums them), and ``capture`` keeps each launch's
    inputs in ``inputs`` as (q, k, v, dict(causal, scale, q_offset)) so that they can be
    replayed. Off, they cost one attribute test per launch."""

    def __init__(self):
        self.count = 0
        self.shapes: collections.Counter = collections.Counter()
        self.timing = False
        self.capture = False
        self.inputs: list = []
        self._events: list = []

    def reset(self) -> None:
        self.count = 0
        self.shapes.clear()
        self.inputs.clear()
        self._events.clear()

    def start(self, device: torch.device):
        """A start event recorded on the device's current stream when timing, else None."""
        if not self.timing:
            return None
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(device))
        return event

    def record(self, q, k, v, kw: dict, start=None) -> None:
        self.count += 1
        self.shapes[(tuple(q.shape), tuple(k.shape), bool(kw["causal"]))] += 1
        if start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(q.device))
            self._events.append((start, end))
        if self.capture:
            self.inputs.append((q, k, v, dict(kw)))

    def device_ms(self) -> float:
        """Summed device time of the timed launches since the last reset."""
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self._events)


LAUNCHES = LaunchCounter()


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"expected q [B,Tq,H,D], k/v [B,Tk,Hkv,D]; got {q.shape}, "
                         f"{k.shape}, {v.shape}")
    b, tq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v shapes {k.shape}, {v.shape} do not match q {q.shape}")
    if tq == 0 or k.shape[2] == 0 or h % k.shape[2] != 0:
        raise ValueError(f"need Tq > 0 and H ({h}) a multiple of Hkv ({k.shape[2]})")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q/k/v must share dtype float32 or bfloat16; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q/k/v on different devices: {q.device}, {k.device}, {v.device}")


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                              causal: bool = False, scale: float | None = None,
                              q_offset: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: (o [B,Tq,H,D] in q.dtype, lse [B,Tq,H] f32).

    Scores, softmax and P.V in f32; KV head of q head h is h // (H/Hkv); key j is visible
    to row i iff j <= i + q_offset under causal masking. A row with no visible key gives
    o = 0 and lse = -inf.
    """
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = d ** -0.5
    qg = q.float().reshape(b, tq, hkv, h // hkv, d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    if causal:
        rows = torch.arange(tq, device=q.device)[:, None] + q_offset
        s = s.masked_fill(torch.arange(tk, device=q.device)[None, :] > rows, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    l_q = l.permute(0, 3, 1, 2, 4)                      # [b, q, kv, g, 1]
    o = torch.where(l_q > 0, o / l_q, torch.zeros_like(o))
    lse = torch.where(l > 0, m + torch.log(l), torch.full_like(l, float("-inf")))
    lse = lse[..., 0].permute(0, 3, 1, 2).reshape(b, tq, h)
    return o.reshape(b, tq, h, d).to(q.dtype), lse


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = False, scale: float | None = None,
                        q_offset: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """q [B,Tq,H,D], k/v [B,Tk,Hkv,D] -> (o [B,Tq,H,D], lse [B,Tq,H] f32)."""
    _check(q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, scale=scale,
                                         q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda (kernel) or cpu (reference), "
                         f"not {q.device}")
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head dims {KERNEL_HEAD_DIMS}, got {d}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("q/k/v must be contiguous in the head dim")
    lib = _build.load_library()   # builds csrc/*.cu on first use
    o = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, tq, h), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        start = LAUNCHES.start(q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.af_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            _DTYPE_CODES[q.dtype], b, tq, tk, h, hkv, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            o.stride(0), o.stride(1), o.stride(2),
            float(scale), int(bool(causal)), int(q_offset), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed with CUDA error {err}")
    LAUNCHES.record(q, k, v, dict(causal=bool(causal), scale=float(scale), q_offset=int(q_offset)),
                    start)
    return o, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, scale: float | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q [B,Tq,H,D], k/v [B,Tk,Hkv,D] -> o [B,Tq,H,D]; see flash_attention_lse."""
    return flash_attention_lse(q, k, v, causal=causal, scale=scale, q_offset=q_offset)[0]
