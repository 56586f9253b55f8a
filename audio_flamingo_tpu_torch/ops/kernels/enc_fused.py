"""The three w8a8 encoder-layer fusions (K9): hand-written Hopper kernels and their plain
PyTorch versions.

Replaces the Pallas TPU kernels of ``audio_flamingo_tpu/ops/pallas/enc_fused.py``:
``enc_ln_qkv`` :103, ``enc_out_ln`` :151 and ``enc_mlp`` :218 (kernels ``_ln_qkv_kernel``
:94, ``_out_ln_kernel`` :137, ``_mlp_kernel`` :201). The CUDA source is
``csrc/enc_fused.cu``; its header states each kernel's design and bound.

- ``enc_ln_qkv``: x [m, d] -> f32 LayerNorm -> per-row int8 quantization -> int8 product
  with the fused q|k|v codes [d, N] -> (acc * h_scale) * w_scale + bias, in x.dtype.
- ``enc_out_ln``: attn [m, d] -> per-row quantization -> int8 product with w_o [d, d] ->
  x2 = x + y + bias in f32 -> (x2 in attn.dtype, int8 codes and f32 scales [m, 1] of the
  LayerNorm of the unrounded f32 x2).
- ``enc_mlp``: (h_q, h_scale) -> per f tile of ``f_tile`` columns: fc1 product, scale,
  bias, the polynomial-erf GELU, re-quantization per (row, tile), fc2 product times the
  tile's row scale added to an f32 accumulator, tile after tile in order; then
  acc * s2 + b2 + x2, in x2.dtype.

The kernels read K-major copies of every weight (``kmajor``, ``mlp_kmajor``; the encoder
makes them once, where its fused tree reaches the card, ``attach_kmajor``), or make them
per call when not given; the plain versions read the JAX layout. ``enc_ln_qkv`` and
``enc_out_ln`` hold a row in registers, so their kernels take rows of at most
``MAX_WIDTH`` elements (``qkv_supported``, ``out_supported``); the CUDA side sizes their
thread-block clusters from the card.

The int8 products are exact (int32), so the kernels and the plain versions differ only
where a sum of floats is taken in another order (a LayerNorm's statistics) and in the
last bit of an exp; a code can flip there and nowhere else. Dispatch is by device: a CUDA
tensor goes to the kernel or raises, a CPU tensor to the plain version.
"""

from __future__ import annotations

import torch

from audio_flamingo_tpu_torch.ops.kernels import _build
from audio_flamingo_tpu_torch.ops.kernels.launches import LaunchCounter
from audio_flamingo_tpu_torch.ops.kernels.w4a16_matmul import aligned
from audio_flamingo_tpu_torch.ops.quant import quantize_act as quant_rows

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MLP_F_TILE = 2560          # the JAX ENC_MLP_F_TILE
MLP_BLOCK_N = 256          # the kernels' output columns a pass (csrc kMlpNC)
MAX_WIDTH = 2048           # enc_ln_qkv's and enc_out_ln's widest row (csrc kRegD)
# blocks of a thread-block cluster sharing one of enc_ln_qkv's row blocks; 0: the CUDA
# side's choice (csrc ln_qkv_cluster). scripts/torch_k3_k9_times.py --clusters sets it.
LN_QKV_CLUSTER = 0

LN_QKV_LAUNCHES = LaunchCounter()   # key: (m, d, N); inputs: the wrapper's arguments
OUT_LN_LAUNCHES = LaunchCounter()   # key: (m, d)
MLP_LAUNCHES = LaunchCounter()      # key: (m, d, f, f_tile)


# ------------------------------------------------------------------ plain versions

def ln(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """f32 LayerNorm over the last axis: (x - mu) * rsqrt(var + eps) * w + b."""
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU through the Abramowitz & Stegun 7.1.26 polynomial erf, as the JAX
    kernels compute it (|erf_poly - erf| <= 1.5e-7), in f32."""
    a1, a2, a3, a4, a5 = (0.254829592, -0.284496736, 1.421413741, -1.453152027,
                          1.061405429)
    u = x * 0.7071067811865476
    s = torch.sign(u)
    z = torch.abs(u)
    t = 1.0 / (1.0 + 0.3275911 * z)
    poly = t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))))
    erf = s * (1.0 - poly * torch.exp(-z * z))
    return 0.5 * x * (1.0 + erf)


def i8_dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int8 [m, K] @ int8 [K, N] -> f32: the exact integer product (f64 holds it exactly),
    rounded to f32 as an int32 is."""
    return (a.double() @ w.double()).float()


def enc_ln_qkv_reference(x, ln_w, ln_b, w_q, w_scale, bias, eps: float = 1e-5):
    h = ln(x.float(), ln_w.float(), ln_b.float(), eps)
    hq, hs = quant_rows(h)
    y = i8_dot(hq, w_q) * hs * w_scale.float()
    return (y + bias.float()).to(x.dtype)


def enc_out_ln_reference(attn, x, w_q, w_scale, bias, ln_w, ln_b, eps: float = 1e-5):
    aq, a_scale = quant_rows(attn.float())
    y = i8_dot(aq, w_q) * a_scale * w_scale.float()
    x2 = x.float() + y + bias.float()
    hq, hs = quant_rows(ln(x2, ln_w.float(), ln_b.float(), eps))
    return x2.to(attn.dtype), hq, hs


def enc_mlp_reference(h_q, h_scale, w1_q, w1_scale, b1, w2_q, w2_scale, b2, x2,
                      f_tile: int = MLP_F_TILE):
    f = w1_q.shape[1]
    ft = min(f_tile, f)
    if f % ft:
        raise ValueError(f"ffn {f} is not a multiple of f_tile {ft}")
    acc = torch.zeros((h_q.shape[0], w2_q.shape[1]), dtype=torch.float32, device=h_q.device)
    for j in range(f // ft):
        sl = slice(j * ft, (j + 1) * ft)
        g = i8_dot(h_q, w1_q[:, sl]) * h_scale.float() * w1_scale[sl].float() + b1[sl].float()
        gq, gs = quant_rows(gelu(g))
        acc = acc + i8_dot(gq, w2_q[sl, :]) * gs
    y = acc * w2_scale.float() + b2.float()
    return (x2.float() + y).to(x2.dtype)


# ------------------------------------------------------------------ kernels

def _vec(t: torch.Tensor) -> torch.Tensor:
    """A per-column vector as the kernels read it: f32, contiguous (an exact cast)."""
    return t.float().contiguous()


def _cuda_check(name: str, x: torch.Tensor, *weights: torch.Tensor) -> None:
    """The activation x and the weights must lie on the card, the weights contiguous (a
    layer slice of a stacked tree is); the wrappers make the activations contiguous."""
    for t in (x, *weights):
        if t.device.type != "cuda":
            raise ValueError(f"{name} runs on cuda (kernel) or cpu (reference), not "
                             f"{t.device}")
    if not all(w.is_contiguous() for w in weights):
        raise ValueError(f"{name}: the kernel takes contiguous weights")


def _launch(counter: LaunchCounter, key, device, fn, args, inputs) -> None:
    lib = _build.load_library()   # builds csrc/*.cu on first use
    with torch.cuda.device(device):
        start = counter.start(device)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed with CUDA error {err}")
    counter.record(key, device, start, inputs)


def kmajor(w_q: torch.Tensor) -> torch.Tensor:
    """The K-major int8 copy a kernel reads of a JAX-layout weight [.., in, out]: its last
    two axes transposed, contiguous (stacked or not)."""
    return w_q.transpose(-2, -1).contiguous()


def _kmajor_for(name: str, w_q: torch.Tensor, w_t: torch.Tensor | None) -> torch.Tensor:
    """The given copy, checked against the codes' shape, or one made now (in x out bytes
    moved per call)."""
    if w_t is None:
        return kmajor(w_q)
    want = (w_q.shape[1], w_q.shape[0])
    if tuple(w_t.shape) != want or w_t.dtype != torch.int8:
        raise ValueError(f"{name}: K-major copy {tuple(w_t.shape)} {w_t.dtype} is not int8 "
                         f"{list(want)}")
    return w_t


def qkv_supported(d: int, n: int) -> bool:
    """The shapes enc_ln_qkv's kernel takes: x [m, d] with d a multiple of 64 up to
    ``MAX_WIDTH``, and N output columns a multiple of 128."""
    return d % 64 == 0 and 0 < d <= MAX_WIDTH and n % 128 == 0 and n > 0


def out_supported(d: int) -> bool:
    """The widths enc_out_ln's kernel takes: multiples of 128 up to ``MAX_WIDTH``."""
    return d % 128 == 0 and 0 < d <= MAX_WIDTH


def enc_ln_qkv(x, ln_w, ln_b, w_q, w_scale, bias, eps: float = 1e-5, *, w_t=None):
    """x [m, d] -> LayerNorm -> quant -> x @ w_q [d, N] int8 -> [m, N] in x.dtype (the q
    pre-scale is folded into w_scale and bias by the quantizer). ``w_t``: the kernel's
    K-major copy [N, d] (``kmajor``), made here when not given."""
    if x.device.type == "cpu":
        return enc_ln_qkv_reference(x, ln_w, ln_b, w_q, w_scale, bias, eps)
    _cuda_check("enc_ln_qkv", x, w_q)
    m, d = x.shape
    n = w_q.shape[1]
    if not qkv_supported(d, n):
        raise ValueError(f"enc_ln_qkv's kernel takes d a multiple of 64 up to {MAX_WIDTH} "
                         f"and N a multiple of 128; got d = {d}, N = {n}")
    w_t = aligned(_kmajor_for("enc_ln_qkv", w_q, w_t))
    _cuda_check("enc_ln_qkv", x, w_t)
    x = aligned(x.contiguous())   # rows are read by 16 bytes
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    vecs = [_vec(t) for t in (ln_w, ln_b, w_scale, bias)]
    _launch(LN_QKV_LAUNCHES, (m, d, n), x.device, "af_enc_ln_qkv",
            (x.data_ptr(), *(t.data_ptr() for t in vecs[:2]), w_t.data_ptr(),
             *(t.data_ptr() for t in vecs[2:]), out.data_ptr(), _DTYPE_CODES[x.dtype],
             m, d, n, LN_QKV_CLUSTER, float(eps)),
            (x, ln_w, ln_b, w_q, w_scale, bias, eps))
    return out


def enc_out_ln(attn, x, w_q, w_scale, bias, ln_w, ln_b, eps: float = 1e-5, *, w_t=None):
    """attn, x [m, d] -> (x2 = x + attn @ w_o + b in attn.dtype, int8 codes [m, d] and f32
    scales [m, 1] of the LayerNorm of the f32 x2). ``w_t``: the kernel's K-major copy of
    w_o (``kmajor``), made here when not given."""
    if attn.device.type == "cpu":
        return enc_out_ln_reference(attn, x, w_q, w_scale, bias, ln_w, ln_b, eps)
    _cuda_check("enc_out_ln", attn, w_q)
    if x.dtype != attn.dtype:
        raise TypeError(f"enc_out_ln kernel: x {x.dtype} and attn {attn.dtype} differ")
    m, d = attn.shape
    if not out_supported(d):
        raise ValueError(f"enc_out_ln's kernel takes d a multiple of 128 up to {MAX_WIDTH}; "
                         f"got d = {d}")
    w_t = aligned(_kmajor_for("enc_out_ln", w_q, w_t))
    _cuda_check("enc_out_ln", attn, w_t)
    attn, x = aligned(attn.contiguous()), x.contiguous()
    x2 = torch.empty_like(attn)
    hq = torch.empty((m, d), dtype=torch.int8, device=attn.device)
    hs = torch.empty((m, 1), dtype=torch.float32, device=attn.device)
    vecs = [_vec(t) for t in (w_scale, bias, ln_w, ln_b)]
    _launch(OUT_LN_LAUNCHES, (m, d), attn.device, "af_enc_out_ln",
            (attn.data_ptr(), x.data_ptr(), w_t.data_ptr(), *(t.data_ptr() for t in vecs),
             x2.data_ptr(), hq.data_ptr(), hs.data_ptr(), _DTYPE_CODES[attn.dtype], m, d,
             float(eps)),
            (attn, x, w_q, w_scale, bias, ln_w, ln_b, eps))
    return x2, hq, hs


def mlp_supported(d: int, f_tile: int) -> bool:
    """The shapes enc_mlp's kernel takes: d and the f tile in whole 256-column passes."""
    return d % MLP_BLOCK_N == 0 and f_tile % MLP_BLOCK_N == 0


def mlp_kmajor(w1_q: torch.Tensor, w2_q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The K-major int8 copies enc_mlp's kernel reads: w1 [.., d, f] -> [.., f, d] and w2
    [.., f, d] -> [.., d, f] (the last two axes transposed, contiguous; stacked or not)."""
    return kmajor(w1_q), kmajor(w2_q)


def _attach(layers, names) -> None:
    for name in names:
        layers[name].register_buffer("w_t", kmajor(layers[name]["w_q"]), persistent=False)


def attach_kmajor(layers) -> None:
    """Give a fused encoder tree's qkv, o, fc1 and fc2 nodes (qwen2.TensorTree) their
    K-major copies as ``w_t`` (6.6 MB a layer at d = 1280 for q|k|v and o, 13.1 MB for fc1
    and fc2): non-persistent buffers, so they move with ``.to()`` and stay out of
    ``state_dict()``; the JAX-layout ``w_q`` stays the one source of the codes. The
    encoder calls this once where its tree reaches the card."""
    _attach(layers, ("qkv", "o", "fc1", "fc2"))


def attach_mlp_kmajor(layers) -> None:
    """``attach_kmajor`` for fc1 and fc2 only. The package does not call it; it stays for
    the tests that give a tree enc_mlp's copies alone."""
    _attach(layers, ("fc1", "fc2"))


def enc_mlp(h_q, h_scale, w1_q, w1_scale, b1, w2_q, w2_scale, b2, x2,
            f_tile: int = MLP_F_TILE, kmajor: tuple | None = None):
    """x2 + fc2(quant(gelu(fc1(h_q)))) with re-quantization per (row, f tile): h_q int8
    [m, d] and h_scale f32 [m, 1] (from enc_out_ln), w1_q [d, f], w2_q [f, d] -> [m, d]
    in x2.dtype. ``kmajor``: the kernel's (w1 [f, d], w2 [d, f]) copies, made here when
    not given (``mlp_kmajor``: 2 d f bytes moved per call)."""
    if h_q.device.type == "cpu":
        return enc_mlp_reference(h_q, h_scale, w1_q, w1_scale, b1, w2_q, w2_scale, b2, x2,
                                 f_tile)
    _cuda_check("enc_mlp", h_q, w1_q, w2_q)
    m, d = h_q.shape
    f = w1_q.shape[1]
    ft = min(f_tile, f)
    if f % ft:
        raise ValueError(f"ffn {f} is not a multiple of f_tile {ft}")
    if not mlp_supported(d, ft):
        raise ValueError(f"enc_mlp's kernel takes d and f_tile multiples of {MLP_BLOCK_N}; "
                         f"got d = {d}, f_tile = {ft}")
    w1_t, w2_t = kmajor if kmajor is not None else mlp_kmajor(w1_q, w2_q)
    _cuda_check("enc_mlp", h_q, w1_t, w2_t)
    if (w1_t.shape, w2_t.shape) != ((f, d), (d, f)) or {w1_t.dtype, w2_t.dtype} != {torch.int8}:
        raise ValueError(f"enc_mlp: K-major copies {tuple(w1_t.shape)} {w1_t.dtype}, "
                         f"{tuple(w2_t.shape)} {w2_t.dtype} are not int8 [{f}, {d}], [{d}, {f}]")
    h_q, x2 = aligned(h_q.contiguous()), x2.contiguous()
    out = torch.empty_like(x2)
    y = torch.empty((f // ft, m, d), dtype=torch.float32, device=x2.device)   # per-tile fc2
    hs = _vec(h_scale)
    vecs = [_vec(t) for t in (w1_scale, b1, w2_scale, b2)]
    _launch(MLP_LAUNCHES, (m, d, f, ft), h_q.device, "af_enc_mlp",
            (h_q.data_ptr(), hs.data_ptr(), w1_t.data_ptr(), vecs[0].data_ptr(),
             vecs[1].data_ptr(), w2_t.data_ptr(), vecs[2].data_ptr(), vecs[3].data_ptr(),
             x2.data_ptr(), out.data_ptr(), y.data_ptr(), _DTYPE_CODES[x2.dtype], m, d, f, ft),
            (h_q, h_scale, w1_q, w1_scale, b1, w2_q, w2_scale, b2, x2, f_tile))
    return out
