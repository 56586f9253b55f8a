"""Weight-only int8 quantization (w8a16), as ``audio_flamingo_tpu/ops/quant.py``.

Per-output-channel scales; activations stay in the compute dtype. The codes and scales are
bit-identical to the JAX package's (run eagerly): the same f32 amax, ``max(amax, 1e-8) /
127`` as a true division on every device (``true_div``) and a half-to-even
``round(w / scale)``.

``q_matmul`` picks its route by the number of rows, never by a failure. Up to
``KERNEL_MAX_ROWS`` rows (every decode batch, the head of a decode step, prefill chunks
of up to 256 tokens) it is the w8a16 kernel, K4 (``ops/kernels/w8a16_matmul.py``): the
codes are streamed once as int8, widened exactly, accumulated in f32 and scaled, as JAX's
Pallas ``w8a16_matmul``; ``q_matmul_group`` gives products that share x (the LM's q|k|v
and gate|up) one K4 launch. The limit is where K4 stops beating the library route on the
H100 (re-measured after K4's redesign: it wins up to 256 rows at [3584, 18944] and loses
at 1024; the numbers are at ``KERNEL_MAX_ROWS``). Above the limit (long prefills,
training batches) it is the library product, as JAX's default ``q_matmul`` is an XLA dot:
on the card a bf16 x is multiplied with the int8 codes converted to bf16, accumulating
and writing f32, then scaled (int8 values and bf16 inputs are exact in bf16, so this is
JAX's f32-accumulated dot up to the order of the sums; the bf16 copy of the codes is made
on every call). Both routes are differentiable in their input with the codes frozen: the
gradient is ``g @ (w_q * scale)^T``, as JAX's autodiff of its dot gives it.

w8a8 (the TTFT path: ``a8_prefill``, ``a8_encoder``): ``quantize_act`` gives per-token
int8 codes and f32 scales, ``q_matmul_a8q`` multiplies them with int8 weights into an
exact int32 product and then scales ``(y * x_scale) * scale`` in f32, as JAX's XLA
product. The int32 product is a library call, as JAX leaves it to XLA:
``torch._int_mm`` on both devices. On the card it needs more than 16 rows and K and N
multiples of 8, so a short block's rows are padded with zero codes, and it takes the codes
K-contiguous. It is exact on both: 127^2 * 18,944 < 2^31.
``quantize_encoder_params`` and ``quantize_encoder_params_fused`` give the JAX package's
two int8 encoder layouts, codes and scales bit-identical.
"""

from __future__ import annotations

import torch

from audio_flamingo_tpu_torch.ops.kernels import w8a16_matmul as k4

# rows up to which q_matmul takes K4. On an H100 80GB HBM3 at 700 W, [m, 3584] x [3584,
# 18944] bf16, device ms, K4 / the library route: m = 32 0.078 / 0.251, 64 0.104 / 0.253,
# 128 0.167 / 0.259, 256 0.204 / 0.275, 1024 0.790 / 0.489 (scripts/torch_a8_w8_times.py;
# PERF.md, K4 rows; chip_smoke.py phase 11a measures it again)
KERNEL_MAX_ROWS = 256


def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d as a true division on every device: on the card, torch divides by a Python
    number through its reciprocal, which can move a scale by an ulp and flip codes."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def div127(x: torch.Tensor) -> torch.Tensor:
    return true_div(x, 127.0)


def quantize_linear(w: torch.Tensor) -> dict:
    """[in, out] float -> {'w_q': int8 [in, out], 'scale': f32 [out]}."""
    wf = w.float()
    scale = div127(torch.clamp(wf.abs().amax(dim=-2), min=1e-8))
    w_q = torch.clamp(torch.round(wf / scale.unsqueeze(-2)), -127, 127)
    return {"w_q": w_q.to(torch.int8), "scale": scale}


def dequantize(p: dict, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return (p["w_q"].float() * p["scale"].unsqueeze(-2)).to(dtype)


class _MatmulF32Out(torch.autograd.Function):
    """bf16 a [m, K] @ b [K, N] (bf16, or int8 codes converted to bf16 here) -> f32 [m, N]
    with f32 accumulation, on the card. Saving b as it is (not its bf16 copy) keeps an
    int8 weight at one byte per code for the backward. The f32 cotangent meets the bf16
    operand split into bf16 high and low parts (two products), which keeps about 16 of
    its bits, as JAX's f32 transpose products keep them; integer codes get no gradient."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b.to(torch.bfloat16), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = _input_grad(g, b, a.dtype)
        if ctx.needs_input_grad[1]:
            gb = _split_mm(a.t(), g).to(b.dtype)
        return ga, gb


def _input_grad(g: torch.Tensor, b: torch.Tensor, a_dtype: torch.dtype) -> torch.Tensor:
    """The input gradient ``g @ b^T`` of ``mm_f32(a, b)`` for an f32 cotangent g, in a's
    dtype: against bf16 (or int8) b on the card through ``_split_mm``, else in f32."""
    if g.is_cuda and a_dtype == torch.bfloat16 and b.dtype in (torch.bfloat16, torch.int8):
        return _split_mm(g, b.to(torch.bfloat16).t()).to(a_dtype)
    return (g.float() @ b.float().t()).to(a_dtype)


class _W8A16(torch.autograd.Function):
    """K4's route with a gradient for x: the backward is the library route's,
    ``(g * scale) @ w_q^T`` (stage 2's frozen int8 LM passes gradients through it)."""

    @staticmethod
    def forward(ctx, x, w_q, scale, out_dtype):
        ctx.save_for_backward(w_q, scale)
        ctx.x_dtype = x.dtype
        return k4.w8a16_matmul(x, w_q, scale, out_dtype)

    @staticmethod
    def backward(ctx, g):
        w_q, scale = ctx.saved_tensors
        return _input_grad(g.float() * scale.float(), w_q, ctx.x_dtype), None, None, None


class _W8A16Group(torch.autograd.Function):
    """K4's grouped route (one launch for products that share x) with a gradient for x:
    the sum of each product's library-route backward ``(g_i * scale_i) @ w_i^T``."""

    @staticmethod
    def forward(ctx, x, out_dtype, *ws):
        ctx.save_for_backward(*ws)
        ctx.x_dtype = x.dtype
        products = [{"w_q": w, "scale": s} for w, s in zip(ws[::2], ws[1::2])]
        return tuple(k4.w8a16_matmul_group(x, products, out_dtype))

    @staticmethod
    def backward(ctx, *gs):
        ws = ctx.saved_tensors
        gx = None
        for g, w_q, scale in zip(gs, ws[::2], ws[1::2]):
            if g is not None:
                part = _input_grad(g.float() * scale.float(), w_q, ctx.x_dtype)
                gx = part if gx is None else gx + part
        return (gx, None) + (None,) * len(ws)


def _split_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b -> f32 where one operand is f32 and the other bf16: the f32 one is split
    into hi = bf16(x) and lo = bf16(x - hi), and both products accumulate in f32."""
    if a.dtype == torch.float32:
        hi = a.to(torch.bfloat16)
        lo = (a - hi.float()).to(torch.bfloat16)
        return (torch.mm(hi, b, out_dtype=torch.float32)
                + torch.mm(lo, b, out_dtype=torch.float32))
    hi = b.to(torch.bfloat16)
    lo = (b - hi.float()).to(torch.bfloat16)
    return torch.mm(a, hi, out_dtype=torch.float32) + torch.mm(a, lo, out_dtype=torch.float32)


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [m, K] @ b [K, N] (any strides) -> f32 [m, N] with exact products: a bf16 ``a``
    on the card against a bf16 or int8 ``b`` is multiplied in bf16 with f32 accumulation
    and output (no f32 copy of b); anything else in f32. Differentiable in a and in a
    float b."""
    if a.is_cuda and a.dtype == torch.bfloat16 and b.dtype in (torch.bfloat16, torch.int8):
        return _MatmulF32Out.apply(a, b)
    return a.float() @ b.float()


def q_matmul(x: torch.Tensor, p: dict, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """[..., in] @ int8 [in, out] * scale -> [..., out] in ``out_dtype`` (default x.dtype).
    ``p["w_q"]`` may be a layer's view of a stacked tensor or the transposed view of a tied
    embedding; neither is copied on K4's route (see the module for the routes)."""
    out_dtype = out_dtype or x.dtype
    x2 = x.reshape(-1, x.shape[-1])
    w_q, scale = p["w_q"], p["scale"]
    if x2.shape[0] > KERNEL_MAX_ROWS:
        y = (mm_f32(x2, w_q) * scale.float()).to(out_dtype)
    else:
        y = _W8A16.apply(x2, w_q, scale, out_dtype)
    return y.reshape(*x.shape[:-1], y.shape[-1])


def q_matmul_group(x: torch.Tensor, ps: list, out_dtype: torch.dtype | None = None
                   ) -> list[torch.Tensor]:
    """``[q_matmul(x, p, out_dtype) for p in ps]`` for products that share x (q|k|v,
    gate|up): up to ``KERNEL_MAX_ROWS`` rows one K4 launch computes them all (the codes
    read in place, as ``q_matmul`` reads them), above it each takes the library route."""
    out_dtype = out_dtype or x.dtype
    x2 = x.reshape(-1, x.shape[-1])
    if x2.shape[0] > KERNEL_MAX_ROWS:
        return [q_matmul(x, p, out_dtype) for p in ps]
    ys = _W8A16Group.apply(x2, out_dtype, *[t for p in ps for t in (p["w_q"], p["scale"])])
    return [y.reshape(*x.shape[:-1], y.shape[-1]) for y in ys]


def quantize_act(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token dynamic int8 activation quantization: x [..., K] -> (int8 codes [..., K],
    f32 scales [..., 1]); scale = max(amax, 1e-6) / 127, codes round(x / scale) half to
    even, clipped to +-127."""
    xf = x.float()
    x_scale = div127(torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-6))
    x_q = torch.clamp(torch.round(xf / x_scale), -127, 127)
    return x_q.to(torch.int8), x_scale


def q_matmul_a8q(x_q: torch.Tensor, x_scale: torch.Tensor, p: dict,
                 out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """int8 activations [..., K] (scales [..., 1]) x int8 weights {'w_q' [K, N], 'scale'
    [N]} -> [..., N] in out_dtype: the exact int32 product (``torch._int_mm``), then
    (y * x_scale) * scale in f32. On the card a block of 16 rows or fewer is padded with
    zero codes to 17, and the [in, out] codes are handed over K-contiguous through a
    per-call transposed copy: on the H100, cuBLAS's int8 product runs several times
    slower on a row-major B (PERF.md), and the copy reads and writes the codes once."""
    a = x_q.reshape(-1, x_q.shape[-1]).contiguous()
    w = p["w_q"]
    m = a.shape[0]
    if a.is_cuda:
        if a.shape[1] % 8 or w.shape[1] % 8:
            raise ValueError(f"the card's int8 product needs K and N multiples of 8, got "
                             f"{tuple(a.shape)} @ {tuple(w.shape)}")
        if m <= 16:
            a = torch.cat([a, a.new_zeros((17 - m, a.shape[1]))])
        w = w.t().contiguous().t()
    y = torch._int_mm(a, w)[:m]
    y = y.reshape(*x_q.shape[:-1], y.shape[-1]).float() * x_scale
    return (y * p["scale"].float()).to(out_dtype)


def q_matmul_a8(x: torch.Tensor, p: dict) -> torch.Tensor:
    """w8a8: x quantized per token, times int8 weights, in x.dtype."""
    x_q, x_scale = quantize_act(x)
    return q_matmul_a8q(x_q, x_scale, p, out_dtype=x.dtype)


def quantize_embedding(emb: torch.Tensor) -> dict:
    """[V, D] float -> int8 with per-ROW (vocab) scales, so a gather dequantizes per token."""
    ef = emb.float()
    scale = div127(torch.clamp(ef.abs().amax(dim=1), min=1e-8))
    w_q = torch.clamp(torch.round(ef / scale[:, None]), -127, 127)
    return {"w_q": w_q.to(torch.int8), "scale": scale}


# ------------------------------------------------------------------ the LM's weights
# The float LM arrives as its state dict in the port's names (torch layout, [out, in]);
# the quantized LM leaves in the JAX package's tree layout: layer leaves stacked on a
# leading [L] axis, linears [in, out]. Each layer is quantized on its own, which gives
# the same values as quantizing the stack (scales never span layers) without an f32 copy
# of a whole stack.
LINEARS = {"q": "q_proj", "k": "k_proj", "v": "v_proj", "o": "o_proj"}
MLP = {"gate": "gate_proj", "up": "up_proj", "down": "down_proj"}


def num_layers(state: dict) -> int:
    return sum(1 for k in state if k.startswith("layers.") and k.endswith(".q_proj.weight"))


def layer_weights(state: dict, module: str) -> list[torch.Tensor]:
    """Layer by layer, the [in, out] view of ``layers.{i}.{module}.weight``."""
    return [state[f"layers.{i}.{module}.weight"].t() for i in range(num_layers(state))]


def stack_layers(state: dict, name: str) -> torch.Tensor:
    return torch.stack([state[f"layers.{i}.{name}"] for i in range(num_layers(state))])


def quantize_per_layer(fn, mats) -> dict:
    """fn maps one [in, out] matrix to a dict of tensors; the results are stacked."""
    outs = [fn(w) for w in mats]
    return {k: torch.stack([o[k].contiguous() for o in outs]) for k in outs[0]}


def float_layer_leaves(state: dict) -> dict:
    """The LM's norm weights, stacked as the JAX tree's ``ln1_w`` / ``ln2_w``."""
    return {"ln1_w": stack_layers(state, "input_layernorm.weight"),
            "ln2_w": stack_layers(state, "post_attention_layernorm.weight")}


def quantized_linear_tree(state: dict, module: str, fn) -> dict:
    lin = quantize_per_layer(fn, layer_weights(state, module))
    if f"layers.0.{module}.bias" in state:
        lin["b"] = stack_layers(state, f"{module}.bias")
    return lin


def head_and_embed(state: dict) -> dict:
    """``embed`` (int8 per row) and ``ln_f_w``; ``lm_head`` is the caller's."""
    return {"embed": quantize_embedding(state["embed_tokens"]), "ln_f_w": state["norm.weight"]}


def quantize_lm_params(state: dict) -> dict:
    """The float LM's state dict -> the JAX package's int8 tree: every layer linear
    {'w_q' [L, in, out], 'scale' [L, out] (, 'b')}, lm_head {'w_q' [d, V], 'scale' [V]},
    embed int8 per row. Norm weights and biases keep their dtype."""
    layers = float_layer_leaves(state)
    for name, module in LINEARS.items():
        layers[name] = quantized_linear_tree(state, module, quantize_linear)
    layers["mlp"] = {name: quantize_per_layer(quantize_linear, layer_weights(state, module))
                     for name, module in MLP.items()}
    out = {"layers": layers, **head_and_embed(state)}
    if "lm_head" in state:
        out["lm_head"] = quantize_linear(state["lm_head"].t())
    return out


def random_quantized_lm(generator: torch.Generator, cfg, device: torch.device | str) -> dict:
    """Random int8 LM tree in the layout of ``quantize_lm_params``, made on ``device``
    without float weights (a 7B f32 init would be ~30 GB). Codes uniform in [-127, 127],
    scales 0.02 / 127, unit norms, zero biases, all f32 but the codes."""
    hd = cfg.resolved_head_dim()
    d, f, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    n_q, n_kv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    kw = dict(device=device)

    def codes(*shape):
        return torch.randint(-127, 128, shape, dtype=torch.int8, generator=generator, **kw)

    def qlin(a, b, bias=False):
        p = {"w_q": codes(L, a, b), "scale": torch.full((L, b), 0.02 / 127.0, **kw)}
        if bias:
            p["b"] = torch.zeros((L, b), **kw)
        return p

    bias = cfg.attention_bias
    params = {
        "embed": {"w_q": codes(cfg.vocab_size, d),
                  "scale": torch.full((cfg.vocab_size,), 0.02 / 127.0, **kw)},
        "layers": {"ln1_w": torch.ones((L, d), **kw), "q": qlin(d, n_q, bias),
                   "k": qlin(d, n_kv, bias), "v": qlin(d, n_kv, bias), "o": qlin(n_q, d),
                   "ln2_w": torch.ones((L, d), **kw),
                   "mlp": {"gate": qlin(d, f), "up": qlin(d, f), "down": qlin(f, d)}},
        "ln_f_w": torch.ones((d,), **kw),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"w_q": codes(d, cfg.vocab_size),
                             "scale": torch.full((cfg.vocab_size,), 0.02 / 127.0, **kw)}
    return params


# ------------------------------------------------------------------ the encoder's weights
# The float encoder arrives as a WhisperEncoder state dict (port names, torch layout); the
# quantized layers leave as the JAX package's ``params["layers"]`` tree: leaves stacked on
# [L], linears [in, out]. Conv stem, positions and ln_post stay float in the module.
ENC_LINEARS = {"q": "q_proj", "k": "k_proj", "v": "v_proj", "o": "out_proj",
               "fc1": "fc1", "fc2": "fc2"}
ENC_NORMS = {"ln1_w": "self_attn_layer_norm.weight", "ln1_b": "self_attn_layer_norm.bias",
             "ln2_w": "final_layer_norm.weight", "ln2_b": "final_layer_norm.bias"}


def quantize_encoder_params(state: dict) -> dict:
    """A WhisperEncoder state dict -> the JAX ``quantize_encoder_params`` layer tree: q, k,
    v, o, fc1, fc2 as {'w_q' [L, in, out], 'scale' [L, out] (, 'b')} and the stacked
    LayerNorm weights, in the dtypes they came in."""
    layers = {name: stack_layers(state, key) for name, key in ENC_NORMS.items()}
    for name, module in ENC_LINEARS.items():
        layers[name] = quantized_linear_tree(state, module, quantize_linear)
    return layers


def quantize_encoder_params_fused(state: dict, head_dim: int) -> dict:
    """A WhisperEncoder state dict -> the JAX ``quantize_encoder_params_fused`` layer tree
    (the K9 kernels' layout): q|k|v concatenated into one {'w_q' [L, d, 3d], 'scale', 'b'}
    with the q pre-scale head_dim^-0.5 folded into the q columns' scales and bias (k's
    missing bias is zeros), then o, fc1, fc2 as in ``quantize_encoder_params``."""
    layers = {name: stack_layers(state, key) for name, key in ENC_NORMS.items()}
    lin = {name: quantized_linear_tree(state, module, quantize_linear)
           for name, module in ENC_LINEARS.items()}
    qs = torch.tensor(float(head_dim), dtype=torch.float32) ** -0.5
    q_b = lin["q"]["b"]
    k_b = lin["k"].get("b", torch.zeros_like(q_b))
    layers["qkv"] = {
        "w_q": torch.cat([lin[n]["w_q"] for n in ("q", "k", "v")], dim=2),
        "scale": torch.cat([lin["q"]["scale"] * qs, lin["k"]["scale"], lin["v"]["scale"]],
                           dim=1),
        "b": torch.cat([q_b.float() * qs, k_b, lin["v"]["b"]], dim=1),
    }
    for name in ("o", "fc1", "fc2"):
        layers[name] = lin[name]
    return layers
