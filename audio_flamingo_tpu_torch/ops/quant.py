"""Weight-only int8 quantization (w8a16), as ``audio_flamingo_tpu/ops/quant.py``.

Per-output-channel scales; activations stay in the compute dtype. The codes and scales are
bit-identical to the JAX package's: the same f32 amax, ``max(amax, 1e-8) / 127`` and a
half-to-even ``round(w / scale)``.

``q_matmul`` is a plain product, as the JAX package leaves it to XLA (its Pallas kernel,
K4, is reached by no caller there). On the card a bf16 x is multiplied with the int8 codes
converted to bf16, accumulating and writing f32, then scaled: int8 values and bf16 inputs
are exact in bf16, so this is JAX's f32-accumulated dot up to the order of the sums, and
no f32 copy of the weight is made. The bf16 copy of the codes is made on every call.
"""

from __future__ import annotations

import torch


def quantize_linear(w: torch.Tensor) -> dict:
    """[in, out] float -> {'w_q': int8 [in, out], 'scale': f32 [out]}."""
    wf = w.float()
    scale = torch.clamp(wf.abs().amax(dim=-2), min=1e-8) / 127.0
    w_q = torch.clamp(torch.round(wf / scale.unsqueeze(-2)), -127, 127)
    return {"w_q": w_q.to(torch.int8), "scale": scale}


def dequantize(p: dict, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return (p["w_q"].float() * p["scale"].unsqueeze(-2)).to(dtype)


def int8_mm(x2: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """x2 [m, K] @ int8 codes [K, N] (any strides) -> f32 [m, N], exact products."""
    if x2.is_cuda and x2.dtype == torch.bfloat16:
        return torch.mm(x2, w_q.to(torch.bfloat16), out_dtype=torch.float32)
    return x2.float() @ w_q.float()


def q_matmul(x: torch.Tensor, p: dict) -> torch.Tensor:
    """[..., in] @ int8 [in, out] * scale -> [..., out] in x.dtype."""
    y = int8_mm(x.reshape(-1, x.shape[-1]), p["w_q"]) * p["scale"].float()
    return y.to(x.dtype).reshape(*x.shape[:-1], y.shape[-1])


def quantize_embedding(emb: torch.Tensor) -> dict:
    """[V, D] float -> int8 with per-ROW (vocab) scales, so a gather dequantizes per token."""
    ef = emb.float()
    scale = torch.clamp(ef.abs().amax(dim=1), min=1e-8) / 127.0
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
