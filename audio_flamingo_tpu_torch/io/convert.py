"""Weight conversion into the port's ``AF3Model`` state dict.

- ``params_from_jax(params, cfg)``: the JAX package's AF3 params pytree, as numpy arrays
  (layers stacked on a leading axis, linears [in, out], convs WIO [k, in, out]). A
  quantized LM (``ops/quant.py`` / ``ops/quant4.py`` trees) crosses as it is: int8 codes,
  f32 scales and the stacked layout, under ``lm.<tree path>`` (``lm.layers.qkv.w_p``).
- ``state_dict_from_hf(sd, cfg)``: an HF-named AF3 state dict (qwen2_audio names
  ``audio_tower.* / multi_modal_projector.linear.* / language_model.*``, or the llava
  ``mm_projector`` variants), torch layouts, as ``load`` reads from safetensors.

Both return {port name: torch tensor}; a tied LM head is dropped.
"""

from __future__ import annotations

import numpy as np
import torch

from audio_flamingo_tpu_torch.config import AF3Config, Qwen2Config
from audio_flamingo_tpu_torch.models.qwen2 import flatten


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _lin(p: dict, name: str, out: dict) -> None:
    """JAX linear {'w': [in, out], 'b'?} -> torch Linear weight [out, in] (+ bias)."""
    out[name + ".weight"] = _t(np.asarray(p["w"]).T)
    if "b" in p:
        out[name + ".bias"] = _t(p["b"])


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _is_quantized(lm: dict) -> bool:
    return isinstance(lm["embed"], dict) or any(
        isinstance(v, dict) and ("w_q" in v or "w_p" in v) for v in lm["layers"].values())


def _as_tensor(value) -> torch.Tensor:
    """A quantized tree's leaf as it is: integer codes keep their dtype, floats go to f32."""
    arr = np.array(value)
    return torch.from_numpy(arr if np.issubdtype(arr.dtype, np.integer)
                            else arr.astype(np.float32))


def params_from_jax(params: dict, cfg: AF3Config) -> dict[str, torch.Tensor]:
    sd: dict[str, torch.Tensor] = {}
    enc = params["encoder"]
    sd["encoder.conv1.weight"] = _t(np.asarray(enc["conv1_w"]).transpose(2, 1, 0))
    sd["encoder.conv1.bias"] = _t(enc["conv1_b"])
    sd["encoder.conv2.weight"] = _t(np.asarray(enc["conv2_w"]).transpose(2, 1, 0))
    sd["encoder.conv2.bias"] = _t(enc["conv2_b"])
    sd["encoder.embed_positions"] = _t(enc["pos"])
    for i in range(cfg.encoder.num_layers):
        lp = _layer(enc["layers"], i)
        p = f"encoder.layers.{i}."
        sd[p + "self_attn_layer_norm.weight"] = _t(lp["ln1_w"])
        sd[p + "self_attn_layer_norm.bias"] = _t(lp["ln1_b"])
        for ours, theirs in (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"),
                             ("out_proj", "o"), ("fc1", "fc1"), ("fc2", "fc2")):
            _lin(lp[theirs], p + ours, sd)
        sd[p + "final_layer_norm.weight"] = _t(lp["ln2_w"])
        sd[p + "final_layer_norm.bias"] = _t(lp["ln2_b"])
    sd["encoder.layer_norm.weight"] = _t(enc["ln_post_w"])
    sd["encoder.layer_norm.bias"] = _t(enc["ln_post_b"])

    for name, p in params["adaptor"].items():
        _lin(p, f"adaptor.{name}", sd)

    sd.update(lm_params_from_jax(params["lm"], cfg.lm, "lm."))
    return sd


def lm_params_from_jax(lm: dict, cfg: Qwen2Config, prefix: str = "") -> dict[str, torch.Tensor]:
    """The JAX Qwen2 tree -> the port's LM state dict (names under ``prefix``): a float
    tree into ``Qwen2``'s names and torch layout, a quantized tree as it is."""
    if _is_quantized(lm):
        if not isinstance(lm["embed"], dict):
            raise ValueError("a quantized LM tree needs its int8 embedding "
                             "(quantize_lm_params with quantize_embed=True)")
        return {k: _as_tensor(v) for k, v in flatten(lm, prefix).items()}
    sd: dict[str, torch.Tensor] = {prefix + "embed_tokens": _t(lm["embed"])}
    for i in range(cfg.num_layers):
        lp = _layer(lm["layers"], i)
        p = f"{prefix}layers.{i}."
        sd[p + "input_layernorm.weight"] = _t(lp["ln1_w"])
        for ours, theirs in (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"), ("o_proj", "o")):
            _lin(lp[theirs], p + ours, sd)
        sd[p + "post_attention_layernorm.weight"] = _t(lp["ln2_w"])
        for ours, theirs in (("gate_proj", "gate"), ("up_proj", "up"), ("down_proj", "down")):
            _lin({"w": lp["mlp"][theirs]}, p + ours, sd)
    sd[prefix + "norm.weight"] = _t(lm["ln_f_w"])
    if not cfg.tie_word_embeddings:
        sd[prefix + "lm_head"] = _t(np.asarray(lm["lm_head"]).T)
    return sd


_TOWER_PREFIXES = ("audio_tower.", "model.audio_tower.", "model.sound_tower.",
                   "audio_encoder.", "model.audio_encoder.")
_ADAPTOR_NAMES = ((("multi_modal_projector.linear", "fc1"),),
                  (("model.multi_modal_projector.linear", "fc1"),),
                  (("multi_modal_projector.linear", "fc1"), ("mm_projector.2", "fc2")),
                  (("mm_projector.0", "fc1"), ("mm_projector.2", "fc2")),
                  (("model.mm_projector.0", "fc1"), ("model.mm_projector.2", "fc2")),
                  (("mm_projector.fc1", "fc1"), ("mm_projector.fc2", "fc2")),
                  (("model.mm_projector.fc1", "fc1"), ("model.mm_projector.fc2", "fc2")))


def state_dict_from_hf(sd: dict, cfg: AF3Config) -> dict[str, torch.Tensor]:
    """HF names -> port names. Raises KeyError when a part of the model is missing."""
    sd = {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
          for k, v in sd.items()}
    tower = next((p for p in _TOWER_PREFIXES if p + "conv1.weight" in sd), None)
    if tower is None:
        raise KeyError("no audio tower found in state dict")
    out: dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        if k.startswith(tower):
            name = k[len(tower):].replace("self_attn.", "")
            if name == "embed_positions.weight":
                name = "embed_positions"
            out["encoder." + name] = v

    # the largest adaptor naming that is present wins (2-layer over 1-layer)
    found = [names for names in _ADAPTOR_NAMES
             if all(base + ".weight" in sd for base, _ in names)]
    if not found:
        raise KeyError("no audio adaptor/projector found in state dict")
    for base, ours in max(found, key=len):
        out[f"adaptor.{ours}.weight"] = sd[base + ".weight"]
        out[f"adaptor.{ours}.bias"] = sd[base + ".bias"]

    lm_prefix = "language_model." if any(k.startswith("language_model.") for k in sd) else ""
    for k, v in sd.items():
        if not k.startswith(lm_prefix + "model.") or k.startswith(tower):
            continue
        name = k[len(lm_prefix + "model."):]
        if name.startswith("layers.") or name.startswith("norm."):
            out["lm." + name.replace("self_attn.", "").replace("mlp.", "")] = v
        elif name == "embed_tokens.weight":
            out["lm.embed_tokens"] = v
    if not cfg.lm.tie_word_embeddings:
        out["lm.lm_head"] = sd[lm_prefix + "lm_head.weight"]
    return out
