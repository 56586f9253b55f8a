"""Weight conversion into the port's state dicts (``AF3Model`` and the voice modules).

- ``params_from_jax(params, cfg)``: the JAX package's AF3 params pytree, as numpy arrays
  (layers stacked on a leading axis, linears [in, out], convs WIO [k, in, out]). A
  quantized LM (``ops/quant.py`` / ``ops/quant4.py`` trees) crosses as it is: int8 codes,
  f32 scales and the stacked layout, under ``lm.<tree path>`` (``lm.layers.qkv.w_p``);
  so do an int8 encoder's layers (either layout) under ``encoder.layers.<tree path>``.
- ``state_dict_from_hf(sd, cfg)``: an HF-named AF3 state dict (qwen2_audio names
  ``audio_tower.* / multi_modal_projector.linear.* / language_model.*``, or the llava
  ``mm_projector`` variants), torch layouts, as ``load`` reads from safetensors.
- ``qwen2_state_from_hf(sd, cfg)``: a plain HF Qwen2 CausalLM state dict (a speculative
  draft, ``api.load_draft``) into ``Qwen2``'s names (JAX ``io/hf_import.import_qwen2``
  :57); ``lm_params_from_jax`` carries a JAX draft's parameters (float or quantized).
- Voice: ``tts_params_from_jax`` (``models/tts.TTSHead``), ``vocoder_params_from_jax``
  (``audio/neural_vocoder.Vocoder``; the layouts move here, once) and
  ``rvq_params_from_jax`` (``audio/rvq.RVQ``'s buffers).

All return {port name: torch tensor}; a tied LM head is dropped.
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


def _is_quantized_encoder(layers: dict) -> bool:
    """Either int8 encoder layout (``quantize_encoder_params`` or ``..._fused``)."""
    return "qkv" in layers or "w_q" in layers["q"]


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
    sd["encoder.layer_norm.weight"] = _t(enc["ln_post_w"])
    sd["encoder.layer_norm.bias"] = _t(enc["ln_post_b"])
    layers = enc["layers"]
    if _is_quantized_encoder(layers):
        sd.update({k: _as_tensor(v) for k, v in flatten(layers, "encoder.layers.").items()})
    else:
        for i in range(cfg.encoder.num_layers):
            lp = _layer(layers, i)
            p = f"encoder.layers.{i}."
            sd[p + "self_attn_layer_norm.weight"] = _t(lp["ln1_w"])
            sd[p + "self_attn_layer_norm.bias"] = _t(lp["ln1_b"])
            for ours, theirs in (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"),
                                 ("out_proj", "o"), ("fc1", "fc1"), ("fc2", "fc2")):
                _lin(lp[theirs], p + ours, sd)
            sd[p + "final_layer_norm.weight"] = _t(lp["ln2_w"])
            sd[p + "final_layer_norm.bias"] = _t(lp["ln2_b"])

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


def qwen2_state_from_hf(sd: dict, cfg: Qwen2Config, prefix: str = "") -> dict[str, torch.Tensor]:
    """An HF Qwen2ForCausalLM state dict (names under ``prefix``) -> ``Qwen2``'s names:
    ``model.layers.*`` and ``model.norm.*`` without ``self_attn.`` / ``mlp.``,
    ``model.embed_tokens.weight`` -> ``embed_tokens`` and, untied, ``lm_head.weight`` ->
    ``lm_head``. Torch layouts are kept."""
    sd = {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
          for k, v in sd.items()}
    out: dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        if not k.startswith(prefix + "model."):
            continue
        name = k[len(prefix + "model."):]
        if name.startswith("layers.") or name.startswith("norm."):
            out[name.replace("self_attn.", "").replace("mlp.", "")] = v
        elif name == "embed_tokens.weight":
            out["embed_tokens"] = v
    if not cfg.tie_word_embeddings:
        out["lm_head"] = sd[prefix + "lm_head.weight"]
    return out


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
    lm = qwen2_state_from_hf({k: v for k, v in sd.items() if not k.startswith(tower)}, cfg.lm,
                             lm_prefix)
    out.update({"lm." + k: v for k, v in lm.items()})
    return out


def tts_params_from_jax(params: dict, cfg) -> dict[str, torch.Tensor]:
    """JAX's TTS head tree (models/tts.py: blocks stacked on a leading axis, linears
    [in, out]) -> ``TTSHead``'s state dict (Linear [out, in])."""
    sd: dict[str, torch.Tensor] = {"embed": _t(params["embed"]),
                                   "queries": _t(params["queries"])}
    _lin(params["state_proj"], "state_proj", sd)
    for i in range(cfg.num_layers):
        bp = _layer(params["blocks"], i)
        p = f"blocks.{i}."
        for n in ("ln1", "ln2"):
            sd[p + n + ".weight"] = _t(bp[n + "_w"])
            sd[p + n + ".bias"] = _t(bp[n + "_b"])
        for n in ("q", "k", "v", "o", "fc1", "fc2"):
            _lin(bp[n], p + n, sd)
    sd["ln_f.weight"] = _t(params["ln_f_w"])
    sd["ln_f.bias"] = _t(params["ln_f_b"])
    _lin(params["mel_out"], "mel_out", sd)
    if "speaker" in params:
        sd["speaker"] = _t(params["speaker"])
    if "rvq_out" in params:
        _lin(params["rvq_out"], "rvq_out", sd)
    return sd


def vocoder_params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """JAX's vocoder tree (audio/neural_vocoder.py: NWC / WIO convs, w [k, in, out]) ->
    ``Vocoder``'s state dict: convs [out, in, k]; the upsampling convs in
    ``conv_transpose1d``'s [in, out, k] with the kernel flipped (JAX's transposed conv is
    a cross-correlation of the dilated input with w)."""
    sd: dict[str, torch.Tensor] = {}

    def conv(name: str, p: dict, transposed: bool = False) -> None:
        w = np.asarray(p["w"], np.float32)
        w = w[::-1].transpose(1, 2, 0) if transposed else w.transpose(2, 1, 0)
        sd[name + ".weight"] = _t(np.ascontiguousarray(w))
        sd[name + ".bias"] = _t(p["b"])

    conv("pre", params["pre"])
    conv("post", params["post"])
    for i, p in enumerate(params["ups"]):
        conv(f"ups.{i}", p, transposed=True)
    for i, blocks in enumerate(params["res"]):
        for j, blk in enumerate(blocks):
            conv(f"res.{i}.{j}.c1", blk["c1"])
            conv(f"res.{i}.{j}.c2", blk["c2"])
    if "f0_head" in params:
        conv("f0_head.c1", params["f0_head"]["c1"])
        conv("f0_head.c2", params["f0_head"]["c2"])
        for i, p in enumerate(params["src"]):
            conv(f"src.{i}", p)
    return sd


def rvq_params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """JAX's RVQ codec tree (audio/rvq.py) -> ``RVQ``'s buffers."""
    return {k: _t(params[k]) for k in ("codebooks", "ema_count", "ema_sum")}
