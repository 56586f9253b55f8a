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
  :57); ``lm_params_from_jax`` carries a JAX draft's parameters (float or quantized), and
  ``lm_params_to_jax`` goes back; both carry LoRA adapters (``models/lora.py``).
- Voice: ``tts_params_from_jax`` (``models/tts.TTSHead``), ``vocoder_params_from_jax``
  (``audio/neural_vocoder.Vocoder``; the layouts move here, once) and
  ``rvq_params_from_jax`` (``audio/rvq.RVQ``'s buffers).
- CLAP text (``models/clap_text``): ``clap_text_params_from_jax`` / ``clap_text_params_to_jax``;
  a bare OPT LM: ``opt_params_from_jax``.
- AF1/AF2: ``af2_params_from_jax(params, cfg)`` (the fusion stacks and the LM:
  ``lm_params_from_jax`` for a Qwen2, float or quantized, and the OPT mapping) into
  ``models/flamingo.FlamingoModel``'s names, and ``clap_params_from_jax(params, cfg)``
  into ``models/clap.ClapAudioTower``'s (HWIO convs to OIHW, once). ``af2_params_to_jax``
  and ``clap_params_to_jax`` go back to the JAX trees' flat names (the pytree flattened
  with ".", as JAX's ``train/checkpoints.export_safetensors`` writes them), which
  ``api.save_af2`` writes; the ``*_from_jax`` functions take a nested tree or those flat
  names.

All return {port name: torch tensor}; a tied LM head is dropped.
"""

from __future__ import annotations

import numpy as np
import torch

from audio_flamingo_tpu_torch.config import (AF2Config, AF3Config, ClapAudioConfig, OPTConfig,
                                             Qwen2Config)
from audio_flamingo_tpu_torch.models.qwen2 import flatten
from audio_flamingo_tpu_torch.models.lora import MODULES as LORA_MODULES
from audio_flamingo_tpu_torch.ops.lora import LORA_NAMES, MLP_TARGETS


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
    tree into ``Qwen2``'s names and torch layout, a quantized tree as it is. LoRA adapters
    (``models/lora.py``) cross too: stacked in a quantized tree, one layer's slice on each
    float linear (``layers.{i}.q_proj.lora_a``; load them into a model that ``add_lora``
    gave adapters)."""
    if _is_quantized(lm):
        if not isinstance(lm["embed"], dict):
            raise ValueError("a quantized LM tree needs its int8 embedding "
                             "(quantize_lm_params with quantize_embed=True)")
        return {k: _as_tensor(v) for k, v in flatten(lm, prefix).items()}
    return _qwen2_from_flat(_flat_tree(lm), cfg, prefix)


def _qwen2_from_flat(flat: dict, cfg: Qwen2Config, prefix: str) -> dict[str, torch.Tensor]:
    """A float Qwen2 tree's flat names -> ``Qwen2``'s state dict, adapters included. JAX
    wraps the float mlp entries in {"w": ...} dicts once an mlp target has adapters."""
    flat = {(k[:-2] if k.startswith("layers.mlp.") and k.endswith(".w") else k): v
            for k, v in flat.items()}
    sd = _from_jax(flat, _qwen2_names(cfg), prefix)
    for target, module in LORA_MODULES.items():
        node = f"layers.mlp.{target}" if target in MLP_TARGETS else f"layers.{target}"
        if node + ".lora_a" not in flat:
            continue
        for leaf in LORA_NAMES:
            arr = np.asarray(flat[f"{node}.{leaf}"], np.float32)
            for i in range(cfg.num_layers):
                sd[f"{prefix}layers.{i}.{module}.{leaf}"] = torch.from_numpy(np.array(arr[i]))
    return sd


def lm_params_to_jax(state: dict, cfg: Qwen2Config, prefix: str = "") -> dict[str, np.ndarray]:
    """The port's LM state dict (names under ``prefix``) -> the JAX Qwen2 tree's flat
    names: a float LM in JAX's layout (f32) with its adapters stacked on the layers (the
    mlp entries wrapped in {"w": ...} once an mlp target has adapters, as JAX's
    ``add_lora`` leaves them), a quantized tree as it is (codes and scales unchanged)."""
    lm = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
    if "embed.w_q" in lm:
        return {k: (v.detach().cpu().numpy() if not v.is_floating_point() else _to_jax(v, "same"))
                for k, v in lm.items()}
    out = _names_to_jax(lm, _qwen2_names(cfg))
    wrapped = False
    for target, module in LORA_MODULES.items():
        if f"layers.0.{module}.lora_a" not in lm:
            continue
        wrapped |= target in MLP_TARGETS
        node = f"layers.mlp.{target}" if target in MLP_TARGETS else f"layers.{target}"
        for leaf in LORA_NAMES:
            out[f"{node}.{leaf}"] = np.stack([_to_jax(lm[f"layers.{i}.{module}.{leaf}"], "same")
                                              for i in range(cfg.num_layers)])
    if wrapped:
        for target in MLP_TARGETS:
            out[f"layers.mlp.{target}.w"] = out.pop(f"layers.mlp.{target}")
    return out


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


# ----------------------------------------------------------------------------------------
# Name tables: (port name, JAX flat name, layer index or None, layout). A layout moves a
# JAX array into the port's: "same", "linear" ([in, out] -> [out, in]) or "conv" (HWIO ->
# OIHW). A layer index picks one layer of a leaf stacked on a leading axis.


def _flat_tree(tree, prefix: str = "") -> dict:
    """A nested tree (dicts, lists) -> {dotted name: leaf}, as JAX's export_safetensors
    names it; a flat dict passes through."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, value in items:
        name = f"{prefix}{key}"
        if isinstance(value, (dict, list, tuple)):
            out.update(_flat_tree(value, name + "."))
        else:
            out[name] = value
    return out


def _to_port(arr, layout: str) -> torch.Tensor:
    arr = np.asarray(arr, np.float32)
    if layout == "linear":
        arr = arr.T
    elif layout == "conv":
        arr = arr.transpose(3, 2, 0, 1)
    return torch.from_numpy(np.array(arr, order="C"))


def _to_jax(t: torch.Tensor, layout: str) -> np.ndarray:
    arr = t.detach().float().cpu().numpy()
    if layout == "linear":
        arr = arr.T
    elif layout == "conv":
        arr = arr.transpose(2, 3, 1, 0)
    return np.array(arr, order="C")


def _from_jax(flat: dict, names: list, prefix: str = "") -> dict[str, torch.Tensor]:
    sd = {}
    for port, theirs, layer, layout in names:
        arr = np.asarray(flat[theirs])
        sd[prefix + port] = _to_port(arr if layer is None else arr[layer], layout)
    return sd


def _names_to_jax(state: dict, names: list, prefix: str = "") -> dict[str, np.ndarray]:
    """The inverse of ``_from_jax``: stacked leaves are stacked again in layer order."""
    out, stacks = {}, {}
    for port, theirs, layer, layout in names:
        arr = _to_jax(state[prefix + port], layout)
        if layer is None:
            out[theirs] = arr
        else:
            stacks.setdefault(theirs, {})[layer] = arr
    for theirs, layers in stacks.items():
        out[theirs] = np.stack([layers[i] for i in range(len(layers))])
    return out


def _qwen2_names(cfg: Qwen2Config) -> list:
    names = [("embed_tokens", "embed", None, "same"), ("norm.weight", "ln_f_w", None, "same")]
    for i in range(cfg.num_layers):
        p = f"layers.{i}."
        names += [(p + "input_layernorm.weight", "layers.ln1_w", i, "same"),
                  (p + "post_attention_layernorm.weight", "layers.ln2_w", i, "same")]
        for ours, theirs in (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v")):
            names += [(p + ours + ".weight", f"layers.{theirs}.w", i, "linear")]
            if cfg.attention_bias:
                names += [(p + ours + ".bias", f"layers.{theirs}.b", i, "same")]
        names += [(p + "o_proj.weight", "layers.o.w", i, "linear")]
        for ours, theirs in (("gate_proj", "gate"), ("up_proj", "up"), ("down_proj", "down")):
            names += [(p + ours + ".weight", f"layers.mlp.{theirs}", i, "linear")]
    if not cfg.tie_word_embeddings:
        names += [("lm_head", "lm_head", None, "linear")]
    return names


def _opt_names(cfg) -> list:
    names = [("embed", "embed", None, "same"), ("pos_embed", "pos_embed", None, "same"),
             ("ln_f.weight", "ln_f_w", None, "same"), ("ln_f.bias", "ln_f_b", None, "same")]
    for i in range(cfg.num_layers):
        p = f"layers.{i}."
        for n in ("ln1", "ln2"):
            names += [(p + n + ".weight", f"layers.{n}_w", i, "same"),
                      (p + n + ".bias", f"layers.{n}_b", i, "same")]
        for n in ("q", "k", "v", "o", "fc1", "fc2"):
            names += [(p + n + ".weight", f"layers.{n}.w", i, "linear"),
                      (p + n + ".bias", f"layers.{n}.b", i, "same")]
    if cfg.word_embed_proj_dim:
        names += [("project_in.weight", "project_in", None, "linear"),
                  ("project_out.weight", "project_out", None, "linear")]
    return names


def _fusion_names(cfg: AF2Config) -> list:
    names = []
    for i in range(cfg.num_audio_transform_layers):
        p = f"audio_transform.{i}."
        for n in ("ln1", "ln2"):
            names += [(p + n + ".weight", f"audio_transform.{n}_w", i, "same"),
                      (p + n + ".bias", f"audio_transform.{n}_b", i, "same")]
        for n in ("q", "k", "v", "o", "fc1", "fc2"):
            names += [(p + n + ".weight", f"audio_transform.{n}.w", i, "linear")]
        for n in ("fc1", "fc2"):
            names += [(p + n + ".bias", f"audio_transform.{n}.b", i, "same")]
    for i in range(cfg.lm.num_layers // cfg.xattn.cross_every_n_layers):
        p = f"xattn.{i}."
        for n in ("ln_q", "ln_kv", "ln_ffn"):
            names += [(p + n + ".weight", f"xattn.{n}_w", i, "same"),
                      (p + n + ".bias", f"xattn.{n}_b", i, "same")]
        for n in ("q", "k", "v", "o", "fc1", "fc2"):
            names += [(p + n + ".weight", f"xattn.{n}.w", i, "linear")]
        for n in ("fc1", "fc2"):
            names += [(p + n + ".bias", f"xattn.{n}.b", i, "same")]
        for n in ("alpha_xattn", "alpha_dense"):
            names += [(p + n, f"xattn.{n}", i, "same")]
    return names


def af2_params_from_jax(params: dict, cfg: AF2Config) -> dict[str, torch.Tensor]:
    """JAX's flamingo params (``audio_transform``, ``xattn``, ``lm``; nested or flat) ->
    ``FlamingoModel``'s state dict. A quantized Qwen2 tree crosses as it is, under
    ``lm.<tree path>``."""
    flat = _flat_tree(params)
    sd = _from_jax(flat, _fusion_names(cfg))
    lm = {k[3:]: v for k, v in flat.items() if k.startswith("lm.")}
    if isinstance(cfg.lm, OPTConfig):
        sd.update(_from_jax(lm, _opt_names(cfg.lm), "lm."))
    elif "embed.w_q" in lm:
        sd.update({"lm." + k: _as_tensor(v) for k, v in lm.items()})
    else:
        sd.update(_qwen2_from_flat(lm, cfg.lm, "lm."))
    return sd


def af2_params_to_jax(state: dict, cfg: AF2Config) -> dict[str, np.ndarray]:
    """``FlamingoModel``'s state dict -> the JAX flamingo tree's flat names (f32 floats;
    a quantized LM's codes and scales as they are)."""
    out = _names_to_jax(state, _fusion_names(cfg))
    lm = {k[3:]: v for k, v in state.items() if k.startswith("lm.")}
    if isinstance(cfg.lm, OPTConfig):
        tree = _names_to_jax(lm, _opt_names(cfg.lm))
    else:
        tree = lm_params_to_jax(lm, cfg.lm)
    out.update({"lm." + k: v for k, v in tree.items()})
    return out


def _clap_names(cfg: ClapAudioConfig) -> list:
    def bn(port, theirs):
        return [(f"{port}.{a}", f"{theirs}.{b}", None, "same")
                for a, b in (("mean", "mean"), ("var", "var"), ("weight", "w"), ("bias", "b"))]

    def lin(port, theirs, bias=True):
        out = [(port + ".weight", theirs + ".w", None, "linear")]
        return out + [(port + ".bias", theirs + ".b", None, "same")] if bias else out

    def norm(port, theirs):
        return [(port + ".weight", theirs + "_w", None, "same"),
                (port + ".bias", theirs + "_b", None, "same")]

    names = bn("batch_norm", "batch_norm")
    names += [("patch_embed.proj.weight", "patch_embed.proj_w", None, "conv"),
              ("patch_embed.proj.bias", "patch_embed.proj_b", None, "same")]
    names += norm("patch_embed.norm", "patch_embed.norm")
    if cfg.enable_fusion:
        names += [("patch_embed.mel_conv.weight", "patch_embed.mel_conv_w", None, "conv"),
                  ("patch_embed.mel_conv.bias", "patch_embed.mel_conv_b", None, "same")]
        for side in ("local", "global"):
            p, q = f"patch_embed.aff_{side}", f"patch_embed.aff.{side}"
            names += lin(p + ".c1", q + ".c1") + bn(p + ".bn1", q + ".bn1")
            names += lin(p + ".c2", q + ".c2") + bn(p + ".bn2", q + ".bn2")
    for i, depth in enumerate(cfg.depths):
        for j in range(depth):
            p = q = f"stages.{i}.blocks.{j}"
            names += norm(p + ".ln1", q + ".ln1") + norm(p + ".ln2", q + ".ln2")
            for n in ("q", "k", "v", "o", "fc1", "fc2"):
                names += lin(f"{p}.{n}", f"{q}.{n}")
            names += [(p + ".bias_table", q + ".bias_table", None, "same")]
        if i < len(cfg.depths) - 1:
            p = f"stages.{i}.downsample"
            names += norm(p + ".norm", p + ".norm") + lin(p + ".reduction", p + ".reduction",
                                                          bias=False)
    names += norm("norm", "norm")
    names += lin("proj_fc1", "projection.fc1") + lin("proj_fc2", "projection.fc2")
    return names


def clap_params_from_jax(params: dict, cfg: ClapAudioConfig) -> dict[str, torch.Tensor]:
    """JAX's HTSAT tower params (nested or flat) -> ``ClapAudioTower``'s state dict."""
    return _from_jax(_flat_tree(params), _clap_names(cfg))


def clap_params_to_jax(state: dict, cfg: ClapAudioConfig) -> dict[str, np.ndarray]:
    """``ClapAudioTower``'s state dict -> the JAX tower tree's flat names (f32)."""
    return _names_to_jax(state, _clap_names(cfg))


def _clap_text_names(cfg) -> list:
    """``models/clap_text.ClapTextTower``'s names against JAX's clap_text tree."""
    names = [(n, n, None, "same") for n in ("word_emb", "pos_emb", "type_emb")]
    names += [("ln_emb.weight", "ln_emb_w", None, "same"), ("ln_emb.bias", "ln_emb_b", None, "same")]
    for i in range(cfg.num_layers):
        p = f"layers.{i}."
        for n in ("q", "k", "v", "o", "fc1", "fc2"):
            names += [(p + n + ".weight", f"layers.{n}.w", i, "linear"),
                      (p + n + ".bias", f"layers.{n}.b", i, "same")]
        for n in ("ln_attn", "ln_out"):
            names += [(p + n + ".weight", f"layers.{n}_w", i, "same"),
                      (p + n + ".bias", f"layers.{n}_b", i, "same")]
    names += [("pooler.weight", "pooler.w", None, "linear"), ("pooler.bias", "pooler.b", None, "same")]
    for n in ("fc1", "fc2"):
        names += [(f"proj_{n}.weight", f"projection.{n}.w", None, "linear"),
                  (f"proj_{n}.bias", f"projection.{n}.b", None, "same")]
    return names


def clap_text_params_from_jax(params: dict, cfg) -> dict[str, torch.Tensor]:
    """JAX's CLAP text tower params (nested or flat) -> ``ClapTextTower``'s state dict."""
    return _from_jax(_flat_tree(params), _clap_text_names(cfg))


def clap_text_params_to_jax(state: dict, cfg) -> dict[str, np.ndarray]:
    """``ClapTextTower``'s state dict -> the JAX tree's flat names (f32)."""
    return _names_to_jax(state, _clap_text_names(cfg))


def opt_params_from_jax(params: dict, cfg: OPTConfig) -> dict[str, torch.Tensor]:
    """JAX's OPT params (nested or flat) -> ``models/opt.OPT``'s state dict."""
    return _from_jax(_flat_tree(params), _opt_names(cfg))
