"""HF checkpoints of AF1/AF2's parts -> the port's state dicts, as the AF2 half of
``audio_flamingo_tpu/io/hf_import.py`` (the AF3 half is ``io/convert.state_dict_from_hf``).

Each importer reads HF's names and torch layouts (Linear [out, in], Conv2d OIHW) into
the JAX package's tree, in numpy and by JAX's table, and crosses that tree into the
port's module names through ``io/convert``: ``import_clap_audio`` for
``models/clap.ClapAudioTower``, ``import_clap_text`` for ``models/clap_text.ClapTextTower``
and ``import_opt`` for ``models/opt.OPT``.
"""

from __future__ import annotations

import numpy as np
import torch

from audio_flamingo_tpu_torch.config import OPTConfig
from audio_flamingo_tpu_torch.io.convert import (clap_params_from_jax, clap_text_params_from_jax,
                                                 opt_params_from_jax)


def _t(x) -> np.ndarray:   # torch Linear [out, in] -> JAX's [in, out]
    return np.ascontiguousarray(np.asarray(x).T)


def _stack(layer_dicts: list[dict]) -> dict:
    """Per-layer trees -> one tree with every leaf stacked on a leading axis."""
    first = layer_dicts[0]
    return {k: (_stack([d[k] for d in layer_dicts]) if isinstance(first[k], dict)
                else np.stack([np.asarray(d[k]) for d in layer_dicts]))
            for k in first}


def _getter(sd: dict, prefix: str):
    return lambda n: np.asarray(sd[prefix + n])


def _bn_import(sd: dict, prefix: str) -> dict:
    return {"mean": np.asarray(sd[prefix + "running_mean"]),
            "var": np.asarray(sd[prefix + "running_var"]),
            "w": np.asarray(sd[prefix + "weight"]), "b": np.asarray(sd[prefix + "bias"])}


def _numpy_sd(sd: dict) -> dict:
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in sd.items()}


def import_clap_audio(sd: dict, cfg, prefix: str = "audio_model.audio_encoder.") -> dict:
    """An HF ClapModel's audio branch (and its ``audio_projection``) -> the port's
    ``ClapAudioTower`` state dict. 1x1 convs of the fusion block become linears."""
    sd = _numpy_sd(sd)
    g = _getter(sd, prefix)

    def conv_hwio(name):
        return g(name).transpose(2, 3, 1, 0)

    def lin(name, bias=True):
        p = {"w": _t(g(name + ".weight"))}
        if bias:
            p["b"] = g(name + ".bias")
        return p

    def conv1x1_as_lin(name):
        return {"w": np.ascontiguousarray(g(name + ".weight")[:, :, 0, 0].T),
                "b": g(name + ".bias")}

    params: dict = {
        "batch_norm": _bn_import(sd, prefix + "batch_norm."),
        "patch_embed": {"proj_w": conv_hwio("patch_embed.proj.weight"),
                        "proj_b": g("patch_embed.proj.bias"),
                        "norm_w": g("patch_embed.norm.weight"),
                        "norm_b": g("patch_embed.norm.bias")},
        "stages": [],
        "norm_w": g("norm.weight"), "norm_b": g("norm.bias"),
    }
    if cfg.enable_fusion:
        pe = params["patch_embed"]
        pe["mel_conv_w"] = conv_hwio("patch_embed.mel_conv2d.weight")
        pe["mel_conv_b"] = g("patch_embed.mel_conv2d.bias")
        fm = "patch_embed.fusion_model."
        pe["aff"] = {
            "local": {"c1": conv1x1_as_lin(fm + "local_att.0"),
                      "bn1": _bn_import(sd, prefix + fm + "local_att.1."),
                      "c2": conv1x1_as_lin(fm + "local_att.3"),
                      "bn2": _bn_import(sd, prefix + fm + "local_att.4.")},
            "global": {"c1": conv1x1_as_lin(fm + "global_att.1"),
                       "bn1": _bn_import(sd, prefix + fm + "global_att.2."),
                       "c2": conv1x1_as_lin(fm + "global_att.4"),
                       "bn2": _bn_import(sd, prefix + fm + "global_att.5.")},
        }
    for i, depth in enumerate(cfg.depths):
        blocks = []
        for j in range(depth):
            p = f"layers.{i}.blocks.{j}."
            blocks.append({
                "ln1_w": g(p + "layernorm_before.weight"), "ln1_b": g(p + "layernorm_before.bias"),
                "q": lin(p + "attention.self.query"), "k": lin(p + "attention.self.key"),
                "v": lin(p + "attention.self.value"), "o": lin(p + "attention.output.dense"),
                "bias_table": g(p + "attention.self.relative_position_bias_table"),
                "ln2_w": g(p + "layernorm_after.weight"), "ln2_b": g(p + "layernorm_after.bias"),
                "fc1": lin(p + "intermediate.dense"), "fc2": lin(p + "output.dense"),
            })
        stage: dict = {"blocks": blocks}
        if i < len(cfg.depths) - 1:
            stage["downsample"] = {
                "norm_w": g(f"layers.{i}.downsample.norm.weight"),
                "norm_b": g(f"layers.{i}.downsample.norm.bias"),
                "reduction": {"w": _t(g(f"layers.{i}.downsample.reduction.weight"))},
            }
        params["stages"].append(stage)
    # the projection lives on ClapModel as audio_projection.*
    params["projection"] = {n: {"w": _t(sd[f"audio_projection.linear{k}.weight"]),
                                "b": np.asarray(sd[f"audio_projection.linear{k}.bias"])}
                            for n, k in (("fc1", 1), ("fc2", 2))}
    return clap_params_from_jax(params, cfg)


def import_clap_text(sd: dict, cfg, prefix: str = "text_model.") -> dict:
    """An HF ClapTextModel (and ClapModel's ``text_projection``) -> the port's
    ``ClapTextTower`` state dict."""
    sd = _numpy_sd(sd)
    g = _getter(sd, prefix)

    def lin(name):
        return {"w": _t(g(name + ".weight")), "b": g(name + ".bias")}

    layers = []
    for i in range(cfg.num_layers):
        p = f"encoder.layer.{i}."
        layers.append({
            "q": lin(p + "attention.self.query"), "k": lin(p + "attention.self.key"),
            "v": lin(p + "attention.self.value"), "o": lin(p + "attention.output.dense"),
            "ln_attn_w": g(p + "attention.output.LayerNorm.weight"),
            "ln_attn_b": g(p + "attention.output.LayerNorm.bias"),
            "fc1": lin(p + "intermediate.dense"), "fc2": lin(p + "output.dense"),
            "ln_out_w": g(p + "output.LayerNorm.weight"),
            "ln_out_b": g(p + "output.LayerNorm.bias"),
        })
    params = {
        "word_emb": g("embeddings.word_embeddings.weight"),
        "pos_emb": g("embeddings.position_embeddings.weight"),
        "type_emb": g("embeddings.token_type_embeddings.weight"),
        "ln_emb_w": g("embeddings.LayerNorm.weight"), "ln_emb_b": g("embeddings.LayerNorm.bias"),
        "layers": _stack(layers),
        "pooler": lin("pooler.dense"),
    }
    if "text_projection.linear1.weight" not in sd:
        raise KeyError("import_clap_text: the state dict has no text_projection (the "
                       "port's tower always projects)")
    params["projection"] = {n: {"w": _t(sd[f"text_projection.linear{k}.weight"]),
                                "b": np.asarray(sd[f"text_projection.linear{k}.bias"])}
                            for n, k in (("fc1", 1), ("fc2", 2))}
    return clap_text_params_from_jax(params, cfg)


def import_opt(sd: dict, cfg: OPTConfig, prefix: str = "") -> dict:
    """An HF OPTForCausalLM -> the port's ``models/opt.OPT`` state dict."""
    sd = _numpy_sd(sd)
    g = _getter(sd, prefix)

    def lin(name):
        return {"w": _t(g(name + ".weight")), "b": g(name + ".bias")}

    layers = []
    for i in range(cfg.num_layers):
        p = f"model.decoder.layers.{i}."
        layers.append({
            "ln1_w": g(p + "self_attn_layer_norm.weight"),
            "ln1_b": g(p + "self_attn_layer_norm.bias"),
            "q": lin(p + "self_attn.q_proj"), "k": lin(p + "self_attn.k_proj"),
            "v": lin(p + "self_attn.v_proj"), "o": lin(p + "self_attn.out_proj"),
            "ln2_w": g(p + "final_layer_norm.weight"), "ln2_b": g(p + "final_layer_norm.bias"),
            "fc1": lin(p + "fc1"), "fc2": lin(p + "fc2"),
        })
    params = {"embed": g("model.decoder.embed_tokens.weight"),
              "pos_embed": g("model.decoder.embed_positions.weight"),
              "layers": _stack(layers)}
    if prefix + "model.decoder.final_layer_norm.weight" in sd:
        params["ln_f_w"] = g("model.decoder.final_layer_norm.weight")
        params["ln_f_b"] = g("model.decoder.final_layer_norm.bias")
    if prefix + "model.decoder.project_in.weight" in sd:
        params["project_in"] = _t(g("model.decoder.project_in.weight"))
        params["project_out"] = _t(g("model.decoder.project_out.weight"))
    return opt_params_from_jax(params, cfg)
