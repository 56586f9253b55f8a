"""Export the port's models to HF-layout checkpoints, as ``audio_flamingo_tpu/io/hf_export.py``
(the reverse of ``io/convert.state_dict_from_hf`` and ``qwen2_state_from_hf``).

``export_af3_state_dict`` writes qwen2_audio names (``audio_tower.*`` /
``multi_modal_projector.*`` / ``language_model.*``, a 2-layer adaptor's second layer as
``mm_projector.2``) in torch layouts, f32, in JAX's order; ``save_pretrained`` writes them
as one ``model.safetensors`` or as shards with an index (the released checkpoints'
layout), in f32 or bf16, beside ``config.json`` and the tokenizer files, so that
``api.load`` and the JAX package read them. ``export_qwen2_state_dict`` and
``save_qwen2_pretrained`` do the same for a plain Qwen2 CausalLM (a speculative draft,
``api.load_draft``).

The export needs a float LM without adapters: fold LoRA adapters in first
(``models/lora.merge_lora``); a quantized LM has no float weights to write.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from audio_flamingo_tpu_torch.config import AF3Config, Qwen2Config
from audio_flamingo_tpu_torch.io.safetensors import save_safetensors
from audio_flamingo_tpu_torch.models import qwen2


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy().copy()


def _check_lm(lm) -> None:
    if isinstance(lm, qwen2.QuantQwen2):
        raise ValueError("the HF export needs a float LM; a quantized LM has only codes")
    if any(n.rsplit(".", 1)[-1].startswith("lora_") for n, _ in lm.named_parameters()):
        raise ValueError("the LM carries LoRA adapters, which the HF layout has no place "
                         "for: fold them in first (models/lora.merge_lora)")


def _qwen2_layers(lm, cfg: Qwen2Config, prefix: str) -> dict[str, np.ndarray]:
    """The decoder layers under ``prefix`` (``model.layers.{i}.`` names), JAX's order."""
    sd = {}
    for i in range(cfg.num_layers):
        layer = lm.layers[i]
        p = f"{prefix}layers.{i}."
        sd[p + "input_layernorm.weight"] = _np(layer.input_layernorm.weight)
        for name in ("q", "k", "v"):
            lin = getattr(layer, f"{name}_proj")
            sd[p + f"self_attn.{name}_proj.weight"] = _np(lin.weight)
            if lin.bias is not None:
                sd[p + f"self_attn.{name}_proj.bias"] = _np(lin.bias)
        sd[p + "self_attn.o_proj.weight"] = _np(layer.o_proj.weight)
        sd[p + "post_attention_layernorm.weight"] = _np(layer.post_attention_layernorm.weight)
        for name in ("gate", "up", "down"):
            sd[p + f"mlp.{name}_proj.weight"] = _np(getattr(layer, f"{name}_proj").weight)
    return sd


def export_af3_state_dict(model, cfg: AF3Config) -> dict[str, np.ndarray]:
    """An ``AF3Model`` (float encoder and LM) -> a flat HF state dict (numpy f32)."""
    _check_lm(model.lm)
    enc = model.encoder
    sd: dict[str, np.ndarray] = {}
    for n in ("conv1", "conv2"):
        sd[f"audio_tower.{n}.weight"] = _np(getattr(enc, n).weight)
        sd[f"audio_tower.{n}.bias"] = _np(getattr(enc, n).bias)
    sd["audio_tower.embed_positions.weight"] = _np(enc.embed_positions)
    for i in range(cfg.encoder.num_layers):
        layer, p = enc.layers[i], f"audio_tower.layers.{i}."
        sd[p + "self_attn_layer_norm.weight"] = _np(layer.self_attn_layer_norm.weight)
        sd[p + "self_attn_layer_norm.bias"] = _np(layer.self_attn_layer_norm.bias)
        for ours in ("q_proj", "k_proj", "v_proj", "out_proj"):
            lin = getattr(layer, ours)
            sd[p + f"self_attn.{ours}.weight"] = _np(lin.weight)
            if lin.bias is not None:
                sd[p + f"self_attn.{ours}.bias"] = _np(lin.bias)
        sd[p + "final_layer_norm.weight"] = _np(layer.final_layer_norm.weight)
        sd[p + "final_layer_norm.bias"] = _np(layer.final_layer_norm.bias)
        for n in ("fc1", "fc2"):
            sd[p + f"{n}.weight"] = _np(getattr(layer, n).weight)
            sd[p + f"{n}.bias"] = _np(getattr(layer, n).bias)
    sd["audio_tower.layer_norm.weight"] = _np(enc.layer_norm.weight)
    sd["audio_tower.layer_norm.bias"] = _np(enc.layer_norm.bias)

    ada = model.adaptor
    sd["multi_modal_projector.linear.weight"] = _np(ada.fc1.weight)
    sd["multi_modal_projector.linear.bias"] = _np(ada.fc1.bias)
    if getattr(ada, "fc2", None) is not None:      # llava naming for the second layer
        sd["mm_projector.2.weight"] = _np(ada.fc2.weight)
        sd["mm_projector.2.bias"] = _np(ada.fc2.bias)

    lm = model.lm
    sd["language_model.model.embed_tokens.weight"] = _np(lm.embed_tokens)
    sd.update(_qwen2_layers(lm, cfg.lm, "language_model.model."))
    sd["language_model.model.norm.weight"] = _np(lm.norm.weight)
    head = lm.embed_tokens if lm.lm_head is None else lm.lm_head
    sd["language_model.lm_head.weight"] = _np(head)
    return sd


def export_qwen2_state_dict(lm, cfg: Qwen2Config) -> dict[str, np.ndarray]:
    """A float ``Qwen2`` -> a flat HF Qwen2ForCausalLM state dict (numpy f32); a tied head
    is not written."""
    _check_lm(lm)
    sd = {"model.embed_tokens.weight": _np(lm.embed_tokens)}
    sd.update(_qwen2_layers(lm, cfg, "model."))
    sd["model.norm.weight"] = _np(lm.norm.weight)
    if lm.lm_head is not None:
        sd["lm_head.weight"] = _np(lm.lm_head)
    return sd


def _qwen2_config(cfg: Qwen2Config) -> dict:
    return {"vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
            "intermediate_size": cfg.intermediate_size, "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads, "num_key_value_heads": cfg.num_kv_heads,
            "rope_theta": cfg.rope_theta, "tie_word_embeddings": cfg.tie_word_embeddings}


def save_qwen2_pretrained(path: str, lm, cfg: Qwen2Config) -> None:
    """Write a plain-Qwen2 HF directory (model.safetensors + config.json) that
    ``api.load_draft`` reads."""
    os.makedirs(path, exist_ok=True)
    save_safetensors(os.path.join(path, "model.safetensors"), export_qwen2_state_dict(lm, cfg),
                     metadata={"format": "pt"})
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"model_type": "qwen2", **_qwen2_config(cfg)}, f, indent=1)


def _bf16_bits(arr: np.ndarray) -> np.ndarray:
    """f32 -> bf16 (round to nearest even), as the raw uint16 bits the writer stores as
    BF16."""
    return torch.from_numpy(arr).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def save_pretrained(path: str, model, cfg: AF3Config, tokenizer=None, *,
                    dtype: str | None = None, max_shard_bytes: int | None = None) -> None:
    """Write an HF-layout checkpoint directory that ``api.load`` reads. dtype="bf16" casts
    the float tensors to bfloat16 (the dtype the released '-hf' checkpoints ship);
    ``max_shard_bytes`` splits the weights, in order, across
    model-XXXXX-of-YYYYY.safetensors with a model.safetensors.index.json weight map."""
    os.makedirs(path, exist_ok=True)
    sd = export_af3_state_dict(model, cfg)
    if dtype == "bf16":
        sd = {k: _bf16_bits(v) for k, v in sd.items()}
    if max_shard_bytes is None:
        save_safetensors(os.path.join(path, "model.safetensors"), sd, metadata={"format": "pt"})
    else:
        shards: list[dict] = [{}]
        sizes = [0]
        for k, v in sd.items():
            if sizes[-1] and sizes[-1] + v.nbytes > max_shard_bytes:
                shards.append({})
                sizes.append(0)
            shards[-1][k] = v
            sizes[-1] += v.nbytes
        n = len(shards)
        weight_map: dict[str, str] = {}
        for i, shard in enumerate(shards):
            fname = f"model-{i + 1:05d}-of-{n:05d}.safetensors"
            save_safetensors(os.path.join(path, fname), shard, metadata={"format": "pt"})
            weight_map.update({k: fname for k in shard})
        index = {"metadata": {"total_size": int(sum(sizes))}, "weight_map": weight_map}
        with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
            json.dump(index, f, indent=1)
    enc = cfg.encoder
    config = {
        "model_type": "qwen2_audio",
        "audio_token_id": cfg.audio_token_id,
        "audio_config": {
            "num_mel_bins": enc.num_mel_bins, "d_model": enc.d_model,
            "encoder_layers": enc.num_layers, "encoder_attention_heads": enc.num_heads,
            "encoder_ffn_dim": enc.ffn_dim, "max_source_positions": enc.max_source_positions,
        },
        "text_config": _qwen2_config(cfg.lm),
    }
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f, indent=1)
    if tokenizer is not None:
        with open(os.path.join(path, "vocab.json"), "w") as f:
            json.dump(tokenizer.vocab, f)
        with open(os.path.join(path, "merges.txt"), "w") as f:
            f.write("#version: 0.2\n")
            for a, b in tokenizer.merges:
                f.write(f"{a} {b}\n")
