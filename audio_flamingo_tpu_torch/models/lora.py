"""LoRA / QLoRA adapters on the Qwen2 LM, as ``audio_flamingo_tpu/ops/lora.py``'s
``add_lora``, ``save_lora``, ``load_lora`` and ``merge_lora``. The adapter arithmetic
(``lora_delta``, ``lora_mask``) and the target names are in ``ops/lora.py``.

Each targeted linear gains ``lora_a`` [K, r] (Normal(0, 1) / sqrt(r)), ``lora_b`` [r, N]
(zeros: the adapter is an exact identity at init) and ``lora_s`` (alpha / r, f32). Where
they live:

- a float ``Qwen2``: parameters on the targeted ``nn.Linear`` of each layer
  (``layers.{i}.q_proj.lora_a`` [K, r], ``lora_b`` [r, N], ``lora_s`` a 0-dim f32);
- a quantized ``QuantQwen2``: tensors of its tree, stacked on the layers as JAX stacks
  them (``layers.q.lora_a`` [L, K, r], ``lora_b`` [L, r, N], ``lora_s`` [L]), beside the
  int8 codes ``w_q`` (QLoRA: a frozen int8 base and float adapters).

Every adapter is an ``nn.Parameter``, made with ``requires_grad`` off; ``lora_s`` is a
fixed hyperparameter and never trains.

A fused-w4 tree (``qkv`` / ``mlp.gateup`` packed int4) is a serving artifact and cannot
carry adapters: ``add_lora`` refuses an int4 base as JAX's assert does, and a fused tree
gets no q/k/v adapters (they are added only where ``q``, ``k``, ``v`` are entries of the
layer tree, as in JAX). ``merge_lora`` folds adapters into a float base; an int8 base
raises.

``save_lora`` / ``load_lora`` use JAX's file layout: a safetensors file of f32 arrays
named by the JAX tree's path (``lm/layers/q/lora_a`` [L, K, r], ``layers/mlp/gate/lora_b``
...), metadata ``{"format": "lora"}``, so a file written by either package loads in the
other. JAX wraps untargeted float mlp entries in ``{"w": ...}`` dicts so that its layer
dispatch routes them; modules need no such wrapping, and the file has only adapters.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from audio_flamingo_tpu_torch.io.safetensors import load_safetensors, save_safetensors
from audio_flamingo_tpu_torch.models.qwen2 import QuantQwen2, Qwen2
from audio_flamingo_tpu_torch.ops.lora import (ATTN_TARGETS, DEFAULT_TARGETS, LORA_NAMES,
                                               MLP_TARGETS)

# the float Qwen2's module of each target
MODULES = {"q": "q_proj", "k": "k_proj", "v": "v_proj", "o": "o_proj", "gate": "gate_proj",
           "up": "up_proj", "down": "down_proj"}


def _lm_of(model) -> tuple[nn.Module, str]:
    """(the LM, the prefix of its names in a file): an AF3-family model's ``lm`` child
    under ``lm/``, or the LM itself."""
    if isinstance(model, (Qwen2, QuantQwen2)):
        return model, ""
    return model.lm, "lm/"


def _quantized(lm) -> bool:
    return isinstance(lm, QuantQwen2)


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _tree_node(lm, name: str):
    """The quantized tree's node of a target (``layers.q``, ``layers.mlp.gate``), or None."""
    layers = lm.layers
    if name in MLP_TARGETS:
        return layers["mlp"][name] if "mlp" in layers and name in layers["mlp"] else None
    return layers[name] if name in layers else None


def _targets_present(lm, targets: tuple) -> list[str]:
    """The targets that get adapters, in DEFAULT_TARGETS order (JAX ``add_lora`` :58-81):
    attention targets only where the layer tree has them; mlp targets need every one to
    be an entry (JAX indexes ``mlp[name]`` and raises a KeyError otherwise)."""
    out = [n for n in ATTN_TARGETS if n in targets
           and (not _quantized(lm) or _tree_node(lm, n) is not None)]
    if any(t in targets for t in MLP_TARGETS):
        for n in MLP_TARGETS:
            if _quantized(lm) and _tree_node(lm, n) is None:
                raise KeyError(f"add_lora: the layer tree's mlp has no {n!r} entry "
                               f"({sorted(dict(lm.layers['mlp'].named_children()))}): a fused "
                               "gate|up cannot carry adapters")
        out += [n for n in MLP_TARGETS if n in targets]
    return out


def _base_shape(lm, name: str) -> tuple[int, int]:
    """(K, N) of a target's base weight; an int4 base refuses adapters."""
    if not _quantized(lm):
        lin = getattr(lm.layers[0], MODULES[name])
        return lin.in_features, lin.out_features
    node = _tree_node(lm, name)
    w = node["w"] if "w" in node else node["w_q"] if "w_q" in node else None
    if w is None:
        raise ValueError("LoRA targets need a dense 'w' or int8 'w_q' base (fused-w4 "
                         "trees cannot carry adapters)")
    return w.shape[-2], w.shape[-1]


def _device(lm) -> torch.device:
    return lm.ln_f_w.device if _quantized(lm) else lm.norm.weight.device


def add_lora(generator: torch.Generator, model, *, rank: int = 8, alpha: float | None = None,
             targets: tuple = DEFAULT_TARGETS):
    """Add zero-init adapters to the LM of ``model`` (a ``Qwen2``, a ``QuantQwen2`` or an
    AF3-family model with an ``lm``), in place on the LM's device; returns ``model``.
    Until ``lora_b`` moves off zero it computes exactly what it did. ``lora_a`` is drawn
    from ``generator`` (on the LM's device), one target after another."""
    lm, _ = _lm_of(model)
    scale = (alpha if alpha is not None else float(rank)) / rank
    names = _targets_present(lm, targets)
    shapes = {n: _base_shape(lm, n) for n in names}
    device = _device(lm)
    n_layers = len(lm.layers) if not _quantized(lm) else lm.layers["ln1_w"].shape[0]
    for n in names:
        k, out = shapes[n]
        a = torch.randn((n_layers, k, rank), generator=generator, device=device) / rank ** 0.5
        b = torch.zeros((n_layers, rank, out), device=device)
        s = torch.full((n_layers,), scale, device=device)
        _set(lm, n, {"lora_a": a, "lora_b": b, "lora_s": s})
    return model


def _set(lm, name: str, leaves: dict) -> None:
    """Install one target's stacked adapters ({'lora_a' [L, K, r], ...}) as parameters:
    stacked in a quantized tree, one layer's slice on each float linear."""
    if _quantized(lm):
        node = _tree_node(lm, name)
        for key, t in leaves.items():
            node.register_parameter(key, _param(t.float().contiguous()))
        return
    for i, layer in enumerate(lm.layers):
        lin = getattr(layer, MODULES[name])
        for key, t in leaves.items():
            lin.register_parameter(key, _param(t[i].float().clone()))


def _get(lm, name: str) -> dict | None:
    """A target's adapters stacked on the layers ({'lora_a' [L, K, r], ...}), or None."""
    if _quantized(lm):
        node = _tree_node(lm, name)
        if node is None or "lora_a" not in node:
            return None
        return {k: node[k] for k in LORA_NAMES}
    lins = [getattr(layer, MODULES[name]) for layer in lm.layers]
    if not hasattr(lins[0], "lora_a"):
        return None
    return {k: torch.stack([getattr(lin, k) for lin in lins]) for k in LORA_NAMES}


def adapters(model) -> dict:
    """{target: stacked adapters} of the model's LM (``_get``), targets with adapters only."""
    lm, _ = _lm_of(model)
    return {n: a for n in DEFAULT_TARGETS if (a := _get(lm, n)) is not None}


def save_lora(path: str, model) -> None:
    """Write only the adapters (f32, stacked on the layers) under the JAX tree's names."""
    lm, prefix = _lm_of(model)
    flat = {}
    for n, leaves in adapters(lm).items():
        node = f"{prefix}layers/mlp/{n}" if n in MLP_TARGETS else f"{prefix}layers/{n}"
        for k, t in leaves.items():
            flat[f"{node}/{k}"] = t.detach().float().cpu().numpy()
    if not flat:
        raise ValueError("no adapter leaves found: call add_lora first")
    save_safetensors(path, flat, metadata={"format": "lora"})


def load_lora(path: str, model):
    """Insert adapters saved by either package into a matching base (float or int8), in
    place; returns ``model``. Names are the JAX tree's paths relative to what is given:
    ``lm/layers/...`` for an AF3-family model, ``layers/...`` for a bare LM."""
    lm, prefix = _lm_of(model)
    grouped: dict = {}
    for name, arr in load_safetensors(path).items():
        if not name.startswith(prefix + "layers/"):
            raise KeyError(f"load_lora: {name!r} is not under {prefix + 'layers/'!r}")
        *node, leaf = name[len(prefix + "layers/"):].split("/")
        target = node[-1]
        if leaf not in LORA_NAMES or target not in DEFAULT_TARGETS:
            raise KeyError(f"load_lora: {name!r} is not an adapter of a known target")
        grouped.setdefault(target, {})[leaf] = torch.from_numpy(np.array(arr, np.float32))
    device = _device(lm)
    for target, leaves in grouped.items():
        if set(leaves) != set(LORA_NAMES):
            raise KeyError(f"load_lora: {target} lacks {set(LORA_NAMES) - set(leaves)}")
        if _quantized(lm) and _tree_node(lm, target) is None:
            raise KeyError(f"load_lora: the base has no {target!r} linear")
        _set(lm, target, {k: v.to(device) for k, v in leaves.items()})
    return model


def _strip(lm, name: str) -> None:
    if _quantized(lm):
        node = _tree_node(lm, name)
        for k in LORA_NAMES:
            delattr(node, k)
        return
    for layer in lm.layers:
        lin = getattr(layer, MODULES[name])
        for k in LORA_NAMES:
            delattr(lin, k)


@torch.no_grad()
def merge_lora(model):
    """Fold the adapters into the float base (w += a b s, computed in f32 and cast to the
    weight's dtype) and remove them, in place; returns ``model``. An int8 base raises:
    its grid cannot absorb the delta exactly (dequantize first)."""
    lm, _ = _lm_of(model)
    found = adapters(lm)
    if _quantized(lm) and found:
        raise ValueError("merge_lora needs a dense float base; dequantize first")
    for n, leaves in found.items():
        for i, layer in enumerate(lm.layers):
            lin = getattr(layer, MODULES[n])
            d = (leaves["lora_a"][i].float() @ leaves["lora_b"][i].float()) * leaves["lora_s"][i]
            lin.weight.copy_((lin.weight.float() + d.t()).to(lin.weight.dtype))
        _strip(lm, n)
    return model
