"""LoRA / QLoRA adapter arithmetic, as ``audio_flamingo_tpu/ops/lora.py``'s ``lora_delta``
and ``lora_mask``.

A targeted linear holds ``lora_a`` [K, r], ``lora_b`` [r, N] and ``lora_s`` (alpha / r,
f32), and ``models/qwen2`` adds ``(x a) b s`` in f32, cast to the product's dtype, after the
base product and before the bias (JAX qwen2.py:125-146). The LM-level functions that know
the two weight layouts (``add_lora``, ``save_lora``, ``load_lora``, ``merge_lora``,
``adapters``) live beside the LM in ``models/lora.py``.

JAX needs ``partition_lora`` because its ``value_and_grad`` takes the adapters as a
separate argument (an int8 base cannot be differentiated); here the same split is
``requires_grad`` on the adapters alone, which ``train/train_step.make_optimizer(...,
lora_only=True)`` sets from ``lora_mask``, so the base codes get no gradient and no
optimizer state.
"""

from __future__ import annotations

import torch
from torch import nn

ATTN_TARGETS = ("q", "k", "v", "o")
MLP_TARGETS = ("gate", "up", "down")
DEFAULT_TARGETS = ATTN_TARGETS + MLP_TARGETS
LORA_NAMES = ("lora_a", "lora_b", "lora_s")


def lora_delta(x: torch.Tensor, p, layer: int | None = None) -> torch.Tensor:
    """(x a) b s in f32, the additive adapter term of one linear (JAX ``lora_delta``), for
    a float linear holding ``lora_a`` / ``lora_b`` / ``lora_s``, or layer ``layer`` of a
    stacked tree node."""
    if layer is None:
        a, b, s = p.lora_a, p.lora_b, p.lora_s
    else:
        a, b, s = p["lora_a"][layer], p["lora_b"][layer], p["lora_s"][layer]
    return torch.matmul(torch.matmul(x.float(), a), b) * s


def is_lora(name: str) -> bool:
    """True for a trainable adapter tensor's name (``lora_a`` / ``lora_b``; ``lora_s`` is
    a fixed hyperparameter)."""
    return name.rsplit(".", 1)[-1] in ("lora_a", "lora_b")


def lora_mask(model: nn.Module) -> dict[str, bool]:
    """{state-dict name: True only on lora_a / lora_b} (JAX ``lora_mask``)."""
    return {name: is_lora(name) for name in model.state_dict(keep_vars=True)}
