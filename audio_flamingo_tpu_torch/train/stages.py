"""Training-stage curriculum: per-stage freeze masks, as
``audio_flamingo_tpu/train/stages.py``.

  AF3: 1 pre-train (adaptor hot) -> 2 encoder tuning (encoder + adaptor hot) ->
       3 full fine-tune (all hot) -> 3.5 context extension and thinking (encoder frozen)
       -> 4 chat and voice.
  MF:  full FT -> context extension -> reasoning cold-start -> GRPO.
"""

from __future__ import annotations

from dataclasses import dataclass

from torch import nn


@dataclass(frozen=True)
class Stage:
    name: str
    train_encoder: bool
    train_adaptor: bool
    train_lm: bool
    lr: float = 1e-4
    description: str = ""


AF3_STAGES: dict[str, Stage] = {
    "1_pretrain": Stage("1_pretrain", False, True, False, lr=1e-3,
                        description="alignment pre-training: adaptor hot, encoder+LLM frozen"),
    "2_encoder_tuning": Stage("2_encoder_tuning", True, True, False, lr=2e-5,
                              description="AF-Whisper + adaptor hot"),
    "3_full_ft": Stage("3_full_ft", True, True, True, lr=1e-5,
                       description="full fine-tune, all hot"),
    "3.5_context_think": Stage("3.5_context_think", False, True, True, lr=1e-5,
                               description="context extension + thinking, encoder frozen"),
    "4_chat_voice": Stage("4_chat_voice", False, True, True, lr=1e-5,
                          description="chat & voice-to-voice"),
}


MF_STAGES: dict[str, Stage] = {
    "mf_1_full_ft": Stage("mf_1_full_ft", True, True, True, lr=1e-5,
                          description="full fine-tune on MF-Skills + context extension"),
    "mf_2_cold_start": Stage("mf_2_cold_start", False, True, True, lr=5e-6,
                             description="reasoning cold-start on MF-Think traces"),
    "mf_3_grpo": Stage("mf_3_grpo", False, False, True, lr=1e-6,
                       description="GRPO reasoning scaling (train/grpo.py)"),
}


def trainable_mask(model: nn.Module, stage: Stage) -> dict[str, bool]:
    """{state-dict name: True where the tensor trains this stage}, over an AF3Model's
    ``encoder``, ``adaptor`` and ``lm`` children (a quantized LM's buffers included);
    any other top-level name trains, as in JAX."""
    flags = {"encoder": stage.train_encoder, "adaptor": stage.train_adaptor,
             "lm": stage.train_lm}
    return {name: flags.get(name.split(".", 1)[0], True)
            for name in model.state_dict(keep_vars=True)}
