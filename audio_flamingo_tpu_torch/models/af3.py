"""AF3 / Music Flamingo: AF-Whisper tower -> MLP adaptor -> Qwen2.5 with prefix tokens,
as ``audio_flamingo_tpu/models/af3.py``.

Audio embeddings replace the ``<sound>`` placeholder embeddings in order (the processor
has already expanded each placeholder to windows x 750 copies). The scatter is the JAX
package's cumsum-gather: the j-th placeholder of a row takes that row's j-th audio token.
"""

from __future__ import annotations

import torch
from torch import nn

from audio_flamingo_tpu_torch.config import AF3Config
from audio_flamingo_tpu_torch.models import adaptor, qwen2, whisper_encoder


class AF3Model(nn.Module):
    def __init__(self, cfg: AF3Config, adaptor_layers: int = 2, **factory):
        super().__init__()
        self.encoder = whisper_encoder.WhisperEncoder(cfg.encoder, **factory)
        self.adaptor = adaptor.Adaptor(cfg.encoder.d_model, cfg.lm.hidden_size,
                                       adaptor_layers, **factory)
        self.lm = qwen2.Qwen2(cfg.lm, **factory)


def build(cfg: AF3Config, device: torch.device | str, dtype: torch.dtype,
          adaptor_layers: int = 2) -> AF3Model:
    """Allocate an AF3Model's weights (uninitialized) directly on ``device`` in ``dtype``:
    the modules are built on the meta device, so no host copy of the weights exists.
    adaptor_layers: 2 for AF3's MLP adaptor, 1 for a single-Linear projector."""
    with torch.device("meta"):
        model = AF3Model(cfg, adaptor_layers, dtype=dtype)
    return model.to_empty(device=device).eval().requires_grad_(False)


@torch.no_grad()
def init_(model: AF3Model, cfg: AF3Config, generator: torch.Generator) -> None:
    whisper_encoder.init_(model.encoder, cfg.encoder, generator)
    adaptor.init_(model.adaptor, generator)
    qwen2.init_(model.lm, generator)


def encode_audio(model: AF3Model, cfg: AF3Config, mels: torch.Tensor) -> torch.Tensor:
    """[num_windows, 3000, n_mels] -> [num_windows, tokens_per_window, lm_hidden]."""
    h = whisper_encoder.apply(model.encoder, cfg.encoder, mels)
    return adaptor.apply(model.adaptor, h)


def scatter_audio_embeds(text_embeds: torch.Tensor, token_ids: torch.Tensor,
                         audio_embeds: torch.Tensor, audio_token_id: int) -> torch.Tensor:
    """text_embeds [B, T, D], token_ids [B, T], audio_embeds [B, A, D]: the j-th
    placeholder position of each row takes audio_embeds[:, j]."""
    is_audio = token_ids == audio_token_id
    ordinal = (torch.cumsum(is_audio.long(), dim=1) - 1).clamp(0, audio_embeds.shape[1] - 1)
    idx = ordinal[..., None].expand(-1, -1, audio_embeds.shape[-1])
    gathered = torch.gather(audio_embeds, 1, idx).to(text_embeds.dtype)
    return torch.where(is_audio[..., None], gathered, text_embeds)


def build_input_embeds(model: AF3Model, cfg: AF3Config, token_ids: torch.Tensor,
                       mels: torch.Tensor | None) -> torch.Tensor:
    """token ids [B, T] (+ mels [B, num_windows, 3000, n_mels]) -> LM input embeddings."""
    embeds = qwen2.embed(model.lm, token_ids)
    if mels is None:
        return embeds
    b, nw, frames, nmel = mels.shape
    audio = encode_audio(model, cfg, mels.reshape(b * nw, frames, nmel))
    audio = audio.reshape(b, nw * audio.shape[1], -1)
    return scatter_audio_embeds(embeds, token_ids, audio, cfg.audio_token_id)


@torch.inference_mode()
def logits(model: AF3Model, cfg: AF3Config, token_ids: torch.Tensor,
           mels: torch.Tensor | None = None) -> torch.Tensor:
    """Full-sequence forward: [B, T] (+ mels) -> [B, T, vocab] f32."""
    b, t = token_ids.shape
    x = build_input_embeds(model, cfg, token_ids, mels)
    pos = torch.arange(t, device=token_ids.device)[None].expand(b, t)
    h, _ = qwen2.forward(model.lm, cfg.lm, x, pos)
    return qwen2.unembed(model.lm, h)
