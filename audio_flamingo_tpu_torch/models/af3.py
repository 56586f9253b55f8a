"""AF3 / Music Flamingo: AF-Whisper tower -> MLP adaptor -> Qwen2.5 with prefix tokens,
as ``audio_flamingo_tpu/models/af3.py``.

Audio embeddings replace the ``<sound>`` placeholder embeddings in order (the processor
has already expanded each placeholder to windows x 750 copies). The scatter is the JAX
package's cumsum-gather: the j-th placeholder of a row takes that row's j-th audio token.

``logits`` is the serving callers' forward (under inference mode). Training goes through
``loss_terms`` / ``loss``: the same forward with autograd on, the shifted cross-entropy
over label positions >= 0, dense or unembedded ``ce_chunk`` tokens at a time under full
recompute.
"""

from __future__ import annotations

import torch
from torch import nn

from audio_flamingo_tpu_torch.config import AF3Config
from audio_flamingo_tpu_torch.models import adaptor, qwen2, whisper_encoder
from audio_flamingo_tpu_torch.ops.remat import remat_wrap


class AF3Model(nn.Module):
    """The audio tower (a float ``WhisperEncoder`` or an int8 ``QuantWhisperEncoder``),
    the adaptor and the LM (a float ``qwen2.Qwen2`` or a quantized ``qwen2.QuantQwen2``)."""

    def __init__(self, encoder: whisper_encoder.WhisperEncoder, adaptor_: adaptor.Adaptor,
                 lm: qwen2.Qwen2 | qwen2.QuantQwen2):
        super().__init__()
        self.encoder = encoder
        self.adaptor = adaptor_
        self.lm = lm


def build(cfg: AF3Config, device: torch.device | str, dtype: torch.dtype,
          adaptor_layers: int = 2, lm: qwen2.QuantQwen2 | None = None,
          encoder: whisper_encoder.QuantWhisperEncoder | None = None) -> AF3Model:
    """Allocate an AF3Model's weights (uninitialized) directly on ``device`` in ``dtype``:
    the modules are built on the meta device, so no host copy of the weights exists.
    adaptor_layers: 2 for AF3's MLP adaptor, 1 for a single-Linear projector. ``lm``: a
    quantized LM already on ``device``, taken as it is in place of a float one;
    ``encoder``: likewise a quantized encoder (``whisper_encoder.quantized_encoder``)."""
    with torch.device("meta"):
        enc = whisper_encoder.WhisperEncoder(cfg.encoder, dtype=dtype) if encoder is None else None
        adp = adaptor.Adaptor(cfg.encoder.d_model, cfg.lm.hidden_size, adaptor_layers,
                              dtype=dtype)
        float_lm = qwen2.Qwen2(cfg.lm, dtype=dtype) if lm is None else None
    enc = enc.to_empty(device=device) if encoder is None else encoder
    adp = adp.to_empty(device=device)
    lm = float_lm.to_empty(device=device) if lm is None else lm
    return AF3Model(enc, adp, lm).eval().requires_grad_(False)


@torch.no_grad()
def init_(model: AF3Model, cfg: AF3Config, generator: torch.Generator) -> None:
    whisper_encoder.init_(model.encoder, cfg.encoder, generator)
    adaptor.init_(model.adaptor, generator)
    qwen2.init_(model.lm, generator)


def encode_audio(model: AF3Model, cfg: AF3Config, mels: torch.Tensor) -> torch.Tensor:
    """[num_windows, 3000, n_mels] -> [num_windows, tokens_per_window, lm_hidden], through
    the float or the quantized encoder."""
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


def hidden_states(model: AF3Model, cfg: AF3Config, token_ids: torch.Tensor,
                  mels: torch.Tensor | None = None) -> torch.Tensor:
    """Full-sequence forward to the LM's final-normed hidden states [B, T, d]."""
    b, t = token_ids.shape
    x = build_input_embeds(model, cfg, token_ids, mels)
    pos = torch.arange(t, device=token_ids.device)[None].expand(b, t)
    return qwen2.forward(model.lm, cfg.lm, x, pos)[0]


@torch.inference_mode()
def logits(model: AF3Model, cfg: AF3Config, token_ids: torch.Tensor,
           mels: torch.Tensor | None = None) -> torch.Tensor:
    """Full-sequence forward: [B, T] (+ mels) -> [B, T, vocab] f32."""
    return qwen2.unembed(model.lm, hidden_states(model, cfg, token_ids, mels))


def _ce_terms(lg: torch.Tensor, labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum of -log p(label), count) over the positions with a label >= 0."""
    valid = labels >= 0
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(lg, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum(), valid.sum()


def _shifted_ce_terms(lg: torch.Tensor, labels: torch.Tensor):
    """Unnormalized shifted-CE terms (nll_sum, valid_token_count): position t predicts
    label t + 1. Gradient accumulation divides by the GLOBAL count (train_step)."""
    return _ce_terms(lg[:, :-1], labels[:, 1:])


def _chunked_ce_terms(model: AF3Model, h: torch.Tensor, labels: torch.Tensor,
                      ce_chunk: int):
    """Shifted-CE terms from hidden states, unembedding ``ce_chunk`` tokens at a time;
    each chunk's unembed and log-softmax run under full recompute, so the backward holds
    one chunk's [B, ce_chunk, V] logits at a time (JAX models/af3.py:129-172). The tail
    is padded with -100 labels."""
    hs, ls = h[:, :-1], labels[:, 1:]
    pad = (-hs.shape[1]) % ce_chunk
    if pad:
        hs = torch.nn.functional.pad(hs, (0, 0, 0, pad))
        ls = torch.nn.functional.pad(ls, (0, pad), value=-100)

    def body(hc, lc):
        return _ce_terms(qwen2.unembed(model.lm, hc), lc)

    body = remat_wrap(body, "full")
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    count = torch.zeros((), dtype=torch.long, device=h.device)
    for c0 in range(0, hs.shape[1], ce_chunk):
        s, c = body(hs[:, c0:c0 + ce_chunk], ls[:, c0:c0 + ce_chunk])
        total = total + s
        count = count + c
    return total, count


def loss_terms(model: AF3Model, cfg: AF3Config, token_ids: torch.Tensor,
               labels: torch.Tensor, mels: torch.Tensor | None = None, ce_chunk: int = 0):
    """Unnormalized (nll_sum, valid_count) of the shifted CE, differentiable in the hot
    weights. ce_chunk > 0: the memory-efficient chunked CE (see _chunked_ce_terms)."""
    h = hidden_states(model, cfg, token_ids, mels)
    if ce_chunk <= 0:
        return _shifted_ce_terms(qwen2.unembed(model.lm, h), labels)
    return _chunked_ce_terms(model, h, labels, ce_chunk)


def loss(model: AF3Model, cfg: AF3Config, token_ids: torch.Tensor, labels: torch.Tensor,
         mels: torch.Tensor | None = None, ce_chunk: int = 0) -> torch.Tensor:
    """Mean shifted CE over label positions >= 0 (prompt and audio positions carry -100),
    as [hf] modeling_qwen2_audio.py:853-866."""
    s, c = loss_terms(model, cfg, token_ids, labels, mels, ce_chunk=ce_chunk)
    return s / c.clamp(min=1)
