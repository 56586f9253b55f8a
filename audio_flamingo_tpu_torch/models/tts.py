"""Streaming TTS head (AF3-Chat voice output), as ``audio_flamingo_tpu/models/tts.py``.

Per chunk of ``chunk_tokens`` text tokens, a small transformer maps the token embeddings,
a continuity state (the previous chunk's trailing ``state_frames`` mel frames, projected)
and learned mel-frame queries (after an optional speaker token) to ``frames_per_chunk``
log-mel frames; audio/neural_vocoder.py or audio/vocoder.py turns each chunk into
waveform. ``TTSHead`` holds the weights (Linear layouts [out, in]); the functions keep
JAX's names and take the head in place of the params tree. The blocks run on the port's
``layer_norm``, ``gqa_attention`` and ``gelu_mlp``; the dense products are plain torch
products, as JAX's are plain XLA dots.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audio_flamingo_tpu_torch.device import resolve_device
from audio_flamingo_tpu_torch.ops.attention import gqa_attention
from audio_flamingo_tpu_torch.ops.mlp import gelu_mlp
from audio_flamingo_tpu_torch.ops.norms import Norm, layer_norm


@dataclass(frozen=True)
class TTSConfig:
    vocab_size: int = 152_064
    d_model: int = 256
    num_layers: int = 4
    num_heads: int = 4
    ffn_dim: int = 1024
    n_mels: int = 80
    chunk_tokens: int = 16          # text tokens consumed per step
    frames_per_chunk: int = 64      # mel frames emitted per step (~0.64 s at 10 ms hop)
    state_frames: int = 8           # trailing frames fed back for continuity
    num_speakers: int = 0           # >0: learned speaker-embedding conditioning token
    rvq_quantizers: int = 0         # >0: ALSO emit RVQ code logits (audio/rvq.py codec)
    rvq_codebook: int = 256


class TTSBlock(nn.Module):
    def __init__(self, cfg: TTSConfig, **factory):
        super().__init__()
        d = cfg.d_model
        self.ln1 = Norm(d, **factory)
        self.q = nn.Linear(d, d, **factory)
        self.k = nn.Linear(d, d, **factory)
        self.v = nn.Linear(d, d, **factory)
        self.o = nn.Linear(d, d, **factory)
        self.ln2 = Norm(d, **factory)
        self.fc1 = nn.Linear(d, cfg.ffn_dim, **factory)
        self.fc2 = nn.Linear(cfg.ffn_dim, d, **factory)


class TTSHead(nn.Module):
    def __init__(self, cfg: TTSConfig, **factory):
        super().__init__()
        d = cfg.d_model
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, d, **factory))
        self.queries = nn.Parameter(torch.empty(cfg.frames_per_chunk, d, **factory))
        self.state_proj = nn.Linear(cfg.n_mels, d, **factory)
        self.blocks = nn.ModuleList(TTSBlock(cfg, **factory) for _ in range(cfg.num_layers))
        self.ln_f = Norm(d, **factory)
        self.mel_out = nn.Linear(d, cfg.n_mels, **factory)
        self.speaker = (nn.Parameter(torch.empty(cfg.num_speakers, d, **factory))
                        if cfg.num_speakers > 0 else None)
        self.rvq_out = (nn.Linear(d, cfg.rvq_quantizers * cfg.rvq_codebook, **factory)
                        if cfg.rvq_quantizers > 0 else None)

    @property
    def device(self) -> torch.device:
        return self.embed.device


@torch.no_grad()
def init(cfg: TTSConfig, generator: torch.Generator | None = None,
         device: torch.device | str | None = None) -> TTSHead:
    """JAX's init laws, drawn from ``generator`` on ``device``: linears N(0, 1) *
    0.5 / sqrt(fan_in) with zero biases; embed, queries and speakers N(0, 0.02^2); norms
    one and zero."""
    device = resolve_device(device)
    with torch.device("meta"):
        head = TTSHead(cfg, dtype=torch.float32)
    head = head.to_empty(device=device)
    for m in head.modules():
        if isinstance(m, nn.Linear):
            m.weight.normal_(0.0, 0.5 * m.in_features ** -0.5, generator=generator)
            m.bias.zero_()
        elif isinstance(m, Norm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    for p in (head.embed, head.queries, head.speaker):
        if p is not None:
            p.normal_(0.0, 0.02, generator=generator)
    return head


def _lin(h: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    return F.linear(h, lin.weight) + lin.bias


def _block(x: torch.Tensor, blk: TTSBlock, nh: int) -> torch.Tensor:
    b, t, d = x.shape
    hd = d // nh
    h = layer_norm(x, blk.ln1.weight, blk.ln1.bias)
    q = _lin(h, blk.q).reshape(b, t, nh, hd)
    k = _lin(h, blk.k).reshape(b, t, nh, hd)
    v = _lin(h, blk.v).reshape(b, t, nh, hd)
    x = x + _lin(gqa_attention(q, k, v).reshape(b, t, d), blk.o)
    h = layer_norm(x, blk.ln2.weight, blk.ln2.bias)
    return x + gelu_mlp(h, blk.fc1.weight, blk.fc1.bias, blk.fc2.weight, blk.fc2.bias)


def _trunk(head: TTSHead, cfg: TTSConfig, token_ids: torch.Tensor, prev_mel: torch.Tensor,
           speaker: torch.Tensor | None) -> torch.Tensor:
    """The shared trunk -> per-frame query hidden states [B, frames, D]. The sequence is
    [speaker?, text tokens, state frames, frame queries]; every query attends the speaker
    token, so the voice identity shapes the whole chunk."""
    b = token_ids.shape[0]
    tok = head.embed[token_ids]                                          # [B, C, D]
    state = _lin(prev_mel, head.state_proj)
    queries = head.queries[None].expand(b, cfg.frames_per_chunk, cfg.d_model)
    parts = [tok, state, queries]
    if speaker is not None:
        if cfg.num_speakers <= 0:
            raise ValueError("cfg.num_speakers must be set for speaker ids")
        parts.insert(0, head.speaker[speaker][:, None])                  # [B, 1, D]
    x = torch.cat(parts, dim=1)
    for blk in head.blocks:
        x = _block(x, blk, cfg.num_heads)
    x = layer_norm(x, head.ln_f.weight, head.ln_f.bias)
    return x[:, -cfg.frames_per_chunk:]


def synthesize_chunk(head: TTSHead, cfg: TTSConfig, token_ids: torch.Tensor,
                     prev_mel: torch.Tensor, speaker: torch.Tensor | None = None) -> torch.Tensor:
    """[B, chunk_tokens] ids + [B, state_frames, n_mels] state (+ [B] speaker ids) ->
    [B, frames_per_chunk, n_mels] log-mel frames."""
    return _lin(_trunk(head, cfg, token_ids, prev_mel, speaker), head.mel_out)


def rvq_chunk_logits(head: TTSHead, cfg: TTSConfig, token_ids: torch.Tensor,
                     prev_mel: torch.Tensor, speaker: torch.Tensor | None = None) -> torch.Tensor:
    """The RVQ-token head: -> [B, frames_per_chunk, quantizers, codebook] logits over
    audio/rvq.py codes."""
    if cfg.rvq_quantizers <= 0:
        raise ValueError("cfg.rvq_quantizers must be set for the RVQ head")
    logits = _lin(_trunk(head, cfg, token_ids, prev_mel, speaker), head.rvq_out)
    return logits.reshape(token_ids.shape[0], cfg.frames_per_chunk, cfg.rvq_quantizers,
                          cfg.rvq_codebook)


def rvq_loss(head: TTSHead, cfg: TTSConfig, codec, rvq_cfg, token_ids: torch.Tensor,
             prev_mel: torch.Tensor, target_mel: torch.Tensor,
             speaker: torch.Tensor | None = None) -> torch.Tensor:
    """Cross-entropy on teacher codes: the codec (audio/rvq.py) encodes the target mel."""
    from audio_flamingo_tpu_torch.audio import rvq as rvq_mod

    codes = rvq_mod.encode(codec, rvq_cfg, target_mel)                   # [B, F, Q]
    logits = rvq_chunk_logits(head, cfg, token_ids, prev_mel, speaker)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, codes[..., None].long())[..., 0]
    return torch.mean(nll)


def _chunks(head: TTSHead, cfg: TTSConfig, token_ids, pad_id: int):
    ids = [int(t) for t in token_ids]
    n_chunks = max(1, -(-len(ids) // cfg.chunk_tokens))
    ids = ids + [pad_id] * (n_chunks * cfg.chunk_tokens - len(ids))
    for c in range(n_chunks):
        yield torch.tensor([ids[c * cfg.chunk_tokens: (c + 1) * cfg.chunk_tokens]],
                           dtype=torch.long, device=head.device)


def _speaker(head: TTSHead, speaker) -> torch.Tensor | None:
    if speaker is None or isinstance(speaker, torch.Tensor):
        return speaker
    return torch.as_tensor(np.atleast_1d(speaker), dtype=torch.long, device=head.device)


@torch.no_grad()
def synthesize_rvq(head: TTSHead, cfg: TTSConfig, codec, rvq_cfg, token_ids,
                   pad_id: int = 0, speaker=None) -> np.ndarray:
    """Whole-utterance RVQ-mode synthesis: argmax codes -> codec decode -> mel.
    Returns [frames, n_mels] (feed it to a vocoder)."""
    from audio_flamingo_tpu_torch.audio import rvq as rvq_mod

    speaker = _speaker(head, speaker)
    state = torch.zeros(1, cfg.state_frames, cfg.n_mels, device=head.device)
    mels = []
    for chunk in _chunks(head, cfg, token_ids, pad_id):
        codes = torch.argmax(rvq_chunk_logits(head, cfg, chunk, state, speaker), dim=-1)
        mel = rvq_mod.decode(codec, rvq_cfg, codes)
        state = mel[:, -cfg.state_frames:]
        mels.append(mel[0].cpu().numpy())
    return np.concatenate(mels, axis=0)


@torch.no_grad()
def synthesize(head: TTSHead, cfg: TTSConfig, token_ids, pad_id: int = 0,
               speaker=None) -> np.ndarray:
    """Whole-utterance synthesis: chunk the token stream and emit mel chunk by chunk.
    token_ids: [T] list or 1-D array. Returns [frames, n_mels]."""
    speaker = _speaker(head, speaker)
    state = torch.zeros(1, cfg.state_frames, cfg.n_mels, device=head.device)
    mels = []
    for chunk in _chunks(head, cfg, token_ids, pad_id):
        mel = synthesize_chunk(head, cfg, chunk, state, speaker)
        state = mel[:, -cfg.state_frames:]
        mels.append(mel[0].cpu().numpy())
    return np.concatenate(mels, axis=0)


def loss(head: TTSHead, cfg: TTSConfig, token_ids: torch.Tensor, prev_mel: torch.Tensor,
         target_mel: torch.Tensor, mask: torch.Tensor | None = None,
         speaker: torch.Tensor | None = None) -> torch.Tensor:
    """Voice-to-voice training loss (AF3 stage 4): L1 + L2 on predicted log-mel frames.
    token_ids [B, chunk_tokens]; prev_mel [B, state_frames, n_mels]; target_mel
    [B, frames_per_chunk, n_mels]; mask [B, frames_per_chunk] optional. The mean divides
    by a 0-dim tensor: a true division, as JAX's."""
    pred = synthesize_chunk(head, cfg, token_ids, prev_mel, speaker)
    diff = pred - target_mel
    per = torch.abs(diff) + diff ** 2
    if mask is not None:
        per = per * mask[..., None]
        denom = torch.clamp(mask.sum() * cfg.n_mels, min=1.0)
    else:
        denom = torch.tensor(float(per.numel()), device=per.device)
    return per.sum() / denom
