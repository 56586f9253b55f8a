"""The beam-search lane of the serving engines, as ``audio_flamingo_tpu/runtime/beam_lane.py``.

A beam request is admitted by an engine, prefilled once (``beam.beam_open``) and then
advanced ``chunk`` beam steps per engine round (``beam.beam_advance``), between the
engine's own decode chunks. Chunk boundaries only partition the steps, so the emitted
(sequences, scores) equal ``beam.generate_beam``'s on the same bucket-padded prompt.

- A beam request owns its cache (one request, K rows) instead of engine slots or pages:
  the per-step reorder by parent is a row gather over all K rows, which neither the
  slots' independent rows nor the shared page pool can carry.
- Prompts are right-padded to the engines' token buckets with the true length given, so
  on the card requests of one capacity and options share one captured step.
- One host read of ``alive`` and ``i`` per request per round.
- The AF1/AF2 family (``family="xattn"``: ``runtime/flamingo_engine.FlamingoEngine`` and
  ``runtime/paged_flamingo_engine.PagedFlamingoEngine``) takes ``window_embeds``, padded by
  the engine's ``pad_windows`` to its fixed media shape as its own admission pads them,
  and runs ``beam.beam_open_xattn`` / ``beam_advance_xattn``; results equal
  ``beam.generate_beam_xattn``'s on the same padded prompt and windows.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from audio_flamingo_tpu_torch.config import bucket_tokens
from audio_flamingo_tpu_torch.device import resolve_device
from audio_flamingo_tpu_torch.runtime import beam as beam_mod


@dataclass
class BeamRequest:
    """One beam-search request for an engine's beam lane."""

    request_id: str
    ids: np.ndarray                       # [1, T]
    mels: object = None                   # AF3 family
    window_embeds: object = None          # AF1/AF2 (xattn) family: [1, n_media, wpm, d]
    num_beams: int = 4
    max_new_tokens: int = 64
    length_penalty: float = 1.0
    early_stopping: object = False
    min_new_tokens: int = 0
    num_return_sequences: int = 1
    no_repeat_ngram_size: int = 0
    do_sample: bool = False
    temperature: float = 1.0
    media_mode: str = "last"              # AF1/AF2: the prefill's media mode (JAX's)
    seed: int = 0                         # a sampled request's generator seed


@dataclass
class BeamLane:
    """Advances admitted beam requests one bounded chunk of steps per round."""

    model: object                         # the port's AF3Model, or a FlamingoModel (xattn)
    cfg: object
    eos_token_id: int
    chunk: int = 8
    family: str = "af3"                   # "af3" | "xattn"
    max_active: int = 1
    device: torch.device | str | None = None
    pad_windows: object = None            # xattn: callable(numpy windows) -> padded tensor

    queue: deque = field(default_factory=deque)
    active: list = field(default_factory=list)    # [request, beam.BeamSearch]
    finished: dict = field(default_factory=dict)  # id -> (sequences [R, L], scores [R])

    def __post_init__(self):
        if self.family not in ("af3", "xattn"):
            raise ValueError(f"family is 'af3' or 'xattn', not {self.family!r}")
        self.device = resolve_device(self.device)

    @property
    def busy(self) -> bool:
        return bool(self.queue or self.active)

    def submit(self, req: BeamRequest) -> None:
        audio, other = (("mels", "window_embeds") if self.family == "af3"
                        else ("window_embeds", "mels"))
        if getattr(req, other) is not None:
            raise ValueError(f"a {self.family} lane takes {audio}, not {other}")
        if req.num_beams <= 1:
            raise ValueError("use the engine's normal path for num_beams=1")
        if req.num_return_sequences > req.num_beams:
            raise ValueError("num_return_sequences must be <= num_beams")
        self.queue.append(req)

    def _admit(self, req: BeamRequest) -> None:
        ids = np.asarray(req.ids, np.int64)
        t = ids.shape[1]
        bucket = bucket_tokens(t)
        if bucket != t:
            pad = np.full((1, bucket - t), max(self.eos_token_id, 0), np.int64)
            ids = np.concatenate([ids, pad], axis=1)
        capacity = -(-(bucket + req.max_new_tokens) // 128) * 128
        generator = (torch.Generator(device=self.device).manual_seed(req.seed)
                     if req.do_sample else None)
        opts = dict(num_beams=req.num_beams, max_new_tokens=req.max_new_tokens,
                    eos_token_id=self.eos_token_id, capacity=capacity,
                    length_penalty=req.length_penalty, early_stopping=req.early_stopping,
                    min_new_tokens=req.min_new_tokens,
                    no_repeat_ngram_size=req.no_repeat_ngram_size, do_sample=req.do_sample,
                    temperature=req.temperature, generator=generator)
        ids = torch.as_tensor(ids, device=self.device)
        if self.family == "af3":
            mels = None if req.mels is None else torch.as_tensor(req.mels, device=self.device)
            search = beam_mod.beam_open(self.model, self.cfg, ids, mels, t, **opts)
        else:
            wins = (self.pad_windows(req.window_embeds) if self.pad_windows is not None
                    else torch.as_tensor(req.window_embeds, device=self.device))
            search = beam_mod.beam_open_xattn(self.model, self.cfg, ids, wins, t,
                                              media_mode=req.media_mode, **opts)
        self.active.append([req, search])

    def step(self) -> bool:
        """Admit, then advance each active request one chunk. Returns True if any device
        work ran this round."""
        while self.queue and len(self.active) < self.max_active:
            self._admit(self.queue.popleft())
        if not self.active:
            return False
        for entry in list(self.active):
            req, search = entry
            beam_mod.beam_advance(search, self.chunk)   # either family's search
            # one host read per round, the engines' cadence
            alive, i = torch.stack([search.state.alive.long(), search.state.i]).tolist()
            if not alive or i >= req.max_new_tokens:
                seqs, scores = search.result(req.num_return_sequences)
                self.finished[req.request_id] = (seqs[0].cpu().numpy(), scores[0].cpu().numpy())
                search.close()
                self.active.remove(entry)
        return True


def attach_beam_lane(engine, family: str = "af3", pad_windows=None) -> BeamLane:
    """The engine's beam lane, attached at first use; it shares the engine's model,
    config, EOS id, chunk and device (and, for the xattn family, its ``pad_windows``)."""
    lane = getattr(engine, "beam_lane", None)
    if lane is None:
        lane = BeamLane(model=engine.model, cfg=engine.cfg, eos_token_id=engine.eos_token_id,
                        chunk=engine.chunk, family=family, device=engine.device,
                        pad_windows=pad_windows)
        engine.beam_lane = lane
    return lane


def step_beam_lane(engine) -> None:
    lane = getattr(engine, "beam_lane", None)
    if lane is not None:
        lane.step()


def beam_lane_busy(engine) -> bool:
    lane = getattr(engine, "beam_lane", None)
    return lane is not None and lane.busy


def finished_beams(engine) -> dict:
    lane = getattr(engine, "beam_lane", None)
    return lane.finished if lane is not None else {}
