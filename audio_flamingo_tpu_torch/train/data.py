"""Training data: weighted dataset mixtures -> static-shape batches, as
``audio_flamingo_tpu/train/data.py``.

- a ``Source`` yields (audio waveform(s), prompt, answer) examples from a numpy
  generator;
- ``MixtureSampler`` draws sources by weight, reproducibly per seed: the same seed gives
  the JAX package's draws;
- ``BatchBuilder`` runs the processor (chat template, ``<sound>`` expansion, log-mel),
  buckets the token length, and labels the answer (-100 over prompt and audio);
- ``icl_interleave`` builds AF1-style few-shot sequences.

A batch lives on the processor's device: the processor computes its log-mels there, and
the builder packs them there, so no batch crosses to the host and back.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterator, Sequence

import numpy as np
import torch

from audio_flamingo_tpu_torch.config import TOKEN_BUCKETS, bucket_tokens  # noqa: F401


@dataclass
class Source:
    """One dataset: an example factory + mixing weight."""

    name: str
    weight: float
    examples: Callable[[np.random.Generator], tuple[list[np.ndarray], str, str]]
    """rng -> (audios, prompt_text_with_placeholders, answer_text)"""


class MixtureSampler:
    """Weighted sampling over sources, reproducible per seed."""

    def __init__(self, sources: Sequence[Source], seed: int = 0):
        if not sources:
            raise ValueError("MixtureSampler needs at least one source")
        self.sources = list(sources)
        w = np.asarray([s.weight for s in sources], np.float64)
        self.probs = w / w.sum()
        self.rng = np.random.default_rng(seed)

    def sample(self):
        idx = int(self.rng.choice(len(self.sources), p=self.probs))
        src = self.sources[idx]
        return src.name, src.examples(self.rng)


@dataclass
class BatchBuilder:
    """Packs processor outputs into fixed-shape training batches on the processor's
    device: {'ids': long [B, T], 'labels': long [B, T], 'mels': f32 [B, W, 3000, M]}.

    Labels follow [hf] modeling_qwen2_audio.py:853-866: -100 over prompt and audio
    positions, token ids (and the closing ``<|im_end|>``) over the answer; rows are
    right-padded to the token bucket with ``pad_id`` and -100, and to the batch's window
    count with zero mels."""

    processor: "object"          # runtime.processor.AF3Processor
    pad_id: int = 0
    max_windows: int = 20

    def build(self, examples: list[tuple[list[np.ndarray], str, str]]) -> dict:
        rows = []
        max_nw = 1
        for audios, prompt, answer in examples:
            pre = self.processor(
                messages=[{"role": "user", "content": prompt}], audios=audios or None)
            prompt_ids = pre["ids"][0]
            ans_ids = np.asarray(self.processor.tokenizer.encode(answer), np.int32)
            eos = self.processor.tokenizer.special_tokens.get("<|im_end|>")
            if eos is not None:
                ans_ids = np.concatenate([ans_ids, [eos]]).astype(np.int32)
            ids = np.concatenate([prompt_ids, ans_ids])
            labels = np.concatenate([np.full(len(prompt_ids), -100, np.int32), ans_ids])
            mels = pre["mels"][0] if pre["mels"] is not None else None
            if mels is not None:
                max_nw = max(max_nw, mels.shape[0])
            rows.append((ids, labels, mels))

        max_nw = min(max_nw, self.max_windows)
        tok_len = bucket_tokens(max(len(r[0]) for r in rows))
        n_mels = self.processor.cfg.encoder.num_mel_bins
        b = len(rows)
        ids = np.full((b, tok_len), self.pad_id, np.int64)
        labels = np.full((b, tok_len), -100, np.int64)
        device = self.processor.device
        mels = torch.zeros((b, max_nw, 3000, n_mels), dtype=torch.float32, device=device)
        for i, (r_ids, r_labels, r_mels) in enumerate(rows):
            n = min(len(r_ids), tok_len)
            ids[i, :n] = r_ids[:n]
            labels[i, :n] = r_labels[:n]
            if r_mels is not None:
                mels[i, : r_mels.shape[0]] = r_mels[: max_nw]
        return {"ids": torch.from_numpy(ids).to(device),
                "labels": torch.from_numpy(labels).to(device), "mels": mels}


def icl_interleave(examples: list[tuple[str, str]],
                   audio_token: str = "<sound>") -> tuple[str, np.ndarray]:
    """AF1 few-shot: interleave (prompt, answer) shots into one sequence.

    Returns (text, media_ordinals) where media_ordinals[i] = number of media items before
    text segment i (the Flamingo cross-attention media mask's input)."""
    parts = []
    for prompt, answer in examples:
        parts.append(f"{audio_token}{prompt} {answer}".strip())
    return "\n".join(parts), np.arange(1, len(examples) + 1)


def batches(sampler: MixtureSampler, builder: BatchBuilder,
            batch_size: int) -> Iterator[dict]:
    """Infinite batch stream (see ``prefetch`` for building the next batch meanwhile)."""
    while True:
        rows = [sampler.sample()[1] for _ in range(batch_size)]
        yield builder.build(rows)


def prefetch(it: Iterator[dict], depth: int = 2) -> Iterator[dict]:
    """Builds up to ``depth`` batches ahead on a background thread, so batch building
    (decode, log-mel, BPE) overlaps the steps. An error in the producer is raised here."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = object()
    failure: list[Exception] = []

    def worker():
        try:
            for item in it:
                q.put(item)
        except Exception as exc:  # handed to the consumer below
            failure.append(exc)
        finally:
            q.put(stop)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is stop:
            if failure:
                raise failure[0]
            return
        yield item
