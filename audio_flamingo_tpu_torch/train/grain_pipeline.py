"""Worker-parallel input pipeline, as ``audio_flamingo_tpu/train/grain_pipeline.py``, on
``torch.utils.data.DataLoader`` workers (the loader the reference's own docstring names;
the port does not use grain).

The workers run the per-example work (audio decode, the source's draws); batch assembly
(bucketing, label masks) stays in ``train/data.BatchBuilder`` in the caller's process,
because a bucket depends on the whole batch. Example ``i`` is drawn from
``np.random.default_rng((seed, i))`` and the loader hands examples back in index order,
so the stream is JAX's for the same seed whatever ``worker_count`` is.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch.utils.data


@dataclass
class _ExampleSource(torch.utils.data.Dataset):
    """Index -> (audios, prompt, answer) over the mixture's sources, each index seeded
    on its own (JAX ``_ExampleSource``)."""

    sources: list
    probs: np.ndarray
    seed: int
    virtual_len: int = 1_000_000

    def __len__(self) -> int:
        return self.virtual_len

    def __getitem__(self, idx: int):
        rng = np.random.default_rng((self.seed, int(idx)))
        src = self.sources[int(rng.choice(len(self.sources), p=self.probs))]
        return src.examples(rng)


def _as_is(example):
    """The loader's collate for one example: no conversion to tensors."""
    return example


def grain_batches(sampler, builder, batch_size: int, *, seed: int = 0,
                  worker_count: int = 0, prefetch: int = 8):
    """Iterator of training batches: the loader's examples in index order ->
    ``BatchBuilder`` batches. sampler: a ``train/data.MixtureSampler`` (its sources and
    probabilities; its own rng is not used). worker_count 0 runs in this process; more
    spawns that many workers (not fork: the caller's process has threads), which keep
    about ``prefetch`` examples in flight together; the sources are pickled to them, so
    their example functions must be importable (module-level functions, or the methods
    of ``train/sources`` objects)."""
    source = _ExampleSource(sources=sampler.sources, probs=sampler.probs, seed=seed)
    extra = ({} if worker_count == 0 else
             dict(prefetch_factor=max(1, -(-prefetch // worker_count)),
                  multiprocessing_context="spawn"))
    loader = torch.utils.data.DataLoader(source, batch_size=None, shuffle=False,
                                         num_workers=worker_count, collate_fn=_as_is, **extra)
    rows = []
    for example in loader:
        rows.append(example)
        if len(rows) == batch_size:
            yield builder.build(rows)
            rows = []
