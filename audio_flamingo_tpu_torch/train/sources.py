"""Dataset sources: JSONL manifests and tar shards -> ``train/data.Source``, as
``audio_flamingo_tpu/train/sources.py``, decoding through the port's own native WAV
reader and resampler (``audio/io.py``).

A manifest line is {"audio": "rel/path.wav", "prompt": "...", "answer": "..."} (audio
optional; an "audios" list for several clips). Tar shards follow the webdataset
convention: members <key>.wav + <key>.json ({prompt, answer}).
"""

from __future__ import annotations

import json
import os
import tarfile
from dataclasses import dataclass

import numpy as np

from audio_flamingo_tpu_torch.audio.io import decode_wav, resample
from audio_flamingo_tpu_torch.train.data import Source


def _load_wav_file(path: str, target_sr: int) -> np.ndarray:
    with open(path, "rb") as f:
        wav, sr = decode_wav(f.read())
    return resample(wav, sr, target_sr)


@dataclass
class JsonlSource:
    """JSONL manifest + audio root -> Source. Examples are drawn uniformly."""

    manifest: str
    audio_root: str = ""
    target_sr: int = 16_000
    name: str | None = None
    weight: float = 1.0
    placeholder: str = "<sound>"

    def __post_init__(self):
        with open(self.manifest) as f:
            self.rows = [json.loads(line) for line in f if line.strip()]
        if not self.rows:
            raise ValueError(f"empty manifest {self.manifest}")

    def _example(self, rng: np.random.Generator):
        row = self.rows[int(rng.integers(0, len(self.rows)))]
        paths = row.get("audios") or ([row["audio"]] if row.get("audio") else [])
        audios = [_load_wav_file(os.path.join(self.audio_root, p), self.target_sr)
                  for p in paths]
        prompt = row["prompt"]
        if audios and self.placeholder not in prompt:
            prompt = self.placeholder * len(audios) + prompt
        return audios, prompt, row["answer"]

    def source(self) -> Source:
        return Source(self.name or os.path.basename(self.manifest), self.weight,
                      self._example)


@dataclass
class TarShardSource:
    """Webdataset-style tar shards: members <key>.wav + <key>.json ({prompt, answer}).
    Shards are indexed once (member offsets) and read lazily, with no extraction."""

    shards: list[str]
    target_sr: int = 16_000
    name: str = "tar"
    weight: float = 1.0
    placeholder: str = "<sound>"

    def __post_init__(self):
        self.index: list[tuple[str, str]] = []  # (shard_path, key)
        self._members: dict[str, dict[str, dict[str, tarfile.TarInfo]]] = {}
        for shard in self.shards:
            with tarfile.open(shard) as tf:
                keyed: dict[str, dict[str, tarfile.TarInfo]] = {}
                for m in tf.getmembers():
                    if not m.isfile():
                        continue
                    key, _, ext = m.name.rpartition(".")
                    keyed.setdefault(key, {})[ext] = m
            complete = {k: v for k, v in keyed.items() if "wav" in v and "json" in v}
            self._members[shard] = complete
            self.index.extend((shard, k) for k in sorted(complete))
        if not self.index:
            raise ValueError("no (wav, json) pairs found in the shards")

    def _example(self, rng: np.random.Generator):
        shard, key = self.index[int(rng.integers(0, len(self.index)))]
        members = self._members[shard][key]
        with tarfile.open(shard) as tf:
            wav_bytes = tf.extractfile(members["wav"]).read()
            meta = json.loads(tf.extractfile(members["json"]).read())
        wav, sr = decode_wav(wav_bytes)
        wav = resample(wav, sr, self.target_sr)
        prompt = meta["prompt"]
        if self.placeholder not in prompt:
            prompt = self.placeholder + prompt
        return [wav], prompt, meta["answer"]

    def source(self) -> Source:
        return Source(self.name, self.weight, self._example)
