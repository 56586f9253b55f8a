"""Serving and training metrics as structured records, as ``audio_flamingo_tpu/utils/
metrics.py`` (the port keeps its own copy): ``MetricsLogger`` (records, optional JSONL
sink) and ``RequestTimer`` (TTFT, decode tokens/s and encode RTFx of one request)."""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field


@dataclass
class MetricsLogger:
    jsonl_path: str | None = None
    records: list[dict] = field(default_factory=list)
    verbose: bool = True

    def log(self, **kv) -> None:
        rec = {"ts": time.time(), **kv}
        self.records.append(rec)
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        if self.verbose:
            parts = [f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                     for k, v in kv.items()]
            print("[metrics] " + " ".join(parts), flush=True)

    def latest(self, key: str):
        for rec in reversed(self.records):
            if key in rec:
                return rec[key]
        return None


@dataclass
class RequestTimer:
    """Per-request serving metrics: TTFT, decode tokens/s and encode RTFx. The clock
    starts when the timer is made (at submit, so queue wait counts)."""

    audio_seconds: float = 0.0
    _t0: float = field(default_factory=time.perf_counter)
    ttft_s: float | None = None
    n_tokens: int = 0
    done_s: float | None = None

    def first_token(self):
        if self.ttft_s is None:
            self.ttft_s = time.perf_counter() - self._t0
        self.n_tokens += 1

    def token(self):
        self.n_tokens += 1

    def finish(self) -> dict:
        self.done_s = time.perf_counter() - self._t0
        decode_s = self.done_s - (self.ttft_s or self.done_s)
        return {
            "ttft_s": self.ttft_s,
            "total_s": self.done_s,
            "tokens": self.n_tokens,
            "decode_tps": ((self.n_tokens - 1) / decode_s
                           if decode_s > 0 and self.n_tokens > 1 else None),
            "rtfx": self.audio_seconds / self.done_s if self.audio_seconds else None,
        }
