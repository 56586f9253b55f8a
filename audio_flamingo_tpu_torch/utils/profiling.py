"""Profiling and tracing utilities, as ``audio_flamingo_tpu/utils/profiling.py``.

``trace`` records a ``torch.profiler`` trace of the host and the card (CUPTI) and writes
it as a Chrome / Perfetto JSON file; ``annotate`` marks a phase inside it; ``PhaseTimer``
accumulates wall-clock time per phase, synchronizing the result's device when asked; and
``enable_nan_checks`` turns on autograd's anomaly mode with its NaN checks.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a ``torch.profiler`` trace (CPU, and CUDA where a card is present) of the
    block; on exit it is written to ``log_dir/trace.json`` (Chrome / Perfetto format).
    Yields the profiler, whose ``key_averages()`` and ``events()`` can be read after."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named range inside a trace (``torch.profiler.record_function``)."""
    return record_function(name)


def _synchronize(result) -> None:
    """Wait for the devices of every tensor in ``result`` (a tensor or a nest of them)."""
    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            torch.cuda.synchronize(result.device)
    elif isinstance(result, dict):
        for value in result.values():
            _synchronize(value)
    elif isinstance(result, (list, tuple)):
        for value in result:
            _synchronize(value)


@dataclass
class PhaseTimer:
    """Wall-clock per-phase accumulator; with ``block=True`` a phase whose body sets
    ``out["result"]`` waits for that result's device before its time is taken."""

    block: bool = True
    totals: dict = field(default_factory=lambda: defaultdict(float))
    counts: dict = field(default_factory=lambda: defaultdict(int))

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        out = {}
        try:
            yield out
        finally:
            if self.block and out.get("result") is not None:
                _synchronize(out["result"])
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict:
        return {k: {"total_s": v, "mean_s": v / max(self.counts[k], 1),
                    "count": self.counts[k]} for k, v in self.totals.items()}


def enable_nan_checks(enable: bool = True) -> None:
    """``torch.autograd.set_detect_anomaly(enable, check_nan=True)``. Unlike JAX's
    ``jax_debug_nans``, which checks every jitted computation's outputs, forward and
    backward alike, this checks only the backward: a backward function that returns a
    NaN raises, naming the forward op that made it (with its traceback). A NaN produced
    in a forward pass, or anywhere under ``inference_mode`` (decode, serving), is not
    checked."""
    torch.autograd.set_detect_anomaly(enable, check_nan=True)
