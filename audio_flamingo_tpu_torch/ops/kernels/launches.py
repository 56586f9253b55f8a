"""Launch counts of the hand-written kernels, so a run can show what went through them.

A launch enqueued while the stream is being captured into a CUDA graph is not counted
then: it is kept as captured (``take_captured``), and whoever replays the graph counts it
at each replay (``count_replay``), when the kernel runs."""

from __future__ import annotations

import collections

import torch


class LaunchCounter:
    """Counts kernel launches, in total and by a key the wrapper chooses (its shapes).

    Two switches, both off by default, serve measurement: ``timing`` brackets each launch
    with CUDA events (``device_ms`` sums them), and ``capture`` keeps what the wrapper
    passes as each launch's inputs in ``inputs`` so that they can be replayed. Off, they
    cost one attribute test per launch."""

    def __init__(self):
        _ALL.append(self)
        self.captured: collections.Counter = collections.Counter()
        self.count = 0
        self.shapes: collections.Counter = collections.Counter()
        self.timing = False
        self.capture = False
        self.inputs: list = []
        self._events: list = []

    def reset(self) -> None:
        self.count = 0
        self.shapes.clear()
        self.inputs.clear()
        self._events.clear()

    def start(self, device: torch.device):
        """A start event recorded on the device's current stream when timing, else None."""
        if not self.timing or _capturing(device):
            return None
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(device))
        return event

    def record(self, key, device: torch.device, start=None, inputs=None) -> None:
        """Count one launch under ``key``, just after it was enqueued on ``device`` (kept
        as captured if the stream is being captured)."""
        if _capturing(device):
            self.captured[key] += 1
            return
        self.count += 1
        self.shapes[key] += 1
        if start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(device))
            self._events.append((start, end))
        if self.capture:
            self.inputs.append(inputs)

    def device_ms(self) -> float:
        """Summed device time of the timed launches since the last reset."""
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self._events)


_ALL: list[LaunchCounter] = []   # every counter made


def _capturing(device: torch.device) -> bool:
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def take_captured() -> list:
    """[(counter, Counter of keys)] of the launches captured since the last call (cleared)."""
    out = [(c, collections.Counter(c.captured)) for c in _ALL if c.captured]
    for c in _ALL:
        c.captured.clear()
    return out


def count_replay(captured: list) -> None:
    """Count one replay of a graph holding ``captured`` (from ``take_captured``)."""
    for counter, keys in captured:
        counter.count += sum(keys.values())
        counter.shapes.update(keys)
