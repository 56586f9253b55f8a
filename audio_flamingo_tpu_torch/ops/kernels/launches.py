"""Launch counts of the hand-written kernels, so a run can show what went through them."""

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
        if not self.timing:
            return None
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(device))
        return event

    def record(self, key, device: torch.device, start=None, inputs=None) -> None:
        """Count one launch under ``key``, just after it was enqueued on ``device``."""
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
