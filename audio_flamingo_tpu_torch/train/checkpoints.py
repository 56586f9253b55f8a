"""Checkpoints of the training state and safetensors export/import, as
``audio_flamingo_tpu/train/checkpoints.py`` (whose orbax is JAX's and is not used here).

A checkpoint is ``<path>/step_<n>/train_state.pt``, written by ``torch.save``: the hot
parameters (by state-dict name), the optimizer state and the step. Frozen weights are not
written: they are the ones the run started from, so ``restore`` loads into a state built
on the same starting model, as the JAX ``restore`` fills a template.

``AsyncCheckpointer`` writes the same files on a background thread (JAX's is orbax's):
its ``save`` copies the state to host memory before it returns, so the steps that run
while the file is written, which update the parameters in place, cannot reach it.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from audio_flamingo_tpu_torch.io.safetensors import load_safetensors, save_safetensors

STATE_FILE = "train_state.pt"


def _step_dir(path: str, step: int | None) -> str:
    return os.path.join(os.path.abspath(path), f"step_{step}" if step is not None else "latest")


def _payload(state, copy: bool) -> dict:
    """What a checkpoint holds: the hot parameters, the optimizer state and the step;
    with ``copy``, every tensor copied to host memory (a snapshot later steps cannot
    change)."""
    def host(t: torch.Tensor) -> torch.Tensor:
        return t.detach().to("cpu", copy=True) if copy else t.detach()

    params = dict(state.model.named_parameters())
    opt = {k: ({n: host(t) for n, t in v.items()} if isinstance(v, dict) else v)
           for k, v in state.opt_state.items()}
    return {"hot": {n: host(p) for n, p in params.items() if p.requires_grad},
            "opt_state": opt, "step": state.step}


def _write(path: str, step: int | None, payload: dict) -> None:
    """torch.save atomically: a temporary file renamed into place."""
    out_dir = _step_dir(path, step)
    os.makedirs(out_dir, exist_ok=True)
    target = os.path.join(out_dir, STATE_FILE)
    tmp = f"{target}.tmp{os.getpid()}.{threading.get_ident()}"
    torch.save(payload, tmp)
    os.replace(tmp, target)


def save(path: str, state, step: int | None = None) -> None:
    """Write a TrainState's hot parameters, optimizer state and step."""
    _write(path, step, _payload(state, copy=False))


def restore(path: str, state, step: int | None = None):
    """Load a checkpoint into ``state`` (same model and optimizer layout), in place on
    its device and dtypes; returns it. A checkpoint of other parameters raises."""
    saved = torch.load(os.path.join(_step_dir(path, step), STATE_FILE), map_location="cpu",
                       weights_only=True)
    params = dict(state.model.named_parameters())
    hot = {n for n, p in params.items() if p.requires_grad}
    if set(saved["hot"]) != hot:
        raise ValueError(f"checkpoint holds parameters {sorted(saved['hot'])[:4]}..., the "
                         f"state trains {sorted(hot)[:4]}... ({len(saved['hot'])} vs "
                         f"{len(hot)})")
    with torch.no_grad():
        for name, value in saved["hot"].items():
            params[name].copy_(value)
        for key in ("mu", "nu"):
            for name, value in saved["opt_state"][key].items():
                state.opt_state[key][name].copy_(value)
    state.opt_state["count"] = saved["opt_state"]["count"]
    state.step = saved["step"]
    return state


def latest_step(path: str) -> int | None:
    steps = []
    if os.path.isdir(path):
        for d in os.listdir(path):
            if d.startswith("step_"):
                try:
                    steps.append(int(d.split("_", 1)[1]))
                except ValueError:
                    pass
    return max(steps) if steps else None


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """bf16 goes out as its raw uint16 bits, which the writer stores as BF16."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def export_safetensors(path: str, state_dict: dict[str, torch.Tensor]) -> None:
    """Write a state dict (e.g. ``model.state_dict()``: names are its dotted paths) as
    one .safetensors file."""
    save_safetensors(path, {name: _to_numpy(t) for name, t in state_dict.items()})


def import_safetensors(path: str, template: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Read a flat .safetensors file back into the names, shapes, dtypes and devices of
    ``template``; a name, or a size, that the file lacks raises."""
    flat = load_safetensors(path, upcast_bf16=False)
    out = {}
    for name, ref in template.items():
        arr = np.array(flat[name])
        t = (torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
             if arr.dtype == np.uint16 else torch.from_numpy(arr))
        out[name] = t.to(device=ref.device, dtype=ref.dtype).reshape(ref.shape)
    return out


class AsyncCheckpointer:
    """Checkpoints that overlap the next steps: ``save`` snapshots the state to host memory
    and returns, one background thread writes the snapshots in order (``save``'s layout,
    which ``restore`` and ``latest_step`` read); ``wait`` blocks until every write is on
    disk and raises a failed write's error; ``close`` waits, then stops the thread."""

    def __init__(self):
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="checkpoint")
        self._pending: list[Future] = []

    def save(self, path: str, state, step: int) -> None:
        payload = _payload(state, copy=True)
        self._pending.append(self._pool.submit(_write, path, step, payload))

    def wait(self) -> None:
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._pool.shutdown(wait=True)
