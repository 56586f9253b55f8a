"""Checkpoints of the training state and safetensors export/import, as
``audio_flamingo_tpu/train/checkpoints.py`` (whose orbax is JAX's and is not used here).

A checkpoint is ``<path>/step_<n>/train_state.pt``, written by ``torch.save``: the hot
parameters (by state-dict name), the optimizer state and the step. Frozen weights are not
written: they are the ones the run started from, so ``restore`` loads into a state built
on the same starting model, as the JAX ``restore`` fills a template.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from audio_flamingo_tpu_torch.io.safetensors import load_safetensors, save_safetensors

STATE_FILE = "train_state.pt"


def _step_dir(path: str, step: int | None) -> str:
    return os.path.join(os.path.abspath(path), f"step_{step}" if step is not None else "latest")


def save(path: str, state, step: int | None = None) -> None:
    """Write a TrainState's hot parameters, optimizer state and step (atomically: a
    temporary file renamed into place)."""
    params = dict(state.model.named_parameters())
    hot = {n: p.detach() for n, p in params.items() if p.requires_grad}
    out_dir = _step_dir(path, step)
    os.makedirs(out_dir, exist_ok=True)
    target = os.path.join(out_dir, STATE_FILE)
    tmp = f"{target}.tmp{os.getpid()}"
    torch.save({"hot": hot, "opt_state": state.opt_state, "step": state.step}, tmp)
    os.replace(tmp, target)


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
