"""Activation recompute (gradient checkpointing) of per-layer forwards, as
``audio_flamingo_tpu/ops/remat.py``, on ``torch.utils.checkpoint`` (non-reentrant).

Policies:
  "none": save everything the backward needs (fastest backward, most memory);
  "dots": save the outputs of the matrix products (``aten.mm``, ``aten.addmm``) and
          recompute everything else in the backward, the flash kernel included, as JAX's
          ``dots_with_no_batch_dims_saveable`` keeps the dots without batch dims;
  "full": save only the layer's inputs and recompute the whole layer in the backward.

Recompute changes memory, not the result: the layer runs the same ops on the same
inputs again. Without grad mode (inference) a wrapped layer runs as it is.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

REMAT_POLICIES = ("none", "dots", "full")
_SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_BY_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_wrap(fn, remat: str):
    """Wrap a per-layer function under the named policy; a bad name raises."""
    if remat not in REMAT_POLICIES:
        raise ValueError(f"remat must be one of {REMAT_POLICIES}, got {remat!r}")
    if remat == "none":
        return fn
    extra = ({} if remat == "full" else dict(context_fn=functools.partial(
        create_selective_checkpoint_contexts, _dots_policy)))

    @functools.wraps(fn)
    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, **extra)
    return wrapped
