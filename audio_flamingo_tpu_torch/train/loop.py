"""Training loop: the stage's optimizer, one train step per batch of the mixture, metrics
and checkpoint/resume, as ``audio_flamingo_tpu/train/loop.py``.

As in JAX, a resumed run restores the training state from the latest checkpoint and
draws its batches from the sampler as it is handed in (the sampler's position is not
checkpointed).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from audio_flamingo_tpu_torch.config import NOT_PORTED, AF3Config
from audio_flamingo_tpu_torch.device import resolve_device
from audio_flamingo_tpu_torch.models import af3
from audio_flamingo_tpu_torch.train import checkpoints
from audio_flamingo_tpu_torch.train.data import BatchBuilder, MixtureSampler, batches
from audio_flamingo_tpu_torch.train.stages import AF3_STAGES, Stage
from audio_flamingo_tpu_torch.train.train_step import TrainState, init_state, train_step
from audio_flamingo_tpu_torch.utils.metrics import MetricsLogger


@dataclass
class TrainRunConfig:
    """The JAX run config's fields, plus the schedule's warmup and the chunked CE."""

    stage: str = "1_pretrain"
    batch_size: int = 2
    num_steps: int = 100
    log_every: int = 10
    ckpt_every: int = 500
    ckpt_dir: str | None = None
    compute_dtype: torch.dtype | None = None   # None: the hot weights' dtype
    warmup_steps: int = 100
    ce_chunk: int = 0


def run(cfg: AF3Config, model: af3.AF3Model, sampler: MixtureSampler, builder: BatchBuilder,
        run_cfg: TrainRunConfig, mesh=None, metrics: MetricsLogger | None = None,
        device: torch.device | str | None = None) -> tuple[TrainState, MetricsLogger]:
    """Train ``model`` in place for num_steps on ``device`` (None: CUDA, raising without a
    card; pass "cpu" to run there); returns (final TrainState, metrics). Each logged
    record holds step, loss, grad_norm and s_per_step (wall seconds per step since the
    start or the resume, to the logged step's loss on the host)."""
    if mesh is not None:
        raise NotImplementedError(NOT_PORTED.format("a device mesh", "9, parallelism"))
    device = resolve_device(device)
    model = model.to(device)
    stage: Stage = AF3_STAGES[run_cfg.stage]
    state, opt = init_state(model, stage, warmup_steps=run_cfg.warmup_steps,
                            total_steps=run_cfg.num_steps)
    metrics = metrics or MetricsLogger()

    start = 0
    if run_cfg.ckpt_dir:
        last = checkpoints.latest_step(run_cfg.ckpt_dir)
        if last is not None:
            state = checkpoints.restore(run_cfg.ckpt_dir, state, step=last)
            start = last

    it = batches(sampler, builder, run_cfg.batch_size)
    t0 = time.perf_counter()
    for i, batch in zip(range(start, run_cfg.num_steps), it):
        state, m = train_step(state, batch, cfg=cfg, opt=opt,
                              compute_dtype=run_cfg.compute_dtype, ce_chunk=run_cfg.ce_chunk)
        if (i + 1) % run_cfg.log_every == 0 or i + 1 == run_cfg.num_steps:
            loss = float(m["loss"])
            gn = float(m["grad_norm"])
            dt = (time.perf_counter() - t0) / max(1, (i + 1 - start))
            metrics.log(step=i + 1, loss=loss, grad_norm=gn, s_per_step=dt)
        if run_cfg.ckpt_dir and (i + 1) % run_cfg.ckpt_every == 0:
            checkpoints.save(run_cfg.ckpt_dir, state, step=i + 1)
    if run_cfg.ckpt_dir:
        checkpoints.save(run_cfg.ckpt_dir, state, step=run_cfg.num_steps)
    return state, metrics
