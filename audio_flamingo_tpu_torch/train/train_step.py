"""Training step: stage freeze masks, a hand-written AdamW in optax's order, gradient
accumulation and the chunked CE, as ``audio_flamingo_tpu/train/train_step.py``.

The parameters live in the model; the hot ones (the stage's mask) require grad and
carry optimizer state, the frozen ones do not. ``train_step`` updates the model's hot
parameters and the optimizer state in place (no second copy of either) and returns the
state with its step advanced. The step computes in the hot weights' dtype.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import numpy as np
import torch

from audio_flamingo_tpu_torch.config import NOT_PORTED, AF3Config
from audio_flamingo_tpu_torch.models import af3, qwen2, whisper_encoder
from audio_flamingo_tpu_torch.ops import lora
from audio_flamingo_tpu_torch.train.stages import Stage, trainable_mask


@dataclass
class TrainState:
    """The model (its hot parameters are the trained state), the optimizer state
    ({'count', 'mu', 'nu'}, moments keyed by parameter name) and the step."""

    model: af3.AF3Model
    opt_state: dict
    step: int


@dataclass(frozen=True)
class AdamW:
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(schedule, b1, b2, eps,
    weight_decay))`` over the parameters named in ``hot``, with JAX's
    ``warmup_cosine_decay_schedule(0, lr, warmup_steps, max(total_steps, warmup_steps + 1),
    lr * 0.1)``. Moments are kept in each parameter's dtype, as optax keeps them."""

    hot: tuple[str, ...]
    lr: float
    warmup_steps: int
    total_steps: int
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    B1, B2, EPS = 0.9, 0.95, 1e-8        # fixed, as in JAX's make_optimizer

    def learning_rate(self, count: int) -> float:
        """The schedule at ``count`` in f32, as optax evaluates it: linear from 0 over
        the warmup, then cosine decay to lr * 0.1 by ``total_steps``."""
        f32 = np.float32
        warm = self.warmup_steps
        if count < warm:
            c = f32(min(max(count, 0), warm))
            frac = f32(1) - c / f32(warm)
            return float(f32(0.0 - self.lr) * frac + f32(self.lr))
        decay = max(self.total_steps, warm + 1) - warm
        alpha = (self.lr * 0.1) / self.lr
        c = f32(min(count - warm, decay))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(decay)))
        return float(f32(self.lr) * (f32(1 - alpha) * cosine + f32(alpha)))

    def init(self, model: torch.nn.Module) -> dict:
        params = dict(model.named_parameters())
        return {"count": 0,
                "mu": {n: torch.zeros_like(params[n]) for n in self.hot},
                "nu": {n: torch.zeros_like(params[n]) for n in self.hot}}

    @torch.no_grad()
    def update(self, grads: dict, opt_state: dict, model: torch.nn.Module) -> None:
        """Clip, AdamW and apply, in place on the hot parameters and the state. Only the hot
        gradients enter the clip's norm (optax's ``multi_transform`` masks the frozen
        leaves); any other entry of ``grads`` is ignored."""
        params = dict(model.named_parameters())
        g_norm = global_norm(grads[name] for name in self.hot)
        clip = g_norm < self.grad_clip
        count = opt_state["count"] + 1
        bc1 = float(1 - np.power(np.float32(self.B1), np.float32(count)))
        bc2 = float(1 - np.power(np.float32(self.B2), np.float32(count)))
        step_size = -self.learning_rate(opt_state["count"])
        for name in self.hot:
            p, g = params[name], grads[name]
            g = torch.where(clip, g, g / g_norm.to(g.dtype) * self.grad_clip)
            mu = opt_state["mu"][name]
            nu = opt_state["nu"][name]
            mu.copy_((1 - self.B1) * g + self.B1 * mu)
            nu.copy_((1 - self.B2) * g.square() + self.B2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.EPS)
            u = u + self.weight_decay * p
            p.add_(step_size * u)
        opt_state["count"] = count


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors, in f32 (optax.global_norm)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def make_optimizer(stage: Stage, model: torch.nn.Module, *, weight_decay: float = 0.01,
                   warmup_steps: int = 100, total_steps: int = 10_000,
                   grad_clip: float = 1.0, lora_only: bool = False) -> AdamW:
    """Set each parameter's requires_grad from the stage's mask and build the optimizer
    over the hot ones, named as ``model`` names them (an AF3Model, or a part of one such as
    its LM, which then trains whole, as JAX's mask trains a subtree). ``lora_only``: the
    mask is AND-ed with ``ops/lora.lora_mask``, so only the LoRA adapters train (JAX
    :36-42); over a quantized LM that is QLoRA, the base codes getting no gradient and no
    optimizer state. A stage that trains a quantized LM without ``lora_only`` raises, as
    does one that trains an int8 encoder."""
    if (stage.train_lm and isinstance(getattr(model, "lm", model), qwen2.QuantQwen2)
            and not lora_only):
        raise NotImplementedError(
            f"stage {stage.name!r} trains the LM, whose weights are quantized codes, which "
            "cannot train: give the LM LoRA adapters (models/lora.add_lora) and pass "
            "lora_only=True (QLoRA), or train a float LM")
    if (stage.train_encoder and not lora_only
            and isinstance(getattr(model, "encoder", None),
                           whisper_encoder.QuantWhisperEncoder)):
        raise ValueError(f"stage {stage.name!r} trains the encoder, whose layers are int8 "
                         "codes (a8_encoder); train the float encoder")
    mask = trainable_mask(model, stage)
    if lora_only:
        mask = {name: hot and lora.is_lora(name) for name, hot in mask.items()}
        if not any(mask.values()):
            raise ValueError(f"lora_only: stage {stage.name!r} leaves no LoRA adapter hot "
                             "(add_lora first, on a part the stage trains)")
    hot = []
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
        if mask[name]:
            hot.append(name)
    return AdamW(tuple(hot), stage.lr, warmup_steps, max(total_steps, warmup_steps + 1),
                 weight_decay=weight_decay, grad_clip=grad_clip)


def init_state(model: af3.AF3Model, stage: Stage, **opt_kwargs) -> tuple[TrainState, AdamW]:
    opt = make_optimizer(stage, model, **opt_kwargs)
    return TrainState(model, opt.init(model), 0), opt


def _hot_dtype(model: af3.AF3Model, opt: AdamW) -> torch.dtype:
    """The dtype a step computes in: the hot weights', or, with only LoRA adapters hot
    (f32 beside a base in any dtype), the LM's."""
    if opt.hot and all(lora.is_lora(n) for n in opt.hot):
        lm = model.lm
        return lm.dtype if isinstance(lm, qwen2.QuantQwen2) else lm.norm.weight.dtype
    params = dict(model.named_parameters())
    dtypes = {params[n].dtype for n in opt.hot}
    if len(dtypes) != 1:
        raise ValueError(f"hot parameters in several dtypes: {dtypes}")
    return dtypes.pop()


def _differentiated(model: af3.AF3Model, opt: AdamW) -> tuple[str, ...]:
    """The parameters whose gradients a step takes: every parameter when all of the
    model's tensors are float, as JAX's ``value_and_grad`` takes them all; else (a
    quantized LM or encoder, whose int8 leaves JAX cannot differentiate) the hot ones."""
    if all(t.is_floating_point() for t in model.state_dict().values()):
        return tuple(name for name, _ in model.named_parameters())
    return opt.hot


def loss_and_grads(model: af3.AF3Model, batch: dict, *, cfg: AF3Config, opt: AdamW,
                   accum_steps: int = 1, ce_chunk: int = 0) -> tuple[torch.Tensor, dict]:
    """(mean loss, {name: gradient in the parameter's dtype}) of one batch, as
    ``train_step`` takes them; see there for the batch and ``accum_steps``. The gradients
    are the hot parameters' and, on an all-float model, the frozen ones' too (for the
    norm only)."""
    device = next(model.parameters()).device
    ids = torch.as_tensor(batch["ids"], device=device).long()
    labels = torch.as_tensor(batch["labels"], device=device).long()
    mels = batch.get("mels")
    if mels is not None:
        mels = torch.as_tensor(mels, device=device)
    params = dict(model.named_parameters())
    names = _differentiated(model, opt)
    wrt = [params[n] for n in names]
    with _grads_on([p for p in wrt if not p.requires_grad]):
        if accum_steps == 1:
            s, c = af3.loss_terms(model, cfg, ids, labels, mels, ce_chunk=ce_chunk)
            loss = s / c.clamp(min=1)
            grads = torch.autograd.grad(loss, wrt)
        else:
            b = ids.shape[0]
            if b % accum_steps:
                raise ValueError(f"batch {b} is not a multiple of accum_steps {accum_steps}")
            m = b // accum_steps
            gsum = [torch.zeros_like(p, dtype=torch.float32) for p in wrt]
            ssum = torch.zeros((), dtype=torch.float32, device=device)
            csum = torch.zeros((), dtype=torch.long, device=device)
            for i in range(accum_steps):
                rows = slice(i * m, (i + 1) * m)
                s, c = af3.loss_terms(model, cfg, ids[rows], labels[rows],
                                      None if mels is None else mels[rows], ce_chunk=ce_chunk)
                for acc, g in zip(gsum, torch.autograd.grad(s, wrt)):
                    acc.add_(g.float())
                ssum = ssum + s.detach()
                csum = csum + c
            denom = csum.clamp(min=1).float()
            grads = tuple((g / denom).to(p.dtype) for g, p in zip(gsum, wrt))
            loss = ssum / denom
    return loss.detach(), dict(zip(names, grads))


@contextlib.contextmanager
def _grads_on(frozen: list):
    """Let autograd reach the frozen parameters for the length of one step."""
    for p in frozen:
        p.requires_grad_(True)
    try:
        yield
    finally:
        for p in frozen:
            p.requires_grad_(False)


def train_step(state: TrainState, batch: dict, *, cfg: AF3Config, opt: AdamW,
               compute_dtype: torch.dtype | None = None, sp_mesh=None,
               accum_steps: int = 1, ce_chunk: int = 0) -> tuple[TrainState, dict]:
    """One step on batch {'ids': [B, T], 'labels': [B, T], 'mels': [B, W, 3000, M] or
    None} (tensors, moved to the model's device if they lie elsewhere). Returns the
    state and {'loss', 'grad_norm'} as device tensors. grad_norm is the norm of the
    unclipped gradients of every parameter, frozen ones included, as JAX reports it, when
    all of the model's tensors are float (the frozen gradients are taken for the norm
    only: they get no optimizer state, and the clip uses the hot part's norm, as optax's
    ``multi_transform`` does). With a quantized LM or encoder it is the hot parameters'
    norm: JAX's ``value_and_grad`` cannot differentiate int8 leaves, so it has no number
    to match there.

    accum_steps > 1 splits the batch into that many microbatches: each one's summed NLL
    is differentiated on its own, the gradients add up in f32, and the sum is divided by
    the batch's total valid-token count, so the result is the full batch's loss and
    gradient (JAX train_step.py:96-118). ce_chunk: af3.loss_terms. The step computes in
    the hot weights' dtype; another ``compute_dtype`` raises, as does ``sp_mesh``."""
    if sp_mesh is not None:
        raise NotImplementedError(NOT_PORTED.format("sequence parallelism (sp_mesh)",
                                                    "9, parallelism"))
    dtype = _hot_dtype(state.model, opt)
    if compute_dtype is not None and compute_dtype != dtype:
        raise NotImplementedError(
            f"compute_dtype {compute_dtype} differs from the hot weights' {dtype}: the "
            "port computes in the weights' dtype (cast the model instead)")
    loss, grads = loss_and_grads(state.model, batch, cfg=cfg, opt=opt,
                                 accum_steps=accum_steps, ce_chunk=ce_chunk)
    metrics = {"loss": loss, "grad_norm": global_norm(grads.values())}
    opt.update(grads, state.opt_state, state.model)
    state.step += 1
    return state, metrics
