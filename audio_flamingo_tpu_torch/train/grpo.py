"""GRPO (group-relative policy optimization), as ``audio_flamingo_tpu/train/grpo.py``.

Sample G rollouts of a prompt (``runtime/generate.generate`` with a ``torch.Generator``,
or a serving engine through ``make_engine_rollout``), score their decoded text with
reward functions, normalize the rewards within the group, and update the policy with the
PPO-style clipped token objective plus the k3 KL penalty against a frozen reference
policy; no value network.

The policy is an ``AF3Model`` and the optimizer the port's ``train_step.AdamW``, whose
hot names are those of the module it updates (the model, or ``model.lm`` with
``trainable="lm"``). The update runs in place on the policy's tensors, where JAX donates
its buffers to a jitted apply (``_donating_apply``). So an engine that holds the policy
module itself stays on-policy with no copy: the engines compute from the module's own
tensors on every call (no fused or K-major copy of an LM weight, no captured graph of
their steps; ``generate``'s captured steps read the tensors in place), and
``_sync_engine_policy`` only points an engine that holds another module of the same
layout at the policy, or raises for another layout (a quantized serving copy), as JAX
does.

As in JAX, an engine's prefix cache survives an update: pages that the old policy
computed for a prompt serve the next rollout of that prompt (ROADMAP.md, Queue 3).

The reference policy may share the policy's towers and hold its LM in int8 (bench.py's
``bench_grpo``); ``_token_logp`` runs either layout.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch

from audio_flamingo_tpu_torch.config import AF3Config
from audio_flamingo_tpu_torch.models import af3, qwen2
from audio_flamingo_tpu_torch.ops.remat import remat_wrap
from audio_flamingo_tpu_torch.ops.sampling import SamplingParams
from audio_flamingo_tpu_torch.runtime import generate as gen
from audio_flamingo_tpu_torch.train.train_step import _grads_on


@dataclass(frozen=True)
class GRPOConfig:
    group_size: int = 4
    clip_eps: float = 0.2
    kl_coef: float = 0.04
    temperature: float = 1.0
    top_k: int = 0
    max_new_tokens: int = 64


def _device(model) -> torch.device:
    return next(model.parameters()).device


def _as_device(x, device: torch.device) -> torch.Tensor | None:
    return None if x is None else torch.as_tensor(x, device=device)


def _tile_mels(mels, g: int, device: torch.device):
    """A prompt's mels [1, W, 3000, M] repeated for the G rows, or None."""
    m = _as_device(mels, device)
    return None if m is None else m.expand(g, *m.shape[1:]).contiguous()


def rollout(model: af3.AF3Model, cfg: AF3Config, token_ids, mels, gcfg: GRPOConfig,
            eos_token_id: int, generator: torch.Generator | None = None):
    """One prompt ([1, T] ids, mels or None) -> G sampled completions through ``generate``:
    (full ids [G, T + N], gen_mask [G, T + N] True over the generated tokens (EOS
    included), lengths [G]), on the model's device."""
    device = _device(model)
    g = gcfg.group_size
    ids = _as_device(token_ids, device).long()
    ids = ids.expand(g, ids.shape[1]).contiguous()
    sampling = SamplingParams(greedy=False, temperature=gcfg.temperature, top_k=gcfg.top_k)
    out = gen.generate(model, cfg, ids, _tile_mels(mels, g, device),
                       max_new_tokens=gcfg.max_new_tokens, eos_token_id=eos_token_id,
                       sampling=sampling, generator=generator)
    tokens, lengths = out.tokens.clone(), out.lengths.clone()   # leave inference mode
    t = ids.shape[1]
    full = torch.cat([ids, tokens], dim=1)
    step_idx = torch.arange(gcfg.max_new_tokens, device=device)[None]
    gen_mask = torch.cat([torch.zeros((g, t), dtype=torch.bool, device=device),
                          step_idx < lengths[:, None]], dim=1)
    return full, gen_mask, lengths


def make_engine_rollout(engine):
    """Rollouts through a serving engine (``runtime/paged_engine.PagedEngine`` or
    ``runtime/engine.BatchEngine``): the G samples of a prompt ride the engine as G
    requests batched together, each drawing from the engine's generator; with
    ``prefix_cache=True`` the shared prompt (and its encoder run) prefills once and the
    other rows reuse its pages. The callable has ``rollout``'s contract (without the
    generator) and carries the engine as ``.engine``, which ``grpo_step`` keeps on-policy."""
    from audio_flamingo_tpu_torch.runtime.engine import Request

    counter = itertools.count()

    def fn(token_ids, mels, gcfg: GRPOConfig, eos_token_id: int):
        g, n = gcfg.group_size, gcfg.max_new_tokens
        sampling = SamplingParams(greedy=False, temperature=gcfg.temperature,
                                  top_k=gcfg.top_k)
        ids_np = np.asarray(token_ids.cpu() if isinstance(token_ids, torch.Tensor)
                            else token_ids)
        rids = [f"grpo{next(counter)}" for _ in range(g)]
        for rid in rids:
            engine.submit(Request(request_id=rid, ids=ids_np, mels=mels, max_new_tokens=n,
                                  sampling=sampling))
        results = engine.run_until_done()
        t = ids_np.shape[1]
        full = np.concatenate([np.tile(ids_np, (g, 1)), np.full((g, n), eos_token_id)],
                              axis=1).astype(np.int64)
        gen_mask = np.zeros((g, t + n), bool)
        lengths = np.zeros((g,), np.int64)
        for i, rid in enumerate(rids):
            toks = results[rid][:n]
            full[i, t: t + len(toks)] = toks
            gen_mask[i, t: t + len(toks)] = True
            lengths[i] = len(toks)
        device = engine.device
        return (torch.from_numpy(full).to(device), torch.from_numpy(gen_mask).to(device),
                torch.from_numpy(lengths).to(device))

    fn.engine = engine
    return fn


def _layout(model) -> list:
    return [(n, tuple(t.shape), t.dtype) for n, t in model.state_dict().items()]


def _sync_engine_policy(rollout_fn, policy: af3.AF3Model) -> None:
    """Keep an engine-backed rollout sampling the current policy: an engine holding the
    policy module itself is on-policy already (the update runs in place); one holding
    another module of the same layout is pointed at the policy; another layout (an
    int8 serving copy of a float policy, say) cannot be kept on-policy here and raises.
    A plain callable (no ``.engine``) is left alone."""
    eng = getattr(rollout_fn, "engine", None)
    if eng is None or eng.model is policy:
        return
    if _layout(eng.model) != _layout(policy):
        raise ValueError(
            "make_engine_rollout: the engine's model has another layout than the policy "
            "(a quantized serving copy?), so grpo_step cannot keep it on-policy; "
            "re-quantize it after each update and pass a callable without an .engine "
            "attribute to opt out")
    eng.model = policy


def group_advantages(rewards: torch.Tensor) -> torch.Tensor:
    """[G] rewards -> (r - mean) / (std + 1e-4), with the population std (JAX's)."""
    return (rewards - rewards.mean()) / (rewards.std(correction=0) + 1e-4)


def _token_logp(model: af3.AF3Model, cfg: AF3Config, ids: torch.Tensor, mels,
                chunk: int = 256) -> torch.Tensor:
    """log p(token_t | tokens < t) for every t >= 1: [G, T - 1] f32. The unembed and the
    log-softmax run ``chunk`` positions at a time, each chunk recomputed in the backward
    (remat "full"), so no [G, T, vocab] logits tensor is held."""
    b, t = ids.shape
    x = af3.build_input_embeds(model, cfg, ids, mels)
    pos = torch.arange(t, device=ids.device)[None].expand(b, t)
    h = qwen2.forward(model.lm, cfg.lm, x, pos)[0]
    hs, tgt = h[:, :-1], ids[:, 1:].long()

    def body(hc, tc):
        logp = torch.log_softmax(qwen2.unembed(model.lm, hc).float(), dim=-1)
        return torch.gather(logp, -1, tc[..., None])[..., 0]

    body = remat_wrap(body, "full")
    return torch.cat([body(hs[:, c:c + chunk], tgt[:, c:c + chunk])
                      for c in range(0, t - 1, chunk)], dim=1)


def _loss_terms(model, ref_logp, cfg, ids, mels, gen_mask, advantages, old_logp,
                gcfg: GRPOConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """(``grpo_loss``, the ratio exp(logp - old_logp) [G, L - 1])."""
    logp = _token_logp(model, cfg, ids, mels)
    mask = gen_mask[:, 1:].float()
    ratio = torch.exp(logp - old_logp)
    adv = advantages[:, None]
    unclipped = ratio * adv
    clipped = torch.clamp(ratio, 1 - gcfg.clip_eps, 1 + gcfg.clip_eps) * adv
    pg = -torch.minimum(unclipped, clipped)
    # k3 KL estimator (unbiased, low variance): e^(ref - logp) - (ref - logp) - 1
    delta = ref_logp.detach() - logp
    kl = torch.exp(delta) - delta - 1.0
    per_tok = pg + gcfg.kl_coef * kl
    return (per_tok * mask).sum() / mask.sum().clamp(min=1.0), ratio.detach()


def grpo_loss(model: af3.AF3Model, ref_logp: torch.Tensor, cfg: AF3Config, ids: torch.Tensor,
              mels, gen_mask: torch.Tensor, advantages: torch.Tensor, old_logp: torch.Tensor,
              gcfg: GRPOConfig) -> torch.Tensor:
    """Clipped-ratio policy loss plus kl_coef x KL(pi || pi_ref), averaged over the
    generated tokens. ids [G, L]; gen_mask [G, L]; advantages [G]; old_logp and ref_logp
    [G, L - 1]: the behaviour policy's and the frozen reference's token logprobs
    (``_token_logp``), which carry no gradient."""
    return _loss_terms(model, ref_logp, cfg, ids, mels, gen_mask, advantages, old_logp,
                       gcfg)[0]


def grpo_step(model: af3.AF3Model, ref_model: af3.AF3Model, opt, opt_state: dict,
              cfg: AF3Config, prompts: Sequence[dict], reward_fn: Callable[[str], float],
              gcfg: GRPOConfig, eos_token_id: int, generator: torch.Generator | None,
              decode_fn: Callable[[list], str], rollout_fn=None, trainable: str | None = None,
              offload_pool: bool = False):
    """One GRPO update over prompts ({'ids': [1, T], 'mels': [1, W, 3000, M] or None}),
    in place on the policy ``model``; returns (model, opt_state, {'loss', 'mean_reward'}).

    ``opt``: a ``train_step.AdamW`` over the module that trains (``model``, or ``model.lm``
    with ``trainable="lm"``, the Music Flamingo GRPO stage: the encoder and adaptor
    frozen, their backward never taken). ``rollout_fn``: a ``make_engine_rollout``
    callable (else ``rollout`` on ``generate`` with ``generator``). ``offload_pool``: the
    rollouts all run first, then the engine's page pool waits in host memory while the
    update runs, and comes back after it."""
    if rollout_fn is not None:
        _sync_engine_policy(rollout_fn, model)
    rollouts = []
    for prompt in prompts:
        if rollout_fn is not None:
            full, gen_mask, lengths = rollout_fn(prompt["ids"], prompt.get("mels"), gcfg,
                                                 eos_token_id)
        else:
            full, gen_mask, lengths = rollout(model, cfg, prompt["ids"], prompt.get("mels"),
                                              gcfg, eos_token_id, generator)
        rollouts.append((prompt, full, gen_mask, lengths))

    eng = getattr(rollout_fn, "engine", None)
    swapped = offload_pool and eng is not None and hasattr(eng, "offload_pool")
    if swapped:
        eng.offload_pool()
    try:
        metrics = _grpo_update(model, ref_model, opt, opt_state, cfg, rollouts, reward_fn,
                               gcfg, decode_fn, trainable)
    finally:
        if swapped:
            eng.restore_pool()
    if rollout_fn is not None:
        _sync_engine_policy(rollout_fn, model)
    return model, opt_state, metrics


def _grpo_update(model, ref_model, opt, opt_state, cfg, rollouts, reward_fn, gcfg,
                 decode_fn, trainable) -> dict:
    """Rewards -> advantages -> the clipped objective's gradients -> AdamW, in place."""
    module = model.lm if trainable == "lm" else model
    params = dict(module.named_parameters())
    wrt = [params[n] for n in opt.hot]
    device = _device(model)
    all_grads = None
    total_loss, total_reward = 0.0, 0.0
    for prompt, full, gen_mask, lengths in rollouts:
        t = np.shape(prompt["ids"])[1]
        full_np, lengths_np = full.cpu().numpy(), lengths.cpu().numpy()
        texts = [decode_fn(full_np[i, t: t + int(lengths_np[i])].tolist())
                 for i in range(gcfg.group_size)]
        rewards = torch.tensor([reward_fn(txt) for txt in texts], dtype=torch.float32,
                               device=device)
        adv = group_advantages(rewards)
        mels_t = _tile_mels(prompt.get("mels"), gcfg.group_size, device)
        with torch.no_grad():
            old_logp = _token_logp(model, cfg, full, mels_t)
            ref_logp = _token_logp(ref_model, cfg, full, mels_t)
        with _grads_on([p for p in wrt if not p.requires_grad]):
            loss = grpo_loss(model, ref_logp, cfg, full, mels_t, gen_mask, adv, old_logp, gcfg)
            grads = torch.autograd.grad(loss, wrt)
        all_grads = (list(grads) if all_grads is None
                     else [a + g for a, g in zip(all_grads, grads)])
        total_loss += float(loss.detach())
        total_reward += float(rewards.mean())
    n = len(rollouts)
    opt.update({name: g / n for name, g in zip(opt.hot, all_grads)}, opt_state, module)
    return {"loss": total_loss / n, "mean_reward": total_reward / n}


# ------------------------------------------------------------------ example rewards

def format_reward(think_open: str = "<think>", think_close: str = "</think>"):
    """Music Flamingo's format reward: a thinking block present and well-formed."""

    def fn(text: str) -> float:
        has_open = think_open in text
        has_close = think_close in text
        ordered = has_open and has_close and text.index(think_open) < text.index(think_close)
        return 1.0 if ordered else (0.25 if (has_open or has_close) else 0.0)

    return fn


def exact_match_reward(answer: str):
    """Correctness reward: 1 if the expected answer appears after the thinking block."""

    def fn(text: str) -> float:
        tail = text.split("</think>")[-1] if "</think>" in text else text
        return 1.0 if answer.strip().lower() in tail.strip().lower() else 0.0

    return fn
