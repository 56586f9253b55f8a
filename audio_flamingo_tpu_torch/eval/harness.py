"""Evaluation harness: run a model over task examples and score them, as
``audio_flamingo_tpu/eval/harness.py``.

One harness dispatches on the task type: asr (WER), mcq (choice accuracy), qa
(containment), caption (CIDEr-D). ``evaluate`` runs ``AudioFlamingo.generate`` greedily,
an example at a time; ``evaluate_batched`` runs every example through the slot engine
(``runtime/engine.BatchEngine``) at once. Both score with ``_score``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Iterable

import numpy as np

from audio_flamingo_tpu_torch.eval import metrics as M
from audio_flamingo_tpu_torch.ops.sampling import SamplingParams
from audio_flamingo_tpu_torch.utils.metrics import MetricsLogger, RequestTimer


@dataclass
class EvalExample:
    audio: np.ndarray | None          # mono 16 kHz f32
    prompt: str
    target: str | list[str]           # list for multi-reference captioning
    task: str = "qa"                  # asr | mcq | qa | caption


@dataclass
class EvalResult:
    task_scores: dict
    per_example: list[dict] = field(default_factory=list)
    serving: dict = field(default_factory=dict)


def evaluate_batched(model, examples: list[EvalExample], *, max_new_tokens: int = 128,
                     think: bool = False, num_slots: int = 8, capacity: int = 2048,
                     chunk: int = 16) -> EvalResult:
    """Throughput evaluation through the slot engine (greedy), on the model's device.

    Same prompts and scoring as ``evaluate``, but all examples run concurrently across
    the engine's slots: the path for sweeping MMAU- or LibriSpeech-scale sets."""
    from audio_flamingo_tpu_torch.runtime.engine import BatchEngine, Request
    from audio_flamingo_tpu_torch.runtime.processor import AUDIO_TOKEN

    engine = BatchEngine(model=model.model, cfg=model.cfg, num_slots=num_slots,
                         capacity=capacity, chunk=chunk, eos_token_id=model.eos_token_id,
                         sampling=SamplingParams(greedy=True), device=model.device)
    examples = list(examples)
    t0 = time.perf_counter()
    for i, ex in enumerate(examples):
        text = ex.prompt
        audios = None
        if ex.audio is not None:
            audios = [ex.audio]
            if AUDIO_TOKEN not in text:
                text = f"{AUDIO_TOKEN}{text}"
        if think:
            text = f"{text}\n{model.THINK_INSTRUCTION}"
        batch = model.processor(messages=[{"role": "user", "content": text}],
                                audios=audios)
        engine.submit(Request(request_id=str(i), ids=batch["ids"], mels=batch["mels"],
                              max_new_tokens=max_new_tokens))
    results = engine.run_until_done()
    total_s = time.perf_counter() - t0

    by_task: dict[str, list[tuple]] = {}
    per_example = []
    for i, ex in enumerate(examples):
        answer = model.processor.tokenizer.decode(results[str(i)], skip_special=True)
        by_task.setdefault(ex.task, []).append((ex.target, answer))
        per_example.append({"prompt": ex.prompt, "answer": answer, "target": ex.target,
                            "task": ex.task})
    return EvalResult(task_scores=_score(by_task), per_example=per_example,
                      serving={"total_s": total_s, "n_examples": len(examples),
                               "examples_per_s": len(examples) / max(total_s, 1e-9)})


def _score(by_task: dict) -> dict:
    """{task: [(target, answer), ...]} -> {metric name: corpus score}."""
    scores: dict = {}
    for task, pairs in by_task.items():
        targets = [t for t, _ in pairs]
        answers = [a for _, a in pairs]
        if task == "asr":
            scores["asr_wer"] = M.corpus_wer([t if isinstance(t, str) else t[0]
                                              for t in targets],
                                             [M.strip_think(a) for a in answers])
        elif task == "mcq":
            scores["mcq_acc"] = M.mcq_accuracy(targets, answers)
        elif task == "caption":
            refs = [[t] if isinstance(t, str) else list(t) for t in targets]
            scores["caption_cider_d"] = M.cider_d(refs, [M.strip_think(a) for a in answers])
        else:
            scores["qa_acc"] = M.containment_accuracy(
                [t if isinstance(t, str) else t[0] for t in targets], answers)
    return scores


def evaluate(model, examples: Iterable[EvalExample], *, max_new_tokens: int = 128,
             think: bool = False, logger: MetricsLogger | None = None) -> EvalResult:
    """model: api.AudioFlamingo (or anything with .generate(sound, prompt, ...)), run
    greedily an example at a time."""
    by_task: dict[str, list[tuple]] = {}
    per_example = []
    timers = []
    for ex in examples:
        timer = RequestTimer(audio_seconds=(len(ex.audio) / 16_000 if ex.audio is not None
                                            else 0.0))
        answer = model.generate(sound=ex.audio, prompt=ex.prompt,
                                max_new_tokens=max_new_tokens,
                                sampling=SamplingParams(greedy=True), think=think)
        timer.token()
        stats = timer.finish()
        timers.append(stats)
        by_task.setdefault(ex.task, []).append((ex.target, answer))
        per_example.append({"prompt": ex.prompt, "answer": answer, "target": ex.target,
                            "task": ex.task})
        if logger:
            logger.log(task=ex.task, total_s=stats["total_s"])

    total_s = [t["total_s"] for t in timers if t["total_s"]]
    serving = {"p50_total_s": float(np.median(total_s)) if total_s else None,
               "n_examples": len(per_example)}
    return EvalResult(task_scores=_score(by_task), per_example=per_example, serving=serving)
