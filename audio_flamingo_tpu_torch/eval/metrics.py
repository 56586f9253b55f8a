"""Eval metrics: WER, MCQ and containment accuracy, CIDEr-D, as
``audio_flamingo_tpu/eval/metrics.py`` (the port keeps its own pure-Python copy).

They back the benchmark suites the reference reports (LibriSpeech WER, MMAU accuracy,
Clotho CIDEr, ...); the metrics themselves are standard.
"""

from __future__ import annotations

import math
import re
from collections import Counter, defaultdict


def normalize_text(s: str) -> str:
    """Basic ASR normalization: lowercase, strip punctuation, collapse whitespace."""
    s = s.lower()
    s = re.sub(r"[^\w\s']", " ", s)
    s = re.sub(r"\s+", " ", s)
    return s.strip()


def wer(reference: str, hypothesis: str, normalize: bool = True) -> float:
    """Word error rate via Levenshtein distance over words."""
    if normalize:
        reference, hypothesis = normalize_text(reference), normalize_text(hypothesis)
    ref = reference.split()
    hyp = hypothesis.split()
    if not ref:
        return 0.0 if not hyp else 1.0
    prev = list(range(len(hyp) + 1))
    for i, rw in enumerate(ref, 1):
        cur = [i] + [0] * len(hyp)
        for j, hw in enumerate(hyp, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (rw != hw))
        prev = cur
    return prev[-1] / len(ref)


def corpus_wer(refs: list[str], hyps: list[str]) -> float:
    """Length-weighted corpus WER (errors summed over all references)."""
    total_err, total_words = 0.0, 0
    for r, h in zip(refs, hyps):
        rn = normalize_text(r)
        n = max(len(rn.split()), 1)
        total_err += wer(r, h) * n
        total_words += n
    return total_err / max(total_words, 1)


_CHOICE_RE = re.compile(r"\b([A-E])\b|\(([A-E])\)", re.IGNORECASE)


def extract_choice(text: str) -> str | None:
    """Pull an MCQ letter out of a free-form answer (last occurrence wins)."""
    matches = _CHOICE_RE.findall(strip_think(text))
    if not matches:
        return None
    last = matches[-1]
    return (last[0] or last[1]).upper()


def mcq_accuracy(targets: list[str], answers: list[str]) -> float:
    correct = sum(1 for t, a in zip(targets, answers)
                  if extract_choice(a) == t.strip().upper())
    return correct / max(len(targets), 1)


def containment_accuracy(targets: list[str], answers: list[str]) -> float:
    """Counts an answer correct if the normalized target appears in it."""
    hits = sum(1 for t, a in zip(targets, answers)
               if normalize_text(t) in normalize_text(strip_think(a)))
    return hits / max(len(targets), 1)


def strip_think(text: str, close: str = "</think>") -> str:
    """Drop the chain-of-thought block (AF3 '+Think' / MF reasoning output)."""
    return text.split(close)[-1].strip() if close in text else text


# ----------------------------------------------------------------------------- CIDEr-D

def _ngrams(words: list[str], n: int) -> Counter:
    return Counter(tuple(words[i: i + n]) for i in range(len(words) - n + 1))


def cider_d(references: list[list[str]], candidates: list[str], n_max: int = 4,
            sigma: float = 6.0) -> float:
    """CIDEr-D over a corpus: candidates[i] scored against references[i] (multi-ref)."""
    refs_tok = [[normalize_text(r).split() for r in rs] for rs in references]
    cands_tok = [normalize_text(c).split() for c in candidates]

    # document frequency over reference sets
    df = [defaultdict(float) for _ in range(n_max)]
    for rs in refs_tok:
        for n in range(n_max):
            seen = set()
            for r in rs:
                seen |= set(_ngrams(r, n + 1).keys())
            for g in seen:
                df[n][g] += 1.0
    log_n_docs = math.log(max(len(refs_tok), 1))

    def tfidf(counts: Counter, n: int):
        vec = {}
        norm = 0.0
        for g, c in counts.items():
            idf = log_n_docs - math.log(max(df[n][g], 1.0))
            v = c * idf
            vec[g] = v
            norm += v * v
        return vec, math.sqrt(norm)

    scores = []
    for rs, cand in zip(refs_tok, cands_tok):
        score_n = []
        for n in range(n_max):
            cv, cn = tfidf(_ngrams(cand, n + 1), n)
            acc = 0.0
            for r in rs:
                rv, rn_ = tfidf(_ngrams(r, n + 1), n)
                num = sum(min(cv.get(g, 0.0), v) * v for g, v in rv.items()
                          if g in cv) if cv else 0.0
                # CIDEr-D clips candidate counts and applies a length penalty
                delta = len(cand) - len(r)
                penalty = math.exp(-(delta ** 2) / (2 * sigma ** 2))
                denom = cn * rn_
                acc += penalty * (num / denom if denom > 0 else 0.0)
            score_n.append(acc / max(len(rs), 1))
        scores.append(10.0 * sum(score_n) / n_max)
    return sum(scores) / max(len(scores), 1)
