"""Text-generation metrics: BLEU-4 and ROUGE-1/2/L over whitespace tokens
(the text half of llamole_tpu/train/metric.py, which cannot be imported
here: llamole_tpu.train loads JAX)."""

import math
from collections import Counter
from typing import Dict, List, Sequence

import numpy as np


def _ngrams(tokens: Sequence, n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def bleu4(candidate: Sequence, reference: Sequence,
          smooth: bool = True) -> float:
    """Sentence BLEU-4, zero-overlap orders smoothed to 1 / 2^n."""
    if not candidate or not reference:
        return 0.0
    log_precisions = []
    for n in range(1, 5):
        cand = _ngrams(candidate, n)
        ref = _ngrams(reference, n)
        overlap = sum(min(c, ref[g]) for g, c in cand.items())
        total = max(sum(cand.values()), 1)
        if overlap == 0:
            if not smooth:
                return 0.0
            overlap = 1.0 / (2 ** n)
        log_precisions.append(math.log(overlap / total))
    bp = 1.0
    if len(candidate) < len(reference):
        bp = math.exp(1 - len(reference) / max(len(candidate), 1))
    return bp * math.exp(sum(log_precisions) / 4)


def _lcs_len(a: Sequence, b: Sequence) -> int:
    dp = [0] * (len(b) + 1)
    for x in a:
        prev = 0
        for j, y in enumerate(b, 1):
            cur = dp[j]
            dp[j] = prev + 1 if x == y else max(dp[j], dp[j - 1])
            prev = cur
    return dp[-1]


def rouge_n(candidate: Sequence, reference: Sequence, n: int) -> float:
    """ROUGE-N F1."""
    if len(candidate) < n or len(reference) < n:
        return 0.0
    cand = _ngrams(candidate, n)
    ref = _ngrams(reference, n)
    overlap = sum(min(c, ref[g]) for g, c in cand.items())
    p = overlap / max(sum(cand.values()), 1)
    r = overlap / max(sum(ref.values()), 1)
    return 0.0 if p + r == 0 else 2 * p * r / (p + r)


def rouge_l(candidate: Sequence, reference: Sequence) -> float:
    """ROUGE-L F1."""
    if not candidate or not reference:
        return 0.0
    lcs = _lcs_len(candidate, reference)
    p = lcs / len(candidate)
    r = lcs / len(reference)
    return 0.0 if p + r == 0 else 2 * p * r / (p + r)


def compute_text_metrics(predictions: List[str],
                         references: List[str]) -> Dict[str, float]:
    """Corpus-averaged BLEU-4 / ROUGE (x 100)."""
    scores = {"bleu-4": [], "rouge-1": [], "rouge-2": [], "rouge-l": []}
    for pred, ref in zip(predictions, references):
        p, r = pred.split(), ref.split()
        scores["bleu-4"].append(bleu4(p, r))
        scores["rouge-1"].append(rouge_n(p, r, 1))
        scores["rouge-2"].append(rouge_n(p, r, 2))
        scores["rouge-l"].append(rouge_l(p, r))
    return {k: float(np.mean(v)) * 100 if v else 0.0
            for k, v in scores.items()}
