"""Corpus BLEU over token-id sequences (a copy of the JAX package's
jax-free ``metrics/bleu.py``, kept here so the port never imports that
package).

The reference's Sockeye NMT workload was judged by BLEU on decoded outputs
(SURVEY.md §3.1; BASELINE.md tracking row 6) — Sockeye shipped its own
``sockeye.evaluate`` corpus BLEU. This is the standard Papineni et al.
formulation: modified (clipped) n-gram precision up to 4-grams, geometric
mean, multiplicative brevity penalty. Pure numpy/host code — it runs once
per experiment on decoded ids, nothing here needs to be jittable.

Scores are in [0, 1]; multiply by 100 for the conventional reporting scale.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Sequence

import numpy as np


def _ngrams(seq: Sequence[int], n: int) -> Counter:
    return Counter(tuple(seq[i:i + n]) for i in range(len(seq) - n + 1))


def bleu_stats(hypothesis: Sequence[int], reference: Sequence[int],
               max_n: int = 4) -> Dict[str, np.ndarray]:
    """Sufficient statistics for one sentence pair: per-order clipped match
    and total counts, plus hyp/ref lengths. Corpus BLEU sums these over the
    corpus before taking precisions — NOT an average of sentence BLEUs."""
    matches = np.zeros(max_n, np.int64)
    totals = np.zeros(max_n, np.int64)
    for n in range(1, max_n + 1):
        hyp_ngrams = _ngrams(hypothesis, n)
        ref_ngrams = _ngrams(reference, n)
        totals[n - 1] = max(len(hypothesis) - n + 1, 0)
        matches[n - 1] = sum(min(c, ref_ngrams[g])
                             for g, c in hyp_ngrams.items())
    return {"matches": matches, "totals": totals,
            "hyp_len": np.int64(len(hypothesis)),
            "ref_len": np.int64(len(reference))}


def corpus_bleu(hypotheses: List[Sequence[int]],
                references: List[Sequence[int]],
                max_n: int = 4, smooth: bool = False) -> float:
    """Corpus-level BLEU in [0, 1].

    ``smooth`` adds 1 to match/total counts for orders with zero matches
    (Lin & Och smoothing) — useful for short synthetic corpora where a
    zero 4-gram count would zero the whole score.
    """
    if len(hypotheses) != len(references):
        raise ValueError(
            f"{len(hypotheses)} hypotheses vs {len(references)} references")
    if not hypotheses:
        return 0.0
    matches = np.zeros(max_n, np.float64)
    totals = np.zeros(max_n, np.float64)
    hyp_len = 0
    ref_len = 0
    for hyp, ref in zip(hypotheses, references):
        s = bleu_stats(hyp, ref, max_n)
        matches += s["matches"]
        totals += s["totals"]
        hyp_len += int(s["hyp_len"])
        ref_len += int(s["ref_len"])
    # Effective order (sacrebleu-style): orders the corpus cannot produce
    # at all (every hypothesis shorter than n → totals == 0) are excluded
    # rather than scored — bumping them to 1/1 under smoothing would grant
    # perfect precision to impossible n-grams and inflate short outputs.
    usable = totals > 0
    if not usable.any():
        return 0.0
    matches, totals = matches[usable], totals[usable]
    if smooth:
        zero = matches == 0
        matches = matches + zero
        totals = totals + zero
    if np.any(matches == 0):
        return 0.0
    log_prec = np.mean(np.log(matches / totals))
    if hyp_len == 0:
        return 0.0
    # Brevity penalty: 1 when hyp is at least as long as ref.
    bp = 1.0 if hyp_len >= ref_len else float(np.exp(1.0 - ref_len / hyp_len))
    return float(bp * np.exp(log_prec))
