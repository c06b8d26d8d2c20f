"""Evaluation metrics — identical definitions to the reference's eval so
accuracy parity is well-defined [B:2 "VQA-RAD closed-ended accuracy",
SURVEY §3.2 "metric definitions are a parity gate"].

  * exact-match accuracy over the answer vocabulary (overall);
  * closed-ended vs open-ended breakdown (VQA-RAD/SLAKE/PathVQA [B:7–9]);
  * per-category breakdown for VQA-Med (modality/plane/organ/abnormality
    [B:10]);
  * smoothed corpus BLEU for open-ended answers (the ImageCLEF secondary
    metric).
"""

from __future__ import annotations

import collections
import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from btia_tpu_torch.data.vocab import tokenize_words


class EvalAccumulator:
    """Streams per-batch eval outputs into the metrics table."""

    def __init__(self):
        self.correct: List[bool] = []
        self.answer_types: List[str] = []
        self.categories: List[str] = []
        self.pred_answers: List[str] = []
        self.ref_answers: List[str] = []

    def add_batch(
        self,
        correct: np.ndarray,
        valid: np.ndarray,
        answer_types: Sequence[str],
        categories: Sequence[str],
        pred_answers: Optional[Sequence[str]] = None,
        ref_answers: Optional[Sequence[str]] = None,
    ) -> None:
        for i in range(len(valid)):
            if not valid[i]:
                continue
            self.correct.append(bool(correct[i]))
            self.answer_types.append(answer_types[i])
            self.categories.append(categories[i])
            if pred_answers is not None:
                self.pred_answers.append(pred_answers[i])
            if ref_answers is not None:
                self.ref_answers.append(ref_answers[i])

    def _acc(self, mask: List[bool]) -> Optional[float]:
        sel = [c for c, m in zip(self.correct, mask) if m]
        return sum(sel) / len(sel) if sel else None

    def summary(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        if not self.correct:
            return out
        out["accuracy"] = sum(self.correct) / len(self.correct)
        closed = self._acc([t == "CLOSED" for t in self.answer_types])
        open_ = self._acc([t != "CLOSED" for t in self.answer_types])
        if closed is not None:
            out["closed_accuracy"] = closed
        if open_ is not None:
            out["open_accuracy"] = open_
        for cat in sorted({c for c in self.categories if c}):
            acc = self._acc([c == cat for c in self.categories])
            if acc is not None:
                out[f"accuracy/{cat}"] = acc
        if self.pred_answers and self.ref_answers:
            open_pairs = [
                (p, r)
                for p, r, t in zip(
                    self.pred_answers, self.ref_answers, self.answer_types
                )
                if t != "CLOSED"
            ] or list(zip(self.pred_answers, self.ref_answers))
            out["bleu"] = corpus_bleu(
                [p for p, _ in open_pairs], [r for _, r in open_pairs]
            )
        return out


def _ngrams(tokens: List[str], n: int) -> collections.Counter:
    return collections.Counter(
        tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1)
    )


def corpus_bleu(
    predictions: Sequence[str], references: Sequence[str], max_n: int = 4
) -> float:
    """Corpus BLEU with add-1 smoothing and brevity penalty."""
    clipped = [0] * max_n
    totals = [0] * max_n
    pred_len = ref_len = 0
    for pred, ref in zip(predictions, references):
        p_tok, r_tok = tokenize_words(pred), tokenize_words(ref)
        pred_len += len(p_tok)
        ref_len += len(r_tok)
        for n in range(1, max_n + 1):
            p_ng, r_ng = _ngrams(p_tok, n), _ngrams(r_tok, n)
            totals[n - 1] += max(sum(p_ng.values()), 0)
            clipped[n - 1] += sum((p_ng & r_ng).values())
    if pred_len == 0:
        return 0.0
    log_precision = 0.0
    for n in range(max_n):
        log_precision += math.log((clipped[n] + 1.0) / (totals[n] + 1.0))
    log_precision /= max_n
    bp = 1.0 if pred_len > ref_len else math.exp(1.0 - ref_len / max(pred_len, 1))
    return bp * math.exp(log_precision)


def blind_best_accuracy(train_items, val_items, slot_words=()) -> float:
    """Accuracy of the strongest image-BLIND predictor on a VQA split:
    per question key (the full string, and the string with slot words
    removed), answer with the train-majority answer; unseen keys fall back
    to the global majority. Any model that ignores pixels is bounded by
    this — learnability claims (tests/test_learnability.py,
    benchmarks/learnability.py) are margins over it, per VERDICT r2 item 1.
    """
    slot = set(slot_words)

    def _template(q: str) -> str:
        return " ".join(w for w in q.split() if w not in slot)

    best = 0.0
    for keyfn in (lambda q: q, _template):
        maj = collections.defaultdict(collections.Counter)
        for s in train_items:
            maj[keyfn(s.question)][s.answer] += 1
        glob = collections.Counter(s.answer for s in train_items)
        hits = 0
        for s in val_items:
            c = maj.get(keyfn(s.question))
            pred = (c or glob).most_common(1)[0][0]
            hits += pred == s.answer
        best = max(best, hits / max(len(val_items), 1))
    return best
