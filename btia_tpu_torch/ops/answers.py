"""The "real answer" rule for turning logits into answers.

The answer head is statically sized to ``ModelConfig.answer_vocab_size``;
only the first ``len(answer_vocab)`` slots are real answers, and slot 0 is
``<unk>``, never a real answer. Every helper takes
``limit = min(len(answer_vocab), head_size)``.
"""

from __future__ import annotations

import numpy as np
import torch


def real_limit(answer_vocab_len: int, head_size: int) -> int:
    return min(answer_vocab_len, head_size)


def argmax_real(logits, limit: int):
    """Best real-answer id (numpy arrays and tensors alike)."""
    return logits[..., 1:limit].argmax(-1) + 1


def topk_real(logits: torch.Tensor, k: int, limit: int):
    """(values, ids) of the k best real answers, k clamped to limit - 1."""
    k = max(1, min(k, limit - 1, logits.shape[-1]))
    idx = torch.arange(logits.shape[-1], device=logits.device)
    masked = torch.where((idx == 0) | (idx >= limit), -1e30, logits)
    return torch.topk(masked, k)


def topn_real_np(logits: np.ndarray, n: int, limit: int) -> np.ndarray:
    """Ids of the n best real answers, host-side (ranked, descending)."""
    return 1 + np.argsort(-logits[..., 1:limit], axis=-1)[..., :n]
