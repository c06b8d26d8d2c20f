"""Pretrained word embeddings for the LSTM question path (the port of
``btia_tpu/data/embeddings.py``).

The loader reads a local GloVe-format text file; vocabulary words missing
from it keep a random vector scaled to the file's mean norm, and the PAD row
is 0. A missing file raises: a silent no-op would hide a config error.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from btia_tpu_torch.data.vocab import WordVocab


def parse_glove_file(path: str | Path, dim: int) -> Dict[str, np.ndarray]:
    """GloVe text format: one 'word v1 ... vd' per line; a line of another
    length (a header, a truncated line) is skipped."""
    table: Dict[str, np.ndarray] = {}
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            parts = line.rstrip().split(" ")
            if len(parts) != dim + 1:
                continue
            table[parts[0]] = np.asarray(parts[1:], dtype=np.float32)
    return table


def build_embedding_matrix(vocab: WordVocab, glove: Dict[str, np.ndarray], dim: int,
                           seed: int = 0) -> Tuple[np.ndarray, int]:
    """(len(vocab), dim) matrix; returns (matrix, words found). PAD row 0."""
    rng = np.random.RandomState(seed)
    scale = float(np.mean([np.linalg.norm(v) for v in glove.values()])) if glove else 1.0
    out = rng.randn(len(vocab), dim).astype(np.float32)
    out *= scale / np.maximum(np.linalg.norm(out, axis=1, keepdims=True), 1e-6)
    out[0] = 0.0  # PAD
    hits = 0
    for word, idx in vocab.stoi.items():
        vec = glove.get(word)
        if vec is not None:
            out[idx] = vec
            hits += 1
    return out, hits


@torch.no_grad()
def load_word_embeddings(model: nn.Module, vocab: WordVocab, glove_path: str | Path) -> int:
    """Replace ``question_encoder.word_embed.embedding`` of `model` with the
    file's vectors, in place; returns the number of vocabulary words found."""
    emb = model.question_encoder.word_embed.embedding
    n, dim = emb.shape
    if n != len(vocab):
        raise ValueError(f"embedding table rows {n} != vocab size {len(vocab)}")
    if not Path(glove_path).is_file():
        raise FileNotFoundError(f"no GloVe file at {glove_path}")
    matrix, hits = build_embedding_matrix(vocab, parse_glove_file(glove_path, dim), dim)
    emb.copy_(torch.from_numpy(matrix))
    return hits
