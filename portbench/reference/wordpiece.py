"""Greedy longest-match WordPiece, as BERT's tokenizer: lowercase, split
into words and punctuation, each word into the longest pieces the
vocabulary holds (``##`` marks a piece inside a word, [UNK] a word that
cannot be split), framed by [CLS] and [SEP] and padded with [PAD] (id 0)."""

from __future__ import annotations

import re
from pathlib import Path
from typing import List

_WORD = re.compile(r"[a-z0-9]+|[^\sa-z0-9]")


class WordPiece:
    def __init__(self, vocab_file: str | Path):
        itos = Path(vocab_file).read_text(encoding="utf-8").splitlines()
        self.stoi = {t: i for i, t in enumerate(itos)}
        self.pad, self.unk, self.cls, self.sep = (self.stoi[t] for t in ("[PAD]", "[UNK]", "[CLS]", "[SEP]"))

    def _pieces(self, word: str) -> List[int]:
        ids, start = [], 0
        while start < len(word):
            for end in range(len(word), start, -1):
                sub = word[start:end] if start == 0 else "##" + word[start:end]
                if sub in self.stoi:
                    ids.append(self.stoi[sub])
                    start = end
                    break
            else:
                return [self.unk]
        return ids

    def encode(self, text: str, max_len: int) -> List[int]:
        ids = [self.cls]
        for w in _WORD.findall(text.lower()):
            ids += self._pieces(w)
            if len(ids) >= max_len - 1:
                break
        ids = ids[: max_len - 1] + [self.sep]
        return ids + [self.pad] * (max_len - len(ids))
