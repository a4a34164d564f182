"""Vocab building and token indexing.

(reference: cliora/data/preprocessing.py)
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np


def build_text_vocab(sentences, word2idx=None):
    """First-seen-order vocab (reference: preprocessing.py:17-23)."""
    word2idx = OrderedDict() if word2idx is None else word2idx.copy()
    for s in sentences:
        for w in s:
            if w not in word2idx:
                word2idx[w] = len(word2idx)
    return word2idx


def indexify(sentences, word2idx, unk_index=None):
    """(reference: preprocessing.py:26-32)"""
    out = []
    for s in sentences:
        row = []
        for w in s:
            if w not in word2idx and unk_index is None:
                raise ValueError(f"OOV token {w!r} with no unk index")
            row.append(word2idx.get(w, unk_index))
        out.append(row)
    return out


def synthesize_training_data(nexamples, vocab_size, min_length=10,
                             max_length=30, seed=None):
    """Random token-id streams (reference: preprocessing.py:87-98)."""
    rs = np.random.RandomState(seed)
    return [
        rs.randint(0, vocab_size,
                   size=rs.randint(min_length, max_length)).tolist()
        for _ in range(nexamples)
    ]
