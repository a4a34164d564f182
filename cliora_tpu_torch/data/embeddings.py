"""Pretrained embedding providers: GloVe/word2vec text files, skip-thought
pickles, cached ELMo vectors, concatenations, or a trainable table.

The port's copy of cliora_tpu/data/embeddings.py (reference:
cliora/data/embeddings.py).  It reads and writes the reference's ELMo
cache format ``elmo_{sha256-of-sorted-vocab}.npy``; a missing cache is
computed by the port's char-CNN (data/elmo.py) from local weight files.
The JAX package fetches a weight file given as a URL; the port takes
local paths only.
"""

from __future__ import annotations

import hashlib
import os
import pickle
from collections import OrderedDict
from typing import Dict, Tuple

import numpy as np

PADDING_TOKEN = "_PAD"
UNK_TOKEN = "_"
EXISTING_VOCAB_TOKEN = "unused-token-a7g39i"

SKIP_THOUGHT_DIM = 620
ELMO_DIM = 512


def validate_word2idx(word2idx: Dict[str, int]):
    vocab = [w for w, _ in sorted(word2idx.items(), key=lambda kv: kv[1])]
    for i, w in enumerate(vocab):
        assert word2idx[w] == i


def hash_tokens(tokens) -> str:
    """sha256 of an alphabetically-sorted vocab (reference: embeddings.py:257-263)."""
    for w0, w1 in zip(tokens, sorted(tokens)):
        assert w0 == w1, "tokens must be sorted"
    m = hashlib.sha256()
    for w in tokens:
        m.update(str.encode(w))
    return m.hexdigest()


def read_glove(filename: str, word2idx: Dict[str, int]
               ) -> Tuple[np.ndarray, Dict[str, int]]:
    """Intersect vocab with a GloVe-format text file.

    Injects _PAD/_/sentinel tokens unless the mapping was already built by
    a previous call (sentinel at index 2).
    (reference: cliora/data/embeddings.py:170-242)
    """
    validate_word2idx(word2idx)

    glove_vocab = set()
    size = None
    with open(filename) as f:
        for i, line in enumerate(f):
            word, vec = line.split(" ", 1)
            glove_vocab.add(word)
            if i == 0:
                size = len(vec.strip().split(" "))

    new_vocab = set(word2idx) & glove_vocab
    new_vocab.discard(PADDING_TOKEN)
    new_vocab.discard(UNK_TOKEN)

    if word2idx.get(EXISTING_VOCAB_TOKEN) == 2:
        new_word2idx = word2idx.copy()
    else:
        new_word2idx = OrderedDict()
        for tok in (PADDING_TOKEN, UNK_TOKEN, EXISTING_VOCAB_TOKEN):
            new_word2idx[tok] = len(new_word2idx)
        for w in word2idx:
            if w not in new_word2idx:
                new_word2idx[w] = len(new_word2idx)

    embeddings = np.zeros((len(new_word2idx), size), dtype=np.float32)
    with open(filename) as f:
        for line in f:
            word, vec = line.strip().split(" ", 1)
            if word not in new_word2idx:
                continue
            embeddings[new_word2idx[word]] = np.fromstring(
                vec, dtype=float, sep=" ")

    validate_word2idx(new_word2idx)
    return embeddings, new_word2idx


def read_skip_thoughts(path: str, word2idx: Dict[str, int]
                       ) -> Tuple[np.ndarray, Dict[str, int]]:
    """620-d skip-thought vectors from a {word: vec} pickle; OOV words get
    the vector of 'a' (reference: embeddings.py:129-135)."""
    with open(path, "rb") as f:
        table = pickle.load(f)
    pad = table.get("a")
    out = np.zeros((len(word2idx), SKIP_THOUGHT_DIM), dtype=np.float32)
    for w, idx in word2idx.items():
        out[idx] = table.get(w, pad)
    return out, word2idx


def elmo_cache_path(cache_dir: str, word2idx: Dict[str, int]) -> str:
    tokens = sorted(word2idx)
    return os.path.join(cache_dir, f"elmo_{hash_tokens(tokens)}.npy")


def read_elmo(word2idx: Dict[str, int], cache_dir: str,
              options_path=None, weights_path=None, device=None
              ) -> Tuple[np.ndarray, Dict[str, int]]:
    """Context-insensitive ELMo vectors, duplicated to 1024-d.

    Prefers the reference-format on-disk cache (keyed by vocab hash); when
    absent, runs the char-CNN (data/elmo.py, on ``device``: the card by
    default) over the sorted vocab and writes the cache in the same
    format (cliora_tpu/data/embeddings.py:120-150).
    (reference: embeddings.py:46-109)
    """
    path = elmo_cache_path(cache_dir, word2idx)
    tokens = sorted(word2idx)
    if os.path.exists(path):
        emb_sorted = np.load(path)
        assert emb_sorted.shape == (len(tokens), ELMO_DIM), emb_sorted.shape
    else:
        from cliora_tpu_torch.data.elmo import embed_tokens
        for flag, p in (("--elmo_options_path", options_path),
                        ("--elmo_weights_path", weights_path)):
            if p is None or str(p).startswith(("http://", "https://")):
                raise ValueError(
                    f"no ELMo cache at {path}: computing it takes the "
                    f"weight files as local paths ({flag}={p!r})")
        emb_sorted = embed_tokens(tokens, options_path, weights_path,
                                  device=device)
        os.makedirs(cache_dir, exist_ok=True)
        np.save(path, emb_sorted)

    # re-order from alphabetical to word2idx order, then fwd/bwd duplicate
    sorted_pos = {tok: i for i, tok in enumerate(tokens)}
    index = [sorted_pos[w] for w, _ in
             sorted(word2idx.items(), key=lambda kv: kv[1])]
    emb = emb_sorted[index]
    return np.concatenate([emb, emb], axis=1), word2idx


def read_both(glove_path: str, word2idx, cache_dir, options_path=None,
              weights_path=None, device=None):
    """Concat GloVe + ELMo over the intersection vocab
    (reference: embeddings.py:137-152)."""
    e_w2v, w2i_w2v = read_glove(glove_path, word2idx)
    e_elmo, w2i_elmo = read_elmo(word2idx, cache_dir, options_path,
                                 weights_path, device=device)
    vocab = [w for w, _ in sorted(w2i_w2v.items(), key=lambda kv: kv[1])
             if w in w2i_elmo]
    new_word2idx = {w: i for i, w in enumerate(vocab)}
    out = np.zeros((len(vocab), e_w2v.shape[1] + e_elmo.shape[1]),
                   dtype=np.float32)
    for w, i in new_word2idx.items():
        out[i, :e_w2v.shape[1]] = e_w2v[w2i_w2v[w]]
        out[i, e_w2v.shape[1]:] = e_elmo[w2i_elmo[w]]
    return out, new_word2idx


def get_embeddings(options, embeddings_path, word2idx):
    """Dispatch on ``options.emb`` (reference: embeddings.py:154-167).

    ``'none'`` returns the vocab size (init_embed_params builds a
    trainable N(0,1) table of width 1024).
    """
    emb = options.emb
    if emb == "w2v":
        return read_glove(embeddings_path, word2idx)
    if emb == "skip":
        return read_skip_thoughts(embeddings_path, word2idx)
    # a missing ELMo cache is computed on the trainer's device
    device = getattr(options, "device", None)
    if emb == "elmo":
        return read_elmo(word2idx, options.elmo_cache_dir,
                         options.elmo_options_path,
                         options.elmo_weights_path, device=device)
    if emb == "both":
        return read_both(embeddings_path, word2idx,
                         options.elmo_cache_dir,
                         options.elmo_options_path,
                         options.elmo_weights_path, device=device)
    if emb == "none":
        return len(word2idx), word2idx
    raise NotImplementedError(emb)
