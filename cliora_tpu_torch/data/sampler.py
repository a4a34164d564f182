"""Negative sampling for the reconstruction loss.

Host-side numpy: one fresh draw of ``k_neg`` distinct words per batch,
shared across the whole batch (reference: cliora/blocks/negative_sampler.py,
cliora/data/batch_iterator.py:147-160).
"""

from __future__ import annotations

import numpy as np


def calculate_freq_dist(corpus, vocab_size: int) -> np.ndarray:
    """Token-frequency vector over an iterable of token-id sequences.

    (reference: cliora/blocks/negative_sampler.py:15-24; bincount instead
    of a Counter loop)
    """
    freq = np.zeros(vocab_size, dtype=np.int64)
    for sent in corpus:
        freq += np.bincount(np.asarray(sent, dtype=np.int64),
                            minlength=vocab_size)
    return freq.astype(np.float32)


class NegativeSampler:
    """Smoothed-unigram sampler: ``p ∝ freq^power + eps/V``.

    (reference: cliora/blocks/negative_sampler.py:27-37)
    """

    def __init__(self, freq_dist, dist_power: float = 0.75,
                 epsilon: float = 1e-2):
        freq_dist = np.asarray(freq_dist, dtype=np.float64)
        dist = freq_dist ** dist_power + epsilon * (1.0 / len(freq_dist))
        self.dist = dist / dist.sum()
        self.rng = np.random.RandomState()

    def set_seed(self, seed: int):
        self.rng.seed(seed)

    def sample(self, num_samples: int) -> np.ndarray:
        """``num_samples`` distinct word ids, int64.

        Clamped to the vocab size so tiny smoke-test vocabs don't fault
        (real corpora always have vocab >> k_neg).
        """
        num_samples = min(num_samples, len(self.dist))
        return self.rng.choice(len(self.dist), num_samples, p=self.dist,
                               replace=False)
