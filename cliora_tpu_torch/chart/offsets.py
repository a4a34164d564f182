"""Flat chart layout for the inside-outside recursion.

The port's own copy of cliora_tpu/chart/offsets.py (numpy only), so
that the port imports nothing of the JAX package.

A sentence of ``n`` tokens induces a triangular chart over all contiguous
spans.  We store it flat and *level-major*:

  * ``level`` L holds all spans of length ``level + 1``; there are
    ``n - level`` of them, at positions ``0 .. n-level-1``.
  * cell ``(level, pos)`` covers the half-open token span
    ``[pos, pos + level + 1)``.
  * the flat chart has ``ncells(n) = n(n+1)/2`` cells; level ``L`` occupies
    the contiguous slice ``[offset(L), offset(L) + n - L)`` where
    ``offset(L) = ncells(n) - (n-L)(n-L+1)/2``.

This matches the storage convention of the reference implementation
(reference: cliora/net/offset_cache.py:1-8, cliora/net/diora.py:7-23) so
that chart dumps / checkpoints / span indexing conventions line up, while
the index *computation* here is closed-form numpy rather than per-level
Python loops.
"""

from __future__ import annotations

import numpy as np


def ncells(n: int) -> int:
    """Number of chart cells for a length-``n`` sentence."""
    return n * (n + 1) // 2


def level_offsets(n: int) -> np.ndarray:
    """``offsets[L]`` = flat index of the first cell of level ``L``.

    (reference: cliora/net/offset_cache.py:1-8)
    """
    lvl = np.arange(n, dtype=np.int64)
    rem = n - lvl
    return ncells(n) - rem * (rem + 1) // 2


def cell_index(n: int, level, pos):
    """Flat index of cell ``(level, pos)``; vectorized over numpy inputs."""
    level = np.asarray(level, dtype=np.int64)
    pos = np.asarray(pos, dtype=np.int64)
    rem = n - level
    return ncells(n) - rem * (rem + 1) // 2 + pos


def random_backpointers(rs, n: int, B: int) -> np.ndarray:
    """(B, ncells) random *valid* CKY backpointers: split k in [0, level).

    Level-0 cells get 0 (never read).  Used by the decode parity tests
    (tests/test_torch_trees.py) so they stay pinned to this layout.
    """
    levels, _ = cell_coords(n)
    hi = np.maximum(levels.astype(np.int64), 1)
    return (rs.randint(0, 1 << 30, size=(B, ncells(n))) % hi).astype(
        np.int32)


def cell_coords(n: int):
    """``(levels, positions)`` of every flat cell, each ``(ncells,)`` int32.

    Closed-form companion to :func:`cell_index`; used to build per-example
    validity masks for padded length buckets (a sentence of true length
    ``m`` padded to ``n`` only owns cells with ``pos + level + 1 <= m``).
    """
    offsets = level_offsets(n)
    idx = np.arange(ncells(n), dtype=np.int64)
    levels = np.searchsorted(offsets, idx, side="right") - 1
    positions = idx - offsets[levels]
    return levels.astype(np.int32), positions.astype(np.int32)
