"""Closed-form gather indices for the inside and outside chart passes.

The port's own copy of cliora_tpu/chart/indices.py's index builders,
plus a cache of the index arrays as device tensors per
``(n, level, device)``, and of each chart's cell coordinates and level
offsets per ``(n, device)``: once a shape is warm, nothing on the train
step's path copies from host memory (a CUDA graph cannot capture such a
copy).

Inside, at target level ``level`` (with ``L = n - level`` targets and
``N = level`` split points): target ``(level, p)`` = span
``[p, p+level+1)``; split ``k`` breaks it into left child ``(k, p)`` and
right child ``(level-k-1, p+k+1)``.  Arrays are laid out position-major,
entry ``j = p * N + k``, so a gather of shape ``(B, L*N, D)`` reshapes to
``(B, L, N, D)`` with the split axis last.  (Same layout contract as the
reference's ``.transpose(0,1).flatten()``:
cliora/net/inside_index.py:192-196.)

Outside, at target level ``level`` (``L = n - level`` targets, each with
``N = L - 1`` (parent, sibling) derivations): target ``(level, p)`` =
span ``[i, j) = [p, p+level+1)``; combination ``c < p`` is the
left-extension with parent ``[c, j)`` and sibling ``[c, i)``, ``c >= p``
the right-extension with parent ``[i, b)`` and sibling ``[j, b)``,
``b = j + (c - p) + 1``.  Arrays are combination-major, entry
``c * L + p``, so a gather reshapes to ``(B, N, L, D)`` and the
derivation softmax runs over axis 1.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from cliora_tpu_torch.chart.offsets import cell_coords, cell_index, level_offsets


def inside_index(n: int, level: int) -> Tuple[np.ndarray, np.ndarray]:
    """Gather indices for the inside pass at ``level``.

    Returns ``(idx_l, idx_r)``, each ``(L * N,)`` int32, position-major
    (``j = pos * N + split``), indexing into the flat chart axis.
    """
    assert 1 <= level < n
    L = n - level
    N = level
    p = np.arange(L, dtype=np.int64)[:, None]   # (L, 1) target positions
    k = np.arange(N, dtype=np.int64)[None, :]   # (1, N) split points
    idx_l = cell_index(n, k, np.broadcast_to(p, (L, N)))
    idx_r = cell_index(n, level - k - 1, p + k + 1)
    return (
        idx_l.reshape(-1).astype(np.int32),
        idx_r.reshape(-1).astype(np.int32),
    )


def outside_index(n: int, level: int) -> Tuple[np.ndarray, np.ndarray]:
    """Gather indices for the outside pass at ``level``.

    Returns ``(par_idx, sis_idx)``, each ``(N * L,)`` int32,
    combination-major (``entry = c * L + p``).  ``par_idx`` indexes the
    *outside* chart; ``sis_idx`` indexes the *inside* chart.
    """
    assert 0 <= level <= n - 2
    L = n - level
    N = L - 1
    p = np.arange(L, dtype=np.int64)[None, :]   # (1, L) target positions
    c = np.arange(N, dtype=np.int64)[:, None]   # (N, 1) combination ids
    j = p + level + 1                           # exclusive end of target span

    left = c < p                                # left-extension combos
    a = c                                       # sibling/parent start (left)
    b = j + (c - p) + 1                         # parent end (right)

    par_level = np.where(left, level + p - a, level + b - j)
    par_pos = np.where(left, a, p)
    sis_level = np.where(left, p - a - 1, b - j - 1)
    sis_pos = np.where(left, a, j)

    # Clip to keep cell_index well-defined for combos that would be invalid
    # on shorter padded sentences; at full length every combo is valid.
    par_idx = cell_index(n, np.minimum(par_level, n - 1), par_pos)
    sis_idx = cell_index(n, np.minimum(sis_level, n - 1), sis_pos)
    return (
        par_idx.reshape(-1).astype(np.int32),
        sis_idx.reshape(-1).astype(np.int32),
    )


class ChartIndex:
    """Memoized per-``(n, level, device)`` index tensors (int64, the index
    dtype of advanced indexing).

    The key set is bounded by the sentence lengths a process sees.  A
    trace (``torch.export``, ``torch.compile``) reads the cache but never
    fills it: a tensor made while tracing is a fake one, and a later
    eager pass would read it.  :meth:`fill` makes a length's entries
    before a trace, which then holds them as constants.
    """

    def __init__(self):
        self._cache: Dict[Tuple[str, int, int, torch.device],
                          Tuple[torch.Tensor, ...]] = {}

    def _get(self, kind, build, n, level, device):
        device = torch.device(device)
        key = (kind, n, level, device)
        if key in self._cache:
            return self._cache[key]
        out = tuple(torch.from_numpy(np.asarray(a, dtype=np.int64)).to(device)
                    for a in build(n, level))
        if not torch.compiler.is_compiling():
            self._cache[key] = out
        return out

    def fill(self, n: int, device):
        """Make every entry the chart passes of a length-``n`` chart read
        on ``device``."""
        for level in range(1, n):
            self.inside(n, level, device)
        for level in range(n - 1):
            self.outside(n, level, device)
        self.coords(n, device)
        self.offsets(n, device)

    def inside(self, n: int, level: int, device) -> Tuple[torch.Tensor,
                                                          torch.Tensor]:
        return self._get("inside", inside_index, n, level, device)

    def outside(self, n: int, level: int, device) -> Tuple[torch.Tensor,
                                                           torch.Tensor]:
        return self._get("outside", outside_index, n, level, device)

    def coords(self, n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(levels, positions)`` of every flat cell, each ``(1, ncells)``."""
        return self._get("coords", lambda n, _: (x[None] for x in
                                                 cell_coords(n)),
                         n, 0, device)

    def offsets(self, n: int, device) -> torch.Tensor:
        """``(n,)`` flat index of the first cell of each level."""
        return self._get("offsets", lambda n, _: (level_offsets(n),), n, 0,
                         device)[0]


# Process-wide cache; index tensors are small and never written.
INDEX = ChartIndex()
