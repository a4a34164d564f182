"""Closed-form gather indices for the inside chart pass.

The port's own copy of the inside half of cliora_tpu/chart/indices.py,
plus a cache of the index arrays as device tensors per
``(n, level, device)``.

Inside, at target level ``level`` (with ``L = n - level`` targets and
``N = level`` split points): target ``(level, p)`` = span
``[p, p+level+1)``; split ``k`` breaks it into left child ``(k, p)`` and
right child ``(level-k-1, p+k+1)``.  Arrays are laid out position-major,
entry ``j = p * N + k``, so a gather of shape ``(B, L*N, D)`` reshapes to
``(B, L, N, D)`` with the split axis last.  (Same layout contract as the
reference's ``.transpose(0,1).flatten()``:
cliora/net/inside_index.py:192-196.)
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from cliora_tpu_torch.chart.offsets import cell_index


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


class ChartIndex:
    """Memoized per-``(n, level, device)`` inside index tensors (int64,
    the index dtype of ``torch.index_select`` and advanced indexing).

    The key set is bounded by the sentence lengths a process sees.
    """

    def __init__(self):
        self._inside: Dict[Tuple[int, int, torch.device],
                           Tuple[torch.Tensor, torch.Tensor]] = {}

    def inside(self, n: int, level: int, device) -> Tuple[torch.Tensor,
                                                          torch.Tensor]:
        device = torch.device(device)
        key = (n, level, device)
        if key not in self._inside:
            idx_l, idx_r = inside_index(n, level)
            self._inside[key] = (
                torch.from_numpy(idx_l.astype(np.int64)).to(device),
                torch.from_numpy(idx_r.astype(np.int64)).to(device))
        return self._inside[key]


# Process-wide cache; index tensors are small and never written.
INDEX = ChartIndex()
