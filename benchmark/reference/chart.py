"""Flat, level-major chart layout and the gather indices of both passes.

A sentence of ``n`` tokens has ``n(n+1)/2`` cells; level ``l`` holds the
``n - l`` spans of length ``l + 1`` and starts at flat index
``ncells(n) - (n-l)(n-l+1)/2``.  Inside, target ``(l, p)`` splits at ``k``
into ``(k, p)`` and ``(l-k-1, p+k+1)``, rows position-major.  Outside,
target ``(l, p)`` = ``[i, j)`` has ``n - l - 1`` (parent, sibling)
derivations, combination-major: ``c < p`` extends left (parent ``[c, j)``,
sibling ``[c, i)``), ``c >= p`` extends right (parent ``[i, b)``, sibling
``[j, b)``, ``b = j + c - p + 1``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def ncells(n: int) -> int:
    return n * (n + 1) // 2


def level_offsets(n: int) -> np.ndarray:
    rem = n - np.arange(n, dtype=np.int64)
    return ncells(n) - rem * (rem + 1) // 2


def cell_index(n: int, level, pos) -> np.ndarray:
    rem = n - np.asarray(level, dtype=np.int64)
    return ncells(n) - rem * (rem + 1) // 2 + np.asarray(pos, dtype=np.int64)


def cell_coords(n: int):
    """``(levels, positions)`` of every flat cell."""
    offs = level_offsets(n)
    idx = np.arange(ncells(n), dtype=np.int64)
    levels = np.searchsorted(offs, idx, side="right") - 1
    return levels, idx - offs[levels]


def inside_index(n: int, level: int):
    L, N = n - level, level
    p = np.arange(L)[:, None]
    k = np.arange(N)[None, :]
    left = cell_index(n, np.broadcast_to(k, (L, N)), np.broadcast_to(p, (L, N)))
    right = cell_index(n, level - k - 1, p + k + 1)
    return left.reshape(-1), right.reshape(-1)


def outside_index(n: int, level: int):
    L = n - level
    N = L - 1
    p = np.arange(L)[None, :]
    c = np.arange(N)[:, None]
    j = p + level + 1
    left = c < p
    b = j + (c - p) + 1
    par_level = np.where(left, level + p - c, level + b - j)
    par_pos = np.where(left, c, p)
    sis_level = np.where(left, p - c - 1, b - j - 1)
    sis_pos = np.where(left, c, j)
    par = cell_index(n, np.minimum(par_level, n - 1), par_pos)
    sis = cell_index(n, np.minimum(sis_level, n - 1), sis_pos)
    return par.reshape(-1), sis.reshape(-1)


@functools.lru_cache(maxsize=None)
def _host_index(kind: str, n: int, level: int):
    fn = inside_index if kind == "inside" else outside_index
    return tuple(np.ascontiguousarray(a) for a in fn(n, level))


def index(kind: str, n: int, level: int, device):
    """The gather indices of one level as int64 tensors on ``device``."""
    return tuple(torch.as_tensor(a, device=device)
                 for a in _host_index(kind, n, level))
