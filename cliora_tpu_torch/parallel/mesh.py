"""Data parallelism over a ``torch.distributed`` group, one rank a card.

Counterpart of cliora_tpu/parallel/mesh.py.  The JAX package shards the
global batch over one ``dp`` mesh axis and lets GSPMD insert the
gradient all-reduce; the reference runs 1-GPU-per-rank DDP
(cliora/net/trainer.py:528-575).  Here each process is one rank and
holds its chunk of every global batch (data/batching.py chunks by rank,
reference: cliora/data/batch_iterator.py:53-66); ``Mesh`` names the
group, its size and this rank.  JAX's single-process multi-device mesh
has no torch idiom: the dp width is the world size.

The losses that couple the batch (VG and contrastive negatives, the
reconstruction mean) are computed as each rank's share of the global
batch's loss, so that the shares sum to the global loss and the summed
gradients are its gradient.  They need two collectives with gradients
(training/losses.py):

* :func:`gather_rows` -- all-gather along the batch axis (every rank's
  image embeddings); the backward sums each row's gradient over the
  ranks and hands it to the row's owner (a reduce-scatter);
* :func:`scatter_sum_rows` -- sum over the ranks, each rank keeping its
  own rows (a reduce-scatter: the per-image contrastive terms that every
  rank's texts add to); the backward all-gathers the gradient.

Their backwards differ because the first copies one value to every rank
(each copy feeds a different rank's loss share, so the gradients add up),
while the second adds every rank's value into one (each rank's value
gets the sum's whole gradient).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

@dataclasses.dataclass(frozen=True)
class Mesh:
    """A data-parallel group: ``size`` ranks, this process's ``rank``,
    the process group (``None``: the default one) and its backend."""
    size: int
    rank: int
    backend: str
    group: Optional[Any] = None


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """The dp group over the whole world of an initialized process group
    (parallel/multihost.py).  ``n_devices`` must equal the world size:
    one process drives one card, so JAX's ``--n_devices 8`` in one
    process becomes eight ranks.  The JAX ``mp`` axis (tensor
    parallelism) is not ported (ROADMAP A8)."""
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(
                f"n_devices={n_devices} needs one process a card: launch "
                f"`python -m torch.distributed.run --nproc_per_node "
                f"{n_devices} -m cliora_tpu_torch.scripts.train ...` (or "
                f"pass --world_size/--master_addr/--master_port/"
                f"--local_rank to each process)")
        raise ValueError("make_mesh needs an initialized process group "
                         "(parallel/multihost.py initialize_multihost)")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices} != world size {world}: "
                         f"the port runs one rank a card")
    return Mesh(size=world, rank=dist.get_rank(),
                backend=str(dist.get_backend()))


def dp_size(mesh: Optional[Mesh]) -> int:
    """Number of ways the batch axis is split (1 without a mesh)."""
    return 1 if mesh is None else mesh.size


def is_multiprocess(mesh: Optional[Mesh]) -> bool:
    """Whether the group spans more than one process."""
    return dp_size(mesh) > 1


def _batch_like(key, x) -> bool:
    # (B,) lengths are batch rows too; other 1-D arrays (the (k,) shared
    # negative samples) are the same on every rank
    return np.ndim(x) >= 2 or key == "lengths"


def shard_batch(mesh: Optional[Mesh], tree, on_indivisible: str = "error"):
    """This rank's rows of a global host batch map: batch-like arrays
    (ndim >= 2, and ``lengths``) keep the rank's contiguous block of
    rows, 1-D shared vectors are kept whole.  A batch axis the group
    does not divide raises ``ValueError``; with ``on_indivisible='warn'``
    (eval paths) it warns and every rank keeps the whole batch
    (cliora_tpu/parallel/mesh.py:66-118)."""
    if on_indivisible not in ("error", "warn"):
        raise ValueError(f"on_indivisible={on_indivisible!r}")
    n = dp_size(mesh)
    if n == 1:
        return dict(tree)
    rows = {k: np.shape(v)[0] for k, v in tree.items()
            if v is not None and _batch_like(k, v)}
    bad = {k: b for k, b in rows.items() if b % n or b == 0}
    if bad:
        msg = (f"batch axis {sorted(set(bad.values()))} not divisible by "
               f"{n}-rank dp group; every rank would compute the full "
               f"batch ({n}x wasted compute)")
        if on_indivisible == "error":
            raise ValueError(msg)
        warnings.warn(msg, stacklevel=2)
        return dict(tree)
    r = 0 if mesh is None else mesh.rank
    out = {}
    for k, v in tree.items():
        if k in rows:
            b = rows[k] // n
            out[k] = v[r * b:(r + 1) * b]
        else:
            out[k] = v
    return out


def replicate_tree(mesh: Optional[Mesh], tensors):
    """Rank 0's values into every rank's tensors, in place (a broadcast
    per tensor); returns ``tensors``.  Ranks build their state from one
    seed or one checkpoint, so this only guards against drift."""
    if mesh is not None:
        for t in tensors:
            dist.broadcast(t.detach(), src=0, group=mesh.group)
    return tensors


def all_reduce_(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum ``t`` over the group in place (no gradient); returns ``t``."""
    dist.all_reduce(t, group=mesh.group)
    return t


def all_reduce_flat(tensors, mesh: Mesh):
    """The group's sums of ``tensors``, from one all-reduce of one flat
    buffer: views of it, shaped like the inputs (no gradient)."""
    flat = all_reduce_(torch.cat([t.reshape(-1) for t in tensors]), mesh)
    return [part.view(t.shape) for part, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``(size * b, ...)``: every rank's ``(b, ...)`` in rank order (no
    gradient)."""
    x = x.contiguous()
    out = x.new_empty((mesh.size * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=mesh.group)
    return out


def reduce_scatter_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``(B / size, ...)``: the sum over the group of this rank's block of
    rows of ``x`` (no gradient)."""
    x = x.contiguous()
    out = x.new_empty((x.shape[0] // mesh.size,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, group=mesh.group)
    return out


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_gather_rows(x, mesh)

    @staticmethod
    def backward(ctx, g):
        out = reduce_scatter_rows(g, ctx.mesh)
        # in the incoming gradient's memory layout, which the rows'
        # consumers see without a group: a reduction over it (a bias
        # gradient) adds in the order of its strides
        return torch.empty_like(g[:out.shape[0]]).copy_(out), None


class _ScatterSumRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return reduce_scatter_rows(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return all_gather_rows(g, ctx.mesh), None


def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """All-gather along axis 0, differentiable: the gradient of a
    gathered row is summed over the ranks into its owner's row."""
    if x.shape[0] == 0:
        raise ValueError("gather_rows of an empty block")
    return _GatherRows.apply(x, mesh)


def scatter_sum_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The group's sum of ``x`` (``(B, ...)`` on every rank), each rank
    keeping its own block of ``B / size`` rows; differentiable: every
    rank's ``x`` gets the whole gradient of the sum."""
    if x.shape[0] % mesh.size:
        raise ValueError(f"scatter_sum_rows: {x.shape[0]} rows over "
                         f"{mesh.size} ranks")
    return _ScatterSumRows.apply(x, mesh)
