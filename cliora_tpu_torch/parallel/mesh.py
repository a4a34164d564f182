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

Tensor parallelism (``mp > 1``, parallel/sharding.py) makes the world a
``dp x mp`` grid with ``mp`` the minor axis, rank ``d * mp + m``, as the
JAX ``make_mesh`` lays out its devices (cliora_tpu/parallel/mesh.py:
32-47), so that the model-parallel collectives run between neighbouring
cards.  ``Mesh`` then names the rank's dp group (the ranks of its ``m``)
in ``size``/``rank``/``group`` and its mp group (the ranks of its ``d``)
in ``mp``/``mp_rank``/``mp_group``; everything above that works on the
batch sees the dp group only, so the ``mp`` ranks of one dp row hold the
same rows, draw the same dropout masks and share the negative samples.
The JAX package refuses ``mp`` across processes; here across processes
is the only form it takes, one rank a card.
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
    the process group (``None``: the default one) and its backend; under
    tensor parallelism also the model-parallel group: ``mp`` ranks, this
    process's ``mp_rank`` and ``mp_group``."""
    size: int
    rank: int
    backend: str
    group: Optional[Any] = None
    mp: int = 1
    mp_rank: int = 0
    mp_group: Optional[Any] = None


def make_mesh(n_devices: Optional[int] = None, mp: int = 1) -> Mesh:
    """The ``dp x mp`` grid over the whole world of an initialized process
    group (parallel/multihost.py), ``dp = world / mp``.  ``n_devices``
    must equal the world size: one process drives one card, so JAX's
    ``--n_devices 8`` in one process becomes eight ranks.  Every rank must
    call it, in the same order as the other ranks' calls: the dp and mp
    groups are made here (``dist.new_group``)."""
    if not dist.is_initialized():
        asked = [f"{name}={n}" for name, n in
                 (("n_devices", n_devices), ("mp", mp)) if (n or 1) > 1]
        if asked:
            raise ValueError(
                f"{' and '.join(asked)} needs one process a card: launch "
                f"`python -m torch.distributed.run --nproc_per_node "
                f"{max(n_devices or 1, mp)} -m cliora_tpu_torch.scripts."
                f"train ...` (or pass --world_size/--master_addr/"
                f"--master_port/--local_rank to each process)")
        raise ValueError("make_mesh needs an initialized process group "
                         "(parallel/multihost.py initialize_multihost)")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices} != world size {world}: "
                         f"the port runs one rank a card")
    if mp < 1 or world % mp:
        raise ValueError(f"world size {world} is not divisible by mp={mp}")
    rank, backend = dist.get_rank(), str(dist.get_backend())
    if mp == 1:
        return Mesh(size=world, rank=rank, backend=backend)
    dp = world // mp
    d, m = divmod(rank, mp)
    dp_groups = [_new_group([e * mp + j for e in range(dp)], backend)
                 for j in range(mp)]
    mp_groups = [_new_group([e * mp + j for j in range(mp)], backend)
                 for e in range(dp)]
    return Mesh(size=dp, rank=d, backend=backend, group=dp_groups[m],
                mp=mp, mp_rank=m, mp_group=mp_groups[d])


def _new_group(ranks, backend):
    """``dist.new_group(ranks)``, made by every rank; under NCCL the
    members make its communicator at once with one all-reduce (a CUDA
    graph captures collectives only on a communicator that exists)."""
    group = dist.new_group(ranks)
    if backend == "nccl" and dist.get_rank() in ranks:
        dist.all_reduce(torch.zeros(1, device=torch.device(
            "cuda", torch.cuda.current_device())), group=group)
    return group


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
    """The dp group's first rank's values into every rank's tensors, in
    place (a broadcast per tensor over the dp group); returns
    ``tensors``.  Ranks build their state from one
    seed or one checkpoint, so this only guards against drift."""
    if mesh is not None:
        src = (0 if mesh.group is None
               else dist.get_global_rank(mesh.group, 0))
        for t in tensors:
            dist.broadcast(t.detach(), src=src, group=mesh.group)
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
