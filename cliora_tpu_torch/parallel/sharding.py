"""Tensor parallelism (Megatron specs over the ``mp`` group) and ZeRO-1.

**Tensor parallelism.**  Counterpart of ``param_specs`` / ``shard_params``
(cliora_tpu/parallel/sharding.py:53-110).  The JAX package gives GSPMD a
partition spec per weight and lets it place the collectives; here each
rank of an ``mp`` group (parallel/mesh.py) holds its slice of the same
weights, and the collectives are placed by hand at the few points where
sharded work begins and ends:

* compose ``fc0`` column-parallel (its ``(D, 2D)`` weight and its bias
  cut on dim 0), ``fc1`` row-parallel (weight cut on its input dim):
  one all-reduce per compose (ops/core.py ``compose_mlp``);
* the bilinear scores' ``mat (D, D)`` cut on its output dim: each rank
  scores its slice of the projection, one all-reduce of the partial
  scores (ops/core.py ``bilinear``);
* the embedding table ``(V, E)``, the embed projections and the
  reconstruction projection ``(D, E)`` cut on E, the image encoder's
  ``(D, F)`` maps on F: each rank projects its feature slice and the
  partial projections are all-reduced (models/diora.py,
  training/losses.py);
* everything else replicated.

Two autograd functions mark those points: :func:`copy_to_mp` (forward
identity, backward all-reduce: where a whole tensor enters sharded work,
every rank's partial gradient of it is summed) and :func:`reduce_from_mp`
(forward all-reduce of partial results, backward identity).  They take
plain tensors, so the hand kernels and the chart's index gathers run as
they do without a group, and the collectives capture in a CUDA graph as
the dp ones do.  A leaf whose dim the group does not divide is
replicated with a warning, as in the JAX package; the dims that are cut
are the same for every leaf of a kind (D, E or F), which
:class:`TensorParallel` names.

**ZeRO-1.**  Counterpart of ``zero1_opt_state`` (cliora_tpu/parallel/
sharding.py:112-161).  The JAX package places each Adam ``mu``/``nu`` leaf
sharded over ``dp`` and GSPMD derives the dataflow: reduce-scatter the
gradient into the update, update the local shard, all-gather the
parameters.  Here that dataflow is written out over one flat buffer of
the trainable parameters, cut into ``size`` equal slices (the last padded
with zeros):

1. the flat gradient is reduce-scattered: each rank gets the group's sum
   over its slice;
2. the global clip norm comes from one all-reduced scalar, the squares
   of each rank's slice summed parameter by parameter;
3. Adam (``torch.optim.Adam``, the trainer's settings) updates the
   rank's slice of the parameters;
4. the slices are all-gathered into the flat buffer, which the model's
   parameters are views of.

Every step is elementwise or a collective, so it captures in a CUDA
graph, and the slices are even whatever the parameter shapes (one
10,000 x 1,024 embedding table is most of the bench model's trainable
parameters, so whole-tensor partitions would be lopsided).  With one
rank the update is the replicated one, bit for bit.  Under tensor
parallelism the flat buffer holds the rank's mp-local parameters (its
slices of the cut ones) and is cut over the dp group, as an mp-sharded
JAX leaf gains a dp component; the squares of the cut parameters are
summed over the mp group too.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from cliora_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather_rows,
    all_reduce_,
    reduce_scatter_rows,
)

MP_AXIS = "mp"


def _spec_for(keys) -> tuple:
    """The partition spec of a parameter path (a tuple of keys), as the
    JAX ``PartitionSpec``'s entries: ``MP_AXIS`` on the cut dim, ``None``
    elsewhere, ``()`` for a replicated leaf."""
    if len(keys) >= 2:
        parent, name = keys[-2], keys[-1]
        if parent == "fc0":
            # column-parallel: torch layout (out, in) -> cut out
            return (MP_AXIS, None) if name == "w" else (MP_AXIS,)
        if parent == "fc1" and name == "w":
            return (None, MP_AXIS)          # row-parallel: cut in
        if parent in ("inside_score", "outside_score") and name == "mat":
            return (None, MP_AXIS)
        if parent == "embed" and name in ("embeddings", "mat", "mat1"):
            return (None, MP_AXIS)          # (V, E) / (D, E): cut E
        if parent == "reconstruct" and name == "mat":
            return (None, MP_AXIS)          # (D, E): cut E
        if (parent in ("fc", "fc_vis") and name == "w"
                and keys[0] == "img_encoder"):
            return (None, MP_AXIS)          # (D, F): cut F
    return ()


def _map_with_path(fn, tree, keys=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, keys + (k,)) for k, v in tree.items()}
    return fn(keys, tree)


def param_specs(params):
    """A tree of partition specs (tuples, :func:`_spec_for`) mirroring the
    nested parameter dict ``params``."""
    return _map_with_path(lambda keys, _: _spec_for(keys), params)


def shard_dims(params, mp: int):
    """A tree mirroring ``params`` of the dim each leaf is cut on over an
    ``mp``-rank group, or ``None`` (replicated): its spec's, unless that
    dim is not divisible by ``mp``, which replicates the leaf with a
    ``UserWarning`` (cliora_tpu/parallel/sharding.py:88-110)."""
    def dim(keys, x):
        spec = _spec_for(keys)
        if mp == 1 or MP_AXIS not in spec:
            return None
        d = spec.index(MP_AXIS)
        if x.shape[d] % mp:
            warnings.warn(f"param {'/'.join(keys)}: dim {d} ({x.shape[d]}) "
                          f"not divisible by mp={mp}; replicating",
                          stacklevel=3)
            return None
        return d

    return _map_with_path(dim, params)


def mp_slice(x: torch.Tensor, mesh: Mesh, dim: int = -1) -> torch.Tensor:
    """The rank's block of ``x`` along ``dim`` (``mesh.mp`` equal blocks)."""
    n = x.shape[dim] // mesh.mp
    return x.narrow(dim, mesh.mp_rank * n, n)


def shard_params(mesh: Mesh, params, dims=None):
    """This rank's slices of the whole parameters ``params`` per
    :func:`shard_dims` (``dims``, when given), as new contiguous tensors;
    replicated leaves are copied whole."""
    if dims is None:
        dims = shard_dims(params, mesh.mp)

    def take(x, d):
        if isinstance(x, dict):
            return {k: take(x[k], d[k]) for k in x}
        x = torch.as_tensor(x)
        return (x if d is None else mp_slice(x, mesh, d)).contiguous().clone()

    return take(params, dims)


def gather_mp(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """The whole tensor of which every rank of the mp group holds its
    block along ``dim`` (an all-gather; no gradient)."""
    x = x.detach().movedim(dim, 0).contiguous()
    out = x.new_empty((mesh.mp * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=mesh.mp_group)
    return out.movedim(0, dim).contiguous()


def gather_params(mesh: Mesh, params, dims):
    """The whole parameters from every rank's slices (the inverse of
    :func:`shard_params`): a collective over the mp group."""
    if isinstance(params, dict):
        return {k: gather_params(mesh, params[k], dims[k]) for k in params}
    return (params.detach() if dims is None
            else gather_mp(params, mesh, dims))


class _CopyToMp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.mesh.mp_group)
        return g, None


class _ReduceFromMp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        # out of place: ``x`` may be a view made by another autograd
        # function, which must not be written in place
        out = x.contiguous().clone()
        dist.all_reduce(out, group=mesh.mp_group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_mp(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """``x`` where it enters sharded work: the forward is the identity,
    the backward sums every mp rank's partial gradient (an all-reduce).
    ``mesh=None``: ``x``."""
    return x if mesh is None else _CopyToMp.apply(x, mesh)


def reduce_from_mp(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The mp group's sum of the partial results ``x`` (an all-reduce);
    the backward hands the whole gradient to every rank's part.
    ``mesh=None``: ``x``."""
    return x if mesh is None else _ReduceFromMp.apply(x, mesh)


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """The mp group each kind of cut weight is split over, or ``None``
    where that kind stays whole: ``hidden`` (the compose's ``fc0``/``fc1``
    and the score matrices, cut on D), ``embed`` (the embedding table and
    the embed and reconstruction projections, cut on E), ``regions`` (the
    image encoder's maps, cut on F)."""
    hidden: Optional[Mesh] = None
    embed: Optional[Mesh] = None
    regions: Optional[Mesh] = None


NO_TP = TensorParallel()


def tensor_parallel(cfg, mesh: Optional[Mesh]) -> TensorParallel:
    """The :class:`TensorParallel` of a model config on ``mesh``:
    :data:`NO_TP` without an mp group; a kind whose dim ``mesh.mp`` does
    not divide stays whole (:func:`shard_dims` replicates its leaves)."""
    if mesh is None or mesh.mp == 1:
        return NO_TP

    def over(n):
        return mesh if n % mesh.mp == 0 else None

    return TensorParallel(hidden=over(cfg.size), embed=over(cfg.input_size),
                          regions=over(cfg.obj_feat_size))


class Zero1:
    """The flat trainable parameters and Adam over this rank's slice.

    ``params``: the trainable parameters in the optimizer's order (under
    tensor parallelism the rank's slices of the cut ones, which ``cut``
    flags); they become views of :attr:`flat`.  ``mesh=None`` is a group
    of one."""

    def __init__(self, params: List[torch.Tensor], tc, mesh: Optional[Mesh],
                 capturable: bool, cut: Optional[List[bool]] = None):
        self.mesh = mesh
        # the mp group whose ranks hold other slices of the cut parameters
        self.mp_mesh = (mesh if mesh is not None and mesh.mp > 1
                        and any(cut or ()) else None)
        self.size = 1 if mesh is None else mesh.size
        self.rank = 0 if mesh is None else mesh.rank
        self.numels = [p.numel() for p in params]
        self.numel = sum(self.numels)
        self.slice_len = -(-self.numel // self.size)
        # the rank's entries that are not padding: DTensor's uneven
        # Shard(0) chunk of the unpadded vector (training/dist_ckpt.py)
        self.valid_len = max(0, min(self.numel - self.rank * self.slice_len,
                                    self.slice_len))
        device = params[0].device
        self.flat = torch.zeros(self.slice_len * self.size, device=device)
        off = 0
        with torch.no_grad():
            for p, n in zip(params, self.numels):
                self.flat[off:off + n].copy_(p.reshape(-1))
                p.data = self.flat[off:off + n].view_as(p)
                off += n
        # the pieces of the rank's slice that belong to one parameter
        # each (and the padding), so that the clip norm adds its squares
        # in the order the replicated step does
        lo = self.rank * self.slice_len
        hi = lo + self.slice_len
        self.pieces, self.piece_cut, off = [], [], 0
        cut = list(cut or [False] * len(params)) + [False]
        for n, c in zip(self.numels + [self.flat.numel() - self.numel], cut):
            a, b = max(off, lo), min(off + n, hi)
            if b > a:
                self.pieces.append(b - a)
                self.piece_cut.append(c)
            off += n
        self.master = self.local(self.flat).clone()
        self.optimizer = torch.optim.Adam(
            [self.master], lr=tc.lr, betas=(0.9, 0.999), eps=1e-8,
            capturable=capturable)
        self.optimizer.state[self.master] = {
            "step": (torch.zeros((), dtype=torch.float32, device=device)
                     if capturable else torch.tensor(0.0)),
            "exp_avg": torch.zeros_like(self.master),
            "exp_avg_sq": torch.zeros_like(self.master),
        }

    @property
    def state(self):
        return self.optimizer.state[self.master]

    def local(self, flat: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a flat (padded) vector."""
        return flat[self.rank * self.slice_len:
                    (self.rank + 1) * self.slice_len]

    def _flatten(self, tensors) -> torch.Tensor:
        pad = self.flat.numel() - self.numel
        parts = [torch.as_tensor(t).to(self.flat.device).reshape(-1)
                 for t in tensors]
        if pad:
            parts.append(self.flat.new_zeros(pad))
        return torch.cat(parts)

    def step(self, grads: List[torch.Tensor], accum_steps: int,
             max_norm: float) -> None:
        """Reduce-scatter, clip by the global norm, Adam on the slice,
        all-gather (the replicated step's order of operations)."""
        g = self._flatten(grads)
        g = self.local(g) if self.mesh is None else reduce_scatter_rows(
            g, self.mesh)
        if accum_steps > 1:
            g = g / accum_steps
        squares = [torch.sum(torch.square(piece))
                   for piece in g.split(self.pieces)]
        if self.mp_mesh is None:
            sq = sum(squares)
            if self.mesh is not None:
                sq = all_reduce_(sq, self.mesh)
        else:
            # the cut parameters' squares are summed over the mp group too,
            # the replicated ones counted once
            zero = g.new_zeros(())
            both = all_reduce_(torch.stack([
                sum((x for x, c in zip(squares, self.piece_cut) if not c),
                    zero),
                sum((x for x, c in zip(squares, self.piece_cut) if c),
                    zero)]), self.mesh)
            cut_sq = both[1].clone()
            dist.all_reduce(cut_sq, group=self.mp_mesh.mp_group)
            sq = both[0] + cut_sq
        norm = torch.sqrt(sq)
        keep = norm < max_norm
        self.master.grad = torch.where(keep, g, g / norm * max_norm)
        self.optimizer.step()
        self._gather()

    def _gather(self) -> None:
        if self.mesh is None:
            self.local(self.flat).copy_(self.master)
        else:
            # out of place: the gather's input is not a view of its output
            self.flat.copy_(all_gather_rows(self.master, self.mesh))

    def params_changed(self) -> None:
        """Take the slice from :attr:`flat` after the parameters were
        written in place (a loaded checkpoint)."""
        with torch.no_grad():
            self.master.copy_(self.local(self.flat))

    def full_state(self) -> Tuple[int, List[torch.Tensor], List[torch.Tensor]]:
        """``(count, mu, nu)``: Adam's count and each parameter's full
        ``mu`` and ``nu`` (flat, in parameter order), gathered from every
        rank's slice -- a collective."""
        st = self.state
        out = []
        for key in ("exp_avg", "exp_avg_sq"):
            full = (st[key] if self.mesh is None
                    else all_gather_rows(st[key], self.mesh))
            out.append(list(full[:self.numel].split(self.numels)))
        return int(st["step"]), out[0], out[1]

    @torch.no_grad()
    def install(self, count: int, mu, nu) -> None:
        """Write the full ``mu`` / ``nu`` of each parameter (any array
        of its size, in parameter order): the rank keeps its slice."""
        st = self.state
        st["exp_avg"].copy_(self.local(self._flatten(mu)))
        st["exp_avg_sq"].copy_(self.local(self._flatten(nu)))
        st["step"].fill_(float(count))

    @torch.no_grad()
    def install_local(self, count: int, mu, nu) -> None:
        """Write this rank's entries of ``mu`` / ``nu`` (its slice without
        the padding, :attr:`valid_len` long)."""
        st = self.state
        for key, src in (("exp_avg", mu), ("exp_avg_sq", nu)):
            st[key].zero_()
            st[key][:self.valid_len].copy_(src)
        st["step"].fill_(float(count))
