"""ZeRO-1: Adam's state and update sharded over the data-parallel group.

Counterpart of ``zero1_opt_state`` (cliora_tpu/parallel/sharding.py:
112-161).  The JAX package places each Adam ``mu``/``nu`` leaf sharded
over ``dp`` and GSPMD derives the dataflow: reduce-scatter the gradient
into the update, update the local shard, all-gather the parameters.
Here that dataflow is written out over one flat buffer of the trainable
parameters, cut into ``size`` equal slices (the last padded with zeros):

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
rank the update is the replicated one, bit for bit.

Tensor parallelism (``param_specs``, ``shard_params``,
cliora_tpu/parallel/sharding.py:53-110) is not ported (ROADMAP A8).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from cliora_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather_rows,
    all_reduce_,
    reduce_scatter_rows,
)


class Zero1:
    """The flat trainable parameters and Adam over this rank's slice.

    ``params``: the trainable parameters in the optimizer's order; they
    become views of :attr:`flat`.  ``mesh=None`` is a group of one."""

    def __init__(self, params: List[torch.Tensor], tc, mesh: Optional[Mesh],
                 capturable: bool):
        self.mesh = mesh
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
        self.pieces, off = [], 0
        for n in self.numels + [self.flat.numel() - self.numel]:
            a, b = max(off, lo), min(off + n, hi)
            if b > a:
                self.pieces.append(b - a)
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
        sq = sum(torch.sum(torch.square(piece))
                 for piece in g.split(self.pieces))
        if self.mesh is not None:
            sq = all_reduce_(sq, self.mesh)
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
