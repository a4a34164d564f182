"""Sharded, async checkpoints via ``torch.distributed.checkpoint`` (DCP).

Counterpart of cliora_tpu/training/orbax_ckpt.py, selected by the train
CLI's ``--ckpt_backend orbax``.  The directory is a DCP checkpoint
(``.metadata`` plus one ``.distcp`` file a writing rank), not an Orbax
one: neither package reads the other's directory, and the ``.npz`` /
``.opt.pkl`` files stay the route between them.

A checkpoint holds a trainer's state:

* ``params/<path>``: every parameter (replicated: one rank writes each);
* ``opt/mu``, ``opt/nu``: Adam's state over the trainable parameters as
  one flat vector in parameter order.  Under ZeRO-1 on more than one rank
  it is a ``DTensor`` sharded over the group, so each rank writes its
  own slice (parallel/sharding.py);
* ``opt/count`` (Adam's count) and ``host_step`` (the dropout stream's
  step).

A restore reads the flat vectors at whatever layout the restoring
trainer has, so a checkpoint written at one world size restores at
another.  Saves and restores are collectives: every rank calls them.

Under tensor parallelism (``mp > 1``) the state is first gathered into
whole tensors (the parameters over the mp group, Adam's moments over the
dp and mp groups) and written as a trainer without a group writes it,
the first rank writing the one copy: a rank's slice of a parameter cut
on its second dim is no contiguous piece of the flat vectors.  The
directory is then the one-process layout, and restores at any
``(dp, mp)``, as the JAX package's Orbax checkpoints of ``--mp`` runs
do (cliora_tpu/training/orbax_ckpt.py).

The state is copied to host memory before a save returns (a blocking
device-to-host copy, ordered after the steps before it), so the next
step or graph replay may write the parameters in place at once; DCP's
collectives run over a gloo group of their own, so an async write on a
background thread never interleaves with the training group's NCCL
collectives (the ``AsyncSaver`` discipline of orbax_ckpt.py:80-115).
"""

from __future__ import annotations

import math
import os
from concurrent.futures import Future
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["save_state", "restore_state", "AsyncSaver", "is_ckpt_dir"]


def is_ckpt_dir(path: str) -> bool:
    """True if ``path`` looks like a DCP checkpoint directory."""
    return os.path.isdir(path) and os.path.exists(
        os.path.join(path, ".metadata"))


def _cpu_group():
    """A gloo group over the world for DCP's collectives (``None``
    without a process group).  A collective: every rank calls it."""
    if not dist.is_initialized():
        return None
    return dist.new_group(backend="gloo")


def _sizes(trainer):
    """The whole element count of each trainable parameter, in order."""
    return [math.prod(trainer.full_shapes[k]) for k, _ in trainer._trainable()]


def _flat_len(trainer) -> int:
    return sum(_sizes(trainer))


def _sharded(trainer) -> bool:
    """Whether each rank writes its own slice of Adam's state (ZeRO-1 on
    more than one rank, without tensor parallelism)."""
    return (trainer.zero1 is not None and trainer.zero1.size > 1
            and trainer._mp() == 1)


def _opt_vector(trainer, local: torch.Tensor, group):
    """The flat ``(N,)`` optimizer vector whose part on this rank is
    ``local``: a ``DTensor`` sharded over ``group`` under ZeRO-1 on more
    than one rank, else ``local`` itself (the whole vector)."""
    if not _sharded(trainer):
        return local
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Shard

    mesh = DeviceMesh.from_group(group, "cpu")
    n = _flat_len(trainer)
    return DTensor.from_local(local, mesh, [Shard(0)], run_check=False,
                              shape=(n,), stride=(1,))


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def _staged_state(trainer, group) -> dict:
    """The trainer's state copied to host memory, as DCP saves it."""
    from cliora_tpu_torch.training.trainer import tree_leaves, tree_paths

    params = trainer.full_params()
    state = {f"params/{k}": _host(p) for k, p in
             zip(tree_paths(params), tree_leaves(params))}
    if trainer._mp() > 1:
        opt = trainer.opt_state()       # whole moments: a collective
        for name in ("mu", "nu"):
            state[f"opt/{name}"] = torch.cat([
                torch.from_numpy(opt[name][k]).reshape(-1)
                for k, _ in trainer._trainable()])
        count = opt["count"]
    elif trainer.zero1 is not None:
        st = trainer.zero1.state
        for key, name in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
            local = _host(st[key][:trainer.zero1.valid_len])
            state[f"opt/{name}"] = _opt_vector(trainer, local, group)
        count = st["step"]
    else:
        trainable = trainer.trainable_params()
        for key, name in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
            state[f"opt/{name}"] = torch.cat([
                _host(trainer.optimizer.state[p][key]).reshape(-1)
                for p in trainable])
        count = trainer.optimizer.state[trainable[0]]["step"]
    state["opt/count"] = torch.tensor(int(count), dtype=torch.int64)
    state["host_step"] = torch.tensor(trainer._host_step, dtype=torch.int64)
    return state


def _template(trainer, group) -> dict:
    """Host tensors shaped like :func:`_staged_state`'s, for DCP to load
    into at this trainer's layout."""
    from cliora_tpu_torch.training.trainer import tree_leaves, tree_paths

    state = {f"params/{k}": torch.empty(trainer.full_shapes[k],
                                        dtype=p.dtype)
             for k, p in zip(tree_paths(trainer.params),
                             tree_leaves(trainer.params))}
    n = _flat_len(trainer)
    for name in ("mu", "nu"):
        if _sharded(trainer):
            local = torch.zeros(trainer.zero1.valid_len)
            state[f"opt/{name}"] = _opt_vector(trainer, local, group)
        else:
            state[f"opt/{name}"] = torch.zeros(n)
    state["opt/count"] = torch.zeros((), dtype=torch.int64)
    state["host_step"] = torch.zeros((), dtype=torch.int64)
    return state


def save_state(path: str, trainer) -> None:
    """Blocking collective save of ``trainer``'s state."""
    import torch.distributed.checkpoint as dcp

    group = _cpu_group()
    dcp.save(_staged_state(trainer, group), checkpoint_id=path,
             process_group=group)


def restore_state(path: str, trainer) -> None:
    """Collective restore into ``trainer``, written in place (captured
    graphs stay valid); resharded to the trainer's layout."""
    import torch.distributed.checkpoint as dcp
    from cliora_tpu_torch.training.trainer import tree_paths

    group = _cpu_group()
    state = _template(trainer, group)
    dcp.load(state, checkpoint_id=path, process_group=group)
    count = int(state["opt/count"])
    trainer.install_state(params={
        k: state[f"params/{k}"] for k in tree_paths(trainer.params)})
    mu, nu = state["opt/mu"], state["opt/nu"]
    if _sharded(trainer):
        trainer.zero1.install_local(count, mu.to_local(), nu.to_local())
    else:
        # whole moments; the trainer keeps its slices of them
        paths = [k for k, _ in trainer._trainable()]
        sizes = _sizes(trainer)
        trainer.install_state(opt_state={
            "count": count,
            "mu": {k: m.view(trainer.full_shapes[k]) for k, m in zip(
                paths, mu.split(sizes))},
            "nu": {k: v.view(trainer.full_shapes[k]) for k, v in zip(
                paths, nu.split(sizes))}})
    trainer.set_step(int(state["host_step"]))


class AsyncSaver:
    """Saves that return once the state is in host memory; the write
    finishes on a background thread while the caller runs eval.  A next
    ``save`` (or ``close``) first waits for the write in flight -- one
    overlapped checkpoint at a time (orbax_ckpt.py:80-115).  Every rank
    makes one and calls ``save`` together."""

    def __init__(self) -> None:
        self._group = _cpu_group()
        self._future: Optional[Future] = None

    def save(self, path: str, trainer) -> None:
        import torch.distributed.checkpoint as dcp

        self.wait()
        self._future = dcp.async_save(
            _staged_state(trainer, self._group), checkpoint_id=path,
            process_group=self._group)

    def wait(self) -> None:
        if self._future is not None:
            future, self._future = self._future, None
            future.result()

    def close(self) -> None:
        self.wait()

    def __enter__(self) -> "AsyncSaver":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
