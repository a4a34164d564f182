"""Multi-process initialization: the ``torch.distributed`` process group.

Counterpart of cliora_tpu/parallel/multihost.py.  The reference launches
one process per GPU with ``torch.distributed.launch`` and meets at
MASTER_ADDR/PORT (reference: cliora/net/trainer.py:528-533,
cliora/scripts/train.py:293-300); the JAX package calls
``jax.distributed.initialize``.  Here the same topology comes from the
caller (the train CLI's ``--master_addr/--master_port/--world_size/
--local_rank``) or from the environment ``torch.distributed.run`` sets
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``), and goes to ``torch.distributed.init_process_group``.

CUDA trainers take NCCL, one rank per card: the rank's card is made the
current device before any CUDA work, and two ranks on one card are
refused with a clear error (NCCL refuses them itself, later and less
clearly).  ``device="cpu"`` takes gloo.  Nothing switches backend on its
own.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value in (None, "") else int(value)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         local_rank: Optional[int] = None,
                         device: str = "cuda") -> bool:
    """Idempotent ``init_process_group``; returns whether a group exists
    after the call.

    A group is made when the caller gives a coordinator
    (``"host:port"``) or more than one process, or when a launcher's
    environment names a coordinator and a world (``MASTER_ADDR`` and
    ``WORLD_SIZE``, as ``torch.distributed.run`` sets them, at any world
    size).  A single process with neither is left alone, and so is
    unrelated environment (a ``WORLD_SIZE`` without ``MASTER_ADDR``).
    Arguments win over the environment.  A topology with a missing
    piece raises ``ValueError`` naming it: torch detects no cluster by
    itself.

    ``device``: ``"cuda"`` (NCCL; the rank's card, ``local_rank`` or
    ``LOCAL_RANK`` or else the rank, becomes the current device first)
    or ``"cpu"`` (gloo).
    """
    if dist.is_initialized():
        return True
    env_addr = os.environ.get("MASTER_ADDR")
    env_port = os.environ.get("MASTER_PORT")
    env_world = _env_int("WORLD_SIZE")
    env_coord = (None if env_addr is None
                 else f"{env_addr}:{env_port or 29500}")
    launched = env_coord is not None and env_world is not None
    multiprocess = (coordinator_address is not None
                    or num_processes not in (None, 1) or launched)
    if not multiprocess:
        return False
    if coordinator_address is None:
        coordinator_address = env_coord
    if num_processes is None:
        num_processes = env_world
    if process_id is None:
        process_id = _env_int("RANK")
    missing = []
    if coordinator_address is None:
        missing.append("coordinator_address / MASTER_ADDR")
    if num_processes is None:
        missing.append("num_processes / WORLD_SIZE")
    if process_id is None:
        missing.append("process_id / RANK")
    if missing:
        raise ValueError(
            "multi-process init: torch does not detect the cluster "
            "topology and these were not provided: " + ", ".join(missing))

    kind = torch.device(device).type
    if kind == "cuda":
        if local_rank is None:
            local_rank = _env_int("LOCAL_RANK")
        if local_rank is None:
            local_rank = process_id
        count = torch.cuda.device_count()
        if not 0 <= local_rank < count:
            raise RuntimeError(
                f"rank {process_id}: local rank {local_rank} has no card "
                f"({count} visible); start at most one rank per card")
        torch.cuda.set_device(local_rank)
        card = torch.device("cuda", local_rank)
        # the communicator is made lazily, after the card check: a
        # communicator over a shared card fails inside NCCL
        dist.init_process_group(
            "nccl", init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id)
        _refuse_shared_cards(card)
        _first_collective(card)
    elif kind == "cpu":
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id)
    else:
        raise ValueError(f"device={device!r}: expected 'cuda' or 'cpu'")
    return True


def _first_collective(card: torch.device) -> None:
    """Make the NCCL communicator now, before any step (a CUDA graph can
    only capture collectives on a communicator that exists)."""
    dist.all_reduce(torch.zeros(1, device=card))


def _refuse_shared_cards(card: torch.device) -> None:
    """Raise when two ranks of the NCCL group sit on one card: each rank
    posts its card's UUID to the group's store and reads the others'."""
    rank, world = dist.get_rank(), dist.get_world_size()
    store = dist.distributed_c10d._get_default_store()
    uuid = str(torch.cuda.get_device_properties(card).uuid)
    store.set(f"cliora_tpu_torch/card/{rank}", uuid)
    owners = {}
    for other in range(world):
        other_uuid = store.get(f"cliora_tpu_torch/card/{other}").decode()
        owners.setdefault(other_uuid, []).append(other)
    shared = [ranks for ranks in owners.values() if len(ranks) > 1]
    if shared:
        raise RuntimeError(
            f"ranks {shared[0]} share one card; NCCL takes one rank per "
            f"card: start at most as many ranks as cards "
            f"(--nproc_per_node), or train on the CPU (--device cpu, "
            f"gloo)")


def is_chief() -> bool:
    """Rank 0 of the group, or the one process without a group."""
    return not dist.is_initialized() or dist.get_rank() == 0
