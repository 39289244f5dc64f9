"""Multi-process bring-up: ``torch.distributed`` initialization, a global
shard mesh, and the two collectives a decomposition needs across
processes.

Counterpart of ``pde_solver_tpu.parallel.distributed``.  As in the JAX
package, the sharded solvers (``parallel.shard``, ``parallel.shard_mg``)
run in one process, over that process's devices; this module brings
several processes up and carries a sum and a neighbour shift across them:

* :func:`initialize_distributed` runs ``init_process_group`` over TCP
  (gloo for a CPU device, NCCL for CUDA) from its arguments or the
  environment, once;
* :func:`global_device_mesh` places this process's shards at rank × local
  count on the global axis;
* :func:`psum` sums a sharded value: a local sum in shard order, then
  ``all_reduce``;
* :func:`ppermute_ring` shifts the shards one step along the global ring:
  neighbours inside a process by copy, across the process boundary by
  ``batch_isend_irecv``.

Environment (read when the arguments are not given):
  PDE_TPU_COORDINATOR   "host:port" of process 0
  PDE_TPU_NUM_PROCESSES total process count
  PDE_TPU_PROCESS_ID    this process's rank
"""

from __future__ import annotations

import datetime
import os
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from pde_solver_tpu_torch.parallel.shard import ShardMesh, Sharded, device_mesh
from pde_solver_tpu_torch.utils.observability import get_logger

_INITIALIZED = False
_TIMEOUT = datetime.timedelta(seconds=300)


def _multi() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> bool:
    """Idempotent ``torch.distributed.init_process_group``.

    Returns True when more than one process is active after the call.
    With neither a coordinator nor a process count (arguments or
    environment) nothing is initialized: one process needs nothing from
    this module."""
    global _INITIALIZED
    if _INITIALIZED or dist.is_initialized():
        _INITIALIZED = True
        return _multi()
    coordinator_address = coordinator_address or os.environ.get(
        "PDE_TPU_COORDINATOR")
    env_np = os.environ.get("PDE_TPU_NUM_PROCESSES")
    env_pid = os.environ.get("PDE_TPU_PROCESS_ID")
    if num_processes is None and env_np:
        num_processes = int(env_np)
    if process_id is None and env_pid:
        process_id = int(env_pid)
    if coordinator_address is None and num_processes is None:
        _INITIALIZED = True
        return False
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            "initialize_distributed needs the coordinator address, the "
            "process count and this process's rank (arguments or "
            "PDE_TPU_COORDINATOR / PDE_TPU_NUM_PROCESSES / "
            "PDE_TPU_PROCESS_ID)")
    from pde_solver_tpu_torch.config import get_config

    dev = torch.device(get_config().device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=_TIMEOUT)
    _INITIALIZED = True
    get_logger().info("torch.distributed initialized (%s): process %d/%d",
                      backend, dist.get_rank(), dist.get_world_size())
    return _multi()


class GlobalMesh(NamedTuple):
    """This process's shards on the global axis ``shard_x``: local shard k
    is global shard ``offset + k`` of ``size``."""

    local: ShardMesh
    rank: int
    world: int
    offset: int
    size: int


def global_device_mesh(n_local: Optional[int] = None) -> GlobalMesh:
    """The global 1-D mesh: this process's first ``n_local`` devices (all
    by default) at rank × local count, every process holding as many."""
    local = device_mesh(n_local)
    rank = dist.get_rank() if dist.is_initialized() else 0
    world = dist.get_world_size() if dist.is_initialized() else 1
    return GlobalMesh(local, rank, world, rank * local.size,
                      world * local.size)


def psum(x: Sharded) -> torch.Tensor:
    """Σ of every entry of every shard of every process: the local shards
    summed in order on the first shard's device, then ``all_reduce``."""
    total = None
    for p in x.parts:
        t = p.sum()
        total = t if total is None else total + t.to(total.device)
    if _multi():
        dist.all_reduce(total)
    return total


def ppermute_ring(x: Sharded) -> Sharded:
    """Global shard j receives the block of global shard j − 1 (mod the
    global count): a copy between this process's shards, a send and a
    receive across the process boundary (the last local block goes to the
    next rank, the previous rank's last block arrives at shard 0)."""
    parts = x.parts
    out = [None] + [parts[k - 1].to(parts[k].device)
                    for k in range(1, len(parts))]
    if not _multi():
        out[0] = parts[-1].to(parts[0].device)
        return Sharded(out, x.mesh)
    rank, world = dist.get_rank(), dist.get_world_size()
    recv = torch.empty_like(parts[0])
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, parts[-1].contiguous(), (rank + 1) % world),
        dist.P2POp(dist.irecv, recv, (rank - 1) % world)])
    for req in reqs:
        req.wait()
    out[0] = recv
    return Sharded(out, x.mesh)
