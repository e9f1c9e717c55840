"""Multi-process bootstrap of the serving mesh, and its collectives.

Counterpart of ``semtools_tpu/parallel/multihost.py``. The sharded scans
(:mod:`semtools_tpu_torch.parallel.scan`) run every shard this process holds
and merge across processes with :func:`all_gather` and :func:`all_max`,
which are identities in a single process. What a multi-process deployment
needs beyond that is the bootstrap:

    from semtools_tpu_torch.parallel import multihost
    multihost.initialize()      # no-op without a coordinator
    mesh = corpus_mesh()        # now spans every process's devices

:func:`initialize` reads the environment the JAX package reads
(``JAX_COORDINATOR_ADDRESS``/``COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``/
``NUM_PROCESSES``, ``JAX_PROCESS_ID``/``PROCESS_ID``), so one deployment
environment drives both packages, and joins ``torch.distributed``: ``nccl``
when the mesh is on CUDA, ``gloo`` on the CPU. Every process holds the whole
host corpus and keeps its own shards of it; every process returns the same
answer.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

_initialized = False


def _env_int(*names) -> Optional[int]:
    for n in names:
        v = os.environ.get(n)
        if v is not None:
            return int(v)
    return None


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
) -> bool:
    """Join the process group when a coordinator is configured; True if
    active. Safe to call unconditionally: without a coordinator it returns
    False and touches nothing. ``device`` picks the backend (default
    ``$SEMTOOLS_TORCH_DEVICE``, else cuda)."""
    global _initialized
    if _initialized:
        return True
    coordinator_address = (coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
                           or os.environ.get("COORDINATOR_ADDRESS"))
    if coordinator_address is None:
        return False
    import torch.distributed as dist

    if dist.is_initialized():
        _initialized = True
        return True
    if num_processes is None:
        num_processes = _env_int("JAX_NUM_PROCESSES", "NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("JAX_PROCESS_ID", "PROCESS_ID")
    if num_processes is None or process_id is None:
        raise ValueError(f"coordinator {coordinator_address} given without the process "
                         "count and id (JAX_NUM_PROCESSES, JAX_PROCESS_ID)")
    dev = torch.device(device if device is not None
                       else os.environ.get("SEMTOOLS_TORCH_DEVICE") or "cuda")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    address = coordinator_address if "://" in coordinator_address \
        else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=address, world_size=num_processes,
                            rank=process_id)
    _initialized = True
    return True


def world() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def all_gather(t: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """``t`` of every process (same shape on each), concatenated along
    ``dim`` in rank order."""
    if world() == 1:
        return t
    import torch.distributed as dist

    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(world())]
    dist.all_gather(parts, t)
    return torch.cat(parts, dim=dim)


def _all_reduce(t: torch.Tensor, op: str) -> torch.Tensor:
    if world() == 1:
        return t
    import torch.distributed as dist

    t = t.clone()
    dist.all_reduce(t, op=getattr(dist.ReduceOp, op))
    return t


def all_max(t: torch.Tensor) -> torch.Tensor:
    """Elementwise maximum of ``t`` over every process."""
    return _all_reduce(t, "MAX")


def all_sum(t: torch.Tensor) -> torch.Tensor:
    """Elementwise sum of ``t`` over every process."""
    return _all_reduce(t, "SUM")
