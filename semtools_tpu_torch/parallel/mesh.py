"""The serving mesh and corpus sharding.

Counterpart of ``semtools_tpu/parallel/mesh.py``. The one parallelism axis is
data parallelism over corpus rows: the [N, D] matrix is cut into equal row
shards, one per mesh device, every shard is scanned, and the per-shard
candidates are merged (:mod:`semtools_tpu_torch.parallel.scan`).

JAX's single-controller ``Mesh`` becomes :class:`Mesh`, an ordered tuple of
``torch.device`` held by one process: every card of the process
(``torch.cuda.device_count()``) or the CPU, each repeated
``SEMTOOLS_TORCH_VIRTUAL_DEVICES`` times (default 1). Repeats are the port's
counterpart of XLA's ``--xla_force_host_platform_device_count``: they let one
card or the CPU run a mesh of several shards, for the parity tests and the
smoke test. They are not a serving option: the store multiplies its byte
budget by the mesh size, so repeats on one card overstate its memory by the
repeat count. A process reads the variable
once (:func:`virtual_devices`) and keeps that mesh: a request forwarded to a
daemon cannot re-shape the daemon's mesh.

Under ``torch.distributed`` (:mod:`semtools_tpu_torch.parallel.multihost`)
the global mesh is every rank's devices in rank order: rank r holds global
shards ``[r * L, (r + 1) * L)`` of ``size = world * L``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

VIRTUAL_ENV = "SEMTOOLS_TORCH_VIRTUAL_DEVICES"

# The repeat count, fixed at its first read in this process (None: unread).
_VIRTUAL: Optional[int] = None


def virtual_devices() -> int:
    """Shards per physical device: ``SEMTOOLS_TORCH_VIRTUAL_DEVICES`` as
    this process first read it (a malformed or non-positive value is 1)."""
    global _VIRTUAL
    if _VIRTUAL is None:
        try:
            _VIRTUAL = max(1, int(os.environ.get(VIRTUAL_ENV, "1") or 1))
        except ValueError:
            _VIRTUAL = 1
    return _VIRTUAL


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: this process's shard devices, in order (repeats of one
    physical device stand next to each other), and its place among
    ``world`` processes."""

    devices: Tuple[torch.device, ...]
    rank: int = 0
    world: int = 1

    @property
    def local(self) -> int:
        return len(self.devices)

    @property
    def size(self) -> int:
        return self.local * self.world

    @property
    def offset(self) -> int:
        """Global index of this process's first shard."""
        return self.rank * self.local

    @property
    def first(self) -> torch.device:
        return self.devices[0]


def _physical(device: torch.device) -> List[torch.device]:
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device(device.type)]


def _world() -> Tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def mesh_size(device: Union[str, torch.device, None] = None) -> int:
    """Shards of :func:`corpus_mesh` on ``device`` (a name is not resolved:
    a tier report must not create a CUDA context)."""
    dev = torch.device(device if device is not None
                       else os.environ.get("SEMTOOLS_TORCH_DEVICE") or "cuda")
    return max(1, len(_physical(dev))) * virtual_devices() * _world()[1]


def corpus_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """The mesh over every physical device of ``device``'s type (CUDA: every
    card; the CPU: one), each :func:`virtual_devices` times; the first
    ``n_devices`` shards of them when given (one process only). Raises when
    fewer are there: a mesh is never quietly smaller than asked."""
    from semtools_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(device)
    devices = tuple(d for d in _physical(dev) for _ in range(virtual_devices()))
    rank, world = _world()
    if n_devices is not None:
        if world > 1:
            if n_devices != len(devices) * world:
                raise ValueError(f"a {world}-process mesh has {len(devices) * world} "
                                 f"shards, not {n_devices}")
        elif not 1 <= n_devices <= len(devices):
            raise ValueError(f"{n_devices} shards asked for; {dev.type} offers "
                             f"{len(devices)} ({VIRTUAL_ENV}={virtual_devices()})")
        else:
            devices = devices[:n_devices]
    return Mesh(devices, rank, world)


def bucket_rows(n: int, n_dev: int) -> int:
    """Padded row count for a mesh-sharded serving corpus.

    A multiple of the mesh size, rounded up in coarse steps (~n/16, min
    256/device) so small corpus mutations keep the padded SHAPE — the
    sharded scan executables key on shapes (n_true is traced), so a
    stable shape means no retrace on the first query after an upsert.
    Worst-case waste is ~6% zero rows, masked by n_true.
    """
    step = max(n_dev * 256, 1 << max(max(n, 1).bit_length() - 5, 0))
    step = ((step + n_dev - 1) // n_dev) * n_dev
    return ((n + step - 1) // step) * step


class ShardedRows:
    """Equal row shards of an [n_local * mesh.size, ...] matrix. This
    process holds the shards of its mesh devices as views of one buffer per
    physical device, so a write to rows shared by several virtual shards is
    one copy. The row-range methods mirror the tensor methods the store's
    patch uses (``narrow``, ``index_select``, ``index_copy_``); they reach
    the rows this process holds."""

    def __init__(self, mesh: Mesh, n_local: int, tail: Tuple[int, ...], dtype: torch.dtype,
                 fill=None):
        self.mesh, self.n_local, self.dtype = mesh, n_local, dtype
        self.shape = (n_local * mesh.size, *tail)
        self.parts: List[Tuple[int, torch.Tensor]] = []  # (first global row, buffer)
        self.shards: List[torch.Tensor] = []
        j = 0
        while j < mesh.local:
            dev, run = mesh.devices[j], 1
            while j + run < mesh.local and mesh.devices[j + run] == dev:
                run += 1
            buf = torch.empty((run * n_local, *tail), dtype=dtype, device=dev)
            if fill is not None:
                buf.fill_(fill)
            self.parts.append(((mesh.offset + j) * n_local, buf))
            self.shards += [buf[r * n_local:(r + 1) * n_local] for r in range(run)]
            j += run

    @property
    def device(self) -> torch.device:
        return self.mesh.first

    def element_size(self) -> int:
        return self.parts[0][1].element_size()

    def numel(self) -> int:
        return int(np.prod(self.shape))

    def pieces(self, start: int, stop: int):
        """(buffer view, first global row, stop) of each held part of rows
        [start, stop)."""
        for g0, buf in self.parts:
            a, b = max(start, g0), min(stop, g0 + buf.shape[0])
            if a < b:
                yield buf[a - g0:b - g0], a, b

    def narrow(self, dim: int, start: int, length: int) -> "RowRange":
        if dim != 0:
            raise ValueError("ShardedRows narrows rows only")
        return RowRange(self, start, start + length)

    def index_select(self, dim: int, idx: torch.Tensor) -> torch.Tensor:
        """Rows ``idx`` (global) on the mesh's first device."""
        idx = idx.to(self.device)
        out = torch.empty((idx.shape[0], *self.shape[1:]), dtype=self.dtype, device=self.device)
        for g0, buf in self.parts:
            sel = (idx >= g0) & (idx < g0 + buf.shape[0])
            rows = (idx[sel] - g0).to(buf.device)
            out[sel] = buf.index_select(0, rows).to(self.device)
        return out

    def index_copy_(self, dim: int, idx: torch.Tensor, rows: torch.Tensor) -> "ShardedRows":
        """Write ``rows`` at global rows ``idx``."""
        for g0, buf in self.parts:
            sel = ((idx >= g0) & (idx < g0 + buf.shape[0])).to(rows.device)
            buf.index_copy_(0, (idx.to(rows.device)[sel] - g0).to(buf.device),
                            rows[sel].to(buf.device))
        return self


class RowRange:
    """Rows [start, stop) of a :class:`ShardedRows`: ``copy_`` and ``fill_``
    as on a tensor slice."""

    def __init__(self, rows: ShardedRows, start: int, stop: int):
        self.rows, self.start, self.stop = rows, start, stop

    def read(self, a: int, b: int) -> torch.Tensor:
        """Rows [start + a, start + b) as one tensor (a view when they lie in
        one buffer)."""
        views = [v for v, _, _ in self.rows.pieces(self.start + a, self.start + b)]
        if len(views) == 1:
            return views[0]
        return torch.cat([v.to(self.rows.device) for v in views])

    def copy_(self, src) -> "RowRange":
        for view, a, b in self.rows.pieces(self.start, self.stop):
            i, j = a - self.start, b - self.start
            view.copy_(src.read(i, j) if isinstance(src, RowRange) else src[i:j])
        return self

    def fill_(self, value) -> "RowRange":
        for view, _, _ in self.rows.pieces(self.start, self.stop):
            view.fill_(value)
        return self


def shard_rows(x: Union[np.ndarray, torch.Tensor], mesh: Mesh, fill=0) -> ShardedRows:
    """``x`` [N, ...] as :class:`ShardedRows` of ``bucket_rows(N)`` rows, the
    padding rows set to ``fill``."""
    n = int(x.shape[0])
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    out = ShardedRows(mesh, bucket_rows(n, mesh.size) // mesh.size, tuple(x.shape[1:]),
                      x.dtype, fill=fill)
    out.narrow(0, 0, n).copy_(x)
    return out


def shard_corpus(corpus, mesh: Mesh, fill=0) -> Tuple[ShardedRows, int]:
    """Place an [N, D] matrix (numpy, or a tensor on any device) row-sharded
    on the mesh: (:class:`ShardedRows`, N). N is padded up to a bucketed
    multiple of the mesh size with ``fill`` rows, which the scans never
    read (they take ``n_true = N``)."""
    return shard_rows(corpus, mesh, fill), int(corpus.shape[0])
