"""Process grids for domain decomposition (port of
:mod:`mi_fieldcalc_tpu.parallel.mesh`, ``mesh.py:30-146``).

Axis convention, as in the JAX package:

* ``"lev"`` — batch parallelism over the leading dim (vertical level,
  ensemble member); no communication.
* ``"gy"`` / ``"gx"`` — spatial decomposition of the trailing ``(ny, nx)``
  grid axes; stencils exchange halos along them
  (:mod:`.halo`).

One process runs one device.  A :class:`ProcessGrid` takes the place of the
JAX ``Mesh``: the ``(lev, gy, gx)`` shape, this rank's coordinates in it
(rank ``(il * gy + iy) * gx + ix``), its device, and the process group of
its ``lev`` slab, over which the operators that decide on a whole field
reduce.  Halo exchanges are point-to-point between global ranks.

Each rank holds its own block of every array and gets its own block back.
A dimension of ``n`` points over ``parts`` ranks is cut so that the first
``n % parts`` blocks hold one point more (:func:`block`); the TPU's padded
layout does not exist here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

__all__ = ["grid_mesh", "partition_spec", "factor_devices",
           "factor_devices_for_grid", "ProcessGrid", "block"]

AXES = ("lev", "gy", "gx")


def block(n: int, parts: int, i: int) -> Tuple[int, int]:
    """``(start, stop)`` of block ``i`` of ``n`` points cut into ``parts``:
    the first ``n % parts`` blocks hold one point more."""
    q, r = divmod(n, parts)
    start = i * q + min(i, r)
    return start, start + q + (1 if i < r else 0)


def factor_devices(n: int) -> Tuple[int, int, int]:
    """Factor ``n`` devices into a (lev, gy, gx) mesh shape: all devices on
    a square-ish (gy, gx) spatial grid (least halo surface per shard)."""
    gy = int(n ** 0.5)
    while n % gy:
        gy -= 1
    return (1, gy, n // gy)


def factor_devices_for_grid(ny: int, nx: int, n: int,
                            radius: int = 2) -> Tuple[int, int, int]:
    """Factor ``n`` devices into the (1, gy, gx) spatial mesh whose largest
    shard, with its ``radius`` halo ring, holds the fewest points.

    The JAX function scores each split by the shard's footprint in the
    TPU's padded layout (8-row, 128-lane tiles).  That layout does not
    exist in the port: a shard is its logical block, so the score is the
    largest block's rows and columns, each plus ``2 * radius`` halo points,
    which counts the bytes a shard streams.  Splits that leave a shard
    fewer than ``2 * radius`` rows or columns, which the overlap path's
    seam strips need (:mod:`.fused`), are taken only where no split
    avoids it.  Ties break toward fewer gx shards, as in the JAX
    function."""
    candidates = []
    for gx in range(1, n + 1):
        if n % gx:
            continue
        gy = n // gx
        if gy > ny or gx > nx:
            continue
        rows, cols = -(-ny // gy), -(-nx // gx)
        ok = ((gy == 1 or ny // gy >= 2 * radius)
              and (gx == 1 or nx // gx >= 2 * radius))
        score = (rows + 2 * radius) * (cols + 2 * radius)
        candidates.append(((not ok, score, gx), (1, gy, gx)))
    if not candidates:
        raise ValueError(f"cannot decompose {ny}x{nx} over {n} devices")
    return min(candidates)[1]


@dataclasses.dataclass(frozen=True)
class ProcessGrid:
    """This process's place in a ``(lev, gy, gx)`` grid of processes."""

    shape: Tuple[int, int, int]
    coords: Tuple[int, int, int]
    device: torch.device
    #: the process group of this rank's ``lev`` slab (the ranks that share
    #: its il); ``None`` in a single process without torch.distributed
    group: Optional[object] = None

    @property
    def rank(self) -> int:
        return self.rank_at(*self.coords)

    def rank_at(self, il: int, iy: int, ix: int) -> int:
        """The global rank at grid coordinates ``(il, iy, ix)``."""
        _, gy, gx = self.shape
        return (il * gy + iy) * gx + ix

    def neighbours(self, axis: str) -> Tuple[Optional[int], Optional[int]]:
        """The global ranks before and after this one along ``"gy"`` or
        ``"gx"``; ``None`` at a physical edge."""
        k = AXES.index(axis)
        c = list(self.coords)
        out = []
        for step in (-1, 1):
            i = c[k] + step
            if 0 <= i < self.shape[k]:
                out.append(self.rank_at(*(c[:k] + [i] + c[k + 1:])))
            else:
                out.append(None)
        return out[0], out[1]

    def block(self, axis: str, n: int) -> Tuple[int, int]:
        """``(start, stop)`` of this rank's block of ``n`` points along
        ``axis``."""
        k = AXES.index(axis)
        return block(n, self.shape[k], self.coords[k])


def grid_mesh(mesh_shape: Optional[Sequence[int]] = None,
              grid_shape: Optional[Tuple[int, int]] = None,
              device=None) -> ProcessGrid:
    """This process's :class:`ProcessGrid` over every process of the
    default process group (one process when torch.distributed is not
    initialised).

    ``mesh_shape`` defaults to all processes on a square-ish (gy, gx)
    spatial grid with lev = 1; pass the global ``grid_shape`` ``(ny, nx)``
    instead to take :func:`factor_devices_for_grid`'s split.  A shorter
    shape drops axes from the front of ``("lev", "gy", "gx")``, as the JAX
    function does: ``(2, 4)`` is a (gy, gx) spatial grid, ``(4,)`` a gx
    split.  Every rank must
    call this with the same arguments: it builds the process group of every
    ``lev`` slab on every rank, in the same order.  ``device`` defaults to
    the one :func:`.distributed.initialize` chose, else the current CUDA
    device."""
    import torch.distributed as dist

    from . import distributed

    multi = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if multi else 1
    rank = dist.get_rank() if multi else 0
    if mesh_shape is None:
        mesh_shape = (factor_devices_for_grid(*grid_shape, n)
                      if grid_shape is not None else factor_devices(n))
    elif grid_shape is not None:
        raise ValueError("pass mesh_shape or grid_shape, not both")
    mesh_shape = tuple(int(s) for s in mesh_shape)
    if not 1 <= len(mesh_shape) <= 3 or min(mesh_shape) < 1:
        raise ValueError(f"bad mesh shape {mesh_shape}")
    shape = (1,) * (3 - len(mesh_shape)) + mesh_shape
    if shape[0] * shape[1] * shape[2] != n:
        raise ValueError(f"mesh shape {mesh_shape} != {n} processes")
    if device is None:
        device = distributed.device() or torch.device(
            "cuda", torch.cuda.current_device())
    device = torch.device(device)
    lev, gy, gx = shape
    coords = (rank // (gy * gx), rank // gx % gy, rank % gx)
    group = None
    if multi:
        for il in range(lev):
            g = dist.new_group(list(range(il * gy * gx, (il + 1) * gy * gx)))
            if il == coords[0]:
                group = g
        # one collective on every rank brings the communicator up before
        # the first point-to-point exchange
        dist.all_reduce(torch.zeros(1, device=device))
    return ProcessGrid(shape, coords, device, group)


def partition_spec(ndim: int, mesh: ProcessGrid = None) -> tuple:
    """The grid axis each dim of an ``ndim`` framework array is cut along
    (``None``: not cut), as the JAX ``PartitionSpec``: ``[..., ny, nx]``
    grids cut their trailing axes over (gy, gx) and a leading axis (3-D
    and up) over lev; 1-D arrays are per-level coefficient vectors and cut
    over lev; scalars are whole on every rank.  ``mesh`` is accepted for
    the JAX signature; every grid has all three axes."""
    del mesh
    if ndim == 0:
        return ()
    if ndim == 1:
        return ("lev",)
    spec = [None] * ndim
    spec[-2], spec[-1] = "gy", "gx"
    if ndim > 2:
        spec[0] = "lev"
    return tuple(spec)
