"""Multi-process runtime: joining the process group, per-rank I/O (port of
:mod:`mi_fieldcalc_tpu.parallel.distributed`, ``distributed.py:35-97``).

Every process runs the same program on one device; ``initialize`` joins
them into the default ``torch.distributed`` process group (NCCL between
cards, gloo when the caller asks for the CPU), and
:func:`..parallel.mesh.grid_mesh` lays them out as a ``(lev, gy, gx)``
grid.  A sharded job on one host with N cards::

    torchrun --nproc-per-node=N job.py

    from mi_fieldcalc_tpu_torch.parallel import distributed, grid_mesh
    distributed.initialize()                  # reads torchrun's environment
    grid = grid_mesh(grid_shape=(ny, nx))
    tk = distributed.local_shard_array(tk_global, grid)   # this rank's block
    ...
    out = derived_fields_fused_sharded(grid, ...)          # its block back
    whole = distributed.gather(out, grid)                  # on every rank

Each rank cuts only its own block, so no rank needs more than its share on
its device; the global numpy arrays stay on the host that reads them.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from ..field import Field

__all__ = ["initialize", "is_initialized", "local_shard_array", "gather",
           "device"]

_state = {"initialized": False, "device": None}


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device: str = "cuda") -> None:
    """Join the default process group; a no-op on a single process.

    With no cluster arguments it reads torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``);
    where there is none it records the single-process no-op, as the JAX
    function does.  ``coordinator_address`` (``"host:port"``),
    ``num_processes`` and ``process_id`` name the group explicitly, and a
    failure to join it raises.  The backend is NCCL on ``device="cuda"``
    (the default; it raises where NCCL is missing, and never falls back to
    gloo) and gloo on ``device="cpu"``.  Each rank's device is
    ``cuda:LOCAL_RANK`` (``LOCAL_RANK`` from the environment, else the
    process id on a one-host group)."""
    import torch.distributed as dist

    if _state["initialized"]:
        return
    explicit = (coordinator_address is not None or num_processes is not None
                or process_id is not None)
    if explicit and None in (coordinator_address, num_processes,
                             process_id):
        raise ValueError("initialize: pass coordinator_address, "
                         "num_processes and process_id together")
    env = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"initialize: no backend for device {dev}")
    if not explicit and not env:
        _state.update(initialized=True, device=None)
        return
    if explicit:
        rank, world = int(process_id), int(num_processes)
        init_method = f"tcp://{coordinator_address}"
    else:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        init_method = "env://"
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("initialize: device='cuda' needs NCCL, which "
                               "this torch build lacks")
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    _state.update(initialized=True, device=dev)


def is_initialized() -> bool:
    return _state["initialized"]


def device() -> Optional[torch.device]:
    """This rank's device as :func:`initialize` chose it; ``None`` before
    it or on the single-process no-op."""
    return _state["device"]


def _spec_slices(shape, grid, spec) -> tuple:
    """This rank's slice of every dim of a global ``shape`` under ``spec``
    (default :func:`.mesh.partition_spec`)."""
    from .mesh import partition_spec

    spec = partition_spec(len(shape)) if spec is None else tuple(spec)
    if len(spec) != len(shape):
        raise ValueError(f"spec {spec} does not fit shape {tuple(shape)}")
    return tuple(slice(None) if ax is None else slice(*grid.block(ax, n))
                 for ax, n in zip(spec, shape))


def local_shard_array(global_data, grid, pspec=None) -> torch.Tensor:
    """This rank's block of the global numpy array ``global_data`` under
    ``pspec`` (default :func:`.mesh.partition_spec`), as a tensor on the
    grid's device.  The JAX function assembles a global array from each
    host's block; here each rank keeps its block."""
    a = np.asarray(global_data)
    return torch.as_tensor(np.ascontiguousarray(
        a[_spec_slices(a.shape, grid, pspec)])).to(grid.device)


def gather(tree, grid, spec=None):
    """The global arrays of a tree of per-rank blocks (tensors, Fields,
    named tuples, tuples, lists), on every rank, each on its block's
    device: the port's ``np.asarray`` of a global ``jax.Array``.  Every
    rank calls it.  ``spec`` (default :func:`.mesh.partition_spec` of each
    tensor's ndim) says which dims are cut; blocks of dims cut over an
    axis of size 1, or not cut, are taken from the rank at coordinate 0."""
    import torch.distributed as dist

    if grid.group is None:
        return tree

    from .mesh import AXES, partition_spec

    lev, gy, gx = grid.shape
    world = lev * gy * gx

    def one(t):
        sp = partition_spec(t.dim()) if spec is None else tuple(spec)
        shape = torch.tensor(t.shape, dtype=torch.int64, device=t.device)
        shapes = [torch.empty_like(shape) for _ in range(world)]
        dist.all_gather(shapes, shape)
        shapes = [tuple(s.tolist()) for s in shapes]
        big = tuple(max(s[d] for s in shapes) for d in range(t.dim()))
        raw = t.view(torch.uint8) if t.dtype == torch.bool else t
        buf = torch.zeros(big, dtype=raw.dtype, device=t.device)
        buf[tuple(slice(0, n) for n in t.shape)] = raw
        bufs = [torch.empty_like(buf) for _ in range(world)]
        dist.all_gather(bufs, buf.contiguous())
        coords = [(r // (gy * gx), r // gx % gy, r % gx)
                  for r in range(world)]
        # the global extent of each dim: the blocks along its axis
        glob = []
        for d, ax in enumerate(sp):
            if ax is None:
                glob.append(shapes[0][d])
                continue
            k = AXES.index(ax)
            glob.append(sum(shapes[r][d] for r, c in enumerate(coords)
                            if all(c[j] == 0 for j in range(3) if j != k)))
        out = torch.empty(glob, dtype=raw.dtype, device=t.device)
        for r, c in enumerate(coords):
            idx = []
            for d, ax in enumerate(sp):
                if ax is None:
                    idx.append(slice(None))
                    continue
                k = AXES.index(ax)
                start = sum(shapes[q][d] for q, cq in enumerate(coords)
                            if cq[k] < c[k] and all(
                                cq[j] == c[j] for j in range(3) if j != k))
                idx.append(slice(start, start + shapes[r][d]))
            out[tuple(idx)] = bufs[r][tuple(slice(0, n) for n in shapes[r])]
        return out.view(torch.bool) if t.dtype == torch.bool else out

    return tree_map(one, tree)


def tree_map(fn, tree):
    """``fn`` on every tensor of a tree of Fields, dataclasses, named
    tuples, tuples, lists and dicts; other leaves pass through."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, Field):
        return Field(fn(tree.values), fn(tree.mask))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[tree_map(fn, x) for x in tree])
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return tree
