"""Halo exchange and sharded execution of the stencil operators (port of
:mod:`mi_fieldcalc_tpu.parallel.halo`, ``halo.py:96-393``).

The reference's stencils read a radius-R neighbourhood and patch the
physical boundary with ``fillEdges`` (FieldCalculations.cc:59-74).  On a
process grid each rank runs the same operators on its block padded with a
radius-R halo ring from its grid neighbours, and ``fillEdges`` fires only
at the physical edges of the domain, never at a seam.

* :func:`halo_exchange` pads a block ``[..., ny, nx]`` to ``[..., ny+2R,
  nx+2R]``: the y-leg first, then the x-leg on the y-extended arrays, so
  the diagonal corners arrive.  Halo slots at physical edges are zeros
  with their mask False, as ``ppermute`` leaves them.
* The packed legs (:func:`packed_strip_exchange`, :func:`packed_sendrecv`)
  carry the strips of many arrays as one message per direction and dtype
  class, all of a leg posted in one ``batch_isend_irecv``.  Masks travel as
  their bytes (a ``uint8`` view of the bool tensor, no copy), which every
  backend takes.
* :class:`EdgeContext` holds a shard's place in the global grid; under it
  (``ops.stencil.ShardCtx``) every ``fillEdges`` of every operator,
  composed ones included, clamps to the global edges, and the operators
  that decide on a whole field reduce over the grid's process group.
* :func:`run_sharded` wires it together: exchange, run the operator under
  the context, crop R from each side.

The JAX package's ``MF_LAB_SELF_PERMUTE`` is a TPU-lab control and is not
ported.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..ops.stencil import ShardCtx, shard_context
from ..utils.profiling import count, span
from .distributed import tree_map
from .mesh import ProcessGrid

__all__ = ["halo_exchange", "packed_strip_exchange", "packed_sendrecv",
           "packed_exchange_rows", "packed_exchange_cols", "run_sharded",
           "EdgeContext", "global_extent"]

_DIM = {"gy": -2, "gx": -1}


def _wire(t: torch.Tensor) -> torch.Tensor:
    """A strip as it rides the wire: bool as its bytes."""
    return t.view(torch.uint8) if t.dtype == torch.bool else t


class _Pending:
    """A started packed exchange: :meth:`wait` gives ``(from_prev,
    from_next)``, each strip shaped and typed as the strip it answers.
    ``wire`` is the open ``halo.wire`` span, closed once every message
    has been waited for."""

    def __init__(self, ops, works, recvs, lo, hi, wire):
        # the ops keep the send buffers alive until the exchange is done
        self._ops, self._works = ops, works
        self._recvs, self._lo, self._hi = recvs, lo, hi
        self._wire = wire

    def wait(self) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        for w in self._works:
            w.wait()
        self._wire.__exit__(None, None, None)
        out = []
        for side, like in ((0, self._hi), (1, self._lo)):
            strips = [None] * len(like)
            for idxs, bufs in self._recvs:
                buf, r = bufs[side], 0
                for i in idxs:
                    n = like[i].numel()
                    if buf is None:
                        strips[i] = torch.zeros_like(like[i])
                    else:
                        part = buf[r:r + n].view(_wire(like[i]).shape)
                        strips[i] = (part.view(torch.bool)
                                     if like[i].dtype == torch.bool else part)
                    r += n
            out.append(strips)
        return out[0], out[1]


def _start(lo_strips: Sequence[torch.Tensor],
           hi_strips: Sequence[torch.Tensor], grid: ProcessGrid,
           axis: str) -> _Pending:
    """Post :func:`packed_sendrecv`'s messages and return at once.  The
    bytes posted to send add to the counter ``halo.bytes``; the span
    ``halo.wire`` runs from the post to :meth:`_Pending.wait` (on a card,
    until the current stream has waited for every message)."""
    import torch.distributed as dist

    lo = [_wire(a.contiguous()) for a in lo_strips]
    hi = [_wire(a.contiguous()) for a in hi_strips]
    prev, nxt = grid.neighbours(axis)
    groups = {}
    for i, a in enumerate(lo):
        groups.setdefault(a.dtype, []).append(i)
    ops, recvs, sent = [], [], 0
    for dtype, idxs in groups.items():
        dev = lo[idxs[0]].device
        bufs = [None, None]
        for side, peer, send in ((0, prev, lo), (1, nxt, hi)):
            if peer is None:
                continue
            out = torch.cat([send[i].reshape(-1) for i in idxs])
            sent += out.numel() * out.element_size()
            bufs[side] = torch.empty(sum(hi[i].numel() if side == 0 else
                                         lo[i].numel() for i in idxs),
                                     dtype=dtype, device=dev)
            ops.append(dist.P2POp(dist.isend, out, peer))
            ops.append(dist.P2POp(dist.irecv, bufs[side], peer))
        recvs.append((idxs, bufs))
    count("halo.bytes", sent)
    wire = span("halo.wire", lo[0].device if lo else None)
    wire.__enter__()
    works = dist.batch_isend_irecv(ops) if ops else []
    return _Pending(ops, works, recvs, list(lo_strips), list(hi_strips),
                    wire)


def packed_sendrecv(lo_strips: Sequence[torch.Tensor],
                    hi_strips: Sequence[torch.Tensor], grid: ProcessGrid,
                    axis: str):
    """Send ready-made strips to the grid neighbours along ``axis``
    (``"gy"`` or ``"gx"``): ``lo_strips[i]`` to the rank before,
    ``hi_strips[i]`` to the rank after.  Returns ``(from_prev,
    from_next)``: the rank before's ``hi_strips`` and the rank after's
    ``lo_strips``, zeros (mask False) at physical edges, dtypes restored.
    Strips of one array have one shape on every rank of the axis; the
    packer flattens each dtype class into one message per direction."""
    return _start(lo_strips, hi_strips, grid, axis).wait()


def _edge_strips(arrays, h: int, axis: str):
    dim = _DIM[axis]
    for a in arrays:
        if a.shape[dim] < h:
            raise ValueError(
                f"a halo of {h} needs >= {h} local "
                f"{'rows' if axis == 'gy' else 'columns'} per {axis} "
                f"shard, got {a.shape[dim]}")
    return ([a.narrow(dim, 0, h) for a in arrays],
            [a.narrow(dim, a.shape[dim] - h, h) for a in arrays])


def packed_strip_exchange(arrays: Sequence[torch.Tensor], h: int,
                          grid: ProcessGrid, axis: str = "gy"):
    """The ``h``-wide halos of many arrays along ``axis`` (``"gy"``: rows,
    ``"gx"``: columns) with one message per direction and dtype class.
    Returns ``(tops, bots)``: per array, the strip from the rank before
    and the rank after (zeros at physical edges)."""
    lo, hi = _edge_strips(arrays, h, axis)
    return packed_sendrecv(lo, hi, grid, axis)


def _zeros(a: torch.Tensor, dim: int, h: int) -> torch.Tensor:
    shape = list(a.shape)
    shape[dim] = h
    return torch.zeros(shape, dtype=a.dtype, device=a.device)


def _pad(arrays, h: int, grid: ProcessGrid, axis: str):
    dim = _DIM[axis]
    if grid.shape[1 if axis == "gy" else 2] == 1:
        before = after = [_zeros(a, dim, h) for a in arrays]
    else:
        before, after = packed_strip_exchange(arrays, h, grid, axis)
    return [torch.cat([b, a, c], dim=dim)
            for a, b, c in zip(arrays, before, after)]


def packed_exchange_rows(arrays: Sequence[torch.Tensor], h: int,
                         grid: ProcessGrid) -> list:
    """Each array padded with ``h`` rows per side from its gy neighbours
    (zeros at physical edges), all arrays in one packed y-leg."""
    return _pad(arrays, h, grid, "gy")


def packed_exchange_cols(arrays: Sequence[torch.Tensor], h: int,
                         grid: ProcessGrid) -> list:
    """Each array padded with ``h`` columns per side from its gx
    neighbours (zeros at physical edges), all arrays in one packed
    x-leg."""
    return _pad(arrays, h, grid, "gx")


def halo_exchange(a: torch.Tensor, radius: int,
                  grid: ProcessGrid) -> torch.Tensor:
    """``a``'s trailing ``(ny, nx)`` axes padded with a radius-R halo ring
    from its grid neighbours: the y-leg, then the x-leg on the y-extended
    block (the diagonal corners ride along)."""
    rows = packed_exchange_rows([a], radius, grid)
    return packed_exchange_cols(rows, radius, grid)[0]


def global_extent(grid: ProcessGrid, ny: int, nx: int) -> Tuple[int, int]:
    """The global ``(ny, nx)`` of the blocks of this grid's ``lev`` slab,
    from every rank's block extents (one small all-gather and one host
    sync); checks that the blocks follow :func:`.mesh.block`'s cut."""
    from .mesh import block

    if grid.group is None:
        return ny, nx
    import torch.distributed as dist

    _, gy, gx = grid.shape
    mine = torch.tensor([ny, nx], dtype=torch.int64, device=grid.device)
    every = [torch.empty_like(mine) for _ in range(gy * gx)]
    dist.all_gather(every, mine, group=grid.group)
    ext = [tuple(e.tolist()) for e in every]
    nyg = sum(ext[iy * gx][0] for iy in range(gy))
    nxg = sum(ext[ix][1] for ix in range(gx))
    for iy in range(gy):
        for ix in range(gx):
            want = (block(nyg, gy, iy), block(nxg, gx, ix))
            got = ext[iy * gx + ix]
            if (want[0][1] - want[0][0], want[1][1] - want[1][0]) != got:
                raise ValueError(f"the block at ({iy}, {ix}) is {got}, not "
                                 f"its cut of the global {nyg}x{nxg}")
    return nyg, nxg


class EdgeContext:
    """A shard's place in the global grid, for one sharded call: ``halo``
    is the width of its halo ring, ``(nyg, nxg)`` the global extents.
    :attr:`ctx` is the ``ops.stencil.ShardCtx`` the operators run under;
    :meth:`fill` is the sharded ``fillEdges`` (FieldCalculations.cc:59-74):
    columns, then rows, copied outward from the first global interior
    row / column at the physical edges only."""

    def __init__(self, halo: int, grid: ProcessGrid, global_shape):
        nyg, nxg = global_shape
        r0, _ = grid.block("gy", nyg)
        c0, _ = grid.block("gx", nxg)
        self.halo = halo
        self.ctx = ShardCtx(r0 - halo, c0 - halo, nyg, nxg, grid.group)

    def fill(self, a: torch.Tensor) -> torch.Tensor:
        from ..ops.stencil import _shard_fill
        return _shard_fill(a, self.ctx)


def _crop(a: torch.Tensor, r: int) -> torch.Tensor:
    if r == 0 or a.dim() < 2:
        return a
    return a[..., r:a.shape[-2] - r, r:a.shape[-1] - r]


def run_sharded(op, grid: ProcessGrid, radius: int, *args,
                offset_arg: Optional[str] = None, **kwargs):
    """Run operator ``op`` on this rank's blocks of a domain-decomposed
    grid.

    ``args`` may be Fields, tensors (``[..., ny, nx]`` blocks, cut as
    :func:`.mesh.partition_spec` says; 0-/1-D ones pass as they are),
    Python scalars, or tuples of these.  ``radius`` is the operator's
    composed stencil radius (1 for the simple derivatives, 2 for
    ``plevelqvector`` / ``thermal_front_parameter``, 0 for pointwise
    operators, which exchange nothing).  ``kwargs`` pass to ``op``.
    ``offset_arg`` names a keyword of ``op`` that receives the shard's
    global ``(row, col)`` of its local (0, 0), negative on halo rows.

    Returns what ``op`` returns, each tensor of 2 or more dims cropped to
    this rank's block.  The global extents come from every rank's block
    (:func:`global_extent`), so every rank of the grid calls this."""
    grids = []
    tree_map(lambda t: grids.append(t) if t.dim() >= 2 else None, args)
    nyg, nxg = global_extent(grid, grids[0].shape[-2], grids[0].shape[-1])
    leaves = grids if radius > 0 else []
    if leaves:
        padded = packed_exchange_cols(
            packed_exchange_rows(leaves, radius, grid), radius, grid)
        it = iter(padded)
        args = tree_map(lambda t: next(it) if t.dim() >= 2 else t, args)
    edge = EdgeContext(radius, grid, (nyg, nxg))
    if offset_arg is not None:
        kwargs = dict(kwargs)
        kwargs[offset_arg] = (edge.ctx.row0, edge.ctx.col0)
    with shard_context(edge.ctx):
        out = op(*args, **kwargs)
    return tree_map(lambda t: _crop(t, radius), out)
