"""The pipeline kernel on a domain-decomposed grid (port of
:mod:`mi_fieldcalc_tpu.parallel.fused`, ``fused.py:44-747``).

Each rank runs the pipeline kernel B1 (:func:`..ops.fused.
derived_fields_fused`) on its block of a ``(lev, gy, gx)`` process grid,
with the block's global offsets as launch arguments, so that ``fillEdges``
fires only on shards that touch the domain edge, never at a seam.  Each
rank passes its own blocks and gets its own blocks back.

* Without overlap, every input is padded with a radius-2 halo ring (the
  packed legs of :mod:`.halo`), B1 runs once on the padded block and the
  result is cropped.
* With ``overlap=True`` B1 first runs on the unpadded block, with no
  dependence on any exchange, while the seam strips are in flight (on
  NCCL's own stream on the card); then short strip launches recompute the
  2 rows / columns by each seam and patch them in, rows first, then
  columns.  The TPU's 8-row strips and y-halo (one sublane tile) are not
  ported: the halo is the stencils' radius, a strip ``3 * RADIUS`` rows.

On CPU tensors B1 is its plain version, under the same offsets.
"""

from __future__ import annotations

import torch

from ..field import Field
from ..models.ensemble import EnsembleSummary, _member_stack, \
    ensemble_summary
from ..models.pipeline import RADIUS, DerivedFieldsStacked, \
    _isobaric_surfaces
from ..ops._harness import require
from ..ops.fused import derived_fields_fused
from ..ops.stencil import ShardCtx, shard_context
from ..utils.profiling import span
from .halo import _start, global_extent, packed_exchange_cols, \
    packed_exchange_rows
from .mesh import ProcessGrid

__all__ = ["derived_fields_fused_sharded", "derived_fields_isobaric_sharded",
           "ensemble_summary_sharded"]

#: the rows (columns) of a shard's own block in a seam strip
_LOC = 2 * RADIUS


def _shard_placement(grid: ProcessGrid, shape, global_shape) -> tuple:
    """``(row0, col0, nyg, nxg)`` of this rank's block of ``shape``."""
    ny, nx = shape[-2], shape[-1]
    if global_shape is None:
        nyg, nxg = global_extent(grid, ny, nx)
    else:
        nyg, nxg = (int(n) for n in global_shape)
    (r0, r1), (c0, c1) = grid.block("gy", nyg), grid.block("gx", nxg)
    if (r1 - r0, c1 - c0) != (ny, nx):
        raise ValueError(f"the block is {ny}x{nx}, not this rank's cut "
                         f"{r1 - r0}x{c1 - c0} of {nyg}x{nxg}")
    return r0, c0, nyg, nxg


def _flat(fields, xm, ym, all_defined: bool) -> list:
    """The arrays that ride the exchange: values, masks (unless
    ``all_defined``: B1 reads none), the map factors."""
    flat = [f.values for f in fields]
    if not all_defined:
        flat += [f.mask for f in fields]
    return flat + [xm, ym]


def _unflat(flat, n: int, all_defined: bool):
    fields = [Field(flat[i], None if all_defined else flat[n + i])
              for i in range(n)]
    return fields, flat[-2], flat[-1]


@span("halo.exchange")
def _exchange(flat, grid: ProcessGrid) -> list:
    """``flat`` padded with a RADIUS halo ring on both axes; a tensor
    that appears more than once rides the wire once.  The span
    ``halo.exchange`` covers the packing, both legs and the padding."""
    uniq = list({id(a): a for a in flat}.values())
    rows = packed_exchange_rows(uniq, RADIUS, grid)
    padded = dict(zip(map(id, uniq),
                      packed_exchange_cols(rows, RADIUS, grid)))
    return [padded[id(a)] for a in flat]


def _b1(fields, al, bl, xm, ym, all_defined, row0, col0, nyg, nxg,
        halo_rows) -> DerivedFieldsStacked:
    return derived_fields_fused(*fields, al, bl, xm, ym, None, stacked=True,
                                all_defined=all_defined,
                                global_shape=(nyg, nxg),
                                grid_offsets=(row0, col0),
                                halo_rows=halo_rows)


def _crop(st: DerivedFieldsStacked, ny: int, nx: int) -> DerivedFieldsStacked:
    r = RADIUS
    return DerivedFieldsStacked(
        st.values[..., r:r + ny, r:r + nx].contiguous(),
        st.masks[..., r:r + ny, r:r + nx].contiguous())


def _halo_core(grid, fields, al, bl, xm, ym, all_defined, placement):
    """B1 once on the block padded with a RADIUS halo ring, cropped."""
    r0, c0, nyg, nxg = placement
    ny, nx = fields[0].values.shape[-2:]
    padded = _exchange(_flat(fields, xm, ym, all_defined), grid)
    pf, pxm, pym = _unflat(padded, len(fields), all_defined)
    out = _b1(pf, al, bl, pxm, pym, all_defined, r0 - RADIUS, c0 - RADIUS,
              nyg, nxg, RADIUS)
    return _crop(out, ny, nx)


def _overlap_core(grid, fields, al, bl, xm, ym, all_defined, placement):
    """B1 on the unpadded block while the seam strips are in flight, then
    the seam bands recomputed by strip launches and patched in (rows
    first, then columns, which carry the corners)."""
    r0, c0, nyg, nxg = placement
    R, L = RADIUS, _LOC
    ny, nx = fields[0].values.shape[-2:]
    _, gy, gx = grid.shape
    if gy > 1 and ny < L:
        raise ValueError(f"overlap mode needs >= {L} local rows per gy "
                         f"shard: a seam strip holds {L} of them "
                         f"(2 * RADIUS), got {ny}")
    if gx > 1 and nx < L:
        raise ValueError(f"overlap mode needs >= {L} local columns per gx "
                         f"shard: a seam strip holds {L} of them "
                         f"(2 * RADIUS), got {nx}")
    flat = _flat(fields, xm, ym, all_defined)
    uniq = list({id(a): a for a in flat}.values())
    pos = {id(a): i for i, a in enumerate(uniq)}
    k = [pos[id(a)] for a in flat]
    n = len(fields)

    def args(arrays):
        f, x, y = _unflat([arrays[i] for i in k], n, all_defined)
        return f, al, bl, x, y, all_defined

    y_leg = (_start([a[..., :R, :] for a in uniq],
                    [a[..., ny - R:, :] for a in uniq], grid, "gy")
             if gy > 1 else None)
    out = _b1(*args(uniq), r0, c0, nyg, nxg, 0)     # no exchange read
    vals, masks = out.values, out.masks
    hy = R if gy > 1 else 0
    tops = bots = None
    if y_leg is not None:
        tops, bots = y_leg.wait()

    def ext(i, lo, hi):
        """Columns [lo, hi) of array i, with the y-halo rows above and
        below them (the x-leg then carries the diagonal corners)."""
        mid = uniq[i][..., lo:hi]
        if not hy:
            return mid
        return torch.cat([tops[i][..., lo:hi], mid, bots[i][..., lo:hi]],
                         dim=-2)

    x_leg = (_start([ext(i, 0, R) for i in range(len(uniq))],
                    [ext(i, nx - R, nx) for i in range(len(uniq))], grid,
                    "gx") if gx > 1 else None)
    up, down = grid.neighbours("gy")
    if gy > 1 and up is not None:
        top = _b1(*args([torch.cat([t, a[..., :L, :]], dim=-2)
                         for t, a in zip(tops, uniq)]),
                  r0 - R, c0, nyg, nxg, 0)
        vals[..., :R, :] = top.values[..., R:2 * R, :]
        masks[..., :R, :] = top.masks[..., R:2 * R, :]
    if gy > 1 and down is not None:
        bot = _b1(*args([torch.cat([a[..., ny - L:, :], b], dim=-2)
                         for a, b in zip(uniq, bots)]),
                  r0 + ny - L, c0, nyg, nxg, 0)
        vals[..., ny - R:, :] = bot.values[..., L - R:L, :]
        masks[..., ny - R:, :] = bot.masks[..., L - R:L, :]
    if x_leg is not None:
        lefts, rights = x_leg.wait()
        left, right = grid.neighbours("gx")
        if left is not None:
            st = _b1(*args([torch.cat([lf, ext(i, 0, L)], dim=-1)
                            for i, lf in enumerate(lefts)]),
                     r0 - hy, c0 - R, nyg, nxg, hy)
            vals[..., :R] = st.values[..., hy:hy + ny, R:2 * R]
            masks[..., :R] = st.masks[..., hy:hy + ny, R:2 * R]
        if right is not None:
            st = _b1(*args([torch.cat([ext(i, nx - L, nx), rt], dim=-1)
                            for i, rt in enumerate(rights)]),
                     r0 - hy, c0 + nx - L, nyg, nxg, hy)
            vals[..., nx - R:] = st.values[..., hy:hy + ny, L - R:L]
            masks[..., nx - R:] = st.masks[..., hy:hy + ny, L - R:L]
    return out


def _maps(xmapr, ymapr, shape, dev):
    xm, ym = (torch.as_tensor(m, dtype=torch.float32, device=dev)
              for m in (xmapr, ymapr))
    require(tuple(xm.shape) == tuple(shape) and
            tuple(ym.shape) == tuple(shape),
            f"sharded pipeline: xmapr / ymapr must be this rank's "
            f"{tuple(shape)} blocks")
    return xm.contiguous(), ym.contiguous()


def _result(st: DerivedFieldsStacked, stacked: bool):
    return st if stacked else st.as_fields()


def derived_fields_fused_sharded(grid: ProcessGrid, tk: Field, q: Field,
                                 u: Field, v: Field, ps: Field, alevel,
                                 blevel, xmapr, ymapr, fcoriolis,
                                 overlap: bool = False, global_shape=None,
                                 stacked: bool = False,
                                 all_defined: bool = False):
    """The pipeline kernel on this rank's blocks of ``grid``.

    Arguments as :func:`..models.pipeline.derived_fields`, each this rank's
    block (:func:`.distributed.local_shard_array`): ``tk, q, u, v``
    ``[nlev, ny, nx]``, ``ps`` ``[ny, nx]``, ``alevel, blevel`` this
    rank's levels, ``xmapr, ymapr`` ``[ny, nx]`` (map factors are per-point
    fields in a real projection); ``fcoriolis`` is not used.  Returns this
    rank's block of :class:`DerivedFields`, or of the
    :class:`DerivedFieldsStacked` layout with ``stacked=True``.

    ``global_shape`` is the global ``(ny, nx)``; ``None`` takes it from
    every rank's block (one small all-gather).  ``overlap=True`` runs B1
    on the block while the seam strips are in flight and patches the seam
    bands from strip launches (:mod:`this module <.fused>`).
    ``all_defined=True`` asserts every input point is defined: no mask
    rides the exchange and B1 writes its 2 gate planes.

    B1 launches once per call without overlap; with it, once for the
    block and once per side that has a grid neighbour."""
    del fcoriolis
    dev = tk.values.device
    placement = _shard_placement(grid, tk.values.shape, global_shape)
    xm, ym = _maps(xmapr, ymapr, tk.values.shape[-2:], dev)
    core = _overlap_core if overlap else _halo_core
    st = core(grid, [tk, q, u, v, ps],
              torch.as_tensor(alevel, dtype=torch.float32, device=dev),
              torch.as_tensor(blevel, dtype=torch.float32, device=dev),
              xm, ym, all_defined, placement)
    return _result(st, stacked)


def derived_fields_isobaric_sharded(grid: ProcessGrid, tk: Field, q: Field,
                                    u: Field, v: Field, ps: Field, alevel,
                                    blevel, xmapr, ymapr, fcoriolis,
                                    plevels, global_shape=None,
                                    overlap: bool = False,
                                    all_defined: bool = False):
    """The 3-D isobaric pipeline (BASELINE config 5's per-rank program)
    on this rank's blocks: the column interpolation B2 (:func:`..ops.
    vertical_fused.hlevel_to_plevel_fused`) on the block as it is, since
    columns never cross a shard, then B1 on the interpolated stacks with
    the block's offsets (the halo ring rides on the ``len(plevels)``
    interpolated levels, not the model levels).  ``all_defined`` is B2's;
    the interpolated masks are data-dependent, so B1 keeps its masks, and
    the one shared mask plane rides the exchange once.  The grid must have
    ``lev == 1``: a column spans every model level.  Returns this rank's
    block of :class:`DerivedFields` on the ``plevels`` stack."""
    from ..ops.vertical_fused import hlevel_to_plevel_fused

    if grid.shape[0] != 1:
        raise ValueError("isobaric sharding needs lev == 1 (columns span "
                         "all model levels)")
    del fcoriolis
    dev = tk.values.device
    placement = _shard_placement(grid, tk.values.shape, global_shape)
    xm, ym = _maps(xmapr, ymapr, tk.values.shape[-2:], dev)
    plevels = tuple(float(t) for t in plevels)
    a = torch.as_tensor(alevel, dtype=torch.float32, device=dev)
    b = torch.as_tensor(blevel, dtype=torch.float32, device=dev)
    interp = hlevel_to_plevel_fused((tk, q, u, v), ps, a, b, plevels,
                                    all_defined=all_defined)
    pa, pb, ps0 = _isobaric_surfaces(plevels, *tk.values.shape[-2:], dev)
    core = _overlap_core if overlap else _halo_core
    st = core(grid, [*interp, ps0], pa, pb, xm, ym, False, placement)
    return st.as_fields()


@span("ensemble.summary", count_allocs=True)
def ensemble_summary_sharded(grid: ProcessGrid, tk: Field, q: Field,
                             u: Field, v: Field, ps: Field, alevel, blevel,
                             xmapr, ymapr, fcoriolis,
                             wind_limit: float = 15.0, global_shape=None,
                             all_defined: bool = False) -> EnsembleSummary:
    """The ensemble pipeline on this rank's blocks: per-member derived
    fields, then the summary (:func:`..models.ensemble.ensemble_summary`).

    Inputs as :func:`..models.ensemble.ensemble_derived_summary`, each this
    rank's block: ``[nmem, nlev, ny, nx]`` member stacks, ``[nmem, ny,
    nx]`` surface pressure, ``(ny, nx)`` map factors.  The member axis
    stays whole on every rank.  The member stacks ride one packed halo
    exchange, then B1 runs once per member on its padded block (the JAX
    function ``vmap``s its seam-strip path over the members instead).  The
    probabilities' whole-field member flags are the maximum over the
    shards (``ops.ensemble.probability`` under the shard's context), so
    every shard divides by the same count.  The grid must have
    ``lev == 1``.

    Its spans carry the unsharded route's names: ``ensemble.summary``
    (the call), ``ensemble.member_fields`` (the member loop) and, once a
    member, ``ensemble.member_stack`` (the crop of B1's padded planes and
    their copy into the member's slot); ``halo.exchange`` and
    ``halo.wire`` (:mod:`.halo`) cover the exchange."""
    if grid.shape[0] != 1:
        raise ValueError("ensemble sharding needs lev == 1 (the member "
                         "axis stays local; spatial axes shard)")
    del fcoriolis
    dev = tk.values.device
    r0, c0, nyg, nxg = _shard_placement(grid, tk.values.shape, global_shape)
    xm, ym = _maps(xmapr, ymapr, tk.values.shape[-2:], dev)
    al = torch.as_tensor(alevel, dtype=torch.float32, device=dev)
    bl = torch.as_tensor(blevel, dtype=torch.float32, device=dev)
    fields = [tk, q, u, v, ps]
    padded = _exchange(_flat(fields, xm, ym, all_defined), grid)
    pf, pxm, pym = _unflat(padded, len(fields), all_defined)
    shape = tuple(tk.values.shape[1:])

    def fill(member, values, masks):
        st = _b1(member, al, bl, pxm, pym, all_defined, r0 - RADIUS,
                 c0 - RADIUS, nyg, nxg, RADIUS)
        with span("ensemble.member_stack"):
            st = _crop(st, *shape[-2:])
            values.copy_(st.values)
            masks.copy_(st.masks)

    with span("ensemble.member_fields"):
        out = _member_stack(pf, shape, 2 if all_defined else 9, fill)
    with shard_context(ShardCtx(r0, c0, nyg, nxg, grid.group)):
        return ensemble_summary(out, wind_limit)
