"""Horizontal centred-difference stencils (port of
:mod:`mi_fieldcalc_tpu.ops.stencil`).

Arrays are ``[..., ny, nx]``.  Neighbours come from circular shifts; the
wrapped rows and columns are exactly the ones :func:`fill_edges`
overwrites afterwards (FieldCalculations.cc:59-74).  Map factors and the
coriolis parameter may be tensors, Fields (their values are read) or
numbers (a float32 0-dim tensor, so every product and quotient stays in
float32 and IEEE).

Under a :class:`ShardCtx` (installed by :func:`shard_context`, which
``parallel.halo.run_sharded`` and the sharded pipeline's plain version
use) an operator runs on one shard of a domain-decomposed grid: the fill
of :func:`fill_edges` fires only at the global edges, the momentum
coordinates add the shard's global offsets, and the Shapiro filter keeps
only the physical edges and decides all-defined for the global field.
Without a context these are the unsharded semantics.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..constants import cp, g, kappa, p0
from ..field import UNDEF, Field, f32
from ._harness import and_masks, const, require

__all__ = ["fill_edges", "gradient", "relvort", "absvort", "divergence",
           "advection", "jacobian", "plevelgwind_xcomp", "plevelgwind_ycomp",
           "plevelgvort", "ilevelgwind", "plevelqvector",
           "thermal_front_parameter", "momentum_x_coordinate",
           "momentum_y_coordinate", "shapiro2_filter"]

_HALF = f32(0.5)
_G = float(g)


def _vals(x, ref: Field) -> torch.Tensor:
    """A map factor or coriolis argument as a tensor; a number becomes a
    float32 0-dim tensor on ``ref``'s device."""
    if isinstance(x, Field):
        return x.values
    if isinstance(x, torch.Tensor):
        return x
    return const(x, ref.values)


def _xm(a):  # value at (y, x-1)
    return torch.roll(a, 1, dims=-1)


def _xp(a):  # value at (y, x+1)
    return torch.roll(a, -1, dims=-1)


def _ym(a):  # value at (y-1, x)
    return torch.roll(a, 1, dims=-2)


def _yp(a):  # value at (y+1, x)
    return torch.roll(a, -1, dims=-2)


def fill_edges(a: torch.Tensor) -> torch.Tensor:
    """Copy the first interior column, then row, outward: column 0 <- 1 and
    nx-1 <- nx-2, then row 0 <- 1 and ny-1 <- ny-2, corners included."""
    a = torch.cat([a[..., :, 1:2], a[..., :, 1:-1], a[..., :, -2:-1]], dim=-1)
    return torch.cat([a[..., 1:2, :], a[..., 1:-1, :], a[..., -2:-1, :]],
                     dim=-2)


class ShardCtx(NamedTuple):
    """One shard's place in a domain-decomposed grid: ``(row0, col0)`` is
    the global position of the local block's (0, 0), negative on halo rows,
    ``(nyg, nxg)`` the global extents, and ``group`` the process group of
    the shards of this grid (``None``: one process), over which the
    operators that decide on a whole field reduce."""
    row0: int
    col0: int
    nyg: int
    nxg: int
    group: Optional[object] = None


_SHARD_CTX = contextvars.ContextVar("mf_shard_ctx", default=None)


@contextlib.contextmanager
def shard_context(ctx: ShardCtx):
    """Run the operators inside the block as on the shard ``ctx``."""
    token = _SHARD_CTX.set(ctx)
    try:
        yield ctx
    finally:
        _SHARD_CTX.reset(token)


def fill_bounds(n: int, origin: int, ng: int) -> Tuple[int, int]:
    """The rows (or columns) ``[lo, hi]`` of a block of ``n`` at global
    ``origin`` in a global extent ``ng`` that keep their own stencil value;
    the others take the value at the nearest of them.  That is fillEdges
    at the global edges, and it keeps every read inside the block."""
    lo, hi = max(1, 1 - origin), min(n - 2, ng - 2 - origin)
    require(lo <= hi, f"a block of {n} at {origin} holds no interior point "
            f"of a global extent of {ng}")
    return lo, hi


def _shard_fill(a: torch.Tensor, ctx: ShardCtx) -> torch.Tensor:
    """:func:`fill_edges` on a shard: columns, then rows, clamped to
    :func:`fill_bounds`."""
    for dim, origin, ng in ((-1, ctx.col0, ctx.nxg), (-2, ctx.row0, ctx.nyg)):
        n = a.shape[dim]
        lo, hi = fill_bounds(n, origin, ng)
        idx = torch.arange(n, device=a.device).clamp(lo, hi)
        a = a.index_select(dim, idx)
    return a


def shard_all_reduce(t: torch.Tensor, op: str) -> torch.Tensor:
    """``t`` reduced (``"sum"``, ``"min"`` or ``"max"``) over the shards of
    the installed :class:`ShardCtx`'s group, in place; ``t`` as it is
    without a context or a group."""
    ctx = _SHARD_CTX.get()
    if ctx is None or ctx.group is None:
        return t
    import torch.distributed as dist
    dist.all_reduce(t, op=getattr(dist.ReduceOp, op.upper()),
                    group=ctx.group)
    return t


def _finish(values, mask) -> Field:
    ctx = _SHARD_CTX.get()
    if ctx is None:
        return Field(fill_edges(values), fill_edges(mask))
    return Field(_shard_fill(values, ctx), _shard_fill(mask, ctx))


def _check_min_size(f: Field, name: str) -> None:
    ny, nx = f.shape[-2], f.shape[-1]
    require(nx >= 3 and ny >= 3, f"{name}: grid must be at least 3x3")


def gradient(f: Field, xmapr, ymapr, compute: int) -> Field:
    """Centred-difference gradients (FieldCalculations.cc:1985-2074):
    1 df/dx, 2 df/dy, 3 |grad f|, 4 the laplacian."""
    require(compute in (1, 2, 3, 4), f"gradient: bad compute {compute}")
    _check_min_size(f, "gradient")
    xm, ym = _vals(xmapr, f), _vals(ymapr, f)
    v, m = f.values, f.mask
    if compute == 1:
        out = _HALF * xm * (_xp(v) - _xm(v))
        mask = _xm(m) & _xp(m)
    elif compute == 2:
        out = _HALF * ym * (_yp(v) - _ym(v))
        mask = _ym(m) & _yp(m)
    elif compute == 3:
        dfdx = _HALF * xm * (_xp(v) - _xm(v))
        dfdy = _HALF * ym * (_yp(v) - _ym(v))
        out = torch.sqrt(dfdx * dfdx + dfdy * dfdy)
        mask = _xm(m) & _xp(m) & _ym(m) & _yp(m)
    else:
        d2fdx = _xm(v) - 2.0 * v + _xp(v)
        d2fdy = _ym(v) - 2.0 * v + _yp(v)
        out = 4.0 * (f32(0.25) * xm * xm * d2fdx
                     + f32(0.25) * ym * ym * d2fdy)
        mask = _xm(m) & _xp(m) & m & _ym(m) & _yp(m)
    return _finish(out, mask)


def relvort(u: Field, v: Field, xmapr, ymapr) -> Field:
    """Relative vorticity dv/dx - du/dy (FieldCalculations.cc:1843-1873)."""
    _check_min_size(u, "relvort")
    xm, ym = _vals(xmapr, u), _vals(ymapr, u)
    out = (_HALF * xm * (_xp(v.values) - _xm(v.values))
           - _HALF * ym * (_yp(u.values) - _ym(u.values)))
    mask = _xm(v.mask) & _xp(v.mask) & _ym(u.mask) & _yp(u.mask)
    return _finish(out, mask)


def absvort(u: Field, v: Field, xmapr, ymapr, fcoriolis) -> Field:
    """Absolute vorticity (FieldCalculations.cc:1875-1908)."""
    _check_min_size(u, "absvort")
    xm, ym = _vals(xmapr, u), _vals(ymapr, u)
    out = (_HALF * xm * (_xp(v.values) - _xm(v.values))
           - _HALF * ym * (_yp(u.values) - _ym(u.values))
           + _vals(fcoriolis, u))
    mask = _xm(v.mask) & _xp(v.mask) & _ym(u.mask) & _yp(u.mask)
    return _finish(out, mask)


def divergence(u: Field, v: Field, xmapr, ymapr) -> Field:
    """Horizontal divergence du/dx + dv/dy (FieldCalculations.cc:1910-1940).

    Reference quirk (cc:1927): the defined-check reads v[x+-1] and u[y+-1],
    the vorticity stencil's inputs, while the value reads u[x+-1] and
    v[y+-1].  Kept for parity."""
    _check_min_size(u, "divergence")
    xm, ym = _vals(xmapr, u), _vals(ymapr, u)
    out = (_HALF * xm * (_xp(u.values) - _xm(u.values))
           + _HALF * ym * (_yp(v.values) - _ym(v.values)))
    mask = _xm(v.mask) & _xp(v.mask) & _ym(u.mask) & _yp(u.mask)
    return _finish(out, mask)


def advection(f: Field, u: Field, v: Field, xmapr, ymapr,
              hours: float) -> Field:
    """Scalar advection -(u df/dx + v df/dy) * 3600*hours
    (FieldCalculations.cc:1942-1983)."""
    _check_min_size(f, "advection")
    xm, ym = _vals(xmapr, f), _vals(ymapr, f)
    scale = f32(-3600.0 * hours)
    fv = f.values
    out = (u.values * _HALF * xm * (_xp(fv) - _xm(fv))
           + v.values * _HALF * ym * (_yp(fv) - _ym(fv))) * scale
    mask = (u.mask & v.mask & _xm(f.mask) & _xp(f.mask) & _ym(f.mask)
            & _yp(f.mask))
    return _finish(out, mask)


def thermal_front_parameter(t: Field, xmapr, ymapr) -> Field:
    """TFP = -grad|grad T| . grad T / |grad T| (FieldCalculations.cc:
    2266-2309), a radius-2 stencil through the filled |grad T| field."""
    _check_min_size(t, "thermalFrontParameter")
    xm, ym = _vals(xmapr, t), _vals(ymapr, t)
    absdelt = gradient(t, xm, ym, 3)
    a, tv = absdelt.values, t.values
    dadx = _HALF * xm * (_xp(a) - _xm(a))
    dady = _HALF * ym * (_yp(a) - _ym(a))
    nonzero = a != 0
    ainv = 1 / torch.where(nonzero, a, torch.ones_like(a))
    dtdxa = _HALF * xm * (_xp(tv) - _xm(tv)) * ainv
    dtdya = _HALF * ym * (_yp(tv) - _ym(tv)) * ainv
    out = -(dadx * dtdxa + dady * dtdya)
    tm, am = t.mask, absdelt.mask
    mask = (_ym(tm) & _xm(tm) & _xp(tm) & _yp(tm)
            & and_masks(_ym(am), _xm(am), am, _xp(am), _yp(am)) & nonzero)
    return _finish(out, mask)



def jacobian(f1: Field, f2: Field, xmapr, ymapr) -> Field:
    """Jacobian df1/dx*df2/dy - df1/dy*df2/dx
    (FieldCalculations.cc:2424-2460)."""
    _check_min_size(f1, "jacobian")
    xm, ym = _vals(xmapr, f1), _vals(ymapr, f1)
    a, b = f1.values, f2.values
    df1dx = _HALF * xm * (_xp(a) - _xm(a))
    df1dy = _HALF * ym * (_yp(a) - _ym(a))
    df2dx = _HALF * xm * (_xp(b) - _xm(b))
    df2dy = _HALF * ym * (_yp(b) - _ym(b))
    mask = _ring(f1.mask) & _ring(f2.mask)
    return _finish(df1dx * df2dy - df1dy * df2dx, mask)


def _ring(m: torch.Tensor) -> torch.Tensor:
    """The four neighbours defined."""
    return _ym(m) & _xm(m) & _xp(m) & _yp(m)


# -- geostrophic wind / vorticity --------------------------------------------

def plevelgwind_xcomp(z: Field, xmapr, ymapr, fcoriolis) -> Field:
    """ug = -(g/f) dz/dy (FieldCalculations.cc:638-672); the mask is the
    values' (the reference counts every point undefined, cc:664)."""
    _check_min_size(z, "plevelgwind_xcomp")
    ym, fc = _vals(ymapr, z), _vals(fcoriolis, z)
    out = f32(-0.5) * ym * (_yp(z.values) - _ym(z.values)) * _G / fc
    return _finish(out, _ring(z.mask))


def plevelgwind_ycomp(z: Field, xmapr, ymapr, fcoriolis) -> Field:
    """vg = +(g/f) dz/dx (FieldCalculations.cc:674-706)."""
    _check_min_size(z, "plevelgwind_ycomp")
    xm, fc = _vals(xmapr, z), _vals(fcoriolis, z)
    out = _HALF * xm * (_xp(z.values) - _xm(z.values)) * _G / fc
    return _finish(out, _ring(z.mask))


def plevelgvort(z: Field, xmapr, ymapr, fcoriolis) -> Field:
    """Geostrophic vorticity (g/f) * laplacian(z)
    (FieldCalculations.cc:708-743)."""
    _check_min_size(z, "plevelgvort")
    xm, ym, fc = _vals(xmapr, z), _vals(ymapr, z), _vals(fcoriolis, z)
    v = z.values
    out = (f32(0.25) * xm * xm * (_xm(v) - 2.0 * v + _xp(v))
           + f32(0.25) * ym * ym * (_ym(v) - 2.0 * v + _yp(v))) \
        * 4.0 * _G / fc
    return _finish(out, _ring(z.mask) & z.mask)


def ilevelgwind(mpot: Field, xmapr, ymapr,
                fcoriolis) -> Tuple[Field, Field]:
    """Geostrophic wind from the Montgomery potential on an isentropic
    level (FieldCalculations.cc:1511-1549); returns ``(ug, vg)``."""
    _check_min_size(mpot, "ilevelgwind")
    xm, ym = _vals(xmapr, mpot), _vals(ymapr, mpot)
    fc = _vals(fcoriolis, mpot)
    v = mpot.values
    ug = f32(-0.5) * ym * (_yp(v) - _ym(v)) / fc
    vg = _HALF * xm * (_xp(v) - _xm(v)) / fc
    mask = _ring(mpot.mask)
    return _finish(ug, mask), _finish(vg, mask)


def plevelqvector(z: Field, t: Field, xmapr, ymapr, fcoriolis, p: float,
                  compute: int) -> Field:
    """Q-vector components on a pressure level
    (FieldCalculations.cc:505-595): 1/2 the x-component (T / theta input),
    3/4 the y-component.  The theta scale is the reference's own
    ``cp * powf(p / p0, r/cp) / cp`` (cc:538-539), on the host."""
    require(p > 0, "plevelqvector: p <= 0")
    require(compute in (1, 2, 3, 4), f"plevelqvector: bad compute {compute}")
    _check_min_size(z, "plevelqvector")
    if compute in (2, 4):
        pi = np.float32(cp * np.power(np.float32(p) / p0, kappa))
        tscale = float(np.float32(pi / cp))
    else:
        tscale = 1.0
    ug = plevelgwind_xcomp(z, xmapr, ymapr, fcoriolis)
    vg = plevelgwind_ycomp(z, xmapr, ymapr, fcoriolis)
    xm, ym = _vals(xmapr, z), _vals(ymapr, z)
    c = f32(-287.0 / (float(p) * 100.0))
    uv, vv, tv = ug.values, vg.values, t.values
    dtdx = _HALF * xm * tscale * (_xp(tv) - _xm(tv))
    dtdy = _HALF * ym * tscale * (_yp(tv) - _ym(tv))
    if compute < 3:
        dugdx = _HALF * xm * (_xp(uv) - _xm(uv))
        dvgdx = _HALF * xm * (_xp(vv) - _xm(vv))
        out = c * (dugdx * dtdx + dvgdx * dtdy)
    else:
        dugdy = _HALF * ym * (_yp(uv) - _ym(uv))
        dvgdy = _HALF * ym * (_yp(vv) - _ym(vv))
        out = c * (dugdy * dtdx + dvgdy * dtdy)
    mask = _ring(ug.mask) & _ring(vg.mask) & _ring(t.mask)
    return _finish(out, mask)


# -- momentum coordinates ----------------------------------------------------

def _clamped_coriolis(fc: torch.Tensor, fcoriolis_min: float):
    fcormin = f32(abs(fcoriolis_min))
    pos = (fc >= 0) & (fc < fcormin)
    neg = (fc <= 0) & (fc > -fcormin)
    return torch.where(pos, fcormin, torch.where(neg, -fcormin, fc))


def _coordinate(f: Field, axis: int) -> torch.Tensor:
    """The global grid index along ``axis`` (-1 x, -2 y) as float32,
    broadcast to the field's shape: the local index plus the shard's
    offset under a :class:`ShardCtx`."""
    n = f.shape[axis]
    ctx = _SHARD_CTX.get()
    off = 0 if ctx is None else (ctx.col0 if axis == -1 else ctx.row0)
    idx = torch.arange(off, off + n, dtype=torch.float32,
                       device=f.values.device)
    return idx.reshape((n, 1) if axis == -2 else (n,)).expand(f.shape)


def momentum_x_coordinate(v: Field, xmapr, fcoriolis,
                          fcoriolis_min: float) -> Field:
    """m(x,y) = x + v*xmapr/fc with the coriolis parameter clamped away
    from zero (FieldCalculations.cc:2351-2386); x is the grid index."""
    _check_min_size(v, "momentumXcoordinate")
    fc = _clamped_coriolis(_vals(fcoriolis, v), fcoriolis_min)
    return Field(_coordinate(v, -1) + v.values * _vals(xmapr, v) / fc, v.mask)


def momentum_y_coordinate(u: Field, ymapr, fcoriolis,
                          fcoriolis_min: float) -> Field:
    """n(x,y) = y - u*ymapr/fc (FieldCalculations.cc:2388-2422)."""
    _check_min_size(u, "momentumYcoordinate")
    fc = _clamped_coriolis(_vals(fcoriolis, u), fcoriolis_min)
    return Field(_coordinate(u, -2) - u.values * _vals(ymapr, u) / fc, u.mask)


# -- Shapiro filter ----------------------------------------------------------

def _edge_keep(prev, new, axis: int, ctx=None):
    """Keep ``prev`` on the first and last row (axis -2) or column (-1);
    under a :class:`ShardCtx` only on the global ones, so a seam row takes
    the smoothed value (its halo neighbours are real data)."""
    if ctx is not None:
        off, ng = (ctx.col0, ctx.nxg) if axis == -1 else (ctx.row0, ctx.nyg)
        n = new.shape[axis]
        c = torch.arange(off, off + n, device=new.device)
        edge = ((c == 0) | (c == ng - 1)).reshape((n, 1) if axis == -2
                                                  else (n,))
        return torch.where(edge, prev, new)
    if axis == -1:
        return torch.cat([prev[..., :, :1], new[..., :, 1:-1],
                          prev[..., :, -1:]], dim=-1)
    return torch.cat([prev[..., :1, :], new[..., 1:-1, :],
                      prev[..., -1:, :]], dim=-2)


def _shapiro_round(f1, s1, s2, ctx=None):
    """One x pass then one y pass with coefficients ``s1`` / ``s2``."""
    f2 = _edge_keep(f1, f1 + s1 * (_xm(f1) + _xp(f1) - 2.0 * f1), -1, ctx)
    return _edge_keep(f2, f2 + s2 * (_ym(f2) + _yp(f2) - 2.0 * f2), -2, ctx)


def _all_defined_global(f: Field, ctx: ShardCtx) -> bool:
    """Whether the global field is all defined: the shard's points inside
    the global grid (its halo slots beyond the physical edges are
    undefined), then the minimum over the shards (one host sync)."""
    ny, nx = f.shape[-2], f.shape[-1]
    dev = f.mask.device
    r = torch.arange(ctx.row0, ctx.row0 + ny, device=dev).reshape(ny, 1)
    c = torch.arange(ctx.col0, ctx.col0 + nx, device=dev)
    inside = (r >= 0) & (r < ctx.nyg) & (c >= 0) & (c < ctx.nxg)
    alldef = (f.mask | ~inside).all().to(torch.int32).reshape(1)
    return bool(shard_all_reduce(alldef, "min"))


def shapiro2_filter(f: Field, all_defined=None,
                    undef: float = UNDEF) -> Field:
    """2nd-order Shapiro smoother (FieldCalculations.cc:2076-2179).

    All-defined: two rounds of x-then-y passes, s = +0.25 then -0.25.
    Otherwise per-point coefficients frozen from the input mask, and the
    second round keeps +0.25 (the reference's sign flip never reaches its
    coefficient arrays, cc:2141-2168); the arithmetic runs on the sentinel
    values.  The output is all-defined (cc:2176).  ``all_defined`` picks
    the path; ``None`` decides from the mask (one host sync), under a
    :class:`ShardCtx` for the global field, as the reference decides once
    per field (cc:2101)."""
    require(f.shape[-1] >= 3 and f.shape[-2] >= 3,
            "shapiro2_filter: grid must be at least 3x3")
    ctx = _SHARD_CTX.get()
    if all_defined is None:
        all_defined = (bool(f.mask.all()) if ctx is None
                       else _all_defined_global(f, ctx))
    if all_defined:
        f1 = f.values
        for s in (f32(0.25), f32(-0.25)):
            f1 = _shapiro_round(f1, s, s, ctx)
    else:
        f1 = f.to_sentinel(undef)
        m = f.mask
        quarter = torch.full((), f32(0.25), device=f1.device)
        zero = torch.zeros((), device=f1.device)
        s1 = torch.where(_xm(m) & m & _xp(m), quarter, zero)
        s2 = torch.where(_ym(m) & m & _yp(m), quarter, zero)
        for _ in range(2):
            f1 = _shapiro_round(f1, s1, s2, ctx)
    return Field(f1, torch.ones_like(f.mask))
