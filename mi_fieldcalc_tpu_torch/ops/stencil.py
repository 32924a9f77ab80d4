"""Horizontal centred-difference stencils (port of the pipeline's slice of
:mod:`mi_fieldcalc_tpu.ops.stencil`, ``stencil.py:51-204, 327-346``).

Arrays are ``[..., ny, nx]``.  Neighbours come from circular shifts; the
wrapped rows and columns are exactly the ones :func:`fill_edges`
overwrites afterwards (FieldCalculations.cc:59-74).
"""

from __future__ import annotations

import torch

from ..field import Field, f32
from ._harness import and_masks, not_ported, require

__all__ = ["fill_edges", "gradient", "relvort", "divergence", "advection",
           "thermal_front_parameter"]

_HALF = f32(0.5)


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


def _finish(values, mask) -> Field:
    return Field(fill_edges(values), fill_edges(mask))


def _check_min_size(f: Field, name: str) -> None:
    ny, nx = f.shape[-2], f.shape[-1]
    require(nx >= 3 and ny >= 3, f"{name}: grid must be at least 3x3")


def gradient(f: Field, xmapr, ymapr, compute: int) -> Field:
    """Centred-difference gradient, compute 3 is |grad f|
    (FieldCalculations.cc:1985-2074)."""
    require(compute in (1, 2, 3, 4), f"gradient: bad compute {compute}")
    if compute != 3:
        raise not_ported("mi_fieldcalc_tpu.ops.gradient",
                         f"gradient compute={compute}")
    _check_min_size(f, "gradient")
    v, m = f.values, f.mask
    dfdx = _HALF * xmapr * (_xp(v) - _xm(v))
    dfdy = _HALF * ymapr * (_yp(v) - _ym(v))
    out = torch.sqrt(dfdx * dfdx + dfdy * dfdy)
    return _finish(out, _xm(m) & _xp(m) & _ym(m) & _yp(m))


def relvort(u: Field, v: Field, xmapr, ymapr) -> Field:
    """Relative vorticity dv/dx - du/dy (FieldCalculations.cc:1843-1873)."""
    _check_min_size(u, "relvort")
    out = (_HALF * xmapr * (_xp(v.values) - _xm(v.values))
           - _HALF * ymapr * (_yp(u.values) - _ym(u.values)))
    mask = _xm(v.mask) & _xp(v.mask) & _ym(u.mask) & _yp(u.mask)
    return _finish(out, mask)


def divergence(u: Field, v: Field, xmapr, ymapr) -> Field:
    """Horizontal divergence du/dx + dv/dy (FieldCalculations.cc:1910-1940).

    Reference quirk (cc:1927): the defined-check reads v[x+-1] and u[y+-1],
    the vorticity stencil's inputs, while the value reads u[x+-1] and
    v[y+-1].  Kept for parity."""
    _check_min_size(u, "divergence")
    out = (_HALF * xmapr * (_xp(u.values) - _xm(u.values))
           + _HALF * ymapr * (_yp(v.values) - _ym(v.values)))
    mask = _xm(v.mask) & _xp(v.mask) & _ym(u.mask) & _yp(u.mask)
    return _finish(out, mask)


def advection(f: Field, u: Field, v: Field, xmapr, ymapr,
              hours: float) -> Field:
    """Scalar advection -(u df/dx + v df/dy) * 3600*hours
    (FieldCalculations.cc:1942-1983)."""
    _check_min_size(f, "advection")
    scale = f32(-3600.0 * hours)
    fv = f.values
    out = (u.values * _HALF * xmapr * (_xp(fv) - _xm(fv))
           + v.values * _HALF * ymapr * (_yp(fv) - _ym(fv))) * scale
    mask = (u.mask & v.mask & _xm(f.mask) & _xp(f.mask) & _ym(f.mask)
            & _yp(f.mask))
    return _finish(out, mask)


def thermal_front_parameter(t: Field, xmapr, ymapr) -> Field:
    """TFP = -grad|grad T| . grad T / |grad T| (FieldCalculations.cc:
    2266-2309), a radius-2 stencil through the filled |grad T| field."""
    _check_min_size(t, "thermalFrontParameter")
    absdelt = gradient(t, xmapr, ymapr, 3)
    a, tv = absdelt.values, t.values
    dadx = _HALF * xmapr * (_xp(a) - _xm(a))
    dady = _HALF * ymapr * (_yp(a) - _ym(a))
    nonzero = a != 0
    ainv = 1 / torch.where(nonzero, a, torch.ones_like(a))
    dtdxa = _HALF * xmapr * (_xp(tv) - _xm(tv)) * ainv
    dtdya = _HALF * ymapr * (_yp(tv) - _ym(tv)) * ainv
    out = -(dadx * dtdxa + dady * dtdya)
    tm, am = t.mask, absdelt.mask
    mask = (_ym(tm) & _xm(tm) & _xp(tm) & _yp(tm)
            & and_masks(_ym(am), _xm(am), am, _xp(am), _yp(am)) & nonzero)
    return _finish(out, mask)

