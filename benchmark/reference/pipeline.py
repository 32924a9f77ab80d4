"""The plain reference of the 12-output derived-field pipeline on hybrid
model levels: pressure, theta, RH, Td, theta_e, ducting, wind speed,
vorticity, divergence, 1-hour T-advection, |grad T| and the thermal front
parameter, with the reference library's masks (FieldCalculations.cc).

A frozen copy, in one file, of the modes the pipeline uses of the port's
plain operators (``mi_fieldcalc_tpu_torch/models/pipeline.py``
``derived_fields`` and the ``ops`` it calls), so that a later change to
the program does not change the yardstick.  Every operation is a separate
PyTorch call in the order the operators take them, so on the card it
rounds as the pipeline kernel (compiled with ``-fmad=false``) does.

Every stencil is horizontal, so levels are independent: a caller may pass
any block of levels with its own hybrid coefficients.
"""

from __future__ import annotations

import torch

from ._base import (EWT, N_EWT, Field, and_masks, cp, eps, f32, kappa,
                    p0inv, rhmax, rhmin, t0, xlh)
from ._libm import pow_posc_f32

__all__ = ["FIELDS", "derived_fields"]

#: output order, as the program's stacked layout holds the planes
FIELDS = ("p", "th", "rh", "td", "thetae", "ducting", "wspeed", "vort",
          "div", "tadv", "gradt", "tfp")

_HALF = f32(0.5)
UNDEF = f32(1.0e35)


def _ewt(device) -> torch.Tensor:
    return torch.as_tensor(EWT, device=device)


def _pidcp(p: torch.Tensor) -> torch.Tensor:
    """``(p/p0)**kappa``: 0 at p == 0, NaN below it (powf's edges)."""
    x = p * float(p0inv)
    edge = torch.where(x == 0, torch.zeros_like(x),
                       torch.full_like(x, float("nan")))
    return torch.where(x > 0, pow_posc_f32(x, kappa), edge)


def _ewt_index(t_celsius: torch.Tensor):
    """``x = (t+100)*0.2``, ``l = int(x)`` clamped to [-1, 40] while a
    float (MetConstants.h:64-68)."""
    x = (t_celsius + f32(100.0)) * f32(0.2)
    lf = torch.nan_to_num(torch.trunc(x), nan=0.0).clamp(-1.0, 40.0)
    return x, lf.to(torch.int32)


def _esat(tk: torch.Tensor):
    """e_w(T) from the table, T in Kelvin: ``(et, ok, l)``."""
    x, l = _ewt_index(tk - float(t0))
    ls = l.clamp(0, N_EWT - 2)
    tab = _ewt(tk.device)
    e0 = tab[ls.long()]
    e1 = tab[ls.long() + 1]
    et = e0 + (e1 - e0) * (x - ls.to(torch.float32))
    return et, (l >= 0) & (l < N_EWT - 1), l


def _ewt_inverse(et: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """MetConstants.cc:37-45: the count of table entries <= et, clipped to
    [0, clip(l, 0, 39)], and the linear inverse in that interval."""
    cnt = torch.zeros(et.shape, dtype=torch.int32, device=et.device)
    for k in range(N_EWT):
        cnt += (et >= float(EWT[k])).to(torch.int32)
    ll = torch.minimum((cnt - 1).clamp(min=0), l.clamp(0, N_EWT - 2))
    tab = _ewt(et.device)
    e0 = tab[ll.long()]
    e1 = tab[ll.long() + 1]
    rr = (et - e0) / (e1 - e0)
    return f32(-100.0) + (ll.to(torch.float32) + rr) * f32(5.0)


def _xm(a):
    return torch.roll(a, 1, dims=-1)


def _xp(a):
    return torch.roll(a, -1, dims=-1)


def _ym(a):
    return torch.roll(a, 1, dims=-2)


def _yp(a):
    return torch.roll(a, -1, dims=-2)


def _fill_edges(a: torch.Tensor) -> torch.Tensor:
    """Column 0 <- 1 and nx-1 <- nx-2, then row 0 <- 1 and ny-1 <- ny-2
    (FieldCalculations.cc:59-74)."""
    a = torch.cat([a[..., :, 1:2], a[..., :, 1:-1], a[..., :, -2:-1]], dim=-1)
    return torch.cat([a[..., 1:2, :], a[..., 1:-1, :], a[..., -2:-1, :]],
                     dim=-2)


def _finish(values, mask) -> Field:
    return Field(_fill_edges(values), _fill_edges(mask))


def _gradt(f: Field, xm, ym) -> Field:
    """|grad f| (FieldCalculations.cc:1985-2074, compute 3)."""
    v, m = f.values, f.mask
    dfdx = _HALF * xm * (_xp(v) - _xm(v))
    dfdy = _HALF * ym * (_yp(v) - _ym(v))
    out = torch.sqrt(dfdx * dfdx + dfdy * dfdy)
    return _finish(out, _xm(m) & _xp(m) & _ym(m) & _yp(m))


def derived_fields(tk: Field, q: Field, u: Field, v: Field, ps: Field,
                   alevel, blevel, xmapr, ymapr) -> dict:
    """The 12 outputs as ``{name: Field}`` of ``[nlev, ny, nx]``.

    ``tk, q, u, v`` are ``[nlev, ny, nx]`` Fields, ``ps`` ``[ny, nx]``,
    ``alevel, blevel`` the ``[nlev]`` hybrid coefficients (hPa and 1) and
    ``xmapr, ymapr`` ``[ny, nx]`` map factors."""
    shape = tk.values.shape
    nlev = shape[0]
    a = alevel.to(torch.float32).reshape(nlev, 1, 1)
    b = blevel.to(torch.float32).reshape(nlev, 1, 1)
    p = Field(a + b * ps.values[None], ps.mask[None].expand(shape))
    xm = xmapr.to(torch.float32).expand(shape)
    ym = ymapr.to(torch.float32).expand(shape)
    out = {"p": p}

    # theta (aleveltemp compute 3)
    out["th"] = Field(tk.values / _pidcp(p.values), and_masks(tk, p))

    # RH and Td (alevelhum 1 and 9): an undefined pressure enters the
    # formulas as the sentinel itself (FieldCalculations.cc:1438)
    p_sent = torch.where(p.mask, p.values, torch.full((), UNDEF,
                                                      device=p.values.device))
    et, ok, l = _esat(tk.values)
    qsat = float(eps) * et / p_sent
    out["rh"] = Field(f32(100.0) * q.values / qsat, and_masks(tk, q) & ok)
    rhf = (q.values / qsat).clamp(float(rhmin), float(rhmax))
    out["td"] = Field(_ewt_inverse(rhf * et, l) + float(t0),
                      and_masks(tk, q) & ok)

    # theta_e (alevelthe 1)
    pi = float(cp) * _pidcp(p.values)
    out["thetae"] = Field((tk.values * float(cp) + q.values * float(xlh)) / pi,
                          and_masks(tk, q, p))

    # ducting (alevelducting 1)
    tv, pv = tk.values, p.values
    out["ducting"] = Field(f32(77.6) * (pv / tv)
                           + f32(373000.0) * (q.values * pv)
                           / (float(eps) * tv * tv), and_masks(tk, q, p))

    # wind speed
    out["wspeed"] = Field(torch.sqrt(u.values * u.values
                                     + v.values * v.values), and_masks(u, v))

    # relative vorticity and divergence (the divergence's defined-check
    # reads the vorticity stencil's inputs, cc:1927)
    uv, vv = u.values, v.values
    vort_mask = _xm(v.mask) & _xp(v.mask) & _ym(u.mask) & _yp(u.mask)
    out["vort"] = _finish(_HALF * xm * (_xp(vv) - _xm(vv))
                          - _HALF * ym * (_yp(uv) - _ym(uv)), vort_mask)
    out["div"] = _finish(_HALF * xm * (_xp(uv) - _xm(uv))
                         + _HALF * ym * (_yp(vv) - _ym(vv)), vort_mask)

    # 1-hour temperature advection
    fv = tk.values
    scale = f32(-3600.0)
    tadv = (uv * _HALF * xm * (_xp(fv) - _xm(fv))
            + vv * _HALF * ym * (_yp(fv) - _ym(fv))) * scale
    out["tadv"] = _finish(tadv, u.mask & v.mask & _xm(tk.mask)
                          & _xp(tk.mask) & _ym(tk.mask) & _yp(tk.mask))

    # |grad T| and the thermal front parameter (cc:2266-2309)
    g = _gradt(tk, xm, ym)
    out["gradt"] = g
    ga = g.values
    dadx = _HALF * xm * (_xp(ga) - _xm(ga))
    dady = _HALF * ym * (_yp(ga) - _ym(ga))
    nonzero = ga != 0
    ainv = 1 / torch.where(nonzero, ga, torch.ones_like(ga))
    dtdxa = _HALF * xm * (_xp(fv) - _xm(fv)) * ainv
    dtdya = _HALF * ym * (_yp(fv) - _ym(fv)) * ainv
    tm, am = tk.mask, g.mask
    tfp_mask = (_ym(tm) & _xm(tm) & _xp(tm) & _yp(tm)
                & _ym(am) & _xm(am) & am & _xp(am) & _yp(am) & nonzero)
    out["tfp"] = _finish(-(dadx * dtdxa + dady * dtdya), tfp_mask)
    return out
