"""Stability and severe-weather indices on pressure levels (port of
:mod:`mi_fieldcalc_tpu.ops.stability`, ``stability.py:31-160``).

Reference: FieldCalculations.cc — kIndex (745), ductingIndex (816),
showalterIndex (872), boydenIndex (973), sweatIndex (1016).  The
Showalter moist adjustment is the reference's 7 fixed iterations with its
early stop when the parcel leaves the saturation table, as 7 masked
steps over the whole tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import (
    clamp_rh, cp, cplr, eps, ewt_defined, ewt_index, ewt_inverse, ewt_value,
    exl, ms2knots, t0, xlh,
)
from ..field import Field, f32
from ._harness import and_masks, const, div, out_field, require
from .levels import _scalar_pidcp

__all__ = ["k_index", "ducting_index", "showalter_index", "boyden_index",
           "sweat_index"]

_T0 = float(t0)


def k_index(t500: Field, t700: Field, rh700: Field, t850: Field,
            rh850: Field, p500: float, p700: float, p850: float,
            compute: int) -> Field:
    """K-index (T+Td)850 - (T-Td)700 - T500 in Celsius
    (FieldCalculations.cc:745-814): 1 inputs T(K), 2 theta."""
    require(p500 > 0 and p500 < p700 < p850, "kIndex: bad pressures")
    require(compute in (1, 2), f"kIndex: bad compute {compute}")
    if compute == 1:
        cvt500 = cvt700 = cvt850 = 1.0
    else:
        cvt500, cvt700, cvt850 = (float(_scalar_pidcp(p))
                                  for p in (p500, p700, p850))
    mask = and_masks(t500, t700, rh700, t850, rh850)
    tc850 = cvt850 * t850.values - _T0
    tc700 = cvt700 * t700.values - _T0
    x850, l850 = ewt_index(tc850)
    x700, l700 = ewt_index(tc700)
    ok = ewt_defined(l850) & ewt_defined(l700)
    rh_850 = clamp_rh(f32(0.01) * rh850.values)
    tdc850 = ewt_inverse(ewt_value(x850, l850) * rh_850, l850)
    rh_700 = clamp_rh(f32(0.01) * rh700.values)
    tdc700 = ewt_inverse(ewt_value(x700, l700) * rh_700, l700)
    tc500 = cvt500 * t500.values - _T0
    out = (tc850 + tdc850) - (tc700 - tdc700) - tc500
    return out_field(out, mask & ok)


def ducting_index(t850: Field, rh850: Field, p850: float,
                  compute: int) -> Field:
    """Ducting index nw(T) - nw(Td) at one level
    (FieldCalculations.cc:816-870)."""
    require(p850 > 0, "ductingIndex: p <= 0")
    require(compute in (1, 2), f"ductingIndex: bad compute {compute}")
    tconvert = float(_scalar_pidcp(p850)) if compute == 2 else 1.0
    mask = and_masks(t850, rh850)
    rh = clamp_rh(f32(0.01) * rh850.values)
    tk = t850.values * tconvert
    x, l = ewt_index(tk - _T0)
    et = ewt_value(x, l)
    etd = et * rh
    tdk = ewt_inverse(etd, l) + _T0
    out = f32(3.8e5) * (et / (tk * tk) - etd / (tdk * tdk))
    return out_field(out, mask & ewt_defined(l))


def showalter_index(t500: Field, t850: Field, rh850: Field,
                    p500: float, p850: float, compute: int) -> Field:
    """Showalter index: T500 less the 850 hPa parcel lifted along the dry
    adiabat and moist-adjusted in 7 iterations
    (FieldCalculations.cc:872-971): 1 inputs T(K), 2 theta.  Undefined
    inputs give a masked point (the reference leaves the output
    uninitialised there, cc:965-967)."""
    require(0 < p500 < p850, "showalterIndex: bad pressures")
    require(compute in (1, 2), f"showalterIndex: bad compute {compute}")
    pi500 = np.float32(_scalar_pidcp(p500) * cp)
    pi850 = np.float32(_scalar_pidcp(p850) * cp)
    if compute == 1:
        cvt500 = cvt850 = np.float32(1)
        dryadiabat = np.float32(cp * (cp / pi850) * (pi500 / cp))
    else:
        cvt500 = np.float32(pi500 / cp)
        cvt850 = np.float32(pi850 / cp)
        dryadiabat = np.float32(cp * (pi500 / cp))
    mask = and_masks(t500, t850, rh850)
    tk500 = float(cvt500) * t500.values
    tk850 = float(cvt850) * t850.values
    rh = clamp_rh(f32(0.01) * rh850.values)
    x, l = ewt_index(tk850 - _T0)
    etd = ewt_value(x, l) * rh
    tcl = float(dryadiabat) * t850.values
    qcl = float(eps) * etd / const(p850, etd)
    p500t = const(p500, etd)
    active = torch.ones_like(mask)
    for _ in range(7):
        x2, l2 = ewt_index(div(tcl, cp) - _T0)
        active = active & ewt_defined(l2)
        qsat = float(eps) * ewt_value(x2, l2) / p500t
        a1 = float(cplr) * qcl / tcl
        a2 = div(exl, tcl)
        dq = (qcl - qsat) / (1.0 + a1 * a2)
        qcl = torch.where(active, qcl - dq, qcl)
        tcl = torch.where(active, tcl + dq * float(xlh), tcl)
    return out_field(tk500 - div(tcl, cp), mask & ewt_defined(l))


def boyden_index(t700: Field, z700: Field, z1000: Field,
                 p700: float, p1000: float, compute: int) -> Field:
    """Boyden index (Z700-Z1000)/10 - Tc700 - 200
    (FieldCalculations.cc:973-1014)."""
    require(compute in (1, 2), f"boydenIndex: bad compute {compute}")
    require(0 < p700 < p1000, "boydenIndex: bad pressures")
    tconv = float(_scalar_pidcp(p700)) if compute == 2 else 1.0
    tc700 = t700.values * tconv - _T0
    out = div(z700.values - z1000.values, 10.0) - tc700 - 200.0
    return out_field(out, and_masks(t700, z700, z1000))


def sweat_index(t850: Field, t500: Field, td850: Field, td500: Field,
                u850: Field, v850: Field, u500: Field, v500: Field) -> Field:
    """Severe Weather Threat index (FieldCalculations.cc:1016-1040)."""
    mask = and_masks(t850, t500, td850, td500, u850, v850, u500, v500)
    ff850 = torch.sqrt(u850.values * u850.values + v850.values * v850.values)
    ff500 = torch.sqrt(u500.values * u500.values + v500.values * v500.values)
    sind = (u500.values * v850.values - v500.values * u850.values) \
        / (ff850 * ff500)
    knots = f32(ms2knots)
    out = (32.0 * td850.values + 20.0 * t850.values - 40.0 * t500.values
           - 980.0 + 2.0 * (ff850 * knots) + ff500 * knots
           + 125.0 * (sind + f32(0.2)))
    return out_field(out, mask)
