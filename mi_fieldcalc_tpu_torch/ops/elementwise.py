"""Level-independent pointwise operators (port of
:mod:`mi_fieldcalc_tpu.ops.elementwise`, ``elementwise.py:45-361``).

Reference: FieldCalculations.cc — cvtemp (1608), abshum (1676), cvhum
(1738), vectorabs (1819), windCooling (2181), underCooledRain (2231),
pressure2FlightLevel (2311), values2classes (2462), min/max (2501-2529),
unary math fields (2531-2563), replaceUndefined/replaceDefined
(2565-2608), fieldOPERfield / fieldOPERconstant / constantOPERfield
(2611-2669), snow_in_cm (3063).

``log``, ``exp``, ``pow``, ``log10``, ``pow10`` and ``tanh`` are the
deterministic ``_libm`` functions, as in the JAX package, and every
division goes through :func:`._harness.div`.  ``cvtemp`` modes 3/4 decide
on a masked mean per 2-D field; its sum runs in PyTorch's order, so only a
mean that lies exactly at the ``t0/2`` threshold can decide otherwise than
the JAX package.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .._libm import exp_f32, log10_f32, log_f32, pow10_f32, pow_f32, \
    tanh_f32
from ..constants import (
    F_LEVEL_TABLE, P_LEVEL_TABLE, clamp_rh, ewt_defined, ewt_index,
    ewt_inverse, ewt_value, t0,
)
from ..field import UNDEF, Field, f32, full_undef
from ._harness import and_masks, const, div, out_field, require
from .stencil import shard_all_reduce

__all__ = [
    "cvtemp", "cvhum", "abshum", "vectorabs", "wind_cooling",
    "under_cooled_rain", "pressure2flightlevel", "values2classes",
    "minvalue_fields", "maxvalue_fields", "minvalue_field_const",
    "maxvalue_field_const", "absvalue_field", "log10_field", "pow10_field",
    "log_field", "exp_field", "power_field", "replace_undefined",
    "replace_defined", "field_oper_field", "field_oper_constant",
    "constant_oper_field", "snow_in_cm",
]

_T0 = float(t0)


def _undef_like(f: Field) -> Field:
    return full_undef(f.shape, f.values.device)


def cvtemp(t: Field, compute: int) -> Field:
    """Kelvin <-> Celsius (FieldCalculations.cc:1608-1674): 1 K->C, 2 C->K,
    3 K->C only if the defined points' mean looks like Kelvin, 4 C->K only
    if it looks like Celsius.  Modes 3/4 decide per 2-D field; on a shard
    (``ops.stencil.ShardCtx``) the partial count and sum are summed over
    the shards first, so every shard decides on the global mean."""
    require(compute in (1, 2, 3, 4), f"cvtemp: bad compute {compute}")
    tconvert = -_T0 if compute in (1, 3) else _T0
    converted = t.values + tconvert
    if compute in (1, 2):
        return Field(converted, t.mask)
    navg = shard_all_reduce(t.mask.sum(dim=(-2, -1)), "sum")
    tsum = shard_all_reduce(torch.where(t.mask, t.values, const(
        0.0, t.values)).sum(dim=(-2, -1)), "sum")
    some = navg > 0
    tavg = torch.where(some, div(tsum, torch.where(some, navg, 1).to(
        torch.float32)), const(0.0, tsum))
    half = f32(t0 / 2)
    skip = (tavg < half) if compute == 3 else (tavg > half)
    return Field(torch.where(skip[..., None, None], t.values, converted),
                 t.mask)


def cvhum(t: Field, hum: Field, compute: int, unit: str = "") -> Field:
    """Dewpoint / RH conversions without pressure
    (FieldCalculations.cc:1738-1817): 1 (T[K],RH%)->Td[K], 2 (T[K],RH%)->
    Td[C], 3 (T[C],RH%)->Td[C], 4 (T[K],Td[K])->RH, 5 (T[C],Td[C])->RH.
    ``unit == "1"`` gives RH as a fraction in modes 4/5; ``unit ==
    "celsius"`` remaps 1 to 2."""
    unit_scale = 100.0
    if compute == 1 and unit == "celsius":
        compute = 2
    if compute in (4, 5) and unit == "1":
        unit_scale = 1.0
    require(compute in (1, 2, 3, 4, 5), f"cvhum: bad compute {compute}")
    tconv = _T0 if compute in (1, 2, 4) else 0.0
    tdconv = _T0 if compute == 1 else 0.0
    mask = and_masks(t, hum)
    if compute in (1, 2, 3):
        x, l = ewt_index(t.values - tconv)
        et = ewt_value(x, l)
        rh = clamp_rh(f32(0.01) * hum.values)
        out = ewt_inverse(rh * et, l) + tdconv
        return out_field(out, mask & ewt_defined(l))
    x1, l1 = ewt_index(t.values - tconv)
    x2, l2 = ewt_index(hum.values - tconv)
    ok = ewt_defined(l1) & ewt_defined(l2)
    out = ewt_value(x2, l2) / ewt_value(x1, l1) * unit_scale
    return out_field(out, mask & ok)


def abshum(t: Field, rhum: Field) -> Field:
    """Absolute humidity from the Vaisala / Wexler saturation formula
    (FieldCalculations.cc:1676-1736); ``t`` in Kelvin, ``rhum`` a
    fraction.  Undefined temperatures are replaced by t0 before the
    formula, as in the JAX package."""
    c = f32(2.16679)
    c1, c2, c3 = f32(-7.85951783), f32(1.84408259), f32(-11.7866497)
    c4, c5, c6 = f32(22.6807411), f32(-15.9618719), f32(1.80122502)
    tc, pc = f32(647.096), f32(220640.0)
    tv = t.sanitized(_T0)
    v = 1.0 - div(tv, tc)
    tii = div(1.0, tv)
    v2 = v * v
    v3 = v * v2
    v4 = v2 * v2
    v1_5 = v * torch.sqrt(v)
    v3_5 = v2 * v1_5
    v7_5 = v4 * v3_5
    pws = pc * exp_f32(tc * tii * (c1 * v + c2 * v1_5 + c3 * v3
                                   + c4 * v3_5 + c5 * v4 + c6 * v7_5))
    pw = pws * rhum.values
    return out_field(c * pw * 100.0 * tii, and_masks(t, rhum))


def vectorabs(u: Field, v: Field) -> Field:
    """Vector magnitude sqrt(u^2+v^2) (FieldCalculations.cc:1819-1841)."""
    out = torch.sqrt(u.values * u.values + v.values * v.values)
    return out_field(out, and_masks(u, v))


def wind_cooling(t: Field, u: Field, v: Field, compute: int) -> Field:
    """Wind-chill temperature difference, 2001 NWS formula, clamped <= 0
    (FieldCalculations.cc:2181-2229); 1 T in Kelvin, 2 in Celsius.  The
    mask is propagated (the reference never refreshes it, cc:2217-2220)."""
    require(compute in (1, 2), f"windCooling: bad compute {compute}")
    tc = t.values - (_T0 if compute == 1 else 0.0)
    ff = torch.sqrt(u.values * u.values + v.values * v.values) * f32(3.6)
    ffpow = pow_f32(ff, 0.16)
    dt = f32(13.12) + f32(0.6215) * tc - f32(11.37) * ffpow \
        + f32(0.3965) * tc * ffpow
    return out_field(torch.minimum(dt, const(0.0, dt)), and_masks(t, u, v))


def under_cooled_rain(precip: Field, snow: Field, tk: Field,
                      precip_min: float, snow_rate_max: float,
                      tc_max: float) -> Field:
    """Freezing-rain indicator 0/1 (FieldCalculations.cc:2231-2264)."""
    tk_max = float(np.float32(tc_max) + t0)
    cond = ((precip.values >= f32(precip_min)) & (tk.values <= tk_max)
            & (snow.values <= precip.values * f32(snow_rate_max)))
    return out_field(cond.to(torch.float32), and_masks(precip, snow, tk))


def pressure2flightlevel(pressure: Field) -> Field:
    """Pressure -> flight level through the standard-level table
    (FieldCalculations.cc:2311-2349): clamp into the table, then
    piecewise-linear between the bracketing entries."""
    ptab, ftab = P_LEVEL_TABLE, F_LEVEL_TABLE
    n_tab = len(ptab) - 1
    p = pressure.values.clamp(float(ptab[n_tab]), float(ptab[0]))
    pk0 = torch.full_like(p, float(ptab[0]))
    pk1 = torch.full_like(p, float(ptab[1]))
    fk0 = torch.full_like(p, float(ftab[0]))
    fk1 = torch.full_like(p, float(ftab[1]))
    for j in range(2, n_tab + 1):
        m = p < float(ptab[j - 1])
        pk0 = torch.where(m, float(ptab[j - 1]), pk0)
        pk1 = torch.where(m, float(ptab[j]), pk1)
        fk0 = torch.where(m, float(ftab[j - 1]), fk0)
        fk1 = torch.where(m, float(ftab[j]), fk1)
    ratio = (p - pk0) / (pk1 - pk0)
    return out_field(fk0 + (fk1 - fk0) * ratio, pressure.mask)


def values2classes(f: Field, values: Sequence[float]) -> Field:
    """Bucketise by ascending thresholds (FieldCalculations.cc:2462-2499):
    classes ``0 .. len(values)-2``; points outside ``[values[0],
    values[-1])`` become undefined."""
    require(len(values) >= 2, "values2classes: needs >= 2 values")
    nvalues = len(values) - 2
    v = f.values
    in_range = (v >= f32(values[0])) & (v < f32(values[nvalues + 1]))
    j = torch.ones(v.shape, dtype=torch.int32, device=v.device)
    for k in range(1, nvalues):
        j = j + (f32(values[k]) < v).to(torch.int32)
    return out_field((j - 1).to(torch.float32), f.mask & in_range)


# --- pointwise min/max/arithmetic (FieldCalculations.cc:2501-2669) ----------

def minvalue_fields(f1: Field, f2: Field) -> Field:
    return out_field(torch.minimum(f1.values, f2.values), and_masks(f1, f2))


def maxvalue_fields(f1: Field, f2: Field) -> Field:
    return out_field(torch.maximum(f1.values, f2.values), and_masks(f1, f2))


def minvalue_field_const(f: Field, value: float,
                         undef: float = UNDEF) -> Field:
    if value == undef:
        return _undef_like(f)
    return Field(torch.minimum(f.values, const(value, f.values)), f.mask)


def maxvalue_field_const(f: Field, value: float,
                         undef: float = UNDEF) -> Field:
    if value == undef:
        return _undef_like(f)
    return Field(torch.maximum(f.values, const(value, f.values)), f.mask)


def absvalue_field(f: Field) -> Field:
    return Field(f.values.abs(), f.mask)


def log10_field(f: Field) -> Field:
    return Field(log10_f32(f.sanitized(1.0)), f.mask)


def pow10_field(f: Field) -> Field:
    return Field(pow10_f32(f.sanitized(0.0)), f.mask)


def log_field(f: Field) -> Field:
    return Field(log_f32(f.sanitized(1.0)), f.mask)


def exp_field(f: Field) -> Field:
    return Field(exp_f32(f.sanitized(0.0)), f.mask)


def power_field(f: Field, value: float, undef: float = UNDEF) -> Field:
    if value == undef:
        return _undef_like(f)
    return Field(pow_f32(f.sanitized(1.0), value), f.mask)


def replace_undefined(f: Field, value: float, undef: float = UNDEF) -> Field:
    """A constant at the undefined points (FieldCalculations.cc:2565-2585);
    ``value == undef`` is a no-op."""
    if value == undef:
        return f
    return Field(torch.where(f.mask, f.values, const(value, f.values)),
                 torch.ones_like(f.mask))


def replace_defined(f: Field, value: float, undef: float = UNDEF) -> Field:
    """A constant at the defined points (FieldCalculations.cc:2587-2608);
    ``value == undef`` undefines all.  Undefined points keep the sentinel
    value and the mask stays honest, as in the JAX package (the reference
    flags the output all-defined)."""
    if value == undef:
        return _undef_like(f)
    out = torch.where(f.mask, const(value, f.values), const(undef, f.values))
    return Field(out, f.mask)


def field_oper_field(compute: int, f1: Field, f2: Field) -> Field:
    """field1 <+-*/> field2 (FieldCalculations.cc:2611-2625); a zero
    divisor gives undefined."""
    require(compute in (1, 2, 3, 4), f"fieldOPERfield: bad compute {compute}")
    mask = and_masks(f1, f2)
    a, b = f1.values, f2.values
    if compute == 1:
        return out_field(a + b, mask)
    if compute == 2:
        return out_field(a - b, mask)
    if compute == 3:
        return out_field(a * b, mask)
    nonzero = b != 0
    out = a / torch.where(nonzero, b, const(1.0, b))
    return out_field(out, mask & nonzero)


def field_oper_constant(compute: int, f: Field, value: float,
                        undef: float = UNDEF) -> Field:
    """field <+-*/> constant (FieldCalculations.cc:2627-2645).  The
    undef / zero-divisor early-out comes before the compute check, as in
    the reference (cc:2629-2630)."""
    if value == undef or (compute == 4 and value == 0):
        return _undef_like(f)
    require(compute in (1, 2, 3, 4),
            f"fieldOPERconstant: bad compute {compute}")
    v, c = f.values, f32(value)
    if compute == 1:
        out = v + c
    elif compute == 2:
        out = v - c
    elif compute == 3:
        out = v * c
    else:
        out = div(v, c)
    return Field(out, f.mask)


def constant_oper_field(compute: int, value: float, f: Field,
                        undef: float = UNDEF) -> Field:
    """constant <+-*/> field (FieldCalculations.cc:2647-2669)."""
    if value == undef:
        return _undef_like(f)
    require(compute in (1, 2, 3, 4),
            f"constantOPERfield: bad compute {compute}")
    v, c = f.values, const(value, f.values)
    if compute == 1:
        return Field(c + v, f.mask)
    if compute == 2:
        return Field(c - v, f.mask)
    if compute == 3:
        return Field(c * v, f.mask)
    nonzero = v != 0
    out = c / torch.where(nonzero, v, const(1.0, v))
    return Field(out, f.mask & nonzero)


def snow_in_cm(snow_water: Field, tk2m: Field, td2m: Field) -> Field:
    """Snow water (kg/m^2) -> snow depth (cm), the SMHI MESAN logistic
    factor clamped >= 1 (FieldCalculations.cc:3063-3118), in the JAX
    package's tanh form (it cannot overflow in float32)."""
    mask = and_masks(snow_water, tk2m, td2m)
    t = div(tk2m.values + td2m.values, 2.0)
    t = torch.where(mask, t, const(_T0, t))
    logit_t = -tanh_f32((t - f32(274.3)) * f32(1.75))
    dt = div(t - f32(252.0), 20.0)
    mm2cm_t = div(0.13, f32(0.02) + f32(0.1) * dt * dt)
    fac = logit_t * mm2cm_t
    sw = snow_water.values
    out = torch.where(sw <= 0, const(0.0, sw),
                      torch.where(fac <= 1, sw, sw * fac))
    return out_field(out, mask)
