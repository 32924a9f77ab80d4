"""Temperature / humidity / THE / ducting operators on pressure, hybrid,
generic model and ocean levels (port of :mod:`mi_fieldcalc_tpu.ops.levels`).

The pressure-level family (``pleveltemp`` ... ``plevelducting``,
``pleveldz2tmean``) folds ``(p/p0)**kappa`` into a float32 scalar on the
host, as the reference does; the scalars reach the tensors as 0-dim
tensors wherever they divide, so every quotient stays IEEE on the card.
The hybrid ("hlevel", per-point ``p = alevel + blevel * ps``) and generic
model-level ("alevel", a pressure field) variants share one core per
family taking a pressure tensor, as in the JAX package.  Every compute
mode of every family is ported, with the reference's quirks:

* ``alevelhum`` lets an undefined pressure flow into the pressure-using
  modes as the sentinel itself (defined garbage), while its
  pressure-independent modes 7/11 require a defined pressure;
* ``hlevelhum``'s ps gate is the inverse: defined ps required except for
  modes 7/11;
* ``alevelducting`` propagates the pressure mask (the reference never
  updates it, a latent bug the JAX package corrects).

``sea_sound_speed`` keeps the reference's float64 intermediates
(FieldCalculations.cc:1581-1593) as float64 tensors; the JAX package
computes it in float32.  Invalid parameters raise :class:`ValueError`
(reference: ``return false``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import cp, eps, g, kappa, p0inv, pidcp_from_p, t0, xlh
from ..field import UNDEF, Field, f32, full_undef
from . import thermo
from ._harness import and_masks, const, div, out_field, require

__all__ = [
    "pleveltemp", "plevelthe", "plevelhum", "pleveldz2tmean",
    "plevelducting", "sea_sound_speed", "hleveltemp", "hlevelthe",
    "hlevelhum", "hlevelducting", "hlevelpressure", "aleveltemp",
    "alevelthe", "alevelhum", "alevelducting",
]


def _scalar_pidcp(p: float) -> np.float32:
    """Host-side float32 ``(p/p0)**kappa``, numpy's float32 ``powf``."""
    return np.float32(np.power(np.float32(p) * p0inv, kappa))


def _remap_temp_compute(compute: int, unit: str) -> int:
    """Unit-string override for the *temp ops (FieldCalculations.cc:340-345)."""
    if compute < 3:
        if unit == "celsius":
            return 1
        if unit == "kelvin":
            return 2
    return compute


def _remap_hum_compute(compute: int, unit: str) -> int:
    """Celsius/Kelvin dewpoint remap for the *hum ops
    (FieldCalculations.cc:422-425)."""
    if compute > 8 and unit == "celsius":
        return compute - 4
    if 4 < compute <= 8 and unit == "kelvin":
        return compute + 4
    return compute


def _bad_hlevel(alevel: float, blevel: float) -> bool:
    """Hybrid-coefficient validation (FieldCalculations.cc:298-301)."""
    return (alevel < 0.0) or (blevel < 0.0) or \
        (alevel == 0.0 and blevel == 0.0) or (blevel > 1.0)


def _hybrid_p(ps: Field, alevel: float, blevel: float) -> torch.Tensor:
    return f32(alevel) + f32(blevel) * ps.values


# ---------------------------------------------------------------------------
# pressure levels: p a constant
# ---------------------------------------------------------------------------

def pleveltemp(t: Field, p: float, compute: int, unit: str = "") -> Field:
    """Pressure-level temperature conversions (FieldCalculations.cc:
    328-367): 1 TH->T(C), 2 TH->T(K), 3 T(K)->TH, 4 T(K)->theta_e,sat,
    5 TH->theta_e,sat; ``unit`` overrides compute < 3."""
    require(p > 0, "pleveltemp: p <= 0")
    compute = _remap_temp_compute(compute, unit)
    require(1 <= compute <= 5, f"pleveltemp: bad compute {compute}")
    pidcp = _scalar_pidcp(p)
    v = t.values
    if compute == 1:
        return Field(v * float(pidcp) - float(t0), t.mask)
    if compute == 2:
        return Field(v * float(pidcp), t.mask)
    if compute == 3:
        return Field(div(v, pidcp), t.mask)
    pa, pi = const(p, v), const(np.float32(pidcp * cp), v)
    if compute == 4:
        out, ok = thermo.t_thesat(v, pa, pi)
    else:  # 5
        out, ok = thermo.th_thesat(v, pa, pi)
    return out_field(out, t.mask & ok)


def plevelthe(t: Field, rh: Field, p: float, compute: int) -> Field:
    """Equivalent potential temperature from T or TH and RH% at a pressure
    level (FieldCalculations.cc:369-398): 1 T(K), 2 TH."""
    require(compute in (1, 2), f"plevelthe: bad compute {compute}")
    require(p > 0, "plevelthe: p <= 0")
    pidcp = _scalar_pidcp(p)
    pi = np.float32(pidcp * cp)
    cvrh = np.float32(np.float32(0.01) * (xlh / pi) * eps / np.float32(p))
    tconv = float(pidcp) if compute == 2 else 1.0
    out, ok = thermo.tk_rh_the(t.values * tconv, rh.values * float(cvrh),
                               np.float32(1) / pidcp)
    return out_field(out, and_masks(t, rh) & ok)


def plevelhum(t: Field, hum: Field, p: float, compute: int, unit: str = "",
              undef: float = UNDEF) -> Field:
    """Pressure-level humidity conversions (FieldCalculations.cc:400-464).
    compute (after the unit remap): 1/2 q->RH%, 3/4 RH%->q, 5/6 RH%->Td(C),
    7/8 q->Td(C), 9-12 as 5-8 in Kelvin; odd modes take T(K), even modes
    TH.  ``p == undef`` gives an all-undefined field unless the mode does
    not use the pressure (5/6/9/10)."""
    require(p > 0 and 0 < compute < 13, "plevelhum: bad p or compute")
    compute = _remap_hum_compute(compute, unit)
    if p == undef and compute not in (5, 6, 9, 10):
        return full_undef(t.shape, device=t.values.device)
    tconv = float(_scalar_pidcp(p)) if compute % 2 == 0 else 1.0
    tdconv = float(t0) if compute >= 9 else 0.0
    tk = t.values * tconv
    pa = const(p, tk)
    if compute in (1, 2):
        out, ok = thermo.tk_q_rh(tk, hum.values, pa)
    elif compute in (3, 4):
        out, ok = thermo.tk_rh_q(tk, hum.values, pa)
    elif compute in (5, 6, 9, 10):
        out, ok = thermo.tk_rh_td(tk, hum.values, tdconv)
    else:  # 7, 8, 11, 12
        out, ok = thermo.tk_q_td(tk, hum.values, pa, tdconv)
    return out_field(out, and_masks(t, hum) & ok)


def plevelducting(t: Field, h: Field, p: float, compute: int) -> Field:
    """Ducting index at a pressure level (FieldCalculations.cc:597-636):
    1 (T,q), 2 (TH,q), 3 (T,RH%), 4 (TH,RH%)."""
    require(p > 0, "plevelducting: p <= 0")
    require(compute in (1, 2, 3, 4), f"plevelducting: bad compute {compute}")
    tconv = float(_scalar_pidcp(p)) if compute % 2 == 0 else 1.0
    tk = t.values * tconv
    pa = const(p, tk)
    mask = and_masks(t, h)
    if compute in (1, 2):
        return out_field(thermo.tk_q_duct(tk, h.values, pa), mask)
    out, ok = thermo.tk_rh_duct(tk, h.values, pa)
    return out_field(out, mask & ok)


def pleveldz2tmean(z1: Field, z2: Field, p1: float, p2: float,
                   compute: int) -> Field:
    """Mean temperature of a thickness layer (FieldCalculations.cc:
    466-503): 1 mean T(C), 2 mean T(K), 3 mean theta."""
    require(p1 > 0 and p2 > 0 and p1 != p2, "pleveldz2tmean: bad p1/p2")
    require(compute in (1, 2, 3), f"pleveldz2tmean: bad compute {compute}")
    pi1 = np.float32(_scalar_pidcp(p1) * cp)
    pi2 = np.float32(_scalar_pidcp(p2) * cp)
    if compute in (1, 2):
        convert = np.float32(g * np.float32(0.5) * (pi1 + pi2)
                             / ((pi2 - pi1) * cp))
        tconvert = -float(t0) if compute == 1 else 0.0
    else:
        convert = np.float32(g / (pi2 - pi1))
        tconvert = 0.0
    out = (z1.values - z2.values) * float(convert) + tconvert
    return out_field(out, and_masks(z1, z2))


def sea_sound_speed(t: Field, s: Field, z: float, compute: int) -> Field:
    """Sea-water sound speed, D. Ross SACLANTCEN SM-107
    (FieldCalculations.cc:1555-1602): 1 T in Celsius, 2 in Kelvin.  The
    intermediates are float64, as the reference's are (cc:1581-1593); the
    result is rounded to float32."""
    require(compute in (1, 2), f"seaSoundSpeed: bad compute {compute}")
    tconv = 0.0 if compute == 1 else float(t0)
    zz = abs(float(z))
    cz = 0.01635 * zz + 0.000000175 * zz * zz
    tt = t.values.to(torch.float64) - tconv
    ss = s.values.to(torch.float64)
    ct = 4.565 * tt - 0.0517 * tt * tt + 0.000221 * tt * tt * tt
    cs = (1.338 - 0.013 * tt + 0.0001 * tt * tt) * (ss - 35.0)
    out = 1449.1 + ct + cs + cz
    return out_field(out.to(torch.float32), and_masks(t, s))


# ---------------------------------------------------------------------------
# the shared cores (p_arr: the per-point pressure tensor)
# ---------------------------------------------------------------------------

def _leveltemp_core(t: Field, p_arr, mask, compute: int) -> Field:
    """Temperature core (FieldCalculations.cc:1076-1095, 1332-1350):
    1 TH->T(C), 2 TH->T(K), 3 T(K)->TH, 4 T(K)->theta_e,sat,
    5 TH->theta_e,sat."""
    pidcp = pidcp_from_p(p_arr)
    v = t.values
    if compute == 1:
        return out_field(v * pidcp - float(t0), mask)
    if compute == 2:
        return out_field(v * pidcp, mask)
    if compute == 3:
        return out_field(v / pidcp, mask)
    pi = pidcp * float(cp)
    if compute == 4:
        out, ok = thermo.t_thesat(v, p_arr, pi)
    else:  # 5
        out, ok = thermo.th_thesat(v, p_arr, pi)
    return out_field(out, mask & ok)


def _levelthe_core(t: Field, q: Field, p_arr, mask, compute: int) -> Field:
    """THE core (FieldCalculations.cc:1128-1140, 1377-1389): 1 (T(K), q),
    2 (TH, q)."""
    pi = float(cp) * pidcp_from_p(p_arr)
    if compute == 1:
        out = (t.values * float(cp) + q.values * float(xlh)) / pi
    else:
        out = t.values + q.values * float(xlh) / pi
    return out_field(out, mask)


def _levelhum_core(t: Field, hum: Field, p_arr, p_mask,
                   compute: int) -> Field:
    """Humidity core (FieldCalculations.cc:1186-1214, 1428-1454).  Mode
    numbering differs from plevelhum: 1/2 q->RH, 3/4 RH->q, 5/6/9/10
    q->Td, 7/8/11/12 RH->Td (7/11 pressure-independent); odd modes take
    T(K), even modes theta; 9-12 give Td in Kelvin.

    ``p_mask`` is the pressure gate: None means the pressure's definedness
    does not gate the output (h- and a-level gates differ, see
    :func:`hlevelhum` / :func:`alevelhum`)."""
    mask = and_masks(t, hum)
    if p_mask is not None:
        mask = mask & p_mask
    tdconv = float(t0) if compute >= 9 else 0.0
    tk = t.values if compute % 2 == 1 else t.values * pidcp_from_p(p_arr)
    if compute in (1, 2):
        out, ok = thermo.tk_q_rh(tk, hum.values, p_arr)
    elif compute in (3, 4):
        out, ok = thermo.tk_rh_q(tk, hum.values, p_arr)
    elif compute in (5, 6, 9, 10):
        out, ok = thermo.tk_q_td(tk, hum.values, p_arr, tdconv)
    else:  # 7, 8, 11, 12
        out, ok = thermo.tk_rh_td(tk, hum.values, tdconv)
    return out_field(out, mask & ok)


def _levelducting_core(t: Field, h: Field, p_arr, mask,
                       compute: int) -> Field:
    """Ducting core (FieldCalculations.cc:1256-1271, 1490-1502):
    1 (T,q), 2 (TH,q), 3 (T,RH%), 4 (TH,RH%)."""
    tk = t.values
    if compute % 2 == 0:
        tk = tk * pidcp_from_p(p_arr)
    if compute in (1, 2):
        return out_field(thermo.tk_q_duct(tk, h.values, p_arr), mask)
    out, ok = thermo.tk_rh_duct(tk, h.values, p_arr)
    return out_field(out, mask & ok)


# ---------------------------------------------------------------------------
# hybrid levels: p = alevel + blevel * ps
# ---------------------------------------------------------------------------

def hleveltemp(t: Field, ps: Field, alevel: float, blevel: float,
               compute: int, unit: str = "") -> Field:
    """Hybrid-level temperature conversions (FieldCalculations.cc:1046-1098)."""
    compute = _remap_temp_compute(compute, unit)
    require(not _bad_hlevel(alevel, blevel), "hleveltemp: bad alevel/blevel")
    require(1 <= compute <= 5, f"hleveltemp: bad compute {compute}")
    return _leveltemp_core(t, _hybrid_p(ps, alevel, blevel),
                           and_masks(t, ps), compute)


def hlevelthe(t: Field, q: Field, ps: Field, alevel: float, blevel: float,
              compute: int) -> Field:
    """THE on hybrid levels (FieldCalculations.cc:1100-1143)."""
    require(not _bad_hlevel(alevel, blevel), "hlevelthe: bad alevel/blevel")
    require(compute in (1, 2), f"hlevelthe: bad compute {compute}")
    return _levelthe_core(t, q, _hybrid_p(ps, alevel, blevel),
                          and_masks(t, q, ps), compute)


def hlevelhum(t: Field, hum: Field, ps: Field, alevel: float, blevel: float,
              compute: int, unit: str = "") -> Field:
    """Hybrid-level humidity conversions (FieldCalculations.cc:1145-1217).
    ps must be defined except for the pressure-independent modes 7/11
    (cc:1187)."""
    require(0 < compute < 13, f"hlevelhum: bad compute {compute}")
    require(not _bad_hlevel(alevel, blevel), "hlevelhum: bad alevel/blevel")
    compute = _remap_hum_compute(compute, unit)
    p_mask = None if compute in (7, 11) else ps.mask
    return _levelhum_core(t, hum, _hybrid_p(ps, alevel, blevel), p_mask,
                          compute)


def hlevelducting(t: Field, h: Field, ps: Field, alevel: float,
                  blevel: float, compute: int) -> Field:
    """Ducting on hybrid levels (FieldCalculations.cc:1219-1274)."""
    require(not _bad_hlevel(alevel, blevel),
            "hlevelducting: bad alevel/blevel")
    require(compute in (1, 2, 3, 4), f"hlevelducting: bad compute {compute}")
    return _levelducting_core(t, h, _hybrid_p(ps, alevel, blevel),
                              and_masks(t, h, ps), compute)


def hlevelpressure(ps: Field, alevel: float, blevel: float) -> Field:
    """Per-point hybrid-level pressure ``p = alevel + blevel*ps``
    (FieldCalculations.cc:1276-1304)."""
    require(not _bad_hlevel(alevel, blevel),
            "hlevelpressure: bad alevel/blevel")
    return Field(_hybrid_p(ps, alevel, blevel), ps.mask)


# ---------------------------------------------------------------------------
# generic model levels: a pressure field
# ---------------------------------------------------------------------------

def aleveltemp(t: Field, p: Field, compute: int, unit: str = "") -> Field:
    """Model-level temperature conversions with a pressure field
    (FieldCalculations.cc:1310-1353)."""
    require(0 < compute < 6, f"aleveltemp: bad compute {compute}")
    compute = _remap_temp_compute(compute, unit)
    return _leveltemp_core(t, p.values, and_masks(t, p), compute)


def alevelthe(t: Field, q: Field, p: Field, compute: int) -> Field:
    """THE on generic model levels (FieldCalculations.cc:1355-1392)."""
    require(compute in (1, 2), f"alevelthe: bad compute {compute}")
    return _levelthe_core(t, q, p.values, and_masks(t, q, p), compute)


def alevelhum(t: Field, hum: Field, p: Field, compute: int,
              unit: str = "") -> Field:
    """Model-level humidity conversions with a pressure field
    (FieldCalculations.cc:1394-1458).

    Reference quirk (cc:1438, inverted against hlevelhum): the
    pressure-independent modes 7/11 demand a defined p, while every
    p-using mode lets an undefined p flow into the formulas and gives
    defined garbage.  Reproduced by computing with ``p.to_sentinel()``."""
    require(0 < compute < 13, f"alevelhum: bad compute {compute}")
    compute = _remap_hum_compute(compute, unit)
    if compute in (7, 11):
        return _levelhum_core(t, hum, p.values, p.mask, compute)
    return _levelhum_core(t, hum, p.to_sentinel(), None, compute)


def alevelducting(t: Field, h: Field, p: Field, compute: int) -> Field:
    """Ducting with a pressure field (FieldCalculations.cc:1460-1505).  The
    mask includes p's (the reference never updates it here, cc:1500-1503;
    the JAX package corrects that and so does the port)."""
    require(compute in (1, 2, 3, 4), f"alevelducting: bad compute {compute}")
    return _levelducting_core(t, h, p.values, and_masks(t, h, p), compute)
