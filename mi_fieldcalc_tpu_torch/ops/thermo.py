"""Per-point thermodynamic kernels (port of
:mod:`mi_fieldcalc_tpu.ops.thermo`, ``thermo.py:52-136``).

Kernels that can introduce undefined points (saturation table out of
range) return ``(value, ok)``; pure kernels return the value.
"""

from __future__ import annotations

import torch

from ..constants import (
    clamp_rh, cp, eps, ewt_defined, ewt_index, ewt_inverse, ewt_value, t0,
    xlh,
)
from ..field import f32

__all__ = ["esat_table", "t_thesat", "th_thesat", "tk_q_rh", "tk_rh_q",
           "tk_q_td", "tk_rh_td", "tk_rh_the", "tk_q_duct", "tk_rh_duct"]


def esat_table(tk: torch.Tensor):
    """Saturation vapour pressure e_w(T) from the table, T in Kelvin;
    returns ``(et, ok, x, l)``."""
    x, l = ewt_index(tk - float(t0))
    return ewt_value(x, l), ewt_defined(l), x, l


def t_thesat(tk, p, pi):
    """T(K) -> saturated equivalent potential temperature
    (FieldCalculations.cc:196-205)."""
    et, ok, _, _ = esat_table(tk)
    qsat = float(eps) * et / p
    return (float(cp) * tk + float(xlh) * qsat) / pi, ok


def th_thesat(th, p, pi):
    """theta -> saturated equivalent potential temperature
    (FieldCalculations.cc:207-216).  ``th * pi / cp`` is its own spelling
    of the temperature, kept apart from ``t * pidcp``: the two can round
    to different table gates.  The divisor is a tensor: PyTorch's CUDA
    division multiplies by the reciprocal of a Python-number divisor, which
    is not the IEEE quotient."""
    tk = th * pi / torch.full((), float(cp), dtype=th.dtype, device=th.device)
    et, ok, _, _ = esat_table(tk)
    qsat = float(eps) * et / p
    return th + float(xlh) * qsat / pi, ok


def tk_q_rh(tk, q, p):
    """(T[K], q) -> RH% (FieldCalculations.cc:218-227)."""
    et, ok, _, _ = esat_table(tk)
    qsat = float(eps) * et / p
    return f32(100.0) * q / qsat, ok


def tk_rh_q(tk, rh, p):
    """(T[K], RH%) -> q (FieldCalculations.cc:229-238)."""
    et, ok, _, _ = esat_table(tk)
    qsat = float(eps) * et / p
    return f32(0.01) * rh * qsat, ok


def tk_q_td(tk, q, p, tdconv: float):
    """(T[K], q) -> dewpoint, degC or K when ``tdconv == t0``
    (FieldCalculations.cc:240-253)."""
    et, ok, _, l = esat_table(tk)
    qsat = float(eps) * et / p
    rh = clamp_rh(q / qsat)
    return ewt_inverse(rh * et, l) + float(tdconv), ok


def tk_rh_td(tk, rh100, tdconv: float):
    """(T[K], RH%) -> dewpoint (FieldCalculations.cc:255-267)."""
    et, ok, _, l = esat_table(tk)
    rh = clamp_rh(f32(0.01) * rh100)
    return ewt_inverse(rh * et, l) + float(tdconv), ok


def tk_rh_the(tk, rh, thconv):
    """Equivalent potential temperature building block
    (FieldCalculations.cc:269-278): ``tk*thconv + e_w(tk)*rh``, where the
    caller pre-scales ``rh`` by ``0.01*(xlh/pi)*eps/p``."""
    et, ok, _, _ = esat_table(tk)
    return tk * float(thconv) + et * rh, ok


def tk_q_duct(tk, q, p):
    """Ducting index from specific humidity (FieldCalculations.cc:280-283)."""
    return (f32(77.6) * (p / tk)
            + f32(373000.0) * (q * p) / (float(eps) * tk * tk))


def tk_rh_duct(tk, rh100, p):
    """Ducting index from RH% (FieldCalculations.cc:285-296)."""
    et, ok, _, _ = esat_table(tk)
    rh = clamp_rh(rh100 * f32(0.01))
    return (f32(77.6) * (p / tk)
            + f32(373000.0) * rh * et / (tk * tk)), ok
