"""Per-point thermodynamic kernels (port of the pipeline's slice of
:mod:`mi_fieldcalc_tpu.ops.thermo`, ``thermo.py:52-130``).

Kernels that can introduce undefined points (saturation table out of
range) return ``(value, ok)``; pure kernels return the value.
"""

from __future__ import annotations

import torch

from ..constants import (
    clamp_rh, eps, ewt_defined, ewt_index, ewt_inverse, ewt_value, t0,
)
from ..field import f32

__all__ = ["esat_table", "tk_q_rh", "tk_q_td", "tk_q_duct"]


def esat_table(tk: torch.Tensor):
    """Saturation vapour pressure e_w(T) from the table, T in Kelvin;
    returns ``(et, ok, x, l)``."""
    x, l = ewt_index(tk - float(t0))
    return ewt_value(x, l), ewt_defined(l), x, l


def tk_q_rh(tk, q, p):
    """(T[K], q) -> RH% (FieldCalculations.cc:218-227)."""
    et, ok, _, _ = esat_table(tk)
    qsat = float(eps) * et / p
    return f32(100.0) * q / qsat, ok


def tk_q_td(tk, q, p, tdconv: float):
    """(T[K], q) -> dewpoint, degC or K when ``tdconv == t0``
    (FieldCalculations.cc:240-253)."""
    et, ok, _, l = esat_table(tk)
    qsat = float(eps) * et / p
    rh = clamp_rh(q / qsat)
    return ewt_inverse(rh * et, l) + float(tdconv), ok


def tk_q_duct(tk, q, p):
    """Ducting index from specific humidity (FieldCalculations.cc:280-283)."""
    return (f32(77.6) * (p / tk)
            + f32(373000.0) * (q * p) / (float(eps) * tk * tk))
