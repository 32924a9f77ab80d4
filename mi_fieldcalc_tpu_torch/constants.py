"""Physical constants, the saturation-vapour table and the flight-level
table.

PyTorch port of the slice of :mod:`mi_fieldcalc_tpu.constants` that the
operators need (the ICAO helpers are host numpy there and not used by
any operator).  The numpy constants carry the reference's
float32 values (MetConstants.h:39-59); they are the same objects the JAX
package defines, re-declared here because the port never imports it.
"""

from __future__ import annotations

import numpy as np
import torch

from .field import f32

__all__ = [
    "cp", "cplr", "eps", "exl", "g", "kappa", "ms2knots", "p0inv", "rhmin",
    "rhmax", "t0", "xlh", "EWT", "P_LEVEL_TABLE", "F_LEVEL_TABLE",
    "N_EWT", "ewt_index", "ewt_defined", "ewt_value", "ewt_inverse",
    "clamp_rh", "pidcp_from_p",
]

r = np.float32(287.0)
cp = np.float32(1004.0)
p0 = np.float32(1000.0)
t0 = np.float32(273.15)
eps = np.float32(0.622)
xlh = np.float32(2.501e6)
rcp = np.float32(r / cp)
cplr = np.float32(xlh / rcp)
exl = np.float32(eps * xlh)
p0inv = np.float32(1.0 / p0)
kappa = np.float32(r / cp)
g = np.float32(9.8)
rhmin = np.float32(0.02)
rhmax = np.float32(1.00)
ms2knots = 3600.0 / 1852.0  # a double in the reference

# e_w(T) for T = -100, -95, ..., +100 degC; 41 entries (MetConstants.h:56-59)
N_EWT = 41
EWT = np.array(
    [.000034, .000089, .000220, .000517, .001155, .002472, .005080, .01005,
     .01921, .03553, .06356, .1111, .1891, .3139, .5088, .8070, 1.2540,
     1.9118, 2.8627, 4.2148, 6.1078, 8.7192, 12.272, 17.044, 23.373, 31.671,
     42.430, 56.236, 73.777, 95.855, 123.40, 157.46, 199.26, 250.16, 311.69,
     385.56, 473.67, 578.09, 701.13, 845.28, 1013.25], dtype=np.float32)

# pressure <-> flight level (MetConstants.h:87-91)
P_LEVEL_TABLE = np.array(
    [1000, 925, 850, 800, 700, 500, 400, 300, 250, 200, 150, 100, 70, 50, 30,
     10], dtype=np.float32)
F_LEVEL_TABLE = np.array(
    [5, 25, 50, 65, 100, 185, 235, 300, 340, 385, 445, 530, 605, 675, 780,
     1020], dtype=np.float32)


#: device -> the EWT table on it
_EWT = {}


def _ewt(device) -> torch.Tensor:
    """The EWT table on ``device``, copied there at its first use and kept:
    later uses copy no host data, so a CUDA graph can capture them."""
    t = _EWT.get(device)
    if t is None:
        t = _EWT[device] = torch.as_tensor(EWT, device=device)
    return t


def ewt_index(t_celsius: torch.Tensor):
    """Table coordinate ``x = (t+100)*0.2`` and ``l = int(x)``
    (MetConstants.h:64-68).

    ``l`` follows the JAX package's float-to-int conversion, which
    truncates toward zero, saturates out-of-range values and maps NaN to 0.
    Every use of ``l`` clips it into ``[0, 39]`` or tests ``0 <= l < 40``,
    so ``l`` is clamped to ``[-1, 40]`` while still a float: exact, free of
    the undefined behaviour of a C cast, and equal in every use.
    """
    x = (t_celsius + f32(100.0)) * f32(0.2)
    lf = torch.nan_to_num(torch.trunc(x), nan=0.0).clamp(-1.0, 40.0)
    return x, lf.to(torch.int32)


def ewt_defined(l: torch.Tensor) -> torch.Tensor:
    """``ewt_calculator::defined`` (MetConstants.h:69)."""
    return (l >= 0) & (l < N_EWT - 1)


def ewt_value(x: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """``ewt[l] + (ewt[l+1]-ewt[l])*(x-l)`` with ``l`` clipped to
    ``[0, 39]`` for safe evaluation (MetConstants.h:78)."""
    ls = l.clamp(0, N_EWT - 2)
    tab = _ewt(x.device)
    e0 = tab[ls.long()]
    e1 = tab[ls.long() + 1]
    return e0 + (e1 - e0) * (x - ls.to(torch.float32))


def ewt_inverse(et: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """``ewt_calculator::inverse`` (MetConstants.cc:37-45): the count of
    table entries ``<= et`` over all 41 entries, clipped to
    ``[0, clip(l, 0, 39)]`` — literal, so NaN counts 0 as in the JAX
    package."""
    cnt = torch.zeros(et.shape, dtype=torch.int32, device=et.device)
    for k in range(N_EWT):
        cnt += (et >= float(EWT[k])).to(torch.int32)
    ll = torch.minimum((cnt - 1).clamp(min=0), l.clamp(0, N_EWT - 2))
    tab = _ewt(et.device)
    e0 = tab[ll.long()]
    e1 = tab[ll.long() + 1]
    rr = (et - e0) / (e1 - e0)
    return f32(-100.0) + (ll.to(torch.float32) + rr) * f32(5.0)


def clamp_rh(rh: torch.Tensor) -> torch.Tensor:
    """Clamp relative humidity (fraction) to ``[0.02, 1.0]``."""
    return rh.clamp(float(rhmin), float(rhmax))


def pidcp_from_p(p: torch.Tensor) -> torch.Tensor:
    """``(p/p0)**kappa`` through the deterministic pow, with the reference
    ``powf`` edges as literals: ``p == 0`` gives 0, ``p < 0`` and NaN give
    NaN (constants.py:245-273 of the JAX package)."""
    from ._libm import pow_posc_f32
    x = p * float(p0inv)
    edge = torch.where(x == 0, torch.zeros_like(x),
                       torch.full_like(x, float("nan")))
    return torch.where(x > 0, pow_posc_f32(x, kappa), edge)
