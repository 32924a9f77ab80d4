"""Physical constants, the saturation-vapour table, the flight-level tables
and the ICAO standard atmosphere.

PyTorch port of :mod:`mi_fieldcalc_tpu.constants`.  The numpy constants
carry the reference's float32 values (MetConstants.h:39-59); they are the
same objects the JAX package defines, re-declared here because the port
never imports it.  The ICAO helpers are host numpy in float64, as there
(MetConstants.cc:47-132).
"""

from __future__ import annotations

import numpy as np
import torch

from .field import f32

__all__ = [
    "r", "cp", "p0", "t0", "eps", "xlh", "rcp", "cplr", "exl", "p0inv",
    "kappa", "g", "ginv", "rhmin", "rhmax", "ft_per_m", "ms2knots",
    "knots2ms", "EWT", "N_EWT", "ewt_index", "ewt_defined", "ewt_value",
    "ewt_inverse", "P_LEVEL_TABLE", "F_LEVEL_TABLE", "F_LEVEL_TABLE_OLD",
    "icao_geo_altitude_from_pressure", "icao_pressure_from_geo_altitude",
    "fl_from_geo_altitude", "geo_altitude_from_fl",
    "pidcp_from_p", "pi_from_p", "clamp_rh",
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
ginv = np.float32(1.0 / g)
rhmin = np.float32(0.02)
rhmax = np.float32(1.00)
ft_per_m = 3.2808399  # feet per metre (a double in the reference)
ms2knots = 3600.0 / 1852.0  # a double in the reference
knots2ms = 1.0 / ms2knots

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
F_LEVEL_TABLE_OLD = np.array(
    [0, 25, 50, 70, 100, 180, 240, 300, 340, 390, 450, 530, 600, 700, 800,
     999], dtype=np.float32)

# ICAO standard atmosphere (MetConstants.cc:47-132)
_ICAO_G = 9.80665
_ICAO_R = 287.05287
_ICAO_N = 8
_ICAO_LAMBDAS = np.array([-6.5, 0.0, 1.0, 2.8, 0.0, -2.8, -2.0])  # K/km
_ICAO_BASE_H = np.array([0.0, 11.0, 20.0, 32.0, 47.0, 51.0, 71.0,
                         84.852])  # km
_ICAO_BASE_T = np.array([288.15, 216.65, 216.65, 228.65, 270.65, 270.65,
                         214.65, 186.946])
_ICAO_BASE_P = np.array([
    1013.15, 226.29806486313493, 54.743370958898005, 8.679301101236328,
    1.1089482781849516, 0.6693192180209551, 0.0395600169484907,
    0.0037334345211142398])


def _icao_layer(x, bases, below):
    """The layer index of each ``x`` (scanning up from the ground) and
    whether it lies above the table; ``below(x, base)`` says x is past a
    layer's base."""
    i = np.ones(x.shape, dtype=np.int64)
    for k in range(1, _ICAO_N):
        i = np.where((i == k) & below(x, bases[k]), k + 1, i)
    return np.clip(i - 1, 0, _ICAO_N - 2), i >= _ICAO_N


def icao_geo_altitude_from_pressure(pressure):
    """Pressure (hPa) -> geopotential altitude (m) in the ICAO standard
    atmosphere (MetConstants.cc:84-100), float64 numpy over arrays."""
    p = np.asarray(pressure, dtype=np.float64)
    l, beyond = _icao_layer(p, _ICAO_BASE_P, lambda x, b: x < b)
    lam = _ICAO_LAMBDAS[l] / 1000.0
    h_l, t_l, p_l = _ICAO_BASE_H[l] * 1000.0, _ICAO_BASE_T[l], _ICAO_BASE_P[l]
    rp = p / p_l
    with np.errstate(divide="ignore", invalid="ignore"):
        grad = (t_l / np.where(lam == 0, 1.0, lam)) * (
            np.power(rp, -(lam * _ICAO_R) / _ICAO_G) - 1.0) + h_l
        iso = h_l - np.log(rp) * (_ICAO_R * t_l) / _ICAO_G
    out = np.where(lam != 0, grad, iso)
    out = np.where(beyond, 1000.0 * (_ICAO_BASE_H[-1] + 1.0), out)
    return out if out.shape else float(out)


def icao_pressure_from_geo_altitude(altitude):
    """Geopotential altitude (m) -> pressure (hPa)
    (MetConstants.cc:102-122)."""
    a = np.asarray(altitude, dtype=np.float64)
    l, beyond = _icao_layer(a / 1000.0, _ICAO_BASE_H, lambda x, b: x > b)
    lam = _ICAO_LAMBDAS[l] / 1000.0
    alt_l, t_l, p_l = _ICAO_BASE_H[l] * 1000.0, _ICAO_BASE_T[l], \
        _ICAO_BASE_P[l]
    da = a - alt_l
    lam1 = np.where(lam == 0, 1.0, lam)
    with np.errstate(divide="ignore", invalid="ignore"):
        grad = np.power(1.0 + da * lam1 / t_l, -_ICAO_G / (lam1 * _ICAO_R))
        iso = np.exp(-da * _ICAO_G / (_ICAO_R * t_l))
    pf = np.where(lam != 0, grad, iso)
    out = np.where(beyond, _ICAO_BASE_P[-1] - 1.0, p_l * pf)
    return out if out.shape else float(out)


def fl_from_geo_altitude(a):
    """Altitude (m) -> flight level rounded to 500 ft
    (MetConstants.cc:124-127)."""
    out = 5 * np.round(np.asarray(a, np.float64) * ft_per_m / 500.0).astype(
        np.int64)
    return out if out.shape else int(out)


def geo_altitude_from_fl(fl):
    """Flight level -> altitude (m), no rounding (MetConstants.cc:129-132)."""
    out = np.asarray(fl, np.float64) * 100.0 / ft_per_m
    return out if out.shape else float(out)


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


def pi_from_p(p: torch.Tensor) -> torch.Tensor:
    """``cp * (p/p0)**kappa`` (FieldCalculations.cc:313-316)."""
    return float(cp) * pidcp_from_p(p)
