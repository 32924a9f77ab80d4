"""Deterministic float32 transcendentals: the Exner pow, log, exp, tanh,
log10, pow and pow10.

PyTorch port of :mod:`mi_fieldcalc_tpu._libm` (``pow_posc_f32``,
``log_f32``, ``exp_f32``, ``tanh_f32``, ``log10_f32``, ``pow_f32`` and
``pow10_f32``).  They use only
mul/add/select/int/bitcast, each rounded on its own, so they give the
bits the JAX package gives (and the CUDA kernels, which are compiled with
``-fmad=false`` so no multiply-add is contracted; ``csrc/common.cuh``
holds their device forms).  Bitcasts are ``Tensor.view(torch.int32)`` and
``.view(torch.float32)``.
"""

from __future__ import annotations

import numpy as np
import torch

from .field import f32

__all__ = ["exp_f32", "log_f32", "log10_f32", "pow_f32", "pow10_f32",
           "pow_posc_f32", "tanh_f32"]

_LOG2E = 1.44269504088896341
#: ln2 split (Cephes C1/C2)
_LN2_HI = 0.693359375
_LN2_LO = -2.12194440e-4
#: 1/ln10
_LOG10E = 0.43429448190325176
#: the smallest normal float32
_MIN_NORMAL = 1.1754944e-38

#: Cephes logf minimax coefficients (degree 8) and exp2 polynomial
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_EXP_Q = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
          4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)


def pow_posc_f32(x: torch.Tensor, c) -> torch.Tensor:
    """Narrow-domain ``x**c`` for a constant ``c`` (``_libm.py:146-216`` of
    the JAX package): positive domain only (``x`` is raised to the smallest
    normal first, so zero and negative bases give finite garbage that
    callers mask), ``|c*log2(x)| <= ~120``, <= ~2.5 ulp on the Exner
    domain.  Base-2 reduction with an exact integer split of ``c*log2 x``
    and one Cephes polynomial for ``2**f``."""
    c_d = float(c)
    c_hi = f32(round(c_d * 4096.0) / 4096.0)
    c_lo = float(np.float32(c_d) - np.float32(c_hi))
    c_l2e = f32(c_d * _LOG2E)
    # maximum() propagates NaN, as jnp.maximum does
    x = torch.maximum(x.to(torch.float32),
                      torch.full((), f32(_MIN_NORMAL), dtype=torch.float32,
                                 device=x.device))
    xi = x.view(torch.int32)
    e = ((xi >> 23) & 0xFF) - 126
    m = ((xi & 0x007FFFFF) | (126 << 23)).view(torch.float32)
    big = m > f32(0.70710678118654752440)
    m = torch.where(big, m, m * 2.0)
    e = torch.where(big, e, e - 1)
    z = m - 1.0
    p = torch.full_like(z, f32(_LOG_P[0]))
    for coef in _LOG_P[1:]:
        p = p * z + f32(coef)
    zz = z * z
    lnm = z + (z * zz * p - zz * 0.5)
    ef = e.to(torch.float32)
    th = c_hi * ef
    r = c_lo * ef + c_l2e * lnm
    t = th + r
    n = torch.floor(t + 0.5)
    f = (th - n) + r
    w = f * f32(0.693147180559945309)
    q = torch.full_like(w, f32(_EXP_Q[0]))
    for coef in _EXP_Q[1:]:
        q = q * w + f32(coef)
    e2 = w * w * q + w + 1.0
    ni = n.clamp(-126.0, 127.0).to(torch.int32)
    s = ((ni + 127) << 23).view(torch.float32)
    return e2 * s


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """Cephes logf (``_libm.py:90-123`` of the JAX package): mantissa in
    ``[sqrt(1/2), sqrt(2))``, the degree-8 polynomial, ``e*ln2`` re-added
    in two parts.  Edges as libm: ``log(0) = -inf``, negative and NaN give
    NaN, ``log(inf) = inf``.  Subnormal positives take ``torch.log``, as
    the JAX function takes the backend log there (they never occur on the
    operators' domains)."""
    x = x.to(torch.float32)
    xi = x.view(torch.int32)
    e = ((xi >> 23) & 0xFF) - 126
    m = ((xi & 0x007FFFFF) | (126 << 23)).view(torch.float32)
    big = m > f32(0.70710678118654752440)
    m = torch.where(big, m, m * 2.0)
    ef = torch.where(big, e, e - 1).to(torch.float32)
    z = m - 1.0
    p = torch.full_like(z, f32(_LOG_P[0]))
    for coef in _LOG_P[1:]:
        p = p * z + f32(coef)
    zz = z * z
    r = z + (z * zz * p - zz * 0.5)
    r = r + ef * f32(_LN2_LO)
    r = r + ef * f32(_LN2_HI)
    r = torch.where(x < f32(_MIN_NORMAL), torch.log(x), r)
    nan = torch.full_like(x, float("nan"))
    r = torch.where(x > 0, r, torch.where(x == 0, torch.full_like(
        x, float("-inf")), nan))
    return torch.where(torch.isfinite(x), r, torch.where(x > 0, x, nan))


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """Cephes expf (``_libm.py:43-70`` of the JAX package): clip to
    ``[-104, 89.5]``, reduce by ln2 in two parts, the degree-5 polynomial,
    and ``2**n`` as two bitcast factors, so the result underflows gradually
    and overflows to inf where libm's does.  The exponent split is
    ``n >> 1``, the floor division JAX's ``n // 2`` is (a C-style
    truncating division would differ for odd negative ``n``); a NaN ``z``
    converts to 0 (XLA's rule; the result is NaN either way)."""
    x = x.to(torch.float32).clamp(f32(-104.0), f32(89.5))
    z = torch.floor(f32(_LOG2E) * x + 0.5)
    r = x - z * f32(_LN2_HI)
    r = r - z * f32(_LN2_LO)
    p = torch.full_like(r, f32(_EXP_Q[0]))
    for coef in _EXP_Q[1:]:
        p = p * r + f32(coef)
    e = r * r * p + r + 1.0
    n = torch.nan_to_num(z, nan=0.0).clamp(-252.0, 254.0).to(torch.int32)
    n1 = n >> 1
    n2 = n - n1
    s1 = ((n1 + 127) << 23).view(torch.float32)
    s2 = ((n2 + 127) << 23).view(torch.float32)
    return (e * s1) * s2


#: Cephes tanhf odd polynomial (|x| < 0.625)
_TANH_P = (-5.70498872745e-3, 2.06390887954e-2, -5.37397155531e-2,
           1.33314422036e-1, -3.33332819422e-1)


def tanh_f32(x: torch.Tensor) -> torch.Tensor:
    """Cephes tanhf (``_libm.py:73-87`` of the JAX package): the odd
    polynomial for ``|x| < 0.625``, else ``1 - 2/(exp_f32(2|x|) + 1)``
    with the sign restored, and ``sign(x)`` beyond 9.  The quotient divides
    by a tensor (IEEE on every device)."""
    x = x.to(torch.float32)
    ax = x.abs()
    z2 = x * x
    p = torch.full_like(z2, f32(_TANH_P[0]))
    for coef in _TANH_P[1:]:
        p = p * z2 + f32(coef)
    small = z2 * x * p + x
    two = torch.full_like(x, 2.0)
    big = 1.0 - torch.div(two, exp_f32(2.0 * ax) + 1.0)
    big = torch.where(x < 0, -big, big)
    out = torch.where(ax < f32(0.625), small, big)
    return torch.where(ax > 9.0, torch.sign(x), out)


def log10_f32(x: torch.Tensor) -> torch.Tensor:
    """``log_f32(x) * (1/ln10)`` (``_libm.py:126-127`` of the JAX
    package)."""
    return log_f32(x) * f32(_LOG10E)


def pow_f32(x: torch.Tensor, c) -> torch.Tensor:
    """``x**c`` for a constant ``c`` (``_libm.py:130-143`` of the JAX
    package): ``exp_f32(c * log_f32(x))`` where ``x > 0``; zero, negative
    and NaN bases keep ``torch.pow``'s edges, which are ``jnp.power``'s
    (integer-exponent signs, ``0**c``)."""
    x = x.to(torch.float32)
    r = exp_f32(f32(c) * log_f32(x))
    return torch.where(x > 0, r, torch.pow(x, f32(c)))


def pow10_f32(x: torch.Tensor) -> torch.Tensor:
    """``10**x`` by the Cephes exp10f reduction (``_libm.py:219-235`` of
    the JAX package): an exact power of two split off, ``exp_f32`` of the
    small rest, and the power of two as two bitcast factors."""
    x = x.to(torch.float32).clamp(f32(-46.0), f32(39.0))
    px = torch.floor(f32(3.32192809488736235) * x + 0.5)
    w = x - px * f32(3.01025390625e-1)
    w = w - px * f32(4.605038981195213739e-6)
    e = exp_f32(w * f32(2.302585092994046))
    n = torch.nan_to_num(px, nan=0.0).clamp(-252.0, 254.0).to(torch.int32)
    n1 = n >> 1
    n2 = n - n1
    s1 = ((n1 + 127) << 23).view(torch.float32)
    s2 = ((n2 + 127) << 23).view(torch.float32)
    return (e * s1) * s2
