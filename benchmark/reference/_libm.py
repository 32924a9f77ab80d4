"""Frozen copy of the port's deterministic float32 transcendentals
(``mi_fieldcalc_tpu_torch/_libm.py``): the Exner pow that the plain
reference needs.  Kept here so that a later change to the
program does not change the yardstick.  Each operation is rounded on its
own, so on the card these give the bits the kernels give (they are
compiled with ``-fmad=false``).
"""

from __future__ import annotations

import numpy as np
import torch

from ._base import f32

__all__ = ["pow_posc_f32"]

_LOG2E = 1.44269504088896341
#: ln2 split (Cephes C1/C2)
_LN2_HI = 0.693359375
_LN2_LO = -2.12194440e-4
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

