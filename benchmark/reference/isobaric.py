"""The plain reference of the isobaric pipeline: temperature, specific
humidity and wind interpolated from hybrid model levels to pressure
surfaces, linearly in ln p, then the 12 derived fields on those surfaces
(:mod:`.pipeline`, with ``alevel`` the targets, ``blevel`` 0 and a zero,
defined surface pressure: a constant-pressure surface in the hybrid law).

A frozen copy of the interpolation rule of the port's plain version
(``mi_fieldcalc_tpu_torch/ops/vertical_fused.py``, as its docstring states
it) for inputs that are all defined, so that a later change to the program
does not change the yardstick:

* the hybrid pressure ``p_k = alevel[k] + blevel[k] * ps`` per level;
* target ``t`` is bracketed at level k where ``p_k <= t < p_{k+1}``; on a
  column whose ``p`` is not monotone the last such k wins;
* ``x = log(p > 0 ? p : 1)``, ``w = (log t - x_k) * dinv`` with ``dinv =
  1 / (denom != 0 ? denom : 1)``, value ``f_k + (f_{k+1} - f_k) * w``;
  an unbracketed target gives 0;
* the mask (one plane for all fields) is the bracket and ``denom != 0``.

The log is a frozen copy of the port's deterministic ``log_f32`` (Cephes
logf, each operation rounded on its own), so on the card this gives the
bits the kernel, compiled with ``-fmad=false``, gives.  Every target is
independent and every stencil of :mod:`.pipeline` horizontal, so the work
runs in blocks of targets.  Departures from the reference library: none
beyond :mod:`.pipeline`'s; on a global grid that includes the dateline
column, which ``fill_edges`` fills from its neighbour as the library
does, not wrapped around the sphere.
"""

from __future__ import annotations

import torch

from ._base import Field, f32
from ._libm import _LN2_HI, _LN2_LO, _LOG_P, _MIN_NORMAL
from .pipeline import FIELDS, derived_fields

__all__ = ["derived_fields_isobaric", "interpolate", "log_f32"]


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """Cephes logf: mantissa in ``[sqrt(1/2), sqrt(2))``, the degree-8
    polynomial, ``e*ln2`` re-added in two parts; ``log(0) = -inf``,
    negative and NaN give NaN, ``log(inf) = inf``, subnormal positives
    ``torch.log``."""
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


def _lx(p: torch.Tensor) -> torch.Tensor:
    return log_f32(torch.where(p > 0, p, torch.ones_like(p)))


def interpolate(fields, ps: torch.Tensor, alevel, blevel, targets) -> tuple:
    """``fields`` (``[nlev, ny, nx]`` value tensors) at the pressures
    ``targets`` (hPa), every input defined: ``(values, mask)``, values
    ``[nvar, nt, ny, nx]`` and one bool mask ``[nt, ny, nx]``."""
    dev = ps.device
    nlev = fields[0].shape[0]
    a = torch.as_tensor(alevel, dtype=torch.float32, device=dev)
    b = torch.as_tensor(blevel, dtype=torch.float32, device=dev)
    xt = torch.tensor([float(t) for t in targets], dtype=torch.float32,
                      device=dev)
    nt = xt.numel()
    xt3 = xt.reshape(nt, 1, 1)
    lxt3 = log_f32(xt).reshape(nt, 1, 1)
    shape = (nt,) + tuple(ps.shape)
    out = torch.zeros((len(fields),) + shape, dtype=torch.float32,
                      device=dev)
    mask = torch.zeros(shape, dtype=torch.bool, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    p_k = a[0] + b[0] * ps
    x0 = _lx(p_k)
    for k in range(nlev - 1):
        p_k1 = a[k + 1] + b[k + 1] * ps
        x1 = _lx(p_k1)
        denom = x1 - x0
        ok = denom != 0
        dinv = one / torch.where(ok, denom, one)
        sel = (p_k <= xt3) & (p_k1 > xt3)
        w = (lxt3 - x0) * dinv
        for v, f in enumerate(fields):
            fk = f[k]
            out[v] = torch.where(sel, fk + (f[k + 1] - fk) * w, out[v])
        mask = torch.where(sel, ok, mask)
        p_k, x0 = p_k1, x1
    return out, mask


def derived_fields_isobaric(fields: dict, alevel, blevel, targets, xmapr,
                            ymapr, block: int = 8) -> dict:
    """The 12 outputs on the surfaces ``targets`` as ``{name: Field}`` of
    ``[nt, ny, nx]``, in :data:`.pipeline.FIELDS`.  ``fields`` holds
    ``{name: (values, mask)}`` of tk, q, u, v ``[nlev, ny, nx]`` and ps
    ``[ny, nx]``, every point defined (the masks are not read); ``alevel,
    blevel`` are the ``[nlev]`` hybrid coefficients; ``block`` targets are
    worked out at a time."""
    targets = tuple(float(t) for t in targets)
    stacks = [fields[n][0] for n in ("tk", "q", "u", "v")]
    ps = fields["ps"][0]
    dev = ps.device
    nt, (ny, nx) = len(targets), ps.shape
    out = {n: Field(torch.empty((nt, ny, nx), device=dev),
                    torch.empty((nt, ny, nx), dtype=torch.bool, device=dev))
           for n in FIELDS}
    ps0 = Field(torch.zeros((ny, nx), device=dev),
                torch.ones((ny, nx), dtype=torch.bool, device=dev))
    for t0 in range(0, nt, block):
        sl = slice(t0, min(nt, t0 + block))
        vals, mask = interpolate(stacks, ps, alevel, blevel, targets[sl])
        got = derived_fields(
            *[Field(v, mask) for v in vals], ps0,
            torch.tensor(targets[sl], dtype=torch.float32, device=dev),
            torch.zeros(len(targets[sl]), dtype=torch.float32, device=dev),
            xmapr, ymapr)
        for n in FIELDS:
            out[n].values[sl] = got[n].values
            out[n].mask[sl] = got[n].mask
        del vals, mask, got
    return out
