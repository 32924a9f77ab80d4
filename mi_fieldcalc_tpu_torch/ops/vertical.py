"""Vertical interpolation: hybrid/model levels -> pressure levels (port of
:mod:`mi_fieldcalc_tpu.ops.vertical`, ``vertical.py:44-132``).

Per target pressure ``pt`` and column: the bracket index is
``k = (#levels with p <= pt) - 1`` clipped to ``[0, nlev-2]``; the target
is in range where that count is in ``[1, nlev-1]``; the value is linear in
ln p (or in p) between levels k and k+1.  Masks follow ``vertical.py:82-84``:
in range, both bracket levels defined, the pressure defined at both and
the bracket not degenerate.

The JAX function vmaps a one-hot selection over the level axis; here each
target is a loop step that gathers its two bracket levels, so no
``[nlev, ...]`` one-hot stack is built (at 137 levels one would hold
366 MB per field and target).  The gather returns the bracket level's own
value; the one-hot sum returns the same wherever the column is finite (it
turns a NaN or inf anywhere in a column into NaN).  ln p is
:func:`.._libm.log_f32`, the port's one deterministic log.

Shapes: field ``[nlev, ny, nx]``, pressure ``[nlev, ny, nx]`` increasing
along axis 0 (model top first), targets a static sequence.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .._libm import log_f32
from ..field import Field
from ._harness import require

__all__ = ["plevel_interp", "hlevel_to_plevel"]


def _take(a: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    return torch.gather(a, 0, k[None])[0]


def plevel_interp(f: Field, p: Field, targets: Sequence[float],
                  log_p: bool = True) -> Field:
    """Interpolate ``f`` from model levels to constant-pressure surfaces.

    Args:
      f: ``[nlev, ny, nx]`` Field on model levels.
      p: per-point pressure Field, monotone increasing along axis 0.
      targets: static target pressures (hPa), any order.
      log_p: interpolate linearly in ln(p) (default) or in p.

    Returns a ``[len(targets), ny, nx]`` Field; out-of-column targets and
    points with undefined bracketing levels are masked out.
    """
    require(f.values.dim() == 3, "plevel_interp: field must be [nlev, ny, nx]")
    require(f.values.shape == p.values.shape,
            "plevel_interp: field/pressure shape mismatch")
    require(len(targets) >= 1, "plevel_interp: no targets")
    nlev = f.values.shape[0]
    fv, fm, pv, pm = f.values, f.mask, p.values, p.mask
    # ln(p) guarded against non-positive garbage at masked points
    x = log_f32(torch.where(pv > 0, pv, torch.ones_like(pv))) if log_p \
        else pv
    one = torch.ones((), dtype=torch.float32, device=fv.device)
    outs, masks = [], []
    for pt in targets:
        ptf = torch.full((), float(pt), dtype=torch.float32, device=fv.device)
        cnt = (pv <= ptf).sum(dim=0, dtype=torch.int64)
        k = (cnt - 1).clamp(0, nlev - 2)
        k1 = k + 1
        in_range = (cnt >= 1) & (cnt <= nlev - 1)
        f0, f1 = _take(fv, k), _take(fv, k1)
        x0, x1 = _take(x, k), _take(x, k1)
        xt = log_f32(ptf) if log_p else ptf
        denom = x1 - x0
        w = (xt - x0) / torch.where(denom != 0, denom, one)
        outs.append(f0 + (f1 - f0) * w)
        masks.append(in_range & _take(fm, k) & _take(fm, k1)
                     & _take(pm, k) & _take(pm, k1) & (denom != 0))
    return Field(torch.stack(outs), torch.stack(masks))


def hlevel_to_plevel(f: Field, ps: Field, alevel, blevel,
                     targets: Sequence[float], log_p: bool = True) -> Field:
    """Hybrid-level field -> pressure levels: builds the per-point hybrid
    pressure ``p = alevel + blevel * ps`` (hlevelpressure,
    FieldCalculations.cc:1276-1304) and interpolates to ``targets``."""
    nlev = f.values.shape[0]
    dev = f.values.device
    a = torch.as_tensor(alevel, dtype=torch.float32, device=dev)
    b = torch.as_tensor(blevel, dtype=torch.float32, device=dev)
    pv = a.reshape(nlev, 1, 1) + b.reshape(nlev, 1, 1) * ps.values[None]
    pm = ps.mask[None].expand(f.values.shape)
    return plevel_interp(f, Field(pv, pm), targets, log_p=log_p)
