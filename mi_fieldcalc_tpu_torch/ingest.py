"""Aligned ingest: re-grid producer sentinel grids onto the product grid
of the serving entries' ``align=True``.

The port's own copy of :mod:`mi_fieldcalc_tpu.ingest`
(``ingest.py:53-148``), in numpy, host code.  ``align=True`` is a product
decision, not a transparent speed path: the output grid changes (the
operational 719x929 becomes 720x1024 over the same physical extent), and
a deployment that switches it on (``MF_STAGING_ALIGN=1``) gets its
products on that grid from either package.  The semantics:

* **the product grid** is the source grid rounded up to the next multiple
  of 8 rows and 128 columns (:func:`aligned_target`);
* **mask-aware bilinear**: each target point takes the bilinear-weighted
  mean of its (up to) 4 source corners, weights zeroed on undefined
  corners (NaN or the sentinel) and renormalised; a target point is
  undefined iff its total defined weight is at most 1e-6;
* **map ratios** (``xmapr = xm / (2 hx)``) carry the grid spacing, which
  scales by ``(n - 1) / (n_t - 1)`` per axis over a fixed extent, so
  :func:`resample_maps` scales the re-gridded ratios by
  ``(n_t - 1) / (n - 1)``: physical gradients are the same on both grids.

The codec's fused pass (``native.decode_resample_batch``) samples the
coordinates :func:`_axis_coords` gives it, so this module and the codec
define the same grid.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .field import UNDEF

__all__ = ["resample_align", "resample_maps", "aligned_target"]

#: below this total defined bilinear weight a target point is undefined
#: (it also guards the renormalising division)
_WEIGHT_EPS = np.float32(1e-6)

#: the product grid's row and column multiples
ROW_MULTIPLE = 8
COL_MULTIPLE = 128


def aligned_target(ny: int, nx: int) -> Tuple[int, int]:
    """The product grid of ``align=True`` for an ``(ny, nx)`` source: each
    extent rounded up to a multiple of :data:`ROW_MULTIPLE` /
    :data:`COL_MULTIPLE` (719x929 -> 720x1024)."""
    return (-(-ny // ROW_MULTIPLE) * ROW_MULTIPLE,
            -(-nx // COL_MULTIPLE) * COL_MULTIPLE)


def _axis_coords(n_src: int, n_dst: int):
    """Source-index sample positions for ``n_dst`` points spanning the
    same physical extent as ``n_src`` points (endpoints map to endpoints):
    the int64 corner indices and the float32 weight of the upper one."""
    if n_src == 1:
        return (np.zeros(n_dst, np.int64), np.zeros(n_dst, np.int64),
                np.zeros(n_dst, np.float32))
    pos = np.linspace(0.0, n_src - 1.0, n_dst)
    i0 = np.clip(np.floor(pos).astype(np.int64), 0, n_src - 2)
    w = (pos - i0).astype(np.float32)
    return i0, i0 + 1, w


def _resample_separable(a, y0, y1, wy, x0, x1, wx) -> np.ndarray:
    """Plain bilinear as two 1-D passes (x, then y), algebraically the
    4-corner form."""
    one = np.float32(1.0)
    ax = np.take(a, x0, axis=-1)
    ax *= (one - wx)
    ax += np.take(a, x1, axis=-1) * wx
    wyc = wy[:, None]
    out = ax[..., y0, :]
    out *= (one - wyc)
    out += ax[..., y1, :] * wyc
    return out if out.dtype == np.float32 else out.astype(np.float32)


def resample_align(a, undef: float = UNDEF,
                   shape_to: Optional[Tuple[int, int]] = None,
                   mask_aware: bool = True) -> np.ndarray:
    """Re-grid sentinel array(s) ``[..., ny, nx]`` onto ``shape_to``
    (default :func:`aligned_target`) over the same physical extent.

    An input already on ``shape_to`` is returned as it is.
    ``mask_aware=False`` runs plain bilinear (for fields known to be
    defined everywhere, such as map factors); with it True, undefined
    corners get zero weight and the result is renormalised, undefined
    only where every contributing corner is.
    """
    a = np.asarray(a, np.float32)
    ny, nx = a.shape[-2:]
    ny_t, nx_t = shape_to if shape_to is not None else aligned_target(ny, nx)
    if (ny_t, nx_t) == (ny, nx):
        return a
    y0, y1, wy = _axis_coords(ny, ny_t)
    x0, x1, wx = _axis_coords(nx, nx_t)
    if not mask_aware:
        return _resample_separable(a, y0, y1, wy, x0, x1, wx)
    undef32 = np.float32(undef)
    # with d the 0/1 defined weight, num = sep(d * c) and den = sep(d):
    # the corner weights are products of per-axis weights
    src_def = ~np.isnan(a) & (a != undef32)
    if src_def.all():
        return _resample_separable(a, y0, y1, wy, x0, x1, wx)
    az = np.where(src_def, a, np.float32(0.0))
    num = _resample_separable(az, y0, y1, wy, x0, x1, wx)
    den = _resample_separable(src_def.astype(np.float32),
                              y0, y1, wy, x0, x1, wx)
    defined = den > _WEIGHT_EPS
    return np.where(defined, num / np.where(defined, den, np.float32(1.0)),
                    undef32).astype(np.float32)


def resample_maps(xmapr, ymapr, ny: int, nx: int,
                  shape_to: Optional[Tuple[int, int]] = None):
    """Re-grid the map-ratio pair onto ``shape_to`` (default
    :func:`aligned_target`) and rescale it for the new spacing; returns
    ``(xmapr_t, ymapr_t)``."""
    ny_t, nx_t = shape_to if shape_to is not None else aligned_target(ny, nx)
    xm = resample_align(xmapr, shape_to=(ny_t, nx_t), mask_aware=False)
    ym = resample_align(ymapr, shape_to=(ny_t, nx_t), mask_aware=False)
    if nx_t != nx and nx > 1:
        xm = xm * np.float32((nx_t - 1) / (nx - 1))
    if ny_t != ny and ny > 1:
        ym = ym * np.float32((ny_t - 1) / (ny - 1))
    return xm.astype(np.float32), ym.astype(np.float32)
