"""Neighbourhood (windowed) functions (port of
:mod:`mi_fieldcalc_tpu.ops.window`, ``window.py:91-283``).

Reference: FieldCalculations.cc — neighbourProbFunctions (2862, a
summed-area-table box mean) and neighbourFunctions (2955, strided window
statistics with a block fill).

* The summed-area table (two cumulative sums) serves only the 0/1
  indicator fields of the probability modes, where its sums are exact
  small integers.  The window mean of raw values sums each window point by
  point, as the reference's loop does (cc:3031): a window sum taken as the
  difference of summed-area corners loses ~1e-3 relative in float32 at
  719x929, far outside the 2e-5 contract.
* Window max / min and the mean read the (2R+1)^2 shifted slices of the
  field padded by R; the percentile sorts the stacked shifted copies.
* The strided sample and block fill gathers, for every output point, the
  statistic at its block's sample point.

Both functions need an all-defined input (cc:2868, 2964); masks appear
only on the undefined border of the output.  The border ring and the
sample grid are in global coordinates: the block's origin is (0, 0) and
its extent (ny, nx), or a shard's place in the global grid under
``ops.stencil.ShardCtx`` (JAX ``window.py:44-57``), so that no border
falls on a seam and the sample grid does not restart on each shard.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from ..field import Field
from ._harness import div, require
from .stencil import _SHARD_CTX

__all__ = ["neighbour_prob_functions", "neighbour_functions"]


def _box_sum_sat(ind: torch.Tensor, rng: int) -> torch.Tensor:
    """Box sums over ``[-rng, rng]^2`` windows through a summed-area table
    (cc:2898-2928), exact for 0/1 indicators.  Points closer than ``rng``
    to the border hold 0; callers mask them."""
    sat = torch.cumsum(torch.cumsum(ind, dim=-2), dim=-1)
    ny, nx = ind.shape[-2], ind.shape[-1]
    a = F.pad(sat, (1, 0, 1, 0))
    w = 2 * rng + 1
    core = (a[..., w:, w:] + a[..., :-w, :-w] - a[..., w:, :-w]
            - a[..., :-w, w:])
    out = torch.zeros_like(ind)
    out[..., rng:ny - rng, rng:nx - rng] = core
    return out


def _grid_ctx(f: Field):
    """``(row0, col0, nyg, nxg)``: the block's global origin and the global
    extents; ``(0, 0, ny, nx)`` outside a shard."""
    ctx = _SHARD_CTX.get()
    if ctx is None:
        return 0, 0, f.shape[-2], f.shape[-1]
    return ctx.row0, ctx.col0, ctx.nyg, ctx.nxg


def _border_mask(f: Field, rng: int) -> torch.Tensor:
    ny, nx = f.shape[-2], f.shape[-1]
    row0, col0, nyg, nxg = _grid_ctx(f)
    dev = f.values.device
    y = torch.arange(row0, row0 + ny, device=dev).reshape(ny, 1)
    x = torch.arange(col0, col0 + nx, device=dev).reshape(1, nx)
    inner = (y >= rng) & (y < nyg - rng) & (x >= rng) & (x < nxg - rng)
    return inner.expand(f.shape)


def _indicator(v: torch.Tensor, limit: int, compute: int) -> torch.Tensor:
    """1 where ``v`` is above (compute 5) or below (6) ``limit``, else 0."""
    return ((v > limit) if compute == 5 else (v < limit)).to(torch.float32)


def neighbour_prob_functions(f: Field, constants: Sequence[float],
                             compute: int) -> Field:
    """Thresholded box-mean probability (FieldCalculations.cc:2862-2953):
    5 above, 6 below; ``constants = (limit, range)``, both truncated to
    int (cc:2877-2878).  The ``range``-wide border is undefined."""
    require(compute in (5, 6),
            f"neighbourProbFunctions: bad compute {compute}")
    require(len(constants) >= 2, "neighbourProbFunctions: needs 2 constants")
    limit, rng = int(constants[0]), int(constants[1])
    require(rng >= 0, "neighbourProbFunctions: bad range")
    ind = _indicator(f.values, limit, compute)
    if rng == 0:
        return Field(ind, torch.ones_like(f.mask))
    box = div(_box_sum_sat(ind, rng), float((2 * rng + 1) ** 2))
    return Field(box, _border_mask(f, rng))


def _window_slices(v: torch.Tensor, rng: int, fill: float):
    """The (2R+1)^2 window members of every point, window row then window
    column (cc:3028-3029), as slices of ``v`` padded by ``rng`` with
    ``fill``."""
    ny, nx = v.shape[-2], v.shape[-1]
    pad = F.pad(v, (rng, rng, rng, rng), value=fill)
    w = 2 * rng + 1
    for dy in range(w):
        for dx in range(w):
            yield pad[..., dy:dy + ny, dx:dx + nx]


def neighbour_functions(f: Field, constants: Sequence[float],
                        compute: int) -> Field:
    """Strided window statistics with a block fill
    (FieldCalculations.cc:2955-3061): 1 mean, 2 max, 3 min, 4 percentile,
    5 probability above, 6 below.  ``constants`` is ``(range[, step])``
    for compute < 4, else ``(limit, range[, step])``.  Samples advance by
    ``step``; each fills the step x step cells around it.  The ``range``
    border and any cells beyond the last block are undefined."""
    require(1 <= compute <= 6, f"neighbourFunctions: bad compute {compute}")
    require(len(constants) >= 1 and not (len(constants) < 2 and compute > 3),
            "neighbourFunctions: not enough constants")
    rng, step, limit = 3, 3, 0
    if compute < 4:
        rng = int(constants[0])
        if len(constants) == 2:
            step = int(constants[1])
    else:
        limit = int(constants[0])
        rng = int(constants[1])
        if len(constants) == 3:
            step = int(constants[2])
    row0, col0, nyg, nxg = _grid_ctx(f)
    require(rng <= nxg and rng <= nyg and rng >= 1,
            "neighbourFunctions: bad range")
    require(step >= 1, "neighbourFunctions: bad step")

    v = f.values
    n_win = float((2 * rng + 1) ** 2)
    if compute == 1:
        acc = torch.zeros_like(v)
        for s in _window_slices(v, rng, 0.0):
            acc = acc + s
        stat = div(acc, n_win)
    elif compute in (2, 3):
        op = torch.maximum if compute == 2 else torch.minimum
        slices = _window_slices(v, rng, float("-inf") if compute == 2
                                else float("inf"))
        stat = next(slices)
        for s in slices:
            stat = op(stat, s)
    elif compute == 4:
        require(0 <= limit < 100, "neighbourFunctions: bad percentile")
        win = torch.stack(list(_window_slices(v, rng, 0.0)))
        stat = torch.sort(win, dim=0).values[
            ((2 * rng + 1) ** 2) * limit // 100]
    else:
        stat = div(_box_sum_sat(_indicator(v, limit, compute), rng), n_win)

    # each point takes the statistic at its block's sample point; the
    # block grid is global, so a sharded caller passes the composed radius
    # rng + step - 1 (a seam point's sample lies up to step - 1 rows into
    # the neighbour shard)
    first = rng
    lo = first - (step - 1) // 2
    dev = v.device

    def sample_of(n, origin, ng):
        """Whether each of the block's ``n`` points along an axis lies in a
        sample's block, and the local index of that sample."""
        coord = torch.arange(origin, origin + n, device=dev)
        nb = max((ng - 2 * rng + step - 1) // step, 0)
        bid = torch.div(coord - lo, step, rounding_mode="floor")
        s = first + bid.clamp(0, max(nb - 1, 0)) * step
        valid = ((bid >= 0) & (bid < nb) & (coord >= lo)
                 & (coord < s - (step - 1) // 2 + step))
        return valid, (s - origin).clamp(0, n - 1)

    vy, iy = sample_of(v.shape[-2], row0, nyg)
    vx, ix = sample_of(v.shape[-1], col0, nxg)
    valid = vy.reshape(-1, 1) & vx.reshape(1, -1)
    gathered = stat.index_select(-2, iy).index_select(-1, ix)
    out = torch.where(valid, gathered, torch.zeros((), device=dev))
    return Field(out, valid.expand(out.shape))
