"""The plain reference of the ensemble summary on one block of a grid cut
into blocks: the whole grid's answer at the block's points.

The 12 derived fields (:mod:`.pipeline`) of every member are worked out on
the block widened by the stencils' ring, the widening clipped at the
grid's own edges, so that only the grid's edges are edges; the outputs are
then cropped to the block, whose points all lie at least the ring's width
from any widened side that is not a grid edge.  The mean and spread are
:func:`.ensemble.mean_spread`'s over the defined members of each point.
The probabilities divide by the members whose field is defined somewhere
on the whole grid: each block's flags, reduced over every block of the
grid by the caller's ``reduce_flags`` (the maximum; ``None`` when the
block is the whole grid).

It runs in blocks of levels, as :func:`.ensemble.summary`, and ``round_to``
rounds every output value as there (the control).
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from ._base import Field, f32
from .ensemble import mean_spread, rounded
from .pipeline import FIELDS, derived_fields


def summary(window, nmem: int, nlev: int, alevel, blevel, xmapr, ymapr,
            crop: tuple, wind_limit: float, level_block: int = 8,
            round_to=None, reduce_flags=None):
    """The summary at the block's points, as :func:`.ensemble.summary`
    gives it: a namespace of ``mean`` and ``spread`` (12 Fields each, in
    :data:`.pipeline.FIELDS` order), ``prob_wind`` and ``prob_t_freeze``.

    ``window(levels)`` gives the widened block's member stacks of the
    levels ``levels`` (a slice) as ``{name: (values, mask)}``: tk, q, u, v
    ``[nmem, L, wy, wx]``, ps ``[nmem, wy, wx]``; ``xmapr, ymapr`` are the
    widened block's ``[wy, wx]`` planes and ``crop`` the block's ``(rows,
    cols)`` slices within it.  ``reduce_flags(flags)`` returns the
    ``[nmem]`` int32 ``flags`` at their maximum over every block."""
    rows, cols = crop
    ny, nx = rows.stop - rows.start, cols.stop - cols.start
    dev = alevel.device
    shape = (nlev, ny, nx)

    def empty():
        return Field(torch.empty(shape, device=dev),
                     torch.empty(shape, dtype=torch.bool, device=dev))

    mean = [empty() for _ in FIELDS]
    spread = [empty() for _ in FIELDS]
    above = torch.empty((nmem,) + shape, dtype=torch.bool, device=dev)
    below = torch.empty((nmem,) + shape, dtype=torch.bool, device=dev)
    any_w = torch.zeros(nmem, dtype=torch.bool, device=dev)
    any_t = torch.zeros(nmem, dtype=torch.bool, device=dev)
    limit = f32(wind_limit)
    for l0 in range(0, nlev, level_block):
        sl = slice(l0, min(nlev, l0 + level_block))
        fields = window(sl)
        ps_v, ps_m = fields["ps"]
        vals = {n: [] for n in FIELDS}
        masks = {n: [] for n in FIELDS}
        for m in range(nmem):
            args = [Field(fields[k][0][m], fields[k][1][m])
                    for k in ("tk", "q", "u", "v")]
            out = derived_fields(*args, Field(ps_v[m], ps_m[m]), alevel[sl],
                                 blevel[sl], xmapr, ymapr)
            for n in FIELDS:
                v = out[n].values[..., rows, cols]
                vals[n].append(v)
                masks[n].append(out[n].mask.expand(
                    out[n].values.shape)[..., rows, cols])
        del fields
        for i, n in enumerate(FIELDS):
            v = torch.stack(vals[n])
            mk = torch.stack(masks[n])
            mu, sd = mean_spread(v, mk)
            mean[i].values[sl] = rounded(mu.values, round_to)
            mean[i].mask[sl] = mu.mask
            spread[i].values[sl] = rounded(sd.values, round_to)
            spread[i].mask[sl] = sd.mask
            if n == "wspeed":
                above[:, sl] = mk & (v > limit)
                any_w |= mk.reshape(nmem, -1).any(dim=1)
            elif n == "tadv":
                below[:, sl] = mk & (v < 0.0)
                any_t |= mk.reshape(nmem, -1).any(dim=1)
        del vals, masks
    if reduce_flags is not None:
        any_w = reduce_flags(any_w.to(torch.int32)) != 0
        any_t = reduce_flags(any_t.to(torch.int32)) != 0

    def prob(passes, sel):
        nfields = sel.sum()
        count = (passes & sel.reshape(-1, 1, 1, 1)).sum(dim=0).to(
            torch.float32)
        some = nfields > 0
        out = count * f32(100.0) / torch.where(some, nfields, 1).to(
            torch.float32)
        return Field(rounded(out, round_to), some.expand(count.shape))

    return SimpleNamespace(mean=mean, spread=spread,
                           prob_wind=prob(above, any_w),
                           prob_t_freeze=prob(below, any_t))
