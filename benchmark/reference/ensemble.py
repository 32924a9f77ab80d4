"""The plain reference of the ensemble summary: the 12 derived fields of
every member (:mod:`.pipeline`), then per point their mean and population
spread over the defined members (FieldCalculations.cc:2696-2757, the
two-pass form), and the probability in % of wind speed above a limit and
of a cooling 1-hour temperature advection, over the members whose field is
defined somewhere (cc:2807-2860).

It runs in blocks of levels (every stencil is horizontal), so that the
members' fields of one block are all it holds at a time besides the
summary.  ``round_to`` rounds every output value to a lower precision
(``torch.bfloat16``), the masks and the arithmetic left as they are: the
control that the comparison has to fail.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from ._base import Field, f32
from .pipeline import FIELDS, derived_fields


def rounded(t: torch.Tensor, dtype) -> torch.Tensor:
    return t if dtype is None else t.to(dtype).to(torch.float32)


def mean_spread(values: torch.Tensor, mask: torch.Tensor):
    """Mean and spread over the leading (member) axis of one field."""
    zero = torch.zeros((), dtype=values.dtype, device=values.device)
    n = mask.sum(dim=0)
    some = n > 0
    nf = torch.where(some, n, 1).to(torch.float32)
    mean = torch.where(mask, values, zero).sum(dim=0) / nf
    d = values - mean[None]
    spread = torch.sqrt(torch.where(mask, d * d, zero).sum(dim=0) / nf)
    return Field(mean, some), Field(spread, some)


def summary(fields: dict, alevel, blevel, xmapr, ymapr,
            wind_limit: float, level_block: int = 8, round_to=None):
    """The summary of the member stacks ``fields`` (``{name: (values,
    mask)}``: tk, q, u, v ``[nmem, nlev, ny, nx]``, ps ``[nmem, ny, nx]``),
    as a namespace of ``mean`` and ``spread`` (12 Fields each, in
    :data:`.pipeline.FIELDS` order), ``prob_wind`` and ``prob_t_freeze``."""
    tk_v = fields["tk"][0]
    nmem, nlev, ny, nx = tk_v.shape
    dev = tk_v.device
    shape = (nlev, ny, nx)
    mean = [Field(torch.empty(shape, device=dev),
                  torch.empty(shape, dtype=torch.bool, device=dev))
            for _ in FIELDS]
    spread = [Field(torch.empty(shape, device=dev),
                    torch.empty(shape, dtype=torch.bool, device=dev))
              for _ in FIELDS]
    above = torch.empty((nmem,) + shape, dtype=torch.bool, device=dev)
    below = torch.empty((nmem,) + shape, dtype=torch.bool, device=dev)
    any_w = torch.zeros(nmem, dtype=torch.bool, device=dev)
    any_t = torch.zeros(nmem, dtype=torch.bool, device=dev)
    limit = f32(wind_limit)
    ps_v, ps_m = fields["ps"]
    for l0 in range(0, nlev, level_block):
        sl = slice(l0, min(nlev, l0 + level_block))
        vals = {n: [] for n in FIELDS}
        masks = {n: [] for n in FIELDS}
        for m in range(nmem):
            args = [Field(fields[k][0][m, sl], fields[k][1][m, sl])
                    for k in ("tk", "q", "u", "v")]
            ps = Field(ps_v[m], ps_m[m])
            out = derived_fields(*args, ps, alevel[sl], blevel[sl], xmapr,
                                 ymapr)
            for n in FIELDS:
                vals[n].append(out[n].values)
                masks[n].append(out[n].mask.expand(out[n].values.shape))
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
