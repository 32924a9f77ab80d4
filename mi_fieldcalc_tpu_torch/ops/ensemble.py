"""Ensemble-member reductions (port of :mod:`mi_fieldcalc_tpu.ops.ensemble`,
``ensemble.py:49-205``).

Reference: FieldCalculations.cc — sumFields (2671), meanValue (2696),
stddevValue (2726), extremeValue (2759), probability (2807).  Members are
stacked on a leading axis (a Field of ``[nmem, ...]``, or a sequence of
Fields), and each reduction runs along it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..field import Field, ValuesDefined, f32
from ..utils.profiling import span
from ._harness import bool_vector, out_field, require
from .stencil import _SHARD_CTX, shard_all_reduce

__all__ = ["sum_fields", "mean_value", "stddev_value", "extreme_value",
           "probability"]


def _stack(members) -> Field:
    if isinstance(members, Field):
        return members
    return Field(torch.stack([m.values for m in members]),
                 torch.stack([m.mask for m in members]))


def _member_axis(flags, s: Field) -> torch.Tensor:
    """A ``[nmem]`` bool list (or tensor) as a tensor that broadcasts over
    a member stack."""
    if isinstance(flags, torch.Tensor):
        t = flags.to(device=s.mask.device, dtype=torch.bool)
    else:
        t = bool_vector(flags, s.mask.device)
    return t.reshape((-1,) + (1,) * (s.mask.dim() - 1))


def _apply_member_flags(s: Field, member_defined) -> Field:
    """Per-member ``fDefinedIn`` flags: a member flagged ALL_DEFINED skips
    the per-point check (FieldCalculations.cc:2710), so its sentinel
    values, if the flag lies, count as data."""
    if member_defined is None:
        return s
    flags = [int(d) == int(ValuesDefined.ALL_DEFINED) for d in member_defined]
    return Field(s.values, s.mask | _member_axis(flags, s))


def _masked_sum(s: Field, values: torch.Tensor) -> torch.Tensor:
    return torch.where(s.mask, values, torch.zeros((), device=values.device,
                                                   dtype=values.dtype)
                       ).sum(dim=0)


def sum_fields(members) -> Field:
    """Pointwise sum over members, undefined wherever any member is
    (FieldCalculations.cc:2671-2694)."""
    s = _stack(members)
    return Field(_masked_sum(s, s.values), s.mask.all(dim=0))


def _defined_count(s: Field):
    """The defined members per point, whether any is, and the count as a
    float32 divisor (1 where none is)."""
    n = s.mask.sum(dim=0)
    some = n > 0
    return some, torch.where(some, n, 1).to(torch.float32)


def mean_value(members, member_defined=None) -> Field:
    """Pointwise mean over the defined members; the divisor is the
    per-point defined count (FieldCalculations.cc:2696-2724)."""
    s = _apply_member_flags(_stack(members), member_defined)
    some, nf = _defined_count(s)
    return out_field(_masked_sum(s, s.values) / nf, some)


def stddev_value(members, member_defined=None) -> Field:
    """Pointwise population standard deviation over the defined members
    (FieldCalculations.cc:2726-2757), in the JAX package's two-pass form
    (the reference runs Welford's recurrence)."""
    s = _apply_member_flags(_stack(members), member_defined)
    some, nf = _defined_count(s)
    mean = _masked_sum(s, s.values) / nf
    d = s.values - mean[None]
    return out_field(torch.sqrt(_masked_sum(s, d * d) / nf), some)


def extreme_value(compute: int, members) -> Field:
    """Max / min value or its member index (FieldCalculations.cc:
    2759-2805): 1 max value, 2 min value, 3 max index, 4 min index.

    The reference's sequential tracking, one member after the other: in
    index mode an all-undefined point yields ``n_members - 1``, marked
    defined (cc:2789-2801)."""
    require(compute in (1, 2, 3, 4), f"extremeValue: bad compute {compute}")
    s = _stack(members)
    n_members = s.values.shape[0]
    require(n_members > 0, "extremeValue: no fields")
    want_max = compute in (1, 3)
    cur = torch.zeros_like(s.values[0])
    cur_def = torch.zeros_like(s.mask[0])
    idx = torch.zeros_like(cur)
    for j in range(n_members):
        vj, mj = s.values[j], s.mask[j]
        better = (vj > cur) if want_max else (vj < cur)
        take = ~cur_def | (mj & better)
        cur = torch.where(take, vj, cur)
        cur_def = torch.where(take, mj, cur_def)
        idx = torch.where(take, f32(j), idx)
    if compute in (1, 2):
        return Field(cur, cur_def)
    return Field(idx, torch.ones_like(cur_def))


def shard_member_flags(flags: torch.Tensor) -> torch.Tensor:
    """The whole-field member flags ``flags`` (one int a member), in place
    their maximum over the shards of the installed ``ops.stencil.ShardCtx``
    group, inside the span ``ensemble.flags_reduce``; as they are where no
    group is installed."""
    ctx = _SHARD_CTX.get()
    if ctx is None or ctx.group is None:
        return flags
    with span("ensemble.flags_reduce"):
        return shard_all_reduce(flags, "max")


def probability(compute: int, members, limits: Sequence[float],
                member_defined: Optional[Sequence[ValuesDefined]] = None,
                member_defined_mask=None) -> Field:
    """Probability (%) or count of members above / below / between limits
    (FieldCalculations.cc:2807-2860): 1 above, 2 below, 3 between, 4-6 the
    same as counts.

    The divisor counts the members whose whole-field flag is not
    NONE_DEFINED, even where the member is undefined at the point
    (FieldCalculationsTest.cc:225-305).  The flags come from
    ``member_defined`` (Python values), ``member_defined_mask`` (a
    ``[nmem]`` bool tensor) or, with neither, each member's mask, on a
    shard (``ops.stencil.ShardCtx``) the maximum over the shards."""
    s = _stack(members)
    check_between = len(limits) >= 2 and compute in (3, 6)
    check_above = len(limits) >= 1 and (compute in (1, 4) or check_between)
    check_below = len(limits) >= 1 and (compute in (2, 5) or check_between)
    require(check_above or check_below,
            "probability: bad compute/limits combination")
    require(member_defined is None or member_defined_mask is None,
            "probability: pass member_defined or member_defined_mask, "
            "not both")
    passes = s.mask
    if check_above:
        passes = passes & (s.values > f32(limits[0]))
    if check_below:
        passes = passes & (s.values < f32(limits[1] if check_between
                                          else limits[0]))
    if member_defined is not None:
        member_sel = bool_vector(
            [int(d) != int(ValuesDefined.NONE_DEFINED)
             for d in member_defined], s.mask.device)
    elif member_defined_mask is not None:
        member_sel = torch.as_tensor(member_defined_mask,
                                     device=s.mask.device).to(torch.bool)
        require(member_sel.dim() == 1,
                "probability: member_defined_mask must be a [nmem] vector")
    else:
        member_sel = s.mask.reshape(s.mask.shape[0], -1).any(dim=1)
        if _SHARD_CTX.get() is not None:
            member_sel = shard_member_flags(member_sel.to(torch.int32)) != 0
    nfields = member_sel.sum()
    passes = passes & _member_axis(member_sel, s)
    count = passes.sum(dim=0).to(torch.float32)
    some = nfields > 0
    if compute < 4:
        out = count * f32(100.0) / torch.where(some, nfields, 1).to(
            torch.float32)
    else:
        out = count
    return out_field(out, some.expand(count.shape))
