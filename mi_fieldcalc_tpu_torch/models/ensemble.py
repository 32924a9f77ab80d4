"""The ensemble post-processing pipeline (port of
:mod:`mi_fieldcalc_tpu.models.ensemble`, ``ensemble.py:48-112``).

The 12-output derived-field pipeline runs once per member of a
``[nmem, nlev, ny, nx]`` member stack, and the ensemble summary (mean,
spread and two exceedance probabilities) reduces along the member axis
with the reference's semantics: the mean and spread divide by the defined
members of each point (FieldCalculations.cc:2706-2719), the probabilities
by the members whose whole field is not undefined (cc:2840-2847).

With ``fused=True`` on CUDA tensors each member is one launch of the
pipeline kernel (:func:`..ops.fused.derived_fields_fused`), so the kernel
runs ``nmem`` times, each launch writing its member's planes in place in
the member stacks (on CPU tensors the plain version's outputs are copied
there); the JAX package ``vmap``s its ``pallas_call`` over the
members instead.  Both routes write the members' fields into one stack and
run the same reductions on it, so they agree bit for bit wherever the
kernel agrees with its plain version.  The reductions of each field are one
launch of the ensemble kernel on CUDA tensors
(:func:`..ops.ensemble_fused.ensemble_stats_fused`), 12 a summary, and its
plain version on CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..field import Field
from ..ops._harness import not_ported
from ..ops.ensemble_fused import ensemble_stats_fused
from ..utils.profiling import count, span
from .pipeline import DerivedFields, DerivedFieldsStacked, derived_fields

__all__ = ["EnsembleSummary", "ensemble_derived_summary"]


class EnsembleSummary(NamedTuple):
    """Per-quantity ensemble statistics (Fields of ``[nlev, ny, nx]``)."""
    mean: DerivedFields       # ensemble mean of each derived field
    spread: DerivedFields     # ensemble (population) standard deviation
    prob_wind: Field          # P(wind speed > wind_limit) in %
    prob_t_freeze: Field      # P(temperature advection cools below 0) in %


def _member(f: Field, m: int) -> Field:
    return Field(f.values[m], None if f.mask is None else f.mask[m])


def _member_stack(fields, shape: tuple, nplanes: int,
                  fill) -> DerivedFields:
    """The member stacks' layout: values ``f32[12, nmem, *shape]`` and
    masks ``bool[nplanes, nmem, *shape]`` (12 planes, or the pipeline
    kernel's 9 or 2), ``nmem`` and the device those of the ``[nmem, ...]``
    ``fields``.  ``fill(members, values, masks)`` writes member ``m``'s
    planes into its slot ``[:, m]``, given member ``m`` of each field (a
    mask None stays None).  Fields whose masks share a plane share its
    tensor (:meth:`.pipeline.DerivedFieldsStacked.as_fields`)."""
    nmem, dev = fields[0].values.shape[0], fields[0].values.device
    values = torch.empty((12, nmem) + shape, dtype=torch.float32,
                         device=dev)
    masks = torch.empty((nplanes, nmem) + shape, dtype=torch.bool,
                        device=dev)
    for m in range(nmem):
        fill([_member(f, m) for f in fields], values[:, m], masks[:, m])
    return DerivedFieldsStacked(values, masks).as_fields()


@span("ensemble.member_fields")
def ensemble_member_fields(tk: Field, q: Field, u: Field, v: Field,
                           ps: Field, alevel, blevel, xmapr, ymapr,
                           fcoriolis, fused: bool = False,
                           all_defined: bool = False) -> DerivedFields:
    """The 12 derived fields of every member, as :class:`DerivedFields` of
    ``[nmem, nlev, ny, nx]`` Fields.  ``fused=True`` takes each member
    through :func:`..ops.fused.derived_fields_fused` (the kernel on CUDA
    tensors, its plain version on CPU tensors), with ``all_defined`` passed
    through; ``fused=False`` through :func:`.pipeline.derived_fields`.

    With ``fused=True`` each member's outputs land in its slot ``[:, m]``
    of the stacks: the values ``[12, nmem, ...]`` and the kernel's own mask
    planes, ``[9, nmem, ...]`` (``[2, nmem, ...]`` under ``all_defined``).
    On CUDA tensors the kernel writes them in place and the counter
    ``ensemble.members_in_place`` counts each member; on CPU tensors the
    plain version's outputs are copied in.  ``fused=False`` copies each
    member's 12 values and masks into ``[12, nmem, ...]`` stacks, in the
    span ``ensemble.member_stack``, which the fused route keeps, empty."""
    dev = tk.values.device
    rest = (alevel, blevel, xmapr, ymapr, fcoriolis)
    if fused:
        from ..ops.fused import derived_fields_fused

    def fill(args, values, masks):
        if fused:
            derived_fields_fused(*args, *rest, all_defined=all_defined,
                                 out_values=values, out_masks=masks)
            if dev.type == "cuda":
                count("ensemble.members_in_place")
        else:
            out = derived_fields(*args, *rest)
        with span("ensemble.member_stack"):
            if not fused:
                for i, f in enumerate(out):
                    values[i] = f.values
                    masks[i] = f.mask

    nplanes = 12 if not fused else 2 if all_defined else 9
    return _member_stack((tk, q, u, v, ps), tuple(tk.values.shape[1:]),
                         nplanes, fill)


@span("ensemble.reduce")
def ensemble_summary(out: DerivedFields,
                     wind_limit: float = 15.0) -> EnsembleSummary:
    """Mean and spread of all 12 member-stacked fields, the probability of
    wind speed above ``wind_limit`` and of a cooling 1-hour temperature
    advection: one :func:`..ops.ensemble_fused.ensemble_stats_fused` a
    field, the two probabilities with their fields' statistics."""
    limits = {"wspeed": (float(wind_limit), 1), "tadv": (0.0, 2)}
    stats = DerivedFields(*[ensemble_stats_fused(f, *limits.get(name, ()))
                            for name, f in zip(out._fields, out)])
    return EnsembleSummary(
        mean=DerivedFields(*[s.mean for s in stats]),
        spread=DerivedFields(*[s.spread for s in stats]),
        prob_wind=stats.wspeed.prob, prob_t_freeze=stats.tadv.prob)


@span("ensemble.summary", count_allocs=True)
def ensemble_derived_summary(tk: Field, q: Field, u: Field, v: Field,
                             ps: Field, alevel, blevel, xmapr, ymapr,
                             fcoriolis, wind_limit: float = 15.0,
                             fused: bool = False, global_shape=None,
                             all_defined: bool = False) -> EnsembleSummary:
    """Derived fields per member, then the ensemble statistics.

    ``tk, q, u, v`` are ``[nmem, nlev, ny, nx]`` member-stacked Fields and
    ``ps`` ``[nmem, ny, nx]``; ``alevel .. fcoriolis`` are shared by all
    members, as in :func:`.pipeline.derived_fields`.  ``fused=True`` runs
    each member through the pipeline kernel (one launch per member on CUDA
    tensors); ``all_defined`` (fused only) asserts every point of every
    member is defined and takes the kernel's all-defined route.  The TPU's
    padded layout (``global_shape``) is not ported."""
    if (global_shape is not None or all_defined) and not fused:
        raise ValueError("ensemble_derived_summary: global_shape/"
                         "all_defined require fused=True")
    if global_shape is not None:
        raise not_ported("mi_fieldcalc_tpu.models.ensemble."
                         "ensemble_derived_summary",
                         "the padded layout (global_shape)")
    out = ensemble_member_fields(tk, q, u, v, ps, alevel, blevel, xmapr,
                                 ymapr, fcoriolis, fused=fused,
                                 all_defined=all_defined)
    return ensemble_summary(out, wind_limit)
