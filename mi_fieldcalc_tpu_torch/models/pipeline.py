"""The derived-field pipelines (port of :mod:`mi_fieldcalc_tpu.models.
pipeline`, ``pipeline.py:47-314``).

12 outputs from temperature, specific humidity, wind and surface pressure
on hybrid model levels: pressure, theta, RH, Td, theta_e, ducting, wind
speed, vorticity, divergence, T-advection, |grad T| and TFP
(:func:`derived_fields`); the same 12 on standard isobaric surfaces after
a vertical interpolation (:func:`derived_fields_isobaric`); and theta,
dewpoint and the kinematics on one pressure level
(:func:`derived_fields_plevel`, BASELINE config 1).
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from ..field import Field, from_arrays
from ..ops import (
    advection, aleveltemp, alevelducting, alevelhum, alevelthe, divergence,
    gradient, plevelhum, pleveltemp, relvort, thermal_front_parameter,
    vectorabs,
)
from ..ops._harness import not_ported
from ..utils.profiling import span

__all__ = ["DerivedFields", "DerivedFieldsStacked", "STANDARD_PLEVELS",
           "RADIUS", "derived_fields", "derived_fields_isobaric",
           "derived_fields_plevel", "inputs_from_numpy"]

#: The pipeline's composed stencil radius (TFP through |grad T|): the halo
#: a shard of a domain-decomposed grid needs.
RADIUS = 2

#: Standard isobaric surfaces for the 3-D vertical pipeline (hPa).
STANDARD_PLEVELS = (1000.0, 925.0, 850.0, 700.0, 500.0, 400.0, 300.0,
                    250.0, 200.0, 150.0, 100.0)


class DerivedFields(NamedTuple):
    """Pipeline output bundle (all Fields, same shape as the inputs)."""
    p: Field
    th: Field
    rh: Field
    td: Field
    thetae: Field
    ducting: Field
    wspeed: Field
    vort: Field
    div: Field
    tadv: Field
    gradt: Field
    tfp: Field


class DerivedFieldsStacked(NamedTuple):
    """The stacked output layout: the 12 value planes in one
    ``(12, nlev, ny, nx)`` float32 tensor and one bool mask stack, in
    :class:`DerivedFields` order.  ``masks`` holds either the 12 planes,
    the 9 deduplicated planes (td/duc/dv share rh/the/vo's plane,
    :data:`MASK9`) or the all-defined path's 2 gate planes
    (:data:`MASK2`)."""
    values: torch.Tensor
    masks: torch.Tensor

    #: field index -> plane index in the deduplicated 9-plane stack
    MASK9 = (0, 1, 2, 2, 3, 3, 4, 5, 5, 6, 7, 8)

    #: field index -> plane index in the all-defined 2-plane stack (plane 0
    #: the humidity table gate, plane 1 TFP's |grad T| != 0; -1 = True)
    MASK2 = (-1, -1, 0, 0, -1, -1, -1, -1, -1, -1, -1, 1)

    @classmethod
    def mask_plane(cls, masks: torch.Tensor, i: int,
                   values_i: torch.Tensor,
                   true: torch.Tensor = None) -> torch.Tensor:
        """Field ``i``'s bool mask from a 12-, 9- or 2-plane stack
        (``values_i`` gives the shape of a synthesised constant mask;
        ``true``, where given, is that mask)."""
        if masks.dtype != torch.bool or masks.dim() != values_i.dim() + 1:
            raise not_ported(
                "mi_fieldcalc_tpu.models.pipeline.DerivedFieldsStacked."
                "mask_plane", "the packed int32 / LEV-packed uint32 layout")
        nplanes = masks.shape[0]
        if nplanes == 2:
            j = cls.MASK2[i]
            if j < 0:
                return true if true is not None else torch.ones(
                    values_i.shape, dtype=torch.bool, device=values_i.device)
        else:
            j = cls.MASK9[i] if nplanes == 9 else i
        return masks[j]

    def field(self, i: int, true: torch.Tensor = None) -> Field:
        return Field(self.values[i],
                     self.mask_plane(self.masks, i, self.values[i], true))

    def as_fields(self) -> DerivedFields:
        """The 12 Fields; fields whose masks share a plane share its
        tensor, and the fields a 2-plane stack leaves all True share one
        all-True mask."""
        true = None
        if self.masks.dtype == torch.bool and self.masks.shape[0] == 2:
            true = torch.ones(self.values.shape[1:], dtype=torch.bool,
                              device=self.values.device)
        return DerivedFields(*[self.field(i, true) for i in range(12)])


def derived_fields(tk: Field, q: Field, u: Field, v: Field, ps: Field,
                   alevel, blevel, xmapr, ymapr,
                   fcoriolis) -> DerivedFields:
    """The full pipeline on hybrid model levels.

    ``tk, q, u, v`` are ``[nlev, ny, nx]`` Fields, ``ps`` a ``[ny, nx]``
    Field, ``alevel, blevel`` the ``[nlev]`` hybrid coefficients and
    ``xmapr, ymapr`` ``[ny, nx]`` (or ``[nlev, ny, nx]``) map factors.
    ``fcoriolis`` is not used by the 12 outputs."""
    del fcoriolis
    dev = tk.values.device
    nlev = tk.values.shape[0]
    a = torch.as_tensor(alevel, dtype=torch.float32, device=dev)
    b = torch.as_tensor(blevel, dtype=torch.float32, device=dev)
    p = Field(a.reshape(nlev, 1, 1) + b.reshape(nlev, 1, 1) * ps.values[None],
              ps.mask[None].expand(tk.values.shape))

    def bcast(arr):
        arr = torch.as_tensor(arr, dtype=torch.float32, device=dev)
        return arr.expand(tk.values.shape) if arr.dim() == 2 else arr

    xm, ym = bcast(xmapr), bcast(ymapr)
    return DerivedFields(
        p=p,
        th=aleveltemp(tk, p, compute=3),
        rh=alevelhum(tk, q, p, compute=1),
        td=alevelhum(tk, q, p, compute=9),
        thetae=alevelthe(tk, q, p, compute=1),
        ducting=alevelducting(tk, q, p, compute=1),
        wspeed=vectorabs(u, v),
        vort=relvort(u, v, xm, ym),
        div=divergence(u, v, xm, ym),
        tadv=advection(tk, u, v, xm, ym, hours=1.0),
        gradt=gradient(tk, xm, ym, compute=3),
        tfp=thermal_front_parameter(tk, xm, ym))


def _isobaric_surfaces(plevels, ny: int, nx: int, dev) -> tuple:
    """The constant-pressure surfaces ``plevels`` in the hybrid law ``p =
    alevel + blevel * ps``: ``(alevel, blevel, ps)`` with ``alevel`` the
    targets, ``blevel`` 0 and a zero ``(ny, nx)`` ``ps``, all defined."""
    ps = Field(torch.zeros((ny, nx), dtype=torch.float32, device=dev),
               torch.ones((ny, nx), dtype=torch.bool, device=dev))
    # staged from pageable memory before .to returns: no wait for the
    # stream, so the host keeps enqueueing ahead of the card
    alevel = torch.tensor(plevels, dtype=torch.float32).to(
        dev, non_blocking=True)
    return alevel, torch.zeros(len(plevels), dtype=torch.float32,
                               device=dev), ps


@span("isobaric.step", count_allocs=True)
def derived_fields_isobaric(tk: Field, q: Field, u: Field, v: Field,
                            ps: Field, alevel, blevel, xmapr, ymapr,
                            fcoriolis, plevels=STANDARD_PLEVELS,
                            fused: bool = False, global_shape=None,
                            stacked: bool = False,
                            all_defined: bool = False):
    """The 3-D vertical pipeline (BASELINE config 4): interpolate the
    prognostic fields from hybrid model levels to isobaric surfaces
    (log-p linear, mask-aware), then run the 12-output derived-field
    suite on the interpolated stack, with ``alevel = plevels``, ``blevel =
    0`` and a zero, all-defined surface pressure, which is the
    constant-pressure surfaces in the pipeline's hybrid law.

    ``fused=True`` runs both stages through the CUDA kernels (the plain
    versions on CPU tensors): the column interpolation
    (:func:`..ops.vertical_fused.hlevel_to_plevel_fused`, with
    ``all_defined`` passed through), then the pipeline kernel
    (:func:`..ops.fused.derived_fields_fused`).  ``stacked`` selects its
    output layout.  ``all_defined`` asserts every input point is defined;
    the interpolated masks stay data-dependent (targets below the surface
    or above the top), so the pipeline kernel keeps its masks.

    ``fused=False`` is the plain composition: :func:`..ops.vertical.
    hlevel_to_plevel` per field, then :func:`derived_fields`.
    ``global_shape`` (the TPU's padded layout) is not ported."""
    from ..ops import hlevel_to_plevel
    from ..ops.fused import derived_fields_fused
    from ..ops.vertical_fused import hlevel_to_plevel_fused

    if (global_shape is not None or stacked or all_defined) and not fused:
        raise ValueError("derived_fields_isobaric: global_shape/stacked/"
                         "all_defined require fused=True")
    if global_shape is not None:
        raise not_ported("mi_fieldcalc_tpu.models.pipeline."
                         "derived_fields_isobaric",
                         "the padded layout (global_shape)")
    dev = tk.values.device
    plevels = tuple(float(t) for t in plevels)
    a = torch.as_tensor(alevel, dtype=torch.float32, device=dev)
    b = torch.as_tensor(blevel, dtype=torch.float32, device=dev)
    if fused:
        tki, qi, ui, vi = hlevel_to_plevel_fused(
            (tk, q, u, v), ps, a, b, plevels, all_defined=all_defined)
    else:
        tki, qi, ui, vi = (hlevel_to_plevel(f, ps, a, b, plevels)
                           for f in (tk, q, u, v))
    pa, pb, ps0 = _isobaric_surfaces(plevels, *tki.values.shape[-2:], dev)
    if fused:
        return derived_fields_fused(tki, qi, ui, vi, ps0, pa, pb, xmapr,
                                    ymapr, fcoriolis, stacked=stacked)
    return derived_fields(tki, qi, ui, vi, ps0, pa, pb, xmapr, ymapr,
                          fcoriolis)


def derived_fields_plevel(tk: Field, rh: Field, u: Field, v: Field,
                          p: float, xmapr, ymapr,
                          fcoriolis) -> Dict[str, Field]:
    """The pressure-level variant (BASELINE config 1): theta, dewpoint
    and the kinematics on one constant-pressure surface.  The dewpoint is
    ``plevelhum`` mode 11, which reads its second field as specific
    humidity (FieldCalculations.cc:400-464); ``fcoriolis`` is not used."""
    del fcoriolis
    return {"th": pleveltemp(tk, p, compute=3),
            "td": plevelhum(tk, rh, p, compute=11),
            "wspeed": vectorabs(u, v),
            "vort": relvort(u, v, xmapr, ymapr),
            "div": divergence(u, v, xmapr, ymapr),
            "gradt": gradient(tk, xmapr, ymapr, compute=3)}


def inputs_from_numpy(args, device=None) -> tuple:
    """The JAX pipeline's 10 arguments, as numpy, moved into the port:
    the 5 Fields ``tk, q, u, v, ps`` as ``(values, mask)`` pairs and
    ``alevel, blevel, xmapr, ymapr, fcoriolis`` as arrays."""
    if len(args) != 10:
        raise ValueError(f"inputs_from_numpy: expected 10 arguments, "
                         f"got {len(args)}")
    fields = tuple(from_arrays(vals, mask, device) for vals, mask in args[:5])
    rest = tuple(torch.as_tensor(np.asarray(a, np.float32), device=device)
                 for a in args[5:])
    return fields + rest
