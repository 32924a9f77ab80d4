"""The derived-field pipeline (port of :mod:`mi_fieldcalc_tpu.models.
pipeline`, ``pipeline.py:47-203``).

12 outputs from temperature, specific humidity, wind and surface pressure
on hybrid model levels: pressure, theta, RH, Td, theta_e, ducting, wind
speed, vorticity, divergence, T-advection, |grad T| and TFP.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..field import Field, from_arrays
from ..ops import (
    advection, aleveltemp, alevelducting, alevelhum, alevelthe, divergence,
    gradient, relvort, thermal_front_parameter, vectorabs,
)
from ..ops._harness import not_ported

__all__ = ["DerivedFields", "DerivedFieldsStacked", "derived_fields",
           "inputs_from_numpy"]


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
                   values_i: torch.Tensor) -> torch.Tensor:
        """Field ``i``'s bool mask from a 12-, 9- or 2-plane stack
        (``values_i`` gives the shape of a synthesised constant mask)."""
        if masks.dtype != torch.bool or masks.dim() != values_i.dim() + 1:
            raise not_ported(
                "mi_fieldcalc_tpu.models.pipeline.DerivedFieldsStacked."
                "mask_plane", "the packed int32 / LEV-packed uint32 layout")
        nplanes = masks.shape[0]
        if nplanes == 2:
            j = cls.MASK2[i]
            if j < 0:
                return torch.ones(values_i.shape, dtype=torch.bool,
                                  device=values_i.device)
        else:
            j = cls.MASK9[i] if nplanes == 9 else i
        return masks[j]

    def field(self, i: int) -> Field:
        return Field(self.values[i],
                     self.mask_plane(self.masks, i, self.values[i]))

    def as_fields(self) -> DerivedFields:
        return DerivedFields(*[self.field(i) for i in range(12)])


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
