"""Elementwise operators (port of the pipeline's slice of
:mod:`mi_fieldcalc_tpu.ops.elementwise`)."""

from __future__ import annotations

import torch

from ..field import Field
from ._harness import and_masks, out_field

__all__ = ["vectorabs"]


def vectorabs(u: Field, v: Field) -> Field:
    """Vector magnitude sqrt(u^2+v^2) (FieldCalculations.cc:1819-1841)."""
    out = torch.sqrt(u.values * u.values + v.values * v.values)
    return out_field(out, and_masks(u, v))
