"""Small helpers shared by the operator modules (port of
:mod:`mi_fieldcalc_tpu.ops._harness`)."""

from __future__ import annotations

import torch

from ..field import Field

__all__ = ["require", "and_masks", "out_field", "not_ported"]


def require(cond: bool, message: str) -> None:
    """Parameter validation (reference: ``return false``)."""
    if not cond:
        raise ValueError(message)


def not_ported(jax_function: str, what: str) -> NotImplementedError:
    """The error for a mode of a JAX function that the port leaves out."""
    return NotImplementedError(
        f"{what} is not ported; use {jax_function} of the JAX package")


def and_masks(*fields_or_masks) -> torch.Tensor:
    """Combined definedness of several inputs as one AND."""
    m = None
    for f in fields_or_masks:
        fm = f.mask if isinstance(f, Field) else f
        m = fm if m is None else (m & fm)
    return m


def out_field(values: torch.Tensor, mask: torch.Tensor) -> Field:
    """Build an output Field, broadcasting the mask to the value shape."""
    return Field(values, mask.to(torch.bool).broadcast_to(values.shape))
