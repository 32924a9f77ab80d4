"""Small helpers shared by the operator modules (port of
:mod:`mi_fieldcalc_tpu.ops._harness`)."""

from __future__ import annotations

import torch

from ..field import Field, f32

__all__ = ["require", "and_masks", "out_field", "not_ported",
           "check_tensor", "const", "div", "bool_vector"]


def require(cond: bool, message: str) -> None:
    """Parameter validation (reference: ``return false``)."""
    if not cond:
        raise ValueError(message)


def not_ported(jax_function: str, what: str) -> NotImplementedError:
    """The error for a mode of a JAX function that the port leaves out."""
    return NotImplementedError(
        f"{what} is not ported; use {jax_function} of the JAX package")


def const(x, ref: torch.Tensor) -> torch.Tensor:
    """The float32 constant ``x`` as a 0-dim tensor on ``ref``'s device:
    a divisor or dividend that keeps PyTorch's division IEEE.  A fill on
    the device, not a copy of host data, so a CUDA graph can capture it."""
    return torch.full((), f32(x), dtype=torch.float32, device=ref.device)


def bool_vector(flags, device) -> torch.Tensor:
    """A short list of Python bools as a 1-D bool tensor on ``device``,
    built by fills on the device (no copy of host data)."""
    t = torch.zeros(len(flags), dtype=torch.bool, device=device)
    for i, flag in enumerate(flags):
        if flag:
            t[i].fill_(True)
    return t


def div(a, b) -> torch.Tensor:
    """``a / b`` as an IEEE float32 division, either side a Python number
    or a tensor.  PyTorch turns ``tensor / number`` on CUDA and ``number /
    tensor`` on every device into a multiply by a reciprocal, which is not
    the quotient the JAX package and the kernels compute."""
    if not isinstance(a, torch.Tensor):
        a = const(a, b)
    elif not isinstance(b, torch.Tensor):
        b = const(b, a)
    return torch.div(a, b)


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


def check_tensor(fn: str, t, name: str, shape: tuple, dtype: torch.dtype,
                 dev: torch.device) -> None:
    """A kernel wrapper's argument check: ``t`` must be a contiguous
    tensor of ``dtype`` and ``shape`` on ``dev``; raises naming the
    wrapper ``fn`` and the argument."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{fn}: {name} must be a tensor on {dev}, got "
                        f"{type(t).__name__}")
    if t.device != dev:
        raise ValueError(f"{fn}: {name} is on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{fn}: {name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} is not contiguous")

