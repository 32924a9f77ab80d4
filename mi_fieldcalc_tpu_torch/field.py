"""Core Field type: explicit boolean masks instead of sentinel checks.

PyTorch port of :mod:`mi_fieldcalc_tpu.field`.  A :class:`Field` holds

* ``values`` — ``float32[..., ny, nx]``; the value at masked-out points is
  unspecified,
* ``mask``   — ``bool[..., ny, nx]``; ``True`` where the point is defined.

The sentinel form (``undef``, default 1e35) exists only at the boundary:
:func:`from_sentinel` / :meth:`Field.to_sentinel` convert, with the
reference predicate ``is_defined(v, undef) = !isnan(v) && v != undef``.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

__all__ = [
    "UNDEF", "ValuesDefined", "Field", "from_sentinel", "from_values",
    "from_arrays", "full_undef", "defined_counts", "defined_state",
    "combine_defined",
]

#: Default missing-value sentinel (``miutil::UNDEF``).
UNDEF: float = 1.0e35


def f32(x: float) -> float:
    """``x`` rounded to float32, as a Python float: the port's scalar
    constants, so an operation with a float32 tensor sees the same operand
    the JAX package's ``np.float32`` constants give."""
    return float(np.float32(x))


class ValuesDefined(enum.IntEnum):
    """Tri-state definedness summary (FieldDefined.h:41)."""

    ALL_DEFINED = 0
    NONE_DEFINED = 1
    SOME_DEFINED = 2


@dataclasses.dataclass(frozen=True)
class Field:
    """A gridded float32 value tensor plus its bool definedness mask, of one
    shape; the trailing two axes are ``(ny, nx)``."""

    values: torch.Tensor
    mask: torch.Tensor

    @property
    def shape(self):
        return self.values.shape

    def sanitized(self, fill: float = 0.0) -> torch.Tensor:
        """The values with ``fill`` at undefined points: a safe input to a
        transcendental function."""
        return torch.where(self.mask, self.values,
                           torch.full((), f32(fill), dtype=self.values.dtype,
                                      device=self.values.device))

    def to_sentinel(self, undef: float = UNDEF) -> torch.Tensor:
        """Materialise the sentinel representation."""
        return torch.where(self.mask, self.values,
                           torch.full((), f32(undef), dtype=self.values.dtype,
                                      device=self.values.device))


def from_sentinel(values, undef: float = UNDEF, device=None) -> Field:
    """Decode a sentinel-coded array: defined iff not NaN and not ``undef``."""
    v = torch.as_tensor(values, dtype=torch.float32, device=device)
    return Field(v, ~torch.isnan(v) & (v != f32(undef)))


def from_values(values, mask=None, device=None) -> Field:
    """Wrap an all-defined (or explicitly masked) array as a Field."""
    v = torch.as_tensor(values, dtype=torch.float32, device=device)
    if mask is None:
        m = torch.ones(v.shape, dtype=torch.bool, device=v.device)
    else:
        m = torch.as_tensor(mask, dtype=torch.bool, device=v.device)
        m = m.broadcast_to(v.shape)
    return Field(v, m)


def from_arrays(values, mask, device=None) -> Field:
    """A Field from a ``(values, mask)`` pair of numpy arrays — the JAX
    package's Field state (``np.asarray(f.values), np.asarray(f.mask)``)
    carried into the port unchanged (copied)."""
    v = torch.tensor(np.asarray(values, np.float32), device=device)
    m = torch.tensor(np.asarray(mask, np.bool_), device=device)
    if v.shape != m.shape:
        raise ValueError(f"from_arrays: values {tuple(v.shape)} and mask "
                         f"{tuple(m.shape)} differ in shape")
    return Field(v, m)


def full_undef(shape, device=None) -> Field:
    """An all-undefined field (``fillUndef``)."""
    return Field(torch.zeros(shape, dtype=torch.float32, device=device),
                 torch.zeros(shape, dtype=torch.bool, device=device))


def defined_counts(mask: torch.Tensor):
    """``(n_defined, n_total)`` as 0-dim int64 tensors on the mask's device,
    with no host sync: :func:`defined_state`'s counts for use inside a
    pipeline (compare them with selects, not host branches).  On a shard,
    sum ``n_defined`` over the shards (``torch.distributed.all_reduce``)
    for the whole field's count."""
    return (mask.sum(dtype=torch.int64),
            torch.full((), mask.numel(), dtype=torch.int64,
                       device=mask.device))


def defined_state(mask: torch.Tensor) -> ValuesDefined:
    """``checkDefined`` over a mask tensor (synchronises with the device)."""
    n_def = int(mask.sum())
    n = mask.numel()
    if n_def == n:
        return ValuesDefined.ALL_DEFINED
    if n_def == 0:
        return ValuesDefined.NONE_DEFINED
    return ValuesDefined.SOME_DEFINED


def combine_defined(a: ValuesDefined, b: ValuesDefined) -> ValuesDefined:
    """``combineDefined`` (FieldDefined.cc:72-83)."""
    if a == ValuesDefined.ALL_DEFINED:
        return b
    if a == ValuesDefined.NONE_DEFINED:
        return ValuesDefined.NONE_DEFINED
    return b if b != ValuesDefined.ALL_DEFINED else ValuesDefined.SOME_DEFINED
