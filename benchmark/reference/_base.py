"""The plain reference's Field type, constants and arithmetic helpers.

Plain PyTorch and numpy.  The reference imports neither ``jax`` nor either
package of the repository; what it shares with the program is only the
inputs the benchmark draws.  The constants carry the float32 values of the
reference library (MetConstants.h:39-59).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

r = np.float32(287.0)
cp = np.float32(1004.0)
p0 = np.float32(1000.0)
t0 = np.float32(273.15)
eps = np.float32(0.622)
xlh = np.float32(2.501e6)
p0inv = np.float32(1.0 / p0)
kappa = np.float32(r / cp)
rhmin = np.float32(0.02)
rhmax = np.float32(1.00)

#: e_w(T) for T = -100, -95, ..., +100 degC (MetConstants.h:56-59)
EWT = np.array(
    [.000034, .000089, .000220, .000517, .001155, .002472, .005080, .01005,
     .01921, .03553, .06356, .1111, .1891, .3139, .5088, .8070, 1.2540,
     1.9118, 2.8627, 4.2148, 6.1078, 8.7192, 12.272, 17.044, 23.373, 31.671,
     42.430, 56.236, 73.777, 95.855, 123.40, 157.46, 199.26, 250.16, 311.69,
     385.56, 473.67, 578.09, 701.13, 845.28, 1013.25], dtype=np.float32)
N_EWT = len(EWT)


def f32(x: float) -> float:
    """``x`` rounded to float32, as a Python float."""
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class Field:
    """float32 values and a bool mask (True where defined), one shape."""
    values: torch.Tensor
    mask: torch.Tensor


def require(cond: bool, message: str) -> None:
    if not cond:
        raise ValueError(message)


def const(x, ref: torch.Tensor) -> torch.Tensor:
    """The float32 constant ``x`` as a 0-dim tensor on ``ref``'s device."""
    return torch.full((), f32(x), dtype=torch.float32, device=ref.device)


def div(a, b) -> torch.Tensor:
    """``a / b`` as an IEEE float32 division, either side a number or a
    tensor (a number becomes a 0-dim tensor: PyTorch multiplies by a
    reciprocal where one side is a Python number)."""
    if not isinstance(a, torch.Tensor):
        a = const(a, b)
    elif not isinstance(b, torch.Tensor):
        b = const(b, a)
    return torch.div(a, b)


def and_masks(*fields_or_masks) -> torch.Tensor:
    m = None
    for f in fields_or_masks:
        fm = f.mask if isinstance(f, Field) else f
        m = fm if m is None else (m & fm)
    return m


def out_field(values: torch.Tensor, mask: torch.Tensor) -> Field:
    return Field(values, mask.to(torch.bool).broadcast_to(values.shape))
