"""P4, the solver-constructs probe: a loop that ends when every lane of a
block is done, tanh in its body, a 5-entry table sum and NaN -> 0.

Port of ``tools/probe_mincog_kernel.py``'s ``kernel`` (:20, ``pallas_call``
:62, interpreted at :66), which asked whether these constructs of the
fused MINCOG kernel lower through Mosaic.  Each lane iterates
``c <- c0 * tanh(a / c)`` from ``c = 1`` and freezes on the iteration that
brings ``|c_new - c| <= 1e-5`` (keeping ``c_new``), or stops after its
own 100th iteration.  Then ``sum_k decay[k] * c`` in order, and NaN -> 0.
A lane's result does not depend on how lanes are grouped (:25-35), so the
plain version iterates all lanes together, and the CUDA kernel
(``csrc/probes.cu`` ``solver_kernel``) gives a thread a new lane as soon
as its lane stops.  tanh is the
port's deterministic :func:`.._libm.tanh_f32` on both sides, and the
quotient an IEEE division, so the two are equal bit for bit:

    python -m mi_fieldcalc_tpu_torch.tools.probe_mincog_kernel [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from .._libm import tanh_f32
from .. import _build
from ..ops._harness import check_tensor
from . import _lab

__all__ = ["solver", "solver_plain", "solver_trips", "solver_branches",
           "solver_ops", "solver_inputs", "main"]

#: the TPU probe's array (probe_mincog_kernel.py:51) and the serving grid
TOOL_SHAPE = (64, 256)
GRID_SHAPE = (719, 929)
#: the probe's table (:54) and loop limits (:27, :33)
DECAY = (1.0, 0.8, 0.6, 0.4, 0.2)
MAX_ITER = 100
TOL = np.float32(1e-5)
#: float32 operations per lane-iteration by the branch tanh_f32 takes for
#: x = a / c: the division (an IEEE division counts 1), the multiply and
#: the subtraction, and tanh's own: the polynomial below |x| = 0.625 (x*x,
#: 4 steps of a multiply and an add, z2*x*p + x: 12), the exp form up to
#: |x| = 9 and for NaN (2|x|, exp_f32's 23 with its floor, + 1, the
#: division and 1 - q: 27), none beyond 9 (the sign of x).  Compares,
#: selects and fabs are not counted.
OPS_ITERATION = {"poly": 3 + 12, "exp": 3 + 27, "saturated": 3}
#: |x| below which tanh_f32 takes its polynomial, above which its sign
TANH_POLY_BELOW = 0.625
TANH_SIGN_ABOVE = 9.0
#: per lane after the loop: 5 multiplies and 5 adds
OPS_SUM = 10


def solver_inputs(shape, seed: int = 0, device="cpu") -> tuple:
    """The probe's inputs (:51-54): ``c0`` in [1, 20), ``a`` in
    [0.5, 50) from numpy's ``default_rng(seed)``, and the decay table."""
    rng = np.random.default_rng(seed)
    c0 = rng.uniform(1.0, 20.0, shape).astype(np.float32)
    a = rng.uniform(0.5, 50.0, shape).astype(np.float32)
    return tuple(torch.as_tensor(v, device=device)
                 for v in (c0, a, np.asarray(DECAY, np.float32)))


def _iterate(c0: torch.Tensor, a: torch.Tensor, branches: bool = False):
    """The loop on every lane at once: ``(c, trips, done, counts)``,
    ``trips`` the iterations each lane ran, ``done`` whether it froze
    before the cap, ``counts`` (when ``branches``, else None) the
    lane-iterations that took each branch of tanh_f32 (the keys of
    :data:`OPS_ITERATION`)."""
    tol = torch.tensor(TOL, device=c0.device)
    c = torch.ones_like(c0)
    done = torch.zeros_like(c0, dtype=torch.bool)
    trips = torch.zeros_like(c0, dtype=torch.int32)
    counts = dict.fromkeys(OPS_ITERATION, 0) if branches else None
    for _ in range(MAX_ITER):
        if bool(done.all()):
            break
        trips += (~done).to(torch.int32)
        x = torch.div(a, c)
        if branches:
            ax = x.abs()
            live = int((~done).sum())
            poly = int((~done & (ax < TANH_POLY_BELOW)).sum())
            sign = int((~done & (ax > TANH_SIGN_ABOVE)).sum())
            counts["poly"] += poly
            counts["saturated"] += sign
            counts["exp"] += live - poly - sign
        c_new = c0 * tanh_f32(x)
        err = (c_new - c).abs()
        c = torch.where(done, c, c_new)
        done = done | (err <= tol)
    return c, trips, done, counts


def solver_plain(c0: torch.Tensor, a: torch.Tensor,
                 decay: torch.Tensor) -> torch.Tensor:
    """The probe's plain PyTorch version."""
    c = _iterate(c0, a)[0]
    acc = torch.zeros_like(c)
    for k in range(decay.shape[0]):
        acc = acc + decay[k] * c
    return torch.where(torch.isnan(acc), torch.zeros_like(acc), acc)


def solver_trips(c0: torch.Tensor, a: torch.Tensor) -> tuple:
    """``(trips, done)``: the iterations each lane needs (its own, however
    lanes are grouped) and whether it froze before the cap."""
    return _iterate(c0, a)[1:3]


def solver_branches(c0: torch.Tensor, a: torch.Tensor) -> dict:
    """The lane-iterations these inputs need in each branch of tanh_f32
    (``poly``, ``exp``, ``saturated``); they sum to ``trips.sum()``."""
    return _iterate(c0, a, branches=True)[3]


def solver_ops(branches: dict, lanes: int) -> int:
    """Float32 operations a run of ``lanes`` lanes needs, from the
    lane-iterations of each branch (:func:`solver_branches`)."""
    return (sum(OPS_ITERATION[k] * v for k, v in branches.items())
            + OPS_SUM * lanes)


#: the kernel's lane counter and count of warps out, one pair a (device,
#: stream): launches on one stream run in turn, and the kernel leaves both
#: zero, so each launch finds them so; launches on two streams, which may
#: run at once, use two pairs
_WORKSPACES: dict = {}


def _workspace(dev: torch.device) -> torch.Tensor:
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if key not in _WORKSPACES:
        _WORKSPACES[key] = torch.zeros(2, dtype=torch.int32, device=dev)
    return _WORKSPACES[key]


def solver(c0: torch.Tensor, a: torch.Tensor,
           decay: torch.Tensor) -> torch.Tensor:
    """The probe on float32 ``c0`` and ``a`` of one shape and a 5-entry
    ``decay``.  On CUDA tensors this launches ``solver_kernel`` and counts
    the launch in ``solver.launches``; on CPU tensors it runs
    :func:`solver_plain`."""
    if not _lab.route("solver", c0):
        return solver_plain(c0, a, decay)
    dev = c0.device
    check_tensor("solver", c0, "c0", tuple(c0.shape), torch.float32, dev)
    check_tensor("solver", a, "a", tuple(c0.shape), torch.float32, dev)
    check_tensor("solver", decay, "decay", (len(DECAY),), torch.float32,
                 dev)
    if not 1 <= c0.numel() < 2 ** 31:
        raise ValueError(f"solver: {c0.numel()} lanes outside 1..2^31-1")
    out = torch.empty_like(c0)
    work = _workspace(dev)
    solver.launches += 1
    _build.call("solver", "mf_probe_solver", dev, c0, a, decay, out, work,
                c0.numel())
    return out


solver.launches = 0


def main(argv=None) -> int:
    dev = _lab.device_from_args("probe_mincog_kernel", argv)
    label = _lab.device_label(dev)
    for shape in ((TOOL_SHAPE, GRID_SHAPE) if dev.type == "cuda"
                  else (TOOL_SHAPE,)):
        c0, a, decay = solver_inputs(shape, 0, dev)
        _lab.assert_same(solver(c0, a, decay), solver_plain(c0, a, decay),
                         f"solver {shape}")
        trips, done = solver_trips(c0, a)
        branches = solver_branches(c0, a)
        ms = _lab.median_ms(lambda: solver(c0, a, decay), dev)
        print(f"[{label}] {shape}: equal to the plain version; "
              f"{int((~done).sum())} lanes unconverged at the cap; "
              f"lane-iterations by branch {branches}; "
              f"{solver_ops(branches, c0.numel()):.3e} operations in "
              f"{ms:.4f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
