"""Hybrid -> pressure-level interpolation of several fields in one CUDA
kernel, with its plain version.

Port of :func:`mi_fieldcalc_tpu.ops.vertical_fused.hlevel_to_plevel_fused`
(``vertical_fused.py:269-371``).  Its TPU kernel ``_interp_kernel``
becomes the hand-written CUDA kernel ``csrc/vertical_interp.cu``; the
plain version is :func:`hlevel_to_plevel_plain`, which follows the
kernel's rule op for op:

* the hybrid pressure ``p_k = alevel[k] + blevel[k] * ps`` is rebuilt per
  level;
* target ``t`` is bracketed at level k where ``p_k <= t < p_{k+1}``; on a
  non-monotone column the last such k wins (the JAX kernel's later
  iterations overwrite earlier ones; :func:`.vertical.plevel_interp`'s
  count-based index is the operator's rule, not the kernel's);
* ``x = log_f32(p > 0 ? p : 1)`` (or p), ``w = (x_t - x_k) * dinv`` with
  ``dinv = 1 / (denom != 0 ? denom : 1)``, value
  ``f_k + (f_{k+1} - f_k) * w``; unbracketed lanes are 0;
* mask: both bracket levels defined, ps defined, ``denom != 0``; under
  ``all_defined`` one shared plane of the bracket and ``denom != 0``.

The one deterministic log (:func:`.._libm.log_f32`, the kernel's
``log_f32``) keeps the kernel, the plain version on the card and the plain
version on the CPU equal bit for bit.  Tensors on the CPU take the plain
version; CUDA tensors take the kernel, or the wrapper raises.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from .. import _build
from .._libm import log_f32
from ..field import Field
from ..utils.profiling import count, device_count, span
from ._harness import check_tensor, require

__all__ = ["hlevel_to_plevel_fused", "hlevel_to_plevel_plain"]

#: the JAX rule's field limit of the packed and carrysel variants
_PACKED_VARS = 31
#: the kernel's limits (csrc/vertical_interp.cu): fields a launch (a call
#: launches once per group of that many), levels and targets
_GROUP_VARS = 31
_MAX_LEV = 4096
_MAX_TARGETS = 1024


def _lx(p: torch.Tensor, log_p: bool) -> torch.Tensor:
    return log_f32(torch.where(p > 0, p, torch.ones_like(p))) if log_p \
        else p


def hlevel_to_plevel_plain(fields: Tuple[Field, ...], ps: Field, alevel,
                           blevel, targets: Sequence[float],
                           log_p: bool = True,
                           all_defined: bool = False) -> Tuple[Field, ...]:
    """The kernel's plain PyTorch version: one pass over level pairs, all
    targets at once, the last matching bracket winning.  Builds no
    per-level one-hot stack (``[nt, ny, nx]`` planes only)."""
    dev = ps.values.device
    nlev = fields[0].values.shape[0]
    a = torch.as_tensor(alevel, dtype=torch.float32, device=dev)
    b = torch.as_tensor(blevel, dtype=torch.float32, device=dev)
    xt = torch.tensor([float(t) for t in targets], dtype=torch.float32,
                      device=dev)
    nt = xt.numel()
    xt3 = xt.reshape(nt, 1, 1)
    lxt3 = (log_f32(xt) if log_p else xt).reshape(nt, 1, 1)
    psv = ps.values
    shape = (nt,) + tuple(psv.shape)
    outs = [torch.zeros(shape, dtype=torch.float32, device=dev)
            for _ in fields]
    nmask = 1 if all_defined else len(fields)
    masks = [torch.zeros(shape, dtype=torch.bool, device=dev)
             for _ in range(nmask)]
    one = torch.ones((), dtype=torch.float32, device=dev)
    p_k = a[0] + b[0] * psv
    x0 = _lx(p_k, log_p)
    for k in range(nlev - 1):
        p_k1 = a[k + 1] + b[k + 1] * psv
        x1 = _lx(p_k1, log_p)
        denom = x1 - x0
        ok = denom != 0
        dinv = one / torch.where(ok, denom, one)
        sel = (p_k <= xt3) & (p_k1 > xt3)
        w = (lxt3 - x0) * dinv
        for v, f in enumerate(fields):
            fk = f.values[k]
            val = fk + (f.values[k + 1] - fk) * w
            outs[v] = torch.where(sel, val, outs[v])
            if not all_defined:
                mk = f.mask[k] & f.mask[k + 1] & ok
                masks[v] = torch.where(sel, mk, masks[v])
        if all_defined:
            masks[0] = torch.where(sel, ok, masks[0])
        p_k, x0 = p_k1, x1
    if all_defined:
        return tuple(Field(o, masks[0]) for o in outs)
    return tuple(Field(o, m & ps.mask) for o, m in zip(outs, masks))


def hlevel_to_plevel_fused(fields: Tuple[Field, ...], ps: Field,
                           alevel, blevel, targets: Sequence[float],
                           log_p: bool = True,
                           interpret: bool = False,
                           variant: str = "packed",
                           ty: int = 8, unroll: int = 8,
                           all_defined: bool = False) -> Tuple[Field, ...]:
    """Interpolate several hybrid-level Fields to constant-pressure
    surfaces in one pass (per field the operator
    :func:`.vertical.hlevel_to_plevel`, same masks on monotone columns).

    Args:
      fields: tuple of ``[nlev, ny, nx]`` Fields sharing one grid: any
        number with ``variant="inplace"``, at most 31 with the other two
        (the JAX rule: their mask carries pack one bit a field).
      ps: ``[ny, nx]`` surface-pressure Field (hPa).
      alevel, blevel: ``[nlev]`` hybrid coefficients.
      targets: target pressures (hPa).
      variant: ``"packed"``, ``"inplace"`` or ``"carrysel"``, the JAX
        kernel's three loop forms.  They compute the same outputs with
        bit-identical bracket arithmetic, and here all three run the same
        kernel and the same plain version.  One difference in the JAX
        kernels does not carry over: at a degenerate bracket (equal
        pressures, mask False) ``"carrysel"`` writes ``f_k`` where the
        other two write ``f_k + (f_{k+1} - f_k) * w``; values under a
        False mask are not part of the contract (``CONFORMANCE.md``), and
        the port writes the latter under every name.
      all_defined: the caller asserts every input point (fields and ps)
        is defined: input masks are not read, and the output Fields share
        one mask tensor, the data-dependent bracket gate.
      interpret, ty, unroll: the TPU kernel's tuning; ignored.

    Returns a tuple of ``[len(targets), ny, nx]`` Fields.  On CUDA
    tensors this launches the kernel once for each group of up to 31
    fields and counts each launch in ``hlevel_to_plevel_fused.launches``;
    inside a profiler session it also counts the columns of its launches
    (``b2.columns``) and, on the card, those the kernel's binary search
    took (``b2.searched_columns``).  On CPU tensors it runs
    :func:`hlevel_to_plevel_plain`.
    """
    del interpret, ty, unroll
    fields = tuple(fields)
    nvar = len(fields)
    require(nvar >= 1, "hlevel_to_plevel_fused: no fields")
    require(nvar <= _PACKED_VARS or variant == "inplace",
            "hlevel_to_plevel_fused: packed mask carries hold at most "
            "31 fields — use variant='inplace' beyond that")
    nlev, ny, nx = fields[0].values.shape
    for f in fields:
        require(tuple(f.values.shape) == (nlev, ny, nx),
                "hlevel_to_plevel_fused: field shape mismatch")
    require(tuple(ps.values.shape) == (ny, nx),
            "hlevel_to_plevel_fused: ps must be (ny, nx)")
    targets = tuple(float(t) for t in targets)
    require(len(targets) >= 1, "hlevel_to_plevel_fused: no targets")
    if variant not in ("carrysel", "inplace", "packed"):
        raise ValueError(f"hlevel_to_plevel_fused: bad variant {variant!r}")
    dev = ps.values.device
    if dev.type == "cpu":
        with span("b2.kernel", dev):
            return hlevel_to_plevel_plain(fields, ps, alevel, blevel,
                                          targets, log_p, all_defined)
    if dev.type != "cuda":
        raise ValueError(f"hlevel_to_plevel_fused: no kernel for {dev}")
    return _launch(fields, ps, alevel, blevel, targets, log_p, all_defined)


hlevel_to_plevel_fused.launches = 0


def _launch_args(fields, ps, alevel, blevel, targets, log_p: bool,
                 all_defined: bool, searched=None) -> tuple:
    """One call's checks, outputs and arguments, on any device:
    ``(outputs, args)``, ``args`` those of ``mf_vertical_interp`` up to its
    stream, tensors for pointers; ``searched`` the int64 counter the
    launches add their searched columns to, or None."""
    name = "hlevel_to_plevel_fused"
    dev = ps.values.device
    nvar = len(fields)
    nlev, ny, nx = fields[0].values.shape
    nt = len(targets)
    if nlev > _MAX_LEV or nt > _MAX_TARGETS:
        raise ValueError(f"{name}: the kernel takes at most {_MAX_LEV} levels "
                         f"and at most {_MAX_TARGETS} targets, got {nlev} "
                         f"and {nt}")
    f32, b8 = torch.float32, torch.bool
    for v, f in enumerate(fields):
        check_tensor(name, f.values, f"fields[{v}]", (nlev, ny, nx), f32,
                     dev)
        if not all_defined:
            check_tensor(name, f.mask, f"fields[{v}].mask", (nlev, ny, nx),
                         b8, dev)
    check_tensor(name, ps.values, "ps", (ny, nx), f32, dev)
    if not all_defined:
        check_tensor(name, ps.mask, "ps.mask", (ny, nx), b8, dev)
    for arg, a in (("alevel", alevel), ("blevel", blevel)):
        check_tensor(name, a, arg, (nlev,), f32, dev)
    # staged from pageable memory before .to returns, without waiting for
    # the stream (a blocking copy would drain the queue every call)
    tgt = torch.tensor(targets, dtype=f32).to(dev, non_blocking=True)
    values = torch.empty((nvar, nt, ny, nx), dtype=f32, device=dev)
    masks = torch.empty((1 if all_defined else nvar, nt, ny, nx), dtype=b8,
                        device=dev)
    vp = (ctypes.c_void_p * nvar)(*[f.values.data_ptr() for f in fields])
    mp = (ctypes.c_void_p * nvar)(
        *[None if all_defined else f.mask.data_ptr() for f in fields])
    out = tuple(Field(values[v], masks[0 if all_defined else v])
                for v in range(nvar))
    return out, (vp, mp, nvar, ps.values, None if all_defined else ps.mask,
                 alevel, blevel, tgt, nt, values, masks, nlev, ny, nx,
                 int(log_p), int(all_defined), searched)


def _launch(fields, ps, alevel, blevel, targets, log_p: bool,
            all_defined: bool) -> Tuple[Field, ...]:
    """One call, as :func:`_launch_args` sets it up: one launch for each
    group of up to 31 fields, each counted, and inside a profiler session
    their columns and, on the card, their searched columns."""
    dev = ps.values.device
    out, args = _launch_args(fields, ps, alevel, blevel, targets, log_p,
                             all_defined,
                             device_count("b2.searched_columns", dev))
    launched = ctypes.c_int(0)
    try:
        with span("b2.kernel", dev):
            _build.call("hlevel_to_plevel_fused", "mf_vertical_interp", dev,
                        *args, ctypes.byref(launched))
    finally:        # the groups launched before a refused one count too
        hlevel_to_plevel_fused.launches += launched.value
        count("b2.columns", ps.values.numel() * launched.value)
    return out
