"""The level-conversion suites in one CUDA kernel pass each, with their
plain versions.

Port of :mod:`mi_fieldcalc_tpu.ops.fused_suite` (``fused_suite.py:55-162,
273-539``).  :func:`alevel_suite_fused` computes any requested set of the
pointwise a-level family (``aleveltemp`` / ``alevelhum`` / ``alevelthe`` /
``alevelducting`` modes) over t, q, rh and a pressure field;
:func:`hlevel_suite_fused` is the hybrid-level form, with the pressure
``p = alevel[k] + blevel[k] * ps`` rebuilt per level and never stored, and
the hlevel gates (``hlevelhum``'s ps gate is the inverse of alevelhum's).
Their TPU kernels ``_suite_kernel`` and ``_hsuite_kernel`` become one
hand-written CUDA template with two entries, ``csrc/level_suite.cu``; the
plain versions (:func:`alevel_suite_plain`, :func:`hlevel_suite_plain`)
run the :mod:`.levels` operators per request.

Outputs come in request order (``temps + hums_q + hums_rh + thes +
ducts_q + ducts_rh``) as a list of Fields.  Under ``all_defined`` no input
mask is read and the masks collapse to at most 3 table-gate planes (the
T-form, theta-form and temp-5 spellings of the saturation gate,
:func:`_gate_kind`); gate-free outputs get a constant-True mask.
:class:`SuiteStacked` is the stacked layout the kernels write, which the
serving entry encodes without expanding masks.

Tensors on the CPU take the plain versions; CUDA tensors take the kernel,
or the wrapper raises.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import _build
from ..field import Field, from_arrays
from ._harness import and_masks, check_tensor, not_ported, require
from .levels import (
    _bad_hlevel, _levelducting_core, _levelhum_core, _levelthe_core,
    _leveltemp_core, alevelducting, alevelhum, alevelthe, aleveltemp,
)

__all__ = ["SuiteStacked", "alevel_suite_fused", "alevel_suite_plain",
           "hlevel_suite_fused", "hlevel_suite_plain",
           "suite_inputs_from_numpy"]

#: valid compute modes per request family.  The humidity split encodes
#: which input each mode consumes (a/h-level numbering: 1/2, 5/6, 9/10
#: take q; 3/4, 7/8, 11/12 take RH), so a q-mode in ``hums_rh`` is
#: rejected instead of silently clamping garbage.
_VALID = {"temp": frozenset(range(1, 6)),
          "hum_q": frozenset({1, 2, 5, 6, 9, 10}),
          "hum_rh": frozenset({3, 4, 7, 8, 11, 12}),
          "the": frozenset({1, 2}),
          "duct_q": frozenset({1, 2}),
          "duct_rh": frozenset({3, 4})}
#: the kernel's family codes (csrc/level_suite.cu ``Family``)
_FAMILY_CODE = {"temp": 0, "hum_q": 1, "hum_rh": 2, "the": 3, "duct_q": 4,
                "duct_rh": 5}
#: the kernel's gate-plane slots (csrc/level_suite.cu ``Gate``)
_GATE_SLOT = {"T": 0, "TH": 1, "TH5": 2}
#: the kernel's request capacity
_MAX_REQ = 32


def _build_reqs(name, temps, hums_q, hums_rh, thes, ducts_q, ducts_rh):
    """Validated ``(family, compute)`` request tuple, in argument order."""
    groups = (("temp", temps), ("hum_q", hums_q), ("hum_rh", hums_rh),
              ("the", thes), ("duct_q", ducts_q), ("duct_rh", ducts_rh))
    reqs = []
    for fam, cs in groups:
        for c in cs:
            c = int(c)
            require(c in _VALID[fam],
                    f"{name}: bad {fam} compute {c} "
                    f"(valid: {sorted(_VALID[fam])})")
            reqs.append((fam, c))
    require(len(reqs) >= 1, f"{name}: no conversions requested")
    return tuple(reqs)


def _consumes(reqs):
    """(need_q, need_rh): which optional inputs the request set reads."""
    return (any(f in ("hum_q", "the", "duct_q") for f, _ in reqs),
            any(f in ("hum_rh", "duct_rh") for f, _ in reqs))


def _gate_kind(fam, c):
    """Which data-dependent gate survives the all-defined path for this
    mode: the table-range gate of the T-form temperature ("T": odd hum
    modes, temp 4, duct 3), of the theta-form ``tk = theta * pidcp``
    temperature ("TH": even hum modes, duct 4), of temp 5's own
    ``tk = theta * pi / cp`` spelling ("TH5", kept apart because the two
    spellings can round to different gates), or none (temp 1-3, THE,
    q-ducting)."""
    if fam == "temp":
        return {4: "T", 5: "TH5"}.get(c)
    if fam in ("hum_q", "hum_rh"):
        return "T" if c % 2 == 1 else "TH"
    if fam in ("duct_q", "duct_rh"):
        return {3: "T", 4: "TH"}.get(c)
    return None  # "the"


def _gate_planes(reqs):
    """Ordered distinct gate kinds the request set needs."""
    kinds = []
    for fam, c in reqs:
        k = _gate_kind(fam, c)
        if k is not None and k not in kinds:
            kinds.append(k)
    return tuple(kinds)


def _mask_map(reqs, all_defined: bool) -> Tuple[int, ...]:
    """Request -> mask plane: its own plane, or under ``all_defined`` its
    gate kind's plane (-1: constant True)."""
    if not all_defined:
        return tuple(range(len(reqs)))
    kinds = _gate_planes(reqs)
    return tuple(kinds.index(k) if k is not None else -1
                 for k in (_gate_kind(f, c) for f, c in reqs))


class SuiteStacked(NamedTuple):
    """The suite's stacked output: values ``f32[nout, nlev, ny, nx]`` in
    request order, masks ``bool[nplanes, nlev, ny, nx]`` and
    ``mask_map[k]``, output k's plane (-1: constant True)."""
    values: torch.Tensor
    masks: torch.Tensor
    mask_map: Tuple[int, ...]

    def as_fields(self) -> List[Field]:
        ones = None
        out = []
        for k, j in enumerate(self.mask_map):
            if j < 0:
                if ones is None:
                    ones = torch.ones(self.values.shape[1:], dtype=torch.bool,
                                      device=self.values.device)
                out.append(Field(self.values[k], ones))
            else:
                out.append(Field(self.values[k], self.masks[j]))
        return out


def _stack(reqs, outs: List[Field], all_defined: bool) -> SuiteStacked:
    """The plain versions' outputs in the kernels' layout; under
    ``all_defined`` each gate plane is the mask of the first output of its
    kind (with all-True inputs that mask IS the gate)."""
    mmap = _mask_map(reqs, all_defined)
    values = torch.stack([f.values for f in outs])
    if not all_defined:
        masks = torch.stack([f.mask for f in outs])
    else:
        kinds = _gate_planes(reqs)
        planes = [next(f.mask for (fam, c), f in zip(reqs, outs)
                       if _gate_kind(fam, c) == k) for k in kinds]
        masks = (torch.stack(planes) if planes else torch.zeros(
            (0,) + tuple(values.shape[1:]), dtype=torch.bool,
            device=values.device))
    return SuiteStacked(values, masks, mmap)


def _all_true(*fields):
    return tuple(None if f is None else Field(f.values,
                                              torch.ones_like(f.mask))
                 for f in fields)


def alevel_suite_plain(t: Field, q: Optional[Field], rh: Optional[Field],
                       p: Field, reqs, all_defined: bool = False
                       ) -> SuiteStacked:
    """B3's plain PyTorch version: the a-level operators per request.
    ``all_defined`` takes every input mask as True (the kernel never
    reads them)."""
    if all_defined:
        t, q, rh, p = _all_true(t, q, rh, p)
    outs = []
    for fam, c in reqs:
        h = rh if fam in ("hum_rh", "duct_rh") else q
        if fam == "temp":
            outs.append(aleveltemp(t, p, compute=c))
        elif fam in ("hum_q", "hum_rh"):
            outs.append(alevelhum(t, h, p, compute=c))
        elif fam == "the":
            outs.append(alevelthe(t, q, p, compute=c))
        else:
            outs.append(alevelducting(t, h, p, compute=c))
    return _stack(reqs, outs, all_defined)


def hlevel_suite_plain(t: Field, q: Optional[Field], rh: Optional[Field],
                       ps: Field, alevel, blevel, reqs,
                       all_defined: bool = False) -> SuiteStacked:
    """B4's plain PyTorch version: the hybrid-level cores per request on
    the 3-D pressure ``alevel[k] + blevel[k] * ps``, with the hlevel gates
    (``hlevelhum``: ps gates every mode but 7/11)."""
    if all_defined:
        t, q, rh, ps = _all_true(t, q, rh, ps)
    dev = t.values.device
    nlev = t.values.shape[0]
    a = torch.as_tensor(alevel, dtype=torch.float32, device=dev)
    b = torch.as_tensor(blevel, dtype=torch.float32, device=dev)
    p_arr = a.reshape(nlev, 1, 1) + b.reshape(nlev, 1, 1) * ps.values[None]
    psm = ps.mask[None]
    outs = []
    for fam, c in reqs:
        h = rh if fam in ("hum_rh", "duct_rh") else q
        if fam == "temp":
            outs.append(_leveltemp_core(t, p_arr, and_masks(t) & psm, c))
        elif fam in ("hum_q", "hum_rh"):
            outs.append(_levelhum_core(t, h, p_arr,
                                       None if c in (7, 11) else psm, c))
        elif fam == "the":
            outs.append(_levelthe_core(t, q, p_arr, and_masks(t, q) & psm,
                                       c))
        else:
            outs.append(_levelducting_core(t, h, p_arr,
                                           and_masks(t, h) & psm, c))
    return _stack(reqs, outs, all_defined)


def _check_inputs(name, t, q, rh, reqs):
    need_q, need_rh = _consumes(reqs)
    require(t.values.dim() == 3, f"{name}: t must be [nlev, ny, nx]")
    shape = tuple(t.values.shape)
    for arg, f, need in (("q", q, need_q), ("rh", rh, need_rh)):
        if need:
            require(f is not None, f"{name}: a requested mode consumes "
                    f"{arg} but {arg} is None")
            require(tuple(f.values.shape) == shape,
                    f"{name}: field shape mismatch")
    return (q if need_q else None), (rh if need_rh else None)


def _check_coefficients(name, alevel, blevel):
    """The per-level hybrid-coefficient check (``_bad_hlevel``)."""
    for a, b in zip(np.asarray(torch.as_tensor(alevel).cpu(), np.float64),
                    np.asarray(torch.as_tensor(blevel).cpu(), np.float64)):
        require(not _bad_hlevel(float(a), float(b)),
                f"{name}: bad a/b level")


def _unported(name, global_shape, grid_offsets):
    if global_shape is not None or grid_offsets is not None:
        raise not_ported(f"mi_fieldcalc_tpu.ops.fused_suite.{name}",
                         "the padded layout (global_shape / grid_offsets)")


def alevel_suite_stacked(t: Field, q: Optional[Field], rh: Optional[Field],
                         p: Field, reqs, all_defined: bool = False
                         ) -> SuiteStacked:
    """The a-level suite in the stacked layout: the kernel on CUDA
    tensors, :func:`alevel_suite_plain` on CPU tensors."""
    name = "alevel_suite_fused"
    q, rh = _check_inputs(name, t, q, rh, reqs)
    require(tuple(p.values.shape) == tuple(t.values.shape),
            f"{name}: field shape mismatch")
    dev = t.values.device
    if dev.type == "cpu":
        return alevel_suite_plain(t, q, rh, p, reqs, all_defined)
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for {dev}")
    return _launch(False, t, q, rh, p, None, None, reqs, all_defined)


def hlevel_suite_stacked(t: Field, q: Optional[Field], rh: Optional[Field],
                         ps: Field, alevel, blevel, reqs,
                         all_defined: bool = False) -> SuiteStacked:
    """The hybrid-level suite in the stacked layout: the kernel on CUDA
    tensors, :func:`hlevel_suite_plain` on CPU tensors.  ``alevel`` and
    ``blevel`` are validated per level (``bad a/b level``), first, as the
    JAX entry does."""
    _check_coefficients("hlevel_suite_fused", alevel, blevel)
    return _hlevel_suite_stacked(t, q, rh, ps, alevel, blevel, reqs,
                                 all_defined)


def _hlevel_suite_stacked(t: Field, q: Optional[Field], rh: Optional[Field],
                          ps: Field, alevel, blevel, reqs,
                          all_defined: bool = False) -> SuiteStacked:
    """:func:`hlevel_suite_stacked` for coefficients already checked on
    the host (the staging route checks its numpy ones before the upload,
    so no device tensor is copied back for it)."""
    name = "hlevel_suite_fused"
    q, rh = _check_inputs(name, t, q, rh, reqs)
    nlev, ny, nx = t.values.shape
    require(tuple(torch.as_tensor(alevel).shape) == (nlev,)
            and tuple(torch.as_tensor(blevel).shape) == (nlev,),
            f"{name}: alevel/blevel must have nlev entries")
    require(tuple(ps.values.shape) == (ny, nx),
            f"{name}: ps must be (ny, nx)")
    dev = t.values.device
    if dev.type == "cpu":
        return hlevel_suite_plain(t, q, rh, ps, alevel, blevel, reqs,
                                  all_defined)
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for {dev}")
    return _launch(True, t, q, rh, ps, alevel, blevel, reqs, all_defined)


def alevel_suite_fused(t: Field, q: Optional[Field], rh: Optional[Field],
                       p: Field, temps=(), hums_q=(), hums_rh=(),
                       thes=(), ducts_q=(), ducts_rh=(),
                       interpret: bool = False, ty: Optional[int] = None,
                       all_defined: bool = False, global_shape=None,
                       grid_offsets=None) -> List[Field]:
    """All requested a-level conversions in one kernel pass.

    Args:
      t: ``[nlev, ny, nx]`` temperature Field (Kelvin for odd computes,
        theta for even, per :func:`.levels.aleveltemp` /
        :func:`.levels.alevelhum` semantics).
      q, rh: specific humidity / RH% Fields, or None where no requested
        mode consumes them.
      p: pressure Field (hPa), the shape of ``t``.
      temps: ``aleveltemp`` computes (1-5); hums_q: ``alevelhum`` computes
        taking q (1/2, 5/6, 9/10); hums_rh: those taking RH (3/4, 7/8,
        11/12); thes: ``alevelthe`` computes (1/2); ducts_q / ducts_rh:
        ``alevelducting`` computes taking q (1/2) / RH (3/4).
      all_defined: the caller asserts every input point is defined.
      interpret, ty: the TPU kernel's tuning; ignored.
      global_shape, grid_offsets: the TPU's padded layout; not ported.

    Returns the outputs as a list of Fields in request order.  On CUDA
    tensors this launches the kernel once and counts the launch in
    ``alevel_suite_fused.launches``; on CPU tensors it runs
    :func:`alevel_suite_plain`."""
    del interpret, ty
    reqs = _build_reqs("alevel_suite_fused", temps, hums_q, hums_rh,
                       thes, ducts_q, ducts_rh)
    _unported("alevel_suite_fused", global_shape, grid_offsets)
    return alevel_suite_stacked(t, q, rh, p, reqs, all_defined).as_fields()


alevel_suite_fused.launches = 0


def hlevel_suite_fused(t: Field, q: Optional[Field], rh: Optional[Field],
                       ps: Field, alevel, blevel,
                       temps=(), hums_q=(), hums_rh=(),
                       thes=(), ducts_q=(), ducts_rh=(),
                       interpret: bool = False, ty: Optional[int] = None,
                       all_defined: bool = False, global_shape=None,
                       grid_offsets=None) -> List[Field]:
    """The hybrid-level conversion suite in one kernel pass: arguments as
    :func:`alevel_suite_fused`, except ``ps`` is the ``(ny, nx)``
    surface-pressure Field and ``alevel`` / ``blevel`` the ``[nlev]``
    hybrid coefficients (validated per level).  Semantics are
    hleveltemp / hlevelhum / hlevelthe / hlevelducting per mode, including
    hlevelhum's ps gate (a defined ps is required except for modes 7/11,
    FieldCalculations.cc:1187).  Counts its launches in
    ``hlevel_suite_fused.launches``."""
    del interpret, ty
    reqs = _build_reqs("hlevel_suite_fused", temps, hums_q, hums_rh,
                       thes, ducts_q, ducts_rh)
    _unported("hlevel_suite_fused", global_shape, grid_offsets)
    return hlevel_suite_stacked(t, q, rh, ps, alevel, blevel, reqs,
                                all_defined).as_fields()


hlevel_suite_fused.launches = 0


def _launch_args(hybrid: bool, t, q, rh, p, alevel, blevel, reqs,
                 all_defined: bool) -> tuple:
    """One launch's checks, outputs and arguments, on any device:
    ``(outputs, args)``, ``args`` those of ``mf_hlevel_suite``
    (``hybrid``) or ``mf_alevel_suite`` but the stream, tensors for
    pointers."""
    name = "hlevel_suite_fused" if hybrid else "alevel_suite_fused"
    if len(reqs) > _MAX_REQ:
        raise ValueError(f"{name}: the kernel takes at most {_MAX_REQ} "
                         f"requests, got {len(reqs)}")
    dev = t.values.device
    nlev, ny, nx = t.values.shape
    f32, b8 = torch.float32, torch.bool
    shape3 = (nlev, ny, nx)

    def field(arg, f, shape):
        if f is None:
            return None, None
        check_tensor(name, f.values, arg, shape, f32, dev)
        if all_defined:
            return f.values, None
        check_tensor(name, f.mask, arg + ".mask", shape, b8, dev)
        return f.values, f.mask

    tv, tm = field("t", t, shape3)
    qv, qm = field("q", q, shape3)
    rv, rm = field("rh", rh, shape3)
    pv, pm = field("ps", p, (ny, nx)) if hybrid else field("p", p, shape3)
    if hybrid:
        for arg, a in (("alevel", alevel), ("blevel", blevel)):
            check_tensor(name, a, arg, (nlev,), f32, dev)
    mmap = _mask_map(reqs, all_defined)
    kinds = _gate_planes(reqs)
    nplanes = len(kinds) if all_defined else len(reqs)
    values = torch.empty((len(reqs),) + shape3, dtype=f32, device=dev)
    masks = torch.empty((nplanes,) + shape3, dtype=b8, device=dev)
    creqs = (ctypes.c_int * (2 * len(reqs)))(
        *[v for fam, c in reqs for v in (_FAMILY_CODE[fam], c)])
    gates = [-1, -1, -1]
    for i, k in enumerate(kinds):
        gates[_GATE_SLOT[k]] = i
    cgates = (ctypes.c_int * 3)(*gates)
    tail = (creqs, len(reqs), cgates, values, masks, nlev, ny, nx,
            int(all_defined))
    if hybrid:
        args = (tv, qv, rv, tm, qm, rm, pv, pm, alevel, blevel, *tail)
    else:
        args = (tv, qv, rv, pv, tm, qm, rm, pm, *tail)
    return SuiteStacked(values, masks, mmap), args


def _launch(hybrid: bool, t, q, rh, p, alevel, blevel, reqs,
            all_defined: bool) -> SuiteStacked:
    """One launch, as :func:`_launch_args` sets it up."""
    entry = hlevel_suite_fused if hybrid else alevel_suite_fused
    out, args = _launch_args(hybrid, t, q, rh, p, alevel, blevel, reqs,
                             all_defined)
    entry.launches += 1
    _build.call(entry.__name__, "mf_hlevel_suite" if hybrid
                else "mf_alevel_suite", t.values.device, *args)
    return out


def suite_inputs_from_numpy(args, device=None) -> tuple:
    """The JAX suites' arguments, as numpy, moved into the port:
    ``(t, q, rh, p)`` or ``(t, q, rh, ps, alevel, blevel)``, each Field a
    ``(values, mask)`` pair (or None for an unused q / rh) and the
    coefficients arrays."""
    if len(args) not in (4, 6):
        raise ValueError(f"suite_inputs_from_numpy: expected 4 or 6 "
                         f"arguments, got {len(args)}")
    fields = tuple(None if a is None else from_arrays(a[0], a[1], device)
                   for a in args[:4])
    rest = tuple(torch.as_tensor(np.asarray(a, np.float32), device=device)
                 for a in args[4:])
    return fields + rest
