"""The MINCOG and ModStall solvers in one CUDA kernel each, with their plain
versions.

Port of :mod:`mi_fieldcalc_tpu.ops.icing_fused` (``icing_fused.py:109-288``).
Each wrapper computes the gate and runs the c-independent prologue in
PyTorch (:func:`.icing._mincog_static`, :func:`.icing._modstall_static`:
``pow``, ``arcsin``, ``sin`` and ``cos``), as the JAX wrapper does, so the
kernel and the plain version see the same prologue planes.  Then:

* CUDA tensors launch the kernel once (``csrc/vessel_icing.cu``:
  ``mf_vessel_icing_mincog`` replaces ``icing_fused.py:_mincog_kernel``,
  ``mf_vessel_icing_modstall`` replaces ``_modstall_kernel``), count the
  launch in ``.launches`` and raise on a failed launch;
* CPU tensors run the plain core (:func:`.icing._mincog_core`,
  :func:`.icing._modstall_core`);
* meta tensors run the checks and give the output's shape, with no launch
  (the batch's validation).

The kernel's decay table is built once per table and device and kept, so
a CUDA graph that captures a launch reads a live tensor and the launch
copies no host data.

Both routes write 0 where the gate is off; the output mask is the gate.
The TPU's tiling (``ty``, ``interpret``, the padded layout, the int8 bit
plane), ``stack_heights`` and ``warm_fp != 0`` are not ported: ``ty`` and
``interpret`` are accepted and ignored, the other two raise.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .. import _build
from ..field import Field
from ._harness import (
    check_tensor, not_ported, out_field, require,
)
from .icing import (
    _mincog_core, _mincog_decay, _mincog_gate, _mincog_require,
    _mincog_static, _modstall_core, _modstall_gate, _modstall_require,
    _modstall_static, _number,
)

__all__ = ["vessel_icing_mincog_fused", "vessel_icing_mincog_plain",
           "vessel_icing_modstall_fused", "vessel_icing_modstall_plain"]

#: f32 planes entering the MINCOG kernel, in argument order
_PLANES = ("c0", "a", "wave", "pw", "depth", "v", "sst", "sal", "airtemp",
           "rh", "ha", "he", "ea", "M", "K", "tau", "vd")
#: f32 planes entering the ModStall kernel, in argument order
_MS_PLANES = ("c0", "a", "wave", "v", "sst", "airtemp", "rh", "tf", "ha",
              "tau", "K", "M")
_JAX = "mi_fieldcalc_tpu.ops.icing_fused."


def _mincog_prologue(sal, wave, x_wind, y_wind, airtemp, rh, sst, p, pw,
                     aice, depth, vs, alpha):
    """Gate, the 17 kernel planes and the shallow / skip0 flags."""
    gate = _mincog_gate(sal, wave, x_wind, y_wind, airtemp, rh, sst, p,
                        aice, depth)
    (v, skip0, c0, shallow, a, ha, tau, ea, K, M, vd, he) = _mincog_static(
        sal.values, wave.values, x_wind.values, y_wind.values,
        airtemp.values, rh.values, p.values, pw.values, depth.values, vs,
        alpha, gate)
    planes = dict(c0=c0, a=a, wave=wave.values, pw=pw.values,
                  depth=depth.values, v=v, sst=sst.values, sal=sal.values,
                  airtemp=airtemp.values, rh=rh.values, ha=ha, he=he,
                  ea=ea, M=M, K=K, tau=tau, vd=vd)
    return gate, planes, shallow, skip0


def _modstall_prologue(sal, wave, x_wind, y_wind, airtemp, rh, sst, p, pw,
                       aice, depth):
    """Gate, the 12 kernel planes and the shallow flag."""
    gate = _modstall_gate(sal, wave, x_wind, y_wind, airtemp, rh, sst, p,
                          aice, depth)
    v, c0, shallow, a, tf, ha, tau, K, M = _modstall_static(
        sal.values, wave.values, x_wind.values, y_wind.values,
        airtemp.values, rh.values, p.values, pw.values, depth.values, gate)
    planes = dict(c0=c0, a=a, wave=wave.values, v=v, sst=sst.values,
                  airtemp=airtemp.values, rh=rh.values, tf=tf, ha=ha,
                  tau=tau, K=K, M=M)
    return gate, planes, shallow


def _gated(out: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    return torch.where(gate, out, torch.zeros_like(out))


def _mincog_plain(gate, planes, shallow, skip0, vsca, alt, decay, trips):
    P = planes
    if trips is not None:
        trips["gate"] = gate
    out = _mincog_core(P["c0"], P["a"], shallow, skip0, P["wave"], P["pw"],
                       P["depth"], P["v"], P["sst"], P["sal"], P["airtemp"],
                       P["rh"], P["ha"], P["he"], P["ea"], P["M"], P["K"],
                       P["tau"], P["vd"], vsca, alt, decay, trips=trips)
    return _gated(out, gate)


def _modstall_plain(gate, planes, shallow, vsca, decay, trips):
    P = planes
    out = _modstall_core(P["c0"], P["a"], shallow, gate, P["wave"], P["v"],
                         P["sst"], P["airtemp"], P["rh"], P["tf"], P["ha"],
                         P["tau"], P["K"], P["M"], vsca, decay, trips=trips)
    if trips is not None:
        trips["solved"] = int(gate.sum())
        if "lanes" in trips:
            live = gate.to(torch.int32)
            trips["lanes"]["live"] = trips["lanes"]["solved"] = live
    return _gated(out, gate)


def vessel_icing_mincog_plain(sal: Field, wave: Field, x_wind: Field,
                              y_wind: Field, airtemp: Field, rh: Field,
                              sst: Field, p: Field, pw: Field, aice: Field,
                              depth: Field, vs: float, alpha: float,
                              zmin: float, zmax: float, alt: int,
                              trips: Optional[dict] = None) -> Field:
    """B5's plain PyTorch version: the prologue and :func:`._mincog_core`,
    0 where the gate is off.  ``trips``, where given, receives the lanes
    solved, the wave fixed point's lane-steps, the tanh evaluations and
    the lane-heights by branch (the work behind the kernel's bound;
    :func:`.icing._count`)."""
    _mincog_require(vs, alpha, zmin, zmax)
    gate, planes, shallow, skip0 = _mincog_prologue(
        sal, wave, x_wind, y_wind, airtemp, rh, sst, p, pw, aice, depth, vs,
        alpha)
    out = _mincog_plain(gate, planes, shallow, skip0,
                        float(vs * math.cos(alpha)), alt,
                        _mincog_decay(zmin, _number(zmin, zmax)), trips)
    return out_field(out, gate)


def vessel_icing_modstall_plain(sal: Field, wave: Field, x_wind: Field,
                                y_wind: Field, airtemp: Field, rh: Field,
                                sst: Field, p: Field, pw: Field, aice: Field,
                                depth: Field, vs: float, alpha: float,
                                zmin: float, zmax: float,
                                trips: Optional[dict] = None) -> Field:
    """B6's plain PyTorch version: the prologue and
    :func:`._modstall_core`, 0 where the gate is off.  ``trips`` as in
    :func:`vessel_icing_mincog_plain`, plus the height fixed point's
    lane-steps."""
    _modstall_require(vs, alpha, zmin, zmax)
    gate, planes, shallow = _modstall_prologue(
        sal, wave, x_wind, y_wind, airtemp, rh, sst, p, pw, aice, depth)
    out = _modstall_plain(gate, planes, shallow, float(vs * math.cos(alpha)),
                          _mincog_decay(zmin, _number(zmin, zmax)), trips)
    return out_field(out, gate)


def _route(name: str, dev: torch.device) -> bool:
    """True for the kernel (CUDA, and meta: its checks without a launch),
    False for the plain version (CPU)."""
    if dev.type in ("cuda", "meta"):
        return True
    if dev.type != "cpu":
        raise ValueError(f"{name}: no kernel for {dev}")
    return False


def vessel_icing_mincog_fused(sal: Field, wave: Field, x_wind: Field,
                              y_wind: Field, airtemp: Field, rh: Field,
                              sst: Field, p: Field, pw: Field, aice: Field,
                              depth: Field, vs: float, alpha: float,
                              zmin: float, zmax: float, alt: int,
                              interpret: bool = False, ty: int = 8,
                              stack_heights: bool = False) -> Field:
    """MINCOG icing rate (``vessel_icing_mincog``'s semantics) through
    kernel B5.  On CUDA tensors it launches the kernel once and counts the
    launch in ``vessel_icing_mincog_fused.launches``; on CPU tensors it
    runs :func:`vessel_icing_mincog_plain`'s core.  ``interpret`` and
    ``ty`` (the TPU tiling) are ignored; ``stack_heights`` is not
    ported."""
    del interpret
    _mincog_require(vs, alpha, zmin, zmax)
    require(ty in (8, 16), "vessel_icing_mincog_fused: ty must be 8 or 16")
    if stack_heights:
        raise not_ported(_JAX + "vessel_icing_mincog_fused",
                         "stack_heights=True")
    gate, planes, shallow, skip0 = _mincog_prologue(
        sal, wave, x_wind, y_wind, airtemp, rh, sst, p, pw, aice, depth, vs,
        alpha)
    vsca = float(vs * math.cos(alpha))
    decay = _mincog_decay(zmin, _number(zmin, zmax))
    if _route("vessel_icing_mincog_fused", gate.device):
        out = _launch(vessel_icing_mincog_fused, _PLANES, planes,
                      (gate, shallow, skip0), decay, vsca, alt)
    else:
        out = _mincog_plain(gate, planes, shallow, skip0, vsca, alt, decay,
                            None)
    return out_field(out, gate)


vessel_icing_mincog_fused.launches = 0


def vessel_icing_modstall_fused(sal: Field, wave: Field, x_wind: Field,
                                y_wind: Field, airtemp: Field, rh: Field,
                                sst: Field, p: Field, pw: Field,
                                aice: Field, depth: Field, vs: float,
                                alpha: float, zmin: float, zmax: float,
                                interpret: bool = False, ty: int = 8,
                                stack_heights: bool = False,
                                warm_fp: Optional[int] = None) -> Field:
    """Modified Stallabrass icing rate (``vessel_icing_modstall``'s
    semantics) through kernel B6, with the exact 32-step warmup at every
    height (``warm_fp`` None or 0; other values are not ported).  Counts
    its launches in ``vessel_icing_modstall_fused.launches``; CPU tensors
    run :func:`vessel_icing_modstall_plain`'s core."""
    del interpret
    _modstall_require(vs, alpha, zmin, zmax)
    require(ty in (8, 16),
            "vessel_icing_modstall_fused: ty must be 8 or 16")
    require(ty == 8 or not stack_heights,
            "vessel_icing_modstall_fused: stack_heights needs ty=8")
    if stack_heights:
        raise not_ported(_JAX + "vessel_icing_modstall_fused",
                         "stack_heights=True")
    if warm_fp:
        raise not_ported(_JAX + "vessel_icing_modstall_fused",
                         f"warm_fp={warm_fp} (the early-armed projection)")
    gate, planes, shallow = _modstall_prologue(
        sal, wave, x_wind, y_wind, airtemp, rh, sst, p, pw, aice, depth)
    vsca = float(vs * math.cos(alpha))
    decay = _mincog_decay(zmin, _number(zmin, zmax))
    if _route("vessel_icing_modstall_fused", gate.device):
        out = _launch(vessel_icing_modstall_fused, _MS_PLANES, planes,
                      (gate, shallow), decay, vsca, None)
    else:
        out = _modstall_plain(gate, planes, shallow, vsca, decay, None)
    return out_field(out, gate)


vessel_icing_modstall_fused.launches = 0


#: (decay table, device) -> the table as a float32 tensor on the device
_DECAY = {}


def _decay_tensor(decay, dev: torch.device) -> torch.Tensor:
    """The decay table on ``dev``, built at its first use and kept."""
    key = (tuple(decay), dev)
    t = _DECAY.get(key)
    if t is None:
        t = _DECAY[key] = torch.tensor(decay, dtype=torch.float32,
                                       device=dev)
    return t


def _launch_args(name: str, names, planes: dict, flags: tuple, decay,
                 vsca: float, alt: Optional[int]) -> tuple:
    """A launch's checks, output and arguments on any device: ``(out,
    args)``, ``args`` those of ``mf_vessel_icing_mincog`` (``alt`` given)
    or ``mf_vessel_icing_modstall`` but the stream, tensors for pointers,
    or None where nothing is launched (an empty grid or meta tensors)."""
    gate = flags[0]
    dev = gate.device
    shape = tuple(gate.shape)
    require(len(shape) == 2, f"{name}: fields must be (ny, nx)")
    n = gate.numel()
    if n >= 2 ** 31:
        raise ValueError(f"{name}: {n} points exceed the kernel's int index")
    for k in names:
        check_tensor(name, planes[k], k, shape, torch.float32, dev)
    for k, f in zip(("gate", "shallow", "skip0"), flags):
        check_tensor(name, f, k, shape, torch.bool, dev)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    if n == 0 or dev.type == "meta":
        return out, None
    ptrs = (ctypes.c_void_p * len(names))(
        *[planes[k].data_ptr() for k in names])
    dec = _decay_tensor(decay, dev)
    if alt is None:
        return out, (ptrs, gate, flags[1], dec, len(decay), vsca, out, n)
    return out, (ptrs, gate, flags[1], flags[2], dec, len(decay), vsca,
                 int(alt), out, n)


def _launch(entry, names, planes: dict, flags: tuple, decay, vsca: float,
            alt: Optional[int]) -> torch.Tensor:
    """One launch of B5 (``alt`` given) or B6 on the planes' device."""
    out, args = _launch_args(entry.__name__, names, planes, flags, decay,
                             vsca, alt)
    if args is None:
        return out               # an empty grid or meta: nothing to launch
    entry.launches += 1
    _build.call(entry.__name__, "mf_vessel_icing_modstall" if alt is None
                else "mf_vessel_icing_mincog", out.device, *args)
    return out
