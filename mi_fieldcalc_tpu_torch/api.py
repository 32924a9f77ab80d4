"""Drop-in replacement for the reference's ``mi_fieldcalc`` python module,
on PyTorch.

Port of :mod:`mi_fieldcalc_tpu.api` (``api.py:20-587``): the same
``__all__``, names and argument order, numpy in and numpy out, a trailing
``undef`` sentinel, and ``None`` for a non-2-D or mismatched input and for
a bad parameter (an operator's ``ValueError``), as the reference's binding
returns them (py_mi_fieldcalc.cc:72-96).  Like the JAX module it keeps the
binding's ``shape(0) -> nx`` convention by transposing nothing.

Each call decodes the sentinels on the device, runs the port's operator
there and encodes the result back; :func:`vesselIcingModStall` and
:func:`vesselIcingMincog` run kernels B6 and B5
(``vessel_icing_modstall_fused`` / ``vessel_icing_mincog_fused``) on CUDA
and the plain operators on the CPU.  Every function takes a keyword-only
``device="cuda"``, which raises where CUDA is not available;
``device="cpu"`` runs everything on the host.

Inside a :func:`batch` context (:mod:`.batch`) every call records itself
and returns a :class:`Deferred`; the storm runs as one program at the
context's exit or at the first read of a result, on CUDA one CUDA graph
per storm signature, replayed by later storms of the same signature.  A
call must name the batch's device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import ops
from .batch import (  # noqa: F401
    BatchError, Deferred, active_batch, batch, cache_stats,
    clear_input_cache, fetch, _resolve_device as _device,
)
from .field import Field, UNDEF, ValuesDefined, from_sentinel  # noqa: F401

__all__ = [
    # call-storm batching (batch.py): one device program per storm
    "batch", "clear_input_cache", "cache_stats", "fetch", "Deferred",
    "BatchError",
    # the 15 functions the reference's pybind11 module exposes
    "ValuesDefined", "kIndex", "ductingIndex", "showalterIndex",
    "boydenIndex", "sweatIndex", "seaSoundSpeed", "cvtemp", "cvhum",
    "abshum", "windCooling", "underCooledRain", "vesselIcingOverland",
    "vesselIcingMertins", "vesselIcingModStall", "vesselIcingMincog",
    # the rest of the C++ API (FieldCalculations.h:113-304), same
    # signature order minus (nx, ny, out, fDefined)
    "pleveltemp", "plevelthe", "plevelhum", "pleveldz2tmean",
    "plevelqvector", "plevelducting", "plevelgwind_xcomp",
    "plevelgwind_ycomp", "plevelgvort", "hleveltemp", "hlevelthe",
    "hlevelhum", "hlevelducting", "hlevelpressure", "aleveltemp",
    "alevelthe", "alevelhum", "alevelducting", "ilevelgwind", "vectorabs",
    "relvort", "absvort", "divergence", "advection", "gradient",
    "shapiro2_filter", "thermalFrontParameter", "pressure2FlightLevel",
    "momentumXcoordinate", "momentumYcoordinate", "jacobian",
    "values2classes", "minvalueFields", "minvalueFieldConst",
    "maxvalueFields", "maxvalueFieldConst", "absvalueField", "log10Field",
    "pow10Field", "logField", "expField", "powerField", "replaceUndefined",
    "replaceDefined", "fieldOPERfield", "fieldOPERconstant",
    "constantOPERfield", "sumFields", "meanValue", "stddevValue",
    "extremeValue", "probability", "neighbourProbFunctions",
    "neighbourFunctions", "snow_in_cm", "copy_field",
]


def _decode(a: np.ndarray, undef: float, dev: torch.device) -> Field:
    return from_sentinel(torch.from_numpy(a).to(dev), undef)


def _encode(out, undef: float):
    if isinstance(out, Field):
        return out.to_sentinel(undef).cpu().numpy()
    return tuple(o.to_sentinel(undef).cpu().numpy() for o in out)


def _canon(x):
    """Hashable (program-key) form of a scalar parameter."""
    return tuple(x) if isinstance(x, (list, tuple)) else x


def _recording(dev: torch.device):
    """The active batch, after checking that ``dev`` is its device; None
    outside a batch."""
    b = active_batch()
    if b is not None:
        b.check_device(dev)
    return b


def _wrap(op, undef, *arrays, scalars=(), kwscalars=None, lead_scalars=(),
          device="cuda"):
    """The py_wrap_2d equivalent: validate 2-D equal shapes, decode the
    sentinels on ``device``, run the operator there and encode.  Returns
    None on invalid input, like the reference binding.  ``lead_scalars``
    go BEFORE the fields (the reference's ``(compute, ...)``-first
    signatures): ``op(*lead_scalars, *fields, *scalars, **kwscalars)``.

    Inside a :func:`batch` context the call is RECORDED instead of run
    (one device program for the whole storm, :mod:`.batch`)."""
    dev = _device(device)
    b = _recording(dev)
    if b is not None:
        return b.record(op, float(undef), arrays,
                        tuple(_canon(s) for s in scalars),
                        tuple(sorted((kwscalars or {}).items())),
                        tuple(_canon(s) for s in lead_scalars))
    npa = [np.ascontiguousarray(a, dtype=np.float32) for a in arrays]
    if npa[0].ndim != 2 or any(a.shape != npa[0].shape for a in npa[1:]):
        return None
    fields = [_decode(a, float(undef), dev) for a in npa]
    try:
        out = op(*lead_scalars, *fields, *scalars, **(kwscalars or {}))
    except ValueError:
        return None  # reference operators signal bad parameters with false
    return _encode(out, float(undef))


def kIndex(t500, t700, rh700, t850, rh850, p500: float, p700: float,
           p850: float, compute: int, undef: float = UNDEF, *,
           device="cuda"):
    return _wrap(ops.k_index, undef, t500, t700, rh700, t850, rh850,
                 scalars=(p500, p700, p850, compute), device=device)


def ductingIndex(t850, rh850, p850: float, compute: int,
                 undef: float = UNDEF, *, device="cuda"):
    return _wrap(ops.ducting_index, undef, t850, rh850,
                 scalars=(p850, compute), device=device)


def showalterIndex(t500, t850, rh850, p500: float, p850: float,
                   compute: int, undef: float = UNDEF, *, device="cuda"):
    return _wrap(ops.showalter_index, undef, t500, t850, rh850,
                 scalars=(p500, p850, compute), device=device)


def boydenIndex(t700, z700, z1000, p700: float, p1000: float, compute: int,
                undef: float = UNDEF, *, device="cuda"):
    return _wrap(ops.boyden_index, undef, t700, z700, z1000,
                 scalars=(p700, p1000, compute), device=device)


def sweatIndex(t850, t500, td850, td500, u850, v850, u500, v500,
               undef: float = UNDEF, *, device="cuda"):
    return _wrap(ops.sweat_index, undef, t850, t500, td850, td500,
                 u850, v850, u500, v500, device=device)


def seaSoundSpeed(t, s, z: float, compute: int, undef: float = UNDEF, *,
                  device="cuda"):
    return _wrap(ops.sea_sound_speed, undef, t, s, scalars=(z, compute),
                 device=device)


def cvtemp(tinp, compute: int, undef: float = UNDEF, *, device="cuda"):
    return _wrap(ops.cvtemp, undef, tinp, scalars=(compute,), device=device)


def cvhum(t, huminp, unit: str, compute: int, undef: float = UNDEF, *,
          device="cuda"):
    return _wrap(ops.cvhum, undef, t, huminp, scalars=(compute, unit),
                 device=device)


def abshum(t, rhum, undef: float = UNDEF, *, device="cuda"):
    return _wrap(ops.abshum, undef, t, rhum, device=device)


def windCooling(t, u, v, compute: int, undef: float = UNDEF, *,
                device="cuda"):
    return _wrap(ops.wind_cooling, undef, t, u, v, scalars=(compute,),
                 device=device)


def underCooledRain(precip, snow, tk, precipMin: float, snowRateMax: float,
                    tcMax: float, undef: float = UNDEF, *, device="cuda"):
    return _wrap(ops.under_cooled_rain, undef, precip, snow, tk,
                 scalars=(precipMin, snowRateMax, tcMax), device=device)


def vesselIcingOverland(airtemp, seatemp, u, v, sal, aice,
                        undef: float = UNDEF, *, device="cuda"):
    return _wrap(ops.vessel_icing_overland, undef, airtemp, seatemp, u, v,
                 sal, aice, device=device)


def vesselIcingMertins(airtemp, seatemp, u, v, sal, aice,
                       undef: float = UNDEF, *, device="cuda"):
    return _wrap(ops.vessel_icing_mertins, undef, airtemp, seatemp, u, v,
                 sal, aice, device=device)


def _icing_modstall_auto(*args):
    # kernel B6 on CUDA tensors, the plain operator on the CPU (the JAX
    # module picks its kernel on the TPU only); both cold-started, so
    # the encoded outputs agree where the gate is on.  A batch validates
    # on meta tensors: the kernel's wrapper checks them without a launch
    if args[0].values.device.type in ("cuda", "meta"):
        return ops.vessel_icing_modstall_fused(*args)
    return ops.vessel_icing_modstall(*args)


def _icing_mincog_auto(*args):
    # kernel B5 on CUDA tensors, the plain operator on the CPU
    if args[0].values.device.type in ("cuda", "meta"):
        return ops.vessel_icing_mincog_fused(*args)
    return ops.vessel_icing_mincog(*args)


def vesselIcingModStall(sal, wave, x_wind, y_wind, airtemp, rh, sst, p, Pw,
                        aice, depth, vs: float, alpha: float, zmin: float,
                        zmax: float, undef: float = UNDEF, *,
                        device="cuda"):
    return _wrap(_icing_modstall_auto, undef, sal, wave, x_wind,
                 y_wind, airtemp, rh, sst, p, Pw, aice, depth,
                 scalars=(vs, alpha, zmin, zmax), device=device)


def vesselIcingMincog(sal, wave, x_wind, y_wind, airtemp, rh, sst, p, Pw,
                      aice, depth, vs: float, alpha: float, zmin: float,
                      zmax: float, alt: int, undef: float = UNDEF, *,
                      device="cuda"):
    return _wrap(_icing_mincog_auto, undef, sal, wave, x_wind, y_wind,
                 airtemp, rh, sst, p, Pw, aice, depth,
                 scalars=(vs, alpha, zmin, zmax, alt), device=device)


# ---------------------------------------------------------------------------
# Full C++ API surface (FieldCalculations.h:113-304) beyond the reference's
# python-bound subset: same argument order as the C++ declarations, minus
# (nx, ny) / output pointer / fDefined, with a trailing undef.
# ---------------------------------------------------------------------------

def pleveltemp(tinp, p: float, unit: str, compute: int,
               undef: float = UNDEF, *, device="cuda"):
    return _wrap(ops.pleveltemp, undef, tinp, scalars=(p, compute, unit),
                 device=device)


def plevelthe(t, rh, p: float, compute: int, undef: float = UNDEF, *,
              device="cuda"):
    return _wrap(ops.plevelthe, undef, t, rh, scalars=(p, compute),
                 device=device)


def plevelhum(t, huminp, p: float, unit: str, compute: int,
              undef: float = UNDEF, *, device="cuda"):
    # undef threads through: p == undef fills the output undef for the
    # pressure-dependent modes (FieldCalculations.cc:437)
    return _wrap(ops.plevelhum, undef, t, huminp,
                 scalars=(p, compute, unit), kwscalars={"undef": undef},
                 device=device)


def pleveldz2tmean(z1, z2, p1: float, p2: float, compute: int,
                   undef: float = UNDEF, *, device="cuda"):
    return _wrap(ops.pleveldz2tmean, undef, z1, z2,
                 scalars=(p1, p2, compute), device=device)


def plevelqvector(z, t, xmapr, ymapr, fcoriolis, p: float, compute: int,
                  undef: float = UNDEF, *, device="cuda"):
    return _wrap(ops.plevelqvector, undef, z, t, xmapr, ymapr, fcoriolis,
                 scalars=(p, compute), device=device)


def plevelducting(t, h, p: float, compute: int, undef: float = UNDEF, *,
                  device="cuda"):
    return _wrap(ops.plevelducting, undef, t, h, scalars=(p, compute),
                 device=device)


def plevelgwind_xcomp(z, xmapr, ymapr, fcoriolis, undef: float = UNDEF, *,
                      device="cuda"):
    return _wrap(ops.plevelgwind_xcomp, undef, z, xmapr, ymapr, fcoriolis,
                 device=device)


def plevelgwind_ycomp(z, xmapr, ymapr, fcoriolis, undef: float = UNDEF, *,
                      device="cuda"):
    return _wrap(ops.plevelgwind_ycomp, undef, z, xmapr, ymapr, fcoriolis,
                 device=device)


def plevelgvort(z, xmapr, ymapr, fcoriolis, undef: float = UNDEF, *,
                device="cuda"):
    return _wrap(ops.plevelgvort, undef, z, xmapr, ymapr, fcoriolis,
                 device=device)


def hleveltemp(tinp, ps, alevel: float, blevel: float, unit: str,
               compute: int, undef: float = UNDEF, *, device="cuda"):
    return _wrap(ops.hleveltemp, undef, tinp, ps,
                 scalars=(alevel, blevel, compute, unit), device=device)


def hlevelthe(t, q, ps, alevel: float, blevel: float, compute: int,
              undef: float = UNDEF, *, device="cuda"):
    return _wrap(ops.hlevelthe, undef, t, q, ps,
                 scalars=(alevel, blevel, compute), device=device)


def hlevelhum(t, huminp, ps, alevel: float, blevel: float, unit: str,
              compute: int, undef: float = UNDEF, *, device="cuda"):
    return _wrap(ops.hlevelhum, undef, t, huminp, ps,
                 scalars=(alevel, blevel, compute, unit), device=device)


def hlevelducting(t, h, ps, alevel: float, blevel: float, compute: int,
                  undef: float = UNDEF, *, device="cuda"):
    return _wrap(ops.hlevelducting, undef, t, h, ps,
                 scalars=(alevel, blevel, compute), device=device)


def hlevelpressure(ps, alevel: float, blevel: float, undef: float = UNDEF,
                   *, device="cuda"):
    return _wrap(ops.hlevelpressure, undef, ps, scalars=(alevel, blevel),
                 device=device)


def aleveltemp(tinp, p, unit: str, compute: int, undef: float = UNDEF, *,
               device="cuda"):
    return _wrap(ops.aleveltemp, undef, tinp, p, scalars=(compute, unit),
                 device=device)


def alevelthe(t, q, p, compute: int, undef: float = UNDEF, *,
              device="cuda"):
    return _wrap(ops.alevelthe, undef, t, q, p, scalars=(compute,),
                 device=device)


def alevelhum(t, huminp, p, unit: str, compute: int, undef: float = UNDEF,
              *, device="cuda"):
    return _wrap(ops.alevelhum, undef, t, huminp, p,
                 scalars=(compute, unit), device=device)


def alevelducting(t, h, p, compute: int, undef: float = UNDEF, *,
                  device="cuda"):
    return _wrap(ops.alevelducting, undef, t, h, p, scalars=(compute,),
                 device=device)


def ilevelgwind(mpot, xmapr, ymapr, fcoriolis, undef: float = UNDEF, *,
                device="cuda"):
    """Returns (ug, vg) — the reference fills two output arrays."""
    return _wrap(ops.ilevelgwind, undef, mpot, xmapr, ymapr, fcoriolis,
                 device=device)


def vectorabs(u, v, undef: float = UNDEF, *, device="cuda"):
    return _wrap(ops.vectorabs, undef, u, v, device=device)


def relvort(u, v, xmapr, ymapr, undef: float = UNDEF, *, device="cuda"):
    return _wrap(ops.relvort, undef, u, v, xmapr, ymapr, device=device)


def absvort(u, v, xmapr, ymapr, fcoriolis, undef: float = UNDEF, *,
            device="cuda"):
    return _wrap(ops.absvort, undef, u, v, xmapr, ymapr, fcoriolis,
                 device=device)


def divergence(u, v, xmapr, ymapr, undef: float = UNDEF, *, device="cuda"):
    return _wrap(ops.divergence, undef, u, v, xmapr, ymapr, device=device)


def advection(f, u, v, xmapr, ymapr, hours: float, undef: float = UNDEF,
              *, device="cuda"):
    return _wrap(ops.advection, undef, f, u, v, xmapr, ymapr,
                 scalars=(hours,), device=device)


def gradient(field, xmapr, ymapr, compute: int, undef: float = UNDEF, *,
             device="cuda"):
    return _wrap(ops.gradient, undef, field, xmapr, ymapr,
                 scalars=(compute,), device=device)


def shapiro2_filter(field, undef: float = UNDEF, *, device="cuda"):
    npa = np.asarray(field, np.float32)
    if npa.ndim != 2:
        _device(device)
        return None
    # the all-defined fast path is resolved on the host, as the reference
    # branches once per call (cc:2101)
    all_defined = bool(not np.isnan(npa).any()
                       and not (npa == np.float32(undef)).any())
    return _wrap(ops.shapiro2_filter, undef, npa,
                 kwscalars={"undef": undef, "all_defined": all_defined},
                 device=device)


def thermalFrontParameter(t, xmapr, ymapr, undef: float = UNDEF, *,
                          device="cuda"):
    return _wrap(ops.thermal_front_parameter, undef, t, xmapr, ymapr,
                 device=device)


def pressure2FlightLevel(pressure, undef: float = UNDEF, *, device="cuda"):
    return _wrap(ops.pressure2flightlevel, undef, pressure, device=device)


def momentumXcoordinate(v, xmapr, fcoriolis, fcoriolisMin: float,
                        undef: float = UNDEF, *, device="cuda"):
    return _wrap(ops.momentum_x_coordinate, undef, v, xmapr, fcoriolis,
                 scalars=(fcoriolisMin,), device=device)


def momentumYcoordinate(u, ymapr, fcoriolis, fcoriolisMin: float,
                        undef: float = UNDEF, *, device="cuda"):
    return _wrap(ops.momentum_y_coordinate, undef, u, ymapr, fcoriolis,
                 scalars=(fcoriolisMin,), device=device)


def jacobian(field1, field2, xmapr, ymapr, undef: float = UNDEF, *,
             device="cuda"):
    return _wrap(ops.jacobian, undef, field1, field2, xmapr, ymapr,
                 device=device)


def values2classes(fvalue, values, undef: float = UNDEF, *, device="cuda"):
    return _wrap(ops.values2classes, undef, fvalue,
                 scalars=(list(values),), device=device)


def minvalueFields(field1, field2, undef: float = UNDEF, *, device="cuda"):
    return _wrap(ops.minvalue_fields, undef, field1, field2, device=device)


def maxvalueFields(field1, field2, undef: float = UNDEF, *, device="cuda"):
    return _wrap(ops.maxvalue_fields, undef, field1, field2, device=device)


def minvalueFieldConst(field1, value: float, undef: float = UNDEF, *,
                       device="cuda"):
    return _wrap(ops.minvalue_field_const, undef, field1,
                 scalars=(value,), kwscalars={"undef": undef},
                 device=device)


def maxvalueFieldConst(field1, value: float, undef: float = UNDEF, *,
                       device="cuda"):
    return _wrap(ops.maxvalue_field_const, undef, field1,
                 scalars=(value,), kwscalars={"undef": undef},
                 device=device)


def absvalueField(field, undef: float = UNDEF, *, device="cuda"):
    return _wrap(ops.absvalue_field, undef, field, device=device)


def log10Field(field, undef: float = UNDEF, *, device="cuda"):
    return _wrap(ops.log10_field, undef, field, device=device)


def pow10Field(field, undef: float = UNDEF, *, device="cuda"):
    return _wrap(ops.pow10_field, undef, field, device=device)


def logField(field, undef: float = UNDEF, *, device="cuda"):
    return _wrap(ops.log_field, undef, field, device=device)


def expField(field, undef: float = UNDEF, *, device="cuda"):
    return _wrap(ops.exp_field, undef, field, device=device)


def powerField(field, value: float, undef: float = UNDEF, *, device="cuda"):
    return _wrap(ops.power_field, undef, field, scalars=(value,),
                 kwscalars={"undef": undef}, device=device)


def replaceUndefined(field, value: float, undef: float = UNDEF, *,
                     device="cuda"):
    return _wrap(ops.replace_undefined, undef, field, scalars=(value,),
                 kwscalars={"undef": undef}, device=device)


def replaceDefined(field, value: float, undef: float = UNDEF, *,
                   device="cuda"):
    return _wrap(ops.replace_defined, undef, field, scalars=(value,),
                 kwscalars={"undef": undef}, device=device)


def fieldOPERfield(compute: int, field1, field2, undef: float = UNDEF, *,
                   device="cuda"):
    return _wrap(ops.field_oper_field, undef, field1, field2,
                 lead_scalars=(compute,), device=device)


def fieldOPERconstant(compute: int, field, value: float,
                      undef: float = UNDEF, *, device="cuda"):
    # undef threads through: value == undef yields an all-undef field
    # (FieldCalculations.cc:2631-2634)
    return _wrap(ops.field_oper_constant, undef, field,
                 lead_scalars=(compute,), scalars=(value,),
                 kwscalars={"undef": undef}, device=device)


def constantOPERfield(compute: int, value: float, field,
                      undef: float = UNDEF, *, device="cuda"):
    return _wrap(ops.constant_oper_field, undef, field,
                 lead_scalars=(compute, value),
                 kwscalars={"undef": undef}, device=device)


@functools.lru_cache(maxsize=256)
def _member_stack_op(op, nlead, nfields):
    """A member reduction in the regular per-field call convention: the
    members enter as ``nfields`` separate 2-D Fields and are stacked in
    the program.  Inside :func:`batch` each member stays an individual
    input: it dedups and caches like any other array and ships in the
    shared same-shape stack."""
    def run(*args, **kw):
        lead = args[:nlead]
        fs = args[nlead:nlead + nfields]
        scal = args[nlead + nfields:]
        stacked = Field(torch.stack([f.values for f in fs]),
                        torch.stack([f.mask for f in fs]))
        return op(*lead, stacked, *scal, **kw)
    return run


def _wrap_members(op, undef, fields, lead_scalars=(), scalars=(),
                  device="cuda"):
    """Ensemble wrapper: the member fields stacked on a leading axis,
    decoded on ``device`` and reduced there
    (``op(*lead_scalars, stack, *scalars)``).  Inside a :func:`batch`
    context each member records as its own 2-D input
    (:func:`_member_stack_op`), so Deferred members chain on the device
    and concrete members ride the input cache."""
    dev = _device(device)
    b = _recording(dev)
    if b is not None:
        fields = list(fields)
        if not fields:
            return None
        return b.record(
            _member_stack_op(op, len(lead_scalars), len(fields)),
            float(undef), tuple(fields),
            tuple(_canon(s) for s in scalars), (),
            tuple(_canon(s) for s in lead_scalars))
    npa = [np.asarray(a, np.float32) for a in fields]
    if not npa or npa[0].ndim != 2 \
            or any(a.shape != npa[0].shape for a in npa[1:]):
        return None
    stack = _decode(np.stack(npa), float(undef), dev)
    try:
        return _encode(op(*lead_scalars, stack, *scalars), float(undef))
    except ValueError:
        return None


def sumFields(fields, undef: float = UNDEF, *, device="cuda"):
    return _wrap_members(ops.sum_fields, undef, fields, device=device)


def _member_flags(fDefinedIn):
    if fDefinedIn is None:
        return None
    return tuple(ValuesDefined(int(d)) for d in fDefinedIn)


def meanValue(fields, fDefinedIn=None, undef: float = UNDEF, *,
              device="cuda"):
    # a member flagged ALL_DEFINED skips the per-point sentinel check
    # (reference cc:2710) — see ops.ensemble._apply_member_flags
    return _wrap_members(ops.mean_value, undef, fields,
                         scalars=(_member_flags(fDefinedIn),),
                         device=device)


def stddevValue(fields, fDefinedIn=None, undef: float = UNDEF, *,
                device="cuda"):
    return _wrap_members(ops.stddev_value, undef, fields,
                         scalars=(_member_flags(fDefinedIn),),
                         device=device)


def extremeValue(compute: int, fields, undef: float = UNDEF, *,
                 device="cuda"):
    return _wrap_members(ops.extreme_value, undef, fields,
                         lead_scalars=(compute,), device=device)


def probability(compute: int, fields, fDefinedIn, limits,
                undef: float = UNDEF, *, device="cuda"):
    return _wrap_members(
        ops.probability, undef, fields, lead_scalars=(compute,),
        scalars=(tuple(limits),
                 tuple(ValuesDefined(int(d)) for d in fDefinedIn)),
        device=device)


def _all_defined_2d(field, undef):
    """Host-side ALL_DEFINED precondition (the pattern shapiro2_filter
    uses): returns the validated array or None."""
    npa = np.asarray(field, np.float32)
    if npa.ndim != 2 or np.isnan(npa).any() \
            or (npa == np.float32(undef)).any():
        return None
    return npa


def neighbourProbFunctions(field, constants, compute: int,
                           undef: float = UNDEF, *, device="cuda"):
    # reference cc:2869 returns false unless the input is ALL_DEFINED —
    # a sentinel flowing into the window sums would otherwise poison
    # whole windows while staying marked defined
    _device(device)
    npa = _all_defined_2d(field, undef)
    if npa is None:
        return None
    return _wrap(ops.neighbour_prob_functions, undef, npa,
                 scalars=(list(constants), compute), device=device)


def neighbourFunctions(field, constants, compute: int,
                       undef: float = UNDEF, *, device="cuda"):
    # ALL_DEFINED precondition, as above (reference cc:2965)
    _device(device)
    npa = _all_defined_2d(field, undef)
    if npa is None:
        return None
    return _wrap(ops.neighbour_functions, undef, npa,
                 scalars=(list(constants), compute), device=device)


def snow_in_cm(snow_water, tk2m, td2m, undef: float = UNDEF, *,
               device="cuda"):
    return _wrap(ops.snow_in_cm, undef, snow_water, tk2m, td2m,
                 device=device)


def copy_field(finp, undef: float = UNDEF, *, device="cuda"):
    """Verbatim copy (FieldCalculations.cc:318-322); numpy-in/numpy-out,
    with no device work."""
    _device(device)
    npa = np.asarray(finp, np.float32)
    if npa.ndim != 2:
        return None
    return npa.copy()
