"""One call of every drop-in ``api`` function, on seeded inputs at any
grid size.

Each api function takes the operator, input kinds and scalars of its first
case in ``conformance_cases.CASES`` (the case's scalar names are the api
function's parameter names).  :func:`api_inputs` draws the case's kinds
from ``KIND_RANGES`` at a chosen ``(ny, nx)`` with a share of undefined
points, and :func:`api_call` calls a module's function on them, so the
JAX ``mi_fieldcalc_tpu.api`` and the port's ``mi_fieldcalc_tpu_torch.api``
take the same call.  Imports numpy and the case list only, so
``chip_smoke.py`` runs the calls on the card through it.
"""

from __future__ import annotations

import inspect
import zlib

import numpy as np

from conformance_cases import CASES, KIND_RANGES, UNDEF

#: the api names that run no operator: the batching names and the enum
NOT_CALLS = ("batch", "clear_input_cache", "cache_stats", "fetch",
             "Deferred", "BatchError", "ValuesDefined")
#: api function -> its first golden case
API_CASES = {}
for _c in CASES:
    API_CASES.setdefault(_c.op, _c)
#: kinds the reference reads without a defined-check
_NO_UNDEF = ("mapr", "fcor")


def api_names(all_names) -> list:
    """The api functions among ``__all__`` that run an operator."""
    return [n for n in all_names if n not in NOT_CALLS]


def api_inputs(name: str, shape, undef_frac: float = 0.08) -> list:
    """Seeded sentinel inputs for ``name``'s case at ``shape``: one array
    per field argument, or the member list of an ensemble reduction.
    Fields the case keeps defined get no sentinel; ``signed`` fields get
    zeros (the divide-by-zero paths)."""
    case = API_CASES[name]
    rng = np.random.default_rng(zlib.crc32(f"{name}{shape}".encode()))
    arrays = []
    for k, kind in enumerate(case.kinds):
        lo, hi = KIND_RANGES[kind]
        full = ((case.n_members,) if case.n_members and k == 0 else ()) \
            + tuple(shape)
        a = rng.uniform(lo, hi, full).astype(np.float32)
        if kind == "signed":
            a.flat[::17] = 0.0
        if case.undef and kind not in _NO_UNDEF:
            a[rng.random(full) < undef_frac] = np.float32(UNDEF)
        arrays.append(list(a) if case.n_members and k == 0 else a)
    return arrays


def api_call(module, name: str, arrays, **kw):
    """``module.name`` on ``arrays`` with its case's scalars; ``kw`` goes
    through (``device=`` for the port)."""
    fn = getattr(module, name)
    case = API_CASES[name]
    params = inspect.signature(fn).parameters
    fields = [p for p, v in params.items()
              if p not in case.scalars and p not in ("undef", "device")
              and v.default is inspect.Parameter.empty
              and p != "fDefinedIn"]
    args = dict(zip(fields, arrays), **case.scalars)
    if "fDefinedIn" in params and params["fDefinedIn"].default \
            is inspect.Parameter.empty:
        args["fDefinedIn"] = [case.fdef_in] * case.n_members
    return fn(**args, **kw)
