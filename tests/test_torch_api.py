"""The port's drop-in module ``mi_fieldcalc_tpu_torch.api`` (and its shim
``mi_fieldcalc_torch``) against the JAX package's ``mi_fieldcalc_tpu.api``,
sentinel numpy in and out, on the CPU.

Every api function runs once through each module at 6x6 on its golden
case's kinds and scalars (``tests/torch_api_cases.py``) with ~3% undefined
points.  Undefined outputs (the sentinel) must be identical.  Defined
values agree within rtol 2e-5, the surface tolerance of
``tests/test_torch_surface.py``, plus ``2e-6*max|ref|``: the JAX module
runs each call as one ``jax.jit`` program, whose XLA:CPU compile contracts
multiply-adds, and an output that crosses zero (a temperature in Celsius,
an index) carries that rounding as an absolute error of its scale, as in
``tests/test_torch_staging.py``.  The icing solvers agree within the JAX
kernel contract of ``tests/test_torch_icing.py`` (rtol 2e-4, atol 1e-5).
"""

import numpy as np
import pytest
import torch

import mi_fieldcalc_tpu.api as japi
import mi_fieldcalc_torch
from mi_fieldcalc_tpu_torch import api, ops
from torch_api_cases import api_call, api_inputs, api_names

torch.set_num_threads(1)

UNDEF = np.float32(1e35)
NAMES = api_names(japi.__all__)
#: the solvers' contract against the JAX package (test_torch_icing.py)
_SOLVER_TOL = dict(rtol=2e-4, atol=1e-5)


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("name", NAMES)
def test_api_matches_jax(name):
    ins = api_inputs(name, (6, 6), undef_frac=0.03)
    ref = api_call(japi, name, ins)
    got = api_call(api, name, ins, device="cpu")
    assert ref is not None and got is not None, name
    refs, gots = _outputs(ref), _outputs(got)
    assert len(gots) == len(refs)
    for g, r in zip(gots, map(np.asarray, refs)):
        assert isinstance(g, np.ndarray) and g.dtype == np.float32
        assert g.shape == r.shape == (6, 6)
        undef = r == UNDEF
        np.testing.assert_array_equal(g == UNDEF, undef, err_msg=name)
        d = ~undef
        assert d.any(), name                    # something is compared
        tol = (_SOLVER_TOL if name in ("vesselIcingModStall",
                                       "vesselIcingMincog")
               else dict(rtol=2e-5, atol=2e-6 * float(np.abs(r[d]).max())))
        np.testing.assert_allclose(g[d], r[d], err_msg=name, **tol)


def test_api_returns_none_on_bad_input():
    a = np.zeros((2, 2), np.float32)
    b = np.zeros((2, 3), np.float32)
    assert api.abshum(a, b, device="cpu") is None              # mismatch
    assert api.cvtemp(np.zeros(4, np.float32), 1, device="cpu") is None
    assert api.cvtemp(np.zeros((2, 2, 2)), 1, device="cpu") is None
    assert api.cvtemp(a, 99, device="cpu") is None             # bad compute
    assert api.seaSoundSpeed(a, a, 10.0, 3, device="cpu") is None
    assert api.sumFields([], device="cpu") is None
    assert api.meanValue([a, b], device="cpu") is None
    assert api.copy_field(np.zeros(3), device="cpu") is None
    assert api.shapiro2_filter(np.zeros(3), device="cpu") is None
    v = np.ones((10, 10), np.float32)
    v[3, 3] = UNDEF                              # ALL_DEFINED precondition
    assert api.neighbourFunctions(v, [2.0], 1, device="cpu") is None


@pytest.mark.parametrize("undef", [1e35, -999.0])
def test_sentinel_round_trip(undef):
    """The caller's undef marks undefined inputs and outputs, NaN inputs
    are undefined too, and copy_field returns its input verbatim."""
    u = np.float32(undef)
    t = np.full((3, 4), 280.0, np.float32)
    t[1, 1] = u
    t[2, 3] = np.nan
    w = np.full((3, 4), 5.0, np.float32)
    out = api.windCooling(t, w, w, 1, undef, device="cpu")
    ref = japi.windCooling(t, w, w, 1, undef)
    assert out[1, 1] == u and out[2, 3] == u and out[0, 0] != u
    np.testing.assert_array_equal(out, ref)
    cp = api.copy_field(t, undef, device="cpu")
    assert cp is not t and cp.tobytes() == t.tobytes()
    assert (api.fieldOPERconstant(1, w, u, undef, device="cpu") == u).all()


def test_cuda_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = np.ones((2, 2), np.float32)
    for call in (lambda: api.abshum(a, a),
                 lambda: api.sumFields([a, a]),
                 lambda: api.copy_field(a),
                 lambda: api.abshum(a, np.ones((3, 3), np.float32)),
                 lambda: mi_fieldcalc_torch.cvtemp(a, 1)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_icing_routes_by_device(monkeypatch):
    """On the CPU the solvers run the plain operators (the JAX module
    picks its kernel only on its accelerator), never the kernel
    wrappers."""
    calls = []
    for name in ("vessel_icing_mincog_fused", "vessel_icing_modstall_fused"):
        monkeypatch.setattr(ops, name,
                            lambda *a, _n=name: calls.append(_n))
    for name in ("vesselIcingMincog", "vesselIcingModStall"):
        out = api_call(api, name, api_inputs(name, (4, 5)), device="cpu")
        assert out.shape == (4, 5) and (out != UNDEF).any()
    assert calls == []


@pytest.mark.parametrize("name", ["batch", "clear_input_cache",
                                  "cache_stats", "fetch", "Deferred",
                                  "BatchError"])
def test_batch_names_raise_not_ported(name):
    """The batching names are the batch module's objects (the name is
    kept from when they were stubs)."""
    from mi_fieldcalc_tpu_torch import batch as B
    assert getattr(api, name) is getattr(B, name)
    assert callable(getattr(api, name))
    assert issubclass(api.BatchError, RuntimeError)
    assert api.BatchError is not RuntimeError


def test_shim_exports_the_jax_surface():
    assert mi_fieldcalc_torch.__all__ == japi.__all__
    assert api.__all__ == japi.__all__
    for name in japi.__all__:
        assert getattr(mi_fieldcalc_torch, name) is getattr(api, name)
    assert mi_fieldcalc_torch.ValuesDefined.ALL_DEFINED == 0
