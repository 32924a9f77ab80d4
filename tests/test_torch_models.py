"""The port's ``derived_fields_plevel`` and ``ensemble_derived_summary``
against the JAX package's, whole, on the CPU.

Seeded numpy inputs with scattered undefined points go through both
packages' functions (op by op, no ``jax.jit``).  Masks must be bitwise
equal; values agree within rtol 2e-5 on the points both define.  The
ensemble runs 3 members x 2 levels x 9x13: the port's ``fused=False`` and
``fused=True`` (on CPU tensors, the pipeline kernel's plain version per
member) against JAX's ``fused=False``, and with ``all_defined`` against
JAX's ``fused=True`` in the TPU interpreter.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mi_fieldcalc_tpu.field import UNDEF, Field as JField
import mi_fieldcalc_tpu.models as jmodels
from mi_fieldcalc_tpu_torch.field import Field as TField
import mi_fieldcalc_tpu_torch.models as tmodels
from mi_fieldcalc_tpu_torch.ops import fused

torch.set_num_threads(1)

NMEM, NLEV, NY, NX = 3, 2, 9, 13
REPO = Path(__file__).resolve().parent.parent


def _sentinel(rng, lo, hi, shape, frac):
    a = rng.uniform(lo, hi, shape).astype(np.float32)
    if frac:
        a[rng.random(shape) < frac] = np.float32(UNDEF)
    return a


def _j(a):
    v = jnp.asarray(a)
    return JField(v, (v != np.float32(UNDEF)) & ~jnp.isnan(v))


def _t(a):
    v = torch.from_numpy(a.copy())
    return TField(v, (v != np.float32(UNDEF)) & ~torch.isnan(v))


def _assert_fields(got, ref, label, scale=None):
    """Masks bitwise; values within rtol 2e-5, plus 4 float32 ulps of
    ``scale`` where given."""
    rm = np.asarray(ref.mask)
    np.testing.assert_array_equal(got.mask.numpy(), rm, err_msg=label)
    assert rm.any(), label
    g, r = got.values.numpy()[rm], np.asarray(ref.values)[rm]
    tol = 2e-5 * np.abs(r)
    if scale is not None:
        tol = tol + 4 * np.spacing(np.abs(np.asarray(scale)[rm]))
    with np.errstate(invalid="ignore"):   # inf - inf where both are inf
        bad = ~((g == r) | (np.abs(g - r) <= tol))
    assert not bad.any(), (f"{label}: {bad.sum()} of {bad.size} points "
                           f"differ, e.g. {g[bad][:3]} against {r[bad][:3]}")


def test_derived_fields_plevel_matches_jax():
    """BASELINE config 1's inputs (T 250-300 K, q, 2% undefined) with
    winds, on one 850 hPa surface."""
    rng = np.random.default_rng(11)
    tk = _sentinel(rng, 250.0, 300.0, (NY, NX), 0.05)
    q = _sentinel(rng, 1e-4, 1e-2, (NY, NX), 0.05)
    u = _sentinel(rng, -30.0, 30.0, (NY, NX), 0.05)
    v = _sentinel(rng, -30.0, 30.0, (NY, NX), 0.05)
    xm = rng.uniform(3e-7, 5e-7, (NY, NX)).astype(np.float32)
    ym = rng.uniform(3e-7, 5e-7, (NY, NX)).astype(np.float32)
    fc = np.full((NY, NX), 1.2e-4, np.float32)
    ref = jmodels.derived_fields_plevel(
        _j(tk), _j(q), _j(u), _j(v), 850.0, jnp.asarray(xm),
        jnp.asarray(ym), jnp.asarray(fc))
    got = tmodels.derived_fields_plevel(
        _t(tk), _t(q), _t(u), _t(v), 850.0, torch.from_numpy(xm),
        torch.from_numpy(ym), torch.from_numpy(fc))
    assert sorted(got) == sorted(ref)
    for name in ref:
        _assert_fields(got[name], ref[name], name)


def _members(undefs: bool):
    rng = np.random.default_rng(13)
    shape = (NMEM, NLEV, NY, NX)
    frac = 0.05 if undefs else 0.0
    arrays = (_sentinel(rng, 255.0, 295.0, shape, frac),
              _sentinel(rng, 1e-4, 1e-2, shape, frac),
              _sentinel(rng, -25.0, 25.0, shape, frac),
              _sentinel(rng, -25.0, 25.0, shape, frac),
              _sentinel(rng, 980.0, 1030.0, (NMEM, NY, NX), frac))
    coeffs = (np.linspace(30.0, 0.0, NLEV).astype(np.float32),
              np.linspace(0.02, 1.0, NLEV).astype(np.float32),
              rng.uniform(3e-7, 5e-7, (NY, NX)).astype(np.float32),
              rng.uniform(3e-7, 5e-7, (NY, NX)).astype(np.float32),
              np.full((NY, NX), 1.2e-4, np.float32))
    return arrays, coeffs


def _assert_summary(got, ref):
    """The spread of members that nearly agree cancels in ``x - mean``, so
    its values are also allowed 4 ulps of the mean (summed in another
    order by the JAX package)."""
    for name, g, r in zip(ref.mean._fields, got.mean, ref.mean):
        _assert_fields(g, r, f"mean.{name}")
    for name, g, r, m in zip(ref.mean._fields, got.spread, ref.spread,
                             ref.mean):
        _assert_fields(g, r, f"spread.{name}", scale=m.values)
    _assert_fields(got.prob_wind, ref.prob_wind, "prob_wind")
    _assert_fields(got.prob_t_freeze, ref.prob_t_freeze, "prob_t_freeze")


@pytest.mark.parametrize("fused_port", [False, True])
def test_ensemble_summary_matches_jax(fused_port):
    arrays, coeffs = _members(undefs=True)
    ref = jmodels.ensemble_derived_summary(
        *[_j(a) for a in arrays], *[jnp.asarray(c) for c in coeffs],
        wind_limit=15.0)
    before = fused.derived_fields_fused.launches
    got = tmodels.ensemble_derived_summary(
        *[_t(a) for a in arrays], *[torch.from_numpy(c) for c in coeffs],
        wind_limit=15.0, fused=fused_port)
    # CPU tensors take the kernel's plain version: no launch
    assert fused.derived_fields_fused.launches == before
    _assert_summary(got, ref)


def test_ensemble_summary_all_defined_matches_jax_kernel():
    """``all_defined`` through both packages' pipeline kernels: the JAX
    one in the TPU interpreter, the port's plain version."""
    arrays, coeffs = _members(undefs=False)
    ref = jmodels.ensemble_derived_summary(
        *[_j(a) for a in arrays], *[jnp.asarray(c) for c in coeffs],
        fused=True, all_defined=True)
    got = tmodels.ensemble_derived_summary(
        *[_t(a) for a in arrays], *[torch.from_numpy(c) for c in coeffs],
        fused=True, all_defined=True)
    _assert_summary(got, ref)


def test_ensemble_summary_rejects_unported_options():
    arrays, coeffs = _members(undefs=False)
    args = [_t(a) for a in arrays] + [torch.from_numpy(c) for c in coeffs]
    with pytest.raises(ValueError, match="require fused=True"):
        tmodels.ensemble_derived_summary(*args, all_defined=True)
    with pytest.raises(NotImplementedError, match="ensemble_derived_summary"):
        tmodels.ensemble_derived_summary(*args, fused=True,
                                         global_shape=(NY, NX))


def test_port_modules_import_without_jax():
    """Every module of the port, its shim ``mi_fieldcalc_torch``, the
    golden and api adapters and ``chip_smoke`` import, and the new entry
    points and every api function run, with ``jax`` and the JAX package
    unimportable."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "sys.modules['mi_fieldcalc_tpu'] = None\n"
        "sys.path[:0] = ['tests']\n"
        "import importlib, pkgutil\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "import mi_fieldcalc_tpu_torch as m\n"
        "names = [i.name for i in pkgutil.walk_packages(m.__path__,"
        " 'mi_fieldcalc_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke, torch_conformance, torch_api_cases\n"
        "import mi_fieldcalc_torch as fc\n"
        "for n in torch_api_cases.api_names(fc.__all__):\n"
        "    out = torch_api_cases.api_call(fc, n, torch_api_cases"
        ".api_inputs(n, (5, 6)), device='cpu')\n"
        "    assert out is not None, n\n"
        "from conformance_cases import CASE_BY_NAME, case_inputs\n"
        "for name in ('plevelthe_c1', 'kIndex_c2', 'shapiro2_undef',"
        " 'neighbour_c4', 'extremeValue_c3', 'pow10Field'):\n"
        "    c = CASE_BY_NAME[name]\n"
        "    out = torch_conformance.port_case(c, case_inputs(c))\n"
        "    assert out.mask.any()\n"
        "rng = np.random.default_rng(0)\n"
        "F = [m.from_sentinel(rng.uniform(lo, hi, (2, 2, 5, 6)).astype("
        "np.float32)) for lo, hi in ((260, 290), (1e-4, 1e-2), (-9, 9),"
        " (-9, 9))]\n"
        "ps = m.from_sentinel(np.full((2, 5, 6), 1000, np.float32))\n"
        "c = [torch.tensor([10.0, 0.0]), torch.tensor([0.5, 1.0])]\n"
        "c += [torch.full((5, 6), 4e-7)] * 2 + [torch.full((5, 6), 1e-4)]\n"
        "s = m.models.ensemble_derived_summary(*F, ps, *c, fused=True)\n"
        "assert s.mean.th.mask.all() and s.prob_wind.values.shape == "
        "(2, 5, 6)\n"
        "assert len(names) > 20\n"
        "bad = [k for k, v in sys.modules.items() if v and k.split('.')[0]"
        " in ('jax', 'mi_fieldcalc_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
