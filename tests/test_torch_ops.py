"""The PyTorch port's pipeline operators against their JAX functions.

Each of the pipeline's 11 operators, and ``fill_edges``, runs on the same
seeded numpy inputs at ``(2, 9, 13)`` with scattered undefs (and an
undefined surface-pressure point, which exercises the ``alevelhum``
sentinel-pressure quirk) through the JAX function and its port.  Masks
must be bitwise equal; values agree within rtol 2e-5 on commonly defined
points.  The JAX functions run op by op (no ``jax.jit``, whose FMA
contraction would move centred differences near cancellation), as their
plain definition.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import mi_fieldcalc_tpu.ops as jops
from mi_fieldcalc_tpu.field import UNDEF, Field as JField
import mi_fieldcalc_tpu_torch.ops as tops
from mi_fieldcalc_tpu_torch.field import Field as TField

torch.set_num_threads(1)

NLEV, NY, NX = 2, 9, 13


def _arrays(seed=0):
    """(values, mask) numpy pairs for tk, q, u, v, p, and the map factors."""
    rng = np.random.default_rng(seed)
    shape = (NLEV, NY, NX)
    tk = rng.normal(275.0, 15.0, shape).astype(np.float32)
    q = rng.uniform(1e-4, 1e-2, shape).astype(np.float32)
    u = rng.normal(0.0, 12.0, shape).astype(np.float32)
    v = rng.normal(0.0, 12.0, shape).astype(np.float32)
    ps = rng.normal(1000.0, 15.0, (NY, NX)).astype(np.float32)
    tk[0, 1, 1] = 500.0                       # beyond the e_sat table
    out = {}
    for name, a in (("tk", tk), ("q", q), ("u", u), ("v", v)):
        m = rng.random(shape) > 0.08
        out[name] = (np.where(m, a, np.float32(UNDEF)), m)
    psm = np.ones((NY, NX), bool)
    psm[NY // 2, NX // 2] = False
    al = np.linspace(0.0, 50.0, NLEV).astype(np.float32)[:, None, None]
    bl = np.linspace(1.0, 0.5, NLEV).astype(np.float32)[:, None, None]
    out["p"] = ((al + bl * np.where(psm, ps, np.float32(UNDEF))).astype(
        np.float32), np.broadcast_to(psm, shape).copy())
    out["xm"] = rng.uniform(3e-7, 5e-7, (NY, NX)).astype(np.float32)
    out["ym"] = rng.uniform(3e-7, 5e-7, (NY, NX)).astype(np.float32)
    return out


def _j(pair):
    return JField(jnp.asarray(pair[0]), jnp.asarray(pair[1]))


def _t(pair):
    return TField(torch.from_numpy(pair[0].copy()),
                  torch.from_numpy(pair[1].copy()))


# name -> (JAX call, port call); each gets (fields, xm, ym) of its package
OPS = {
    "aleveltemp_3": lambda o, f, xm, ym: o.aleveltemp(f["tk"], f["p"], 3),
    "alevelhum_1": lambda o, f, xm, ym: o.alevelhum(f["tk"], f["q"], f["p"],
                                                    1),
    "alevelhum_9": lambda o, f, xm, ym: o.alevelhum(f["tk"], f["q"], f["p"],
                                                    9),
    "alevelthe_1": lambda o, f, xm, ym: o.alevelthe(f["tk"], f["q"], f["p"],
                                                    1),
    "alevelducting_1": lambda o, f, xm, ym: o.alevelducting(
        f["tk"], f["q"], f["p"], 1),
    "vectorabs": lambda o, f, xm, ym: o.vectorabs(f["u"], f["v"]),
    "relvort": lambda o, f, xm, ym: o.relvort(f["u"], f["v"], xm, ym),
    "divergence": lambda o, f, xm, ym: o.divergence(f["u"], f["v"], xm, ym),
    "advection": lambda o, f, xm, ym: o.advection(f["tk"], f["u"], f["v"],
                                                  xm, ym, hours=1.0),
    "gradient_3": lambda o, f, xm, ym: o.gradient(f["tk"], xm, ym, 3),
    "thermal_front_parameter": lambda o, f, xm, ym:
        o.thermal_front_parameter(f["tk"], xm, ym),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_op_matches_jax(name):
    a = _arrays(seed=len(name))
    names = ("tk", "q", "u", "v", "p")
    jf = {k: _j(a[k]) for k in names}
    tf = {k: _t(a[k]) for k in names}
    ref = OPS[name](jops, jf, jnp.asarray(a["xm"]), jnp.asarray(a["ym"]))
    got = OPS[name](tops, tf, torch.from_numpy(a["xm"]),
                    torch.from_numpy(a["ym"]))
    rm = np.asarray(ref.mask)
    assert got.mask.dtype == torch.bool
    np.testing.assert_array_equal(got.mask.numpy(), rm, err_msg=name)
    assert rm.any() and not rm.all(), "inputs must exercise both states"
    np.testing.assert_allclose(got.values.numpy()[rm],
                               np.asarray(ref.values)[rm], rtol=2e-5,
                               atol=0, err_msg=name)


def test_alevelhum_sentinel_pressure_quirk():
    """With ps undefined, RH is *defined* garbage computed with p = 1e35."""
    a = _arrays(seed=7)
    out = tops.alevelhum(_t(a["tk"]), _t(a["q"]), _t(a["p"]), 1)
    y, x = NY // 2, NX // 2
    ok = a["tk"][1][:, y, x] & a["q"][1][:, y, x]
    np.testing.assert_array_equal(out.mask.numpy()[:, y, x], ok)
    assert ok.any() and np.all(out.values.numpy()[:, y, x][ok] > 1e20)


@pytest.mark.parametrize("dtype", [np.float32, np.bool_])
def test_fill_edges_matches_jax(dtype):
    rng = np.random.default_rng(4)
    a = rng.normal(0.0, 1.0, (NLEV, NY, NX))
    a = (a > 0) if dtype is np.bool_ else a.astype(np.float32)
    got = tops.fill_edges(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jops.fill_edges(
        jnp.asarray(a))))
    np.testing.assert_array_equal(got[:, 0, 0], a[:, 1, 1])


@pytest.mark.parametrize("call, jax_name", [
    (lambda o, f: o.aleveltemp(f["tk"], f["p"], 1), "aleveltemp"),
    (lambda o, f: o.alevelhum(f["tk"], f["q"], f["p"], 5), "alevelhum"),
    (lambda o, f: o.alevelhum(f["tk"], f["q"], f["p"], 9, unit="celsius"),
     "alevelhum"),
    (lambda o, f: o.alevelthe(f["tk"], f["q"], f["p"], 2), "alevelthe"),
    (lambda o, f: o.alevelducting(f["tk"], f["q"], f["p"], 3),
     "alevelducting"),
    (lambda o, f: o.gradient(f["tk"], 1.0, 1.0, 4), "gradient"),
])
def test_unported_modes_raise(call, jax_name):
    """The level modes and ``gradient`` mode 4 (the laplacian, ported with
    the rest of the stencils) run and equal the JAX functions (op by op,
    masks bitwise, values within rtol 2e-5); a bad compute mode raises."""
    a = _arrays(seed=len(jax_name))
    names = ("tk", "q", "p")
    tf = {k: _t(a[k]) for k in names}
    ref = call(jops, {k: _j(a[k]) for k in names})
    got = call(tops, tf)
    rm = np.asarray(ref.mask)
    np.testing.assert_array_equal(got.mask.numpy(), rm)
    assert rm.any() and not rm.all()
    np.testing.assert_allclose(got.values.numpy()[rm],
                               np.asarray(ref.values)[rm], rtol=2e-5)
    with pytest.raises(ValueError):
        tops.aleveltemp(tf["tk"], tf["tk"], 7)
