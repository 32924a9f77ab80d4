"""The port's operator surface against the JAX package, case by case.

Every case of ``conformance_cases.CASES`` but the icing ones runs through
the JAX operator (``test_conformance._native``, op by op with no
``jax.jit``: XLA:CPU's jit contracts multiply-adds) and through its port
(``torch_conformance``), on the case's seeded inputs with ~8% more undefined points scattered over
every field that may hold them.  Masks must be bitwise equal; values agree
within rtol 2e-5 on the points both define.
"""

import numpy as np
import pytest
import torch

from conformance_cases import CASES, UNDEF, case_inputs
from test_conformance import GOLDENS, _native
from torch_conformance import outputs, port_case

torch.set_num_threads(1)

#: kinds the reference reads without a defined-check
_NO_UNDEF = ("mapr", "fcor")


def _inputs(case):
    """The case's inputs with ~8% more undefined points (none where the
    case is all-defined, or in map factors and coriolis)."""
    ins = case_inputs(case)
    if not case.undef:
        return ins
    rng = np.random.default_rng(len(case.name) * 7919 + 17)
    for a, kind in zip(ins, case.kinds):
        if kind not in _NO_UNDEF:
            a[rng.random(a.shape) < 0.08] = np.float32(UNDEF)
    return ins


#: the icing operators are held to the JAX package by test_torch_icing.py
SURFACE = [c for c in CASES if not c.op.startswith("vesselIcing")]


@pytest.mark.parametrize("case", SURFACE, ids=[c.name for c in SURFACE])
def test_port_matches_jax(case):
    ins = _inputs(case)
    ref = _native(case, [a.copy() for a in ins])
    got = port_case(case, ins)
    refs = dict(outputs(case, ref))
    for key, field in outputs(case, got):
        rm = np.asarray(refs[key].mask)
        gm = field.mask.numpy()
        np.testing.assert_array_equal(gm, rm, err_msg=key)
        # a case whose golden is all undefined cannot define a point here
        assert rm.any() or not (GOLDENS[key] != UNDEF).any(), key
        np.testing.assert_allclose(field.values.numpy()[rm],
                                   np.asarray(refs[key].values)[rm],
                                   rtol=2e-5, atol=0, err_msg=key)


@pytest.mark.parametrize("compute, unit", [
    (1, ""), (1, "celsius"), (2, ""), (3, ""), (4, ""), (4, "1"), (5, "")])
def test_cvhum_modes_match_jax(compute, unit):
    """Every ``cvhum`` mode on inputs in its own units (the golden cases
    give modes 2-4 temperatures outside the table, so nothing is defined
    there): T in K or C, RH% or a dewpoint a few degrees below T."""
    import jax.numpy as jnp

    import mi_fieldcalc_tpu.ops as jops
    from mi_fieldcalc_tpu.field import from_sentinel as jfs
    from mi_fieldcalc_tpu_torch import from_sentinel as tfs, ops as tops

    rng = np.random.default_rng(compute * 10 + len(unit))
    tc = rng.uniform(-35.0, 25.0, (9, 13)).astype(np.float32)
    kelvin = compute in (1, 2, 4)
    t = tc + np.float32(273.15) if kelvin else tc
    if compute in (4, 5):
        hum = t - rng.uniform(0.0, 12.0, t.shape).astype(np.float32)
    else:
        hum = rng.uniform(3.0, 99.0, t.shape).astype(np.float32)
    t[rng.random(t.shape) < 0.1] = np.float32(UNDEF)
    hum[rng.random(t.shape) < 0.1] = np.float32(UNDEF)
    ref = jops.cvhum(jfs(jnp.asarray(t)), jfs(jnp.asarray(hum)), compute,
                     unit)
    got = tops.cvhum(tfs(t), tfs(hum), compute, unit)
    rm = np.asarray(ref.mask)
    np.testing.assert_array_equal(got.mask.numpy(), rm)
    assert rm.any() and not rm.all()
    np.testing.assert_allclose(got.values.numpy()[rm],
                               np.asarray(ref.values)[rm], rtol=2e-5, atol=0)
