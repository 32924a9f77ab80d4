"""The reference goldens replayed through the PyTorch port on the CPU.

Every case of ``tests/goldens/goldens.npz`` (180, 12x10) and of
``goldens_large.npz`` (5, 719x929) runs its seeded inputs
(``conformance_cases.case_inputs``) through the port's operator
(``torch_conformance.PORT_OPS``) and is held to the golden by the JAX
suite's own contract, ``test_conformance._check``: the mask equal to the
reference's sentinel pattern where the case says ``mask_exact``, and the
values within the case's rtol / atol wherever both sides are defined.
A case whose operator the port lacks skips as ``not_ported``.
"""

import os

import numpy as np
import pytest
import torch

from conformance_cases import CASES, LARGE_CASES, case_inputs
from test_conformance import _check
from torch_conformance import PORT_OPS, outputs, port_case

torch.set_num_threads(1)

_DIR = os.path.join(os.path.dirname(__file__), "goldens")
GOLDENS = np.load(os.path.join(_DIR, "goldens.npz"))
GOLDENS_LARGE = np.load(os.path.join(_DIR, "goldens_large.npz"))


def _replay(case, goldens):
    if case.op not in PORT_OPS:
        pytest.skip("not_ported")
    out = port_case(case, case_inputs(case))
    for key, field in outputs(case, out):
        assert field.values.dtype == torch.float32, key
        assert field.mask.dtype == torch.bool, key
        _check(case, field, goldens[key])


@pytest.mark.parametrize("case", CASES, ids=[c.name for c in CASES])
def test_torch_conformance(case):
    _replay(case, GOLDENS)


@pytest.mark.parametrize("case", LARGE_CASES,
                         ids=[c.name for c in LARGE_CASES])
def test_torch_conformance_large(case):
    assert case_inputs(case)[-1].shape[-2:] == (719, 929)
    _replay(case, GOLDENS_LARGE)


def test_every_case_has_a_port():
    """No operator of the golden suite is left out of the port."""
    missing = sorted({c.op for c in CASES + LARGE_CASES} - set(PORT_OPS))
    assert missing == []
