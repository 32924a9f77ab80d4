"""The icing kernels' source, compiled for the host CPU, against their plain
versions, bit for bit.

``csrc/vessel_icing.cu`` (with ``csrc/common.cuh``) is compiled by g++ as
plain C++ through the stand-in ``cuda_runtime.h`` of ``cuda_host.py``,
which runs each block as one thread: the kernels' phases are block-stride
loops over lists with shared counters, so one thread runs every phase of
its block in turn.  With ``-ffp-contract=off`` every float operation rounds
on its own, as the card's ``-fmad=false`` build does, so the per-point
arithmetic of B5 and B6 can be held to the plain versions here, where no
card is.  PyTorch's CPU
``sqrt`` is not correctly rounded (the card's is, and so is the host
``sqrtf``), so the plain versions run with a correctly rounded one.
The card itself checks the same equality (``test_torch_icing.py``'s
``cuda``-marked tests, ``chip_smoke.py`` phase 9).
"""

import math

import numpy as np
import pytest
import torch

import icing_corner_cases as corners
from cuda_host import host_library, run
from mi_fieldcalc_tpu_torch.field import from_sentinel
from mi_fieldcalc_tpu_torch.ops import icing_fused as F
from mi_fieldcalc_tpu_torch.ops.icing import _mincog_decay, _number

torch.set_num_threads(1)

SCAL = (5.0, 0.52, 2.0, 11.0)
SCAL_VS0 = (0.0, 0.0, 1.0, 4.0)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return host_library(tmp_path_factory, "vessel_icing.cu", 2)


@pytest.fixture
def exact_sqrt(monkeypatch):
    """A correctly rounded float32 sqrt (through float64), as the card's."""
    sqrt = torch.sqrt
    monkeypatch.setattr(torch, "sqrt", lambda x: sqrt(x.double()).float())


def _inputs(ny, nx, seed, adversarial, plant):
    """``tests/test_torch_icing.py``'s input pattern."""
    rng = np.random.default_rng(seed)

    def f(lo, hi):
        x = rng.uniform(lo, hi, (ny, nx)).astype(np.float32)
        x.reshape(-1)[rng.integers(0, x.size, max(1, x.size // 23))] = 1e35
        return x

    a = [f(0.0, 35.0), f(0.0 if adversarial else 0.1, 8.0),
         f(-25.0, 25.0), f(-25.0, 25.0), f(-25.0, 2.0), f(0.3, 1.0),
         f(-1.0, 8.0), f(960.0, 1040.0),
         f(6.0, 14.0) if adversarial else f(2.0, 12.0), f(0.0, 0.5),
         f(2.0, 40.0) if adversarial else f(5.0, 500.0)]
    if plant:
        a[8].reshape(-1)[::7] = 0.0
        a[0].reshape(-1)[3::11] = 0.0
    return [from_sentinel(x) for x in a]


def _host_launch(lib, planes, flags, decay, vsca, alt):
    """One host launch of B5 (``alt``) or B6 on the kernel planes and the
    bool flags (gate, shallow, and skip0 for B5), with the arguments the
    wrapper launches with (``icing_fused._launch_args``)."""
    out, args = F._launch_args("host", F._MS_PLANES if alt is None
                               else F._PLANES, planes, flags, decay, vsca,
                               alt)
    assert run(lib, "mf_vessel_icing_modstall" if alt is None
               else "mf_vessel_icing_mincog", args) == 0
    return out


def _host_run(lib, fields, scal, alt):
    """One host launch of B5 (``alt``) or B6 on the wrapper's prologue."""
    vs, alpha, zmin, zmax = scal
    if alt is None:
        gate, planes, *flags = F._modstall_prologue(*fields)
    else:
        gate, planes, *flags = F._mincog_prologue(*fields, vs, alpha)
    return _host_launch(lib, planes, (gate, *flags),
                        _mincog_decay(zmin, _number(zmin, zmax)),
                        float(vs * math.cos(alpha)), alt)


def _assert_same(got, ref, label):
    same = (got.view(torch.int32) == ref.view(torch.int32)) | (
        torch.isnan(got) & torch.isnan(ref))
    assert bool(same.all()), (label, float((got - ref).abs()[~same].max()))


def _check_all(lib, fields, scal):
    """B5 (alt 1 and 2) and B6 from the host build against their plain
    versions, bit for bit."""
    for alt in (1, 2, None):
        got = _host_run(lib, fields, scal, alt)
        if alt is None:
            ref = F.vessel_icing_modstall_plain(*fields, *scal)
        else:
            ref = F.vessel_icing_mincog_plain(*fields, *scal, alt)
        _assert_same(got, ref.values, alt)


@pytest.mark.parametrize("shape", [(1, 1), (3, 37), (37, 61), (9, 131),
                                   (64, 256)])
@pytest.mark.parametrize("kind", ["friendly", "adversarial", "vs0"])
def test_host_kernels_match_plain(host_lib, exact_sqrt, shape, kind):
    adversarial = kind != "friendly"
    scal = SCAL_VS0 if kind == "vs0" else SCAL
    fields = _inputs(*shape, seed=sum(shape) + len(kind),
                     adversarial=adversarial, plant=adversarial)
    _check_all(host_lib, fields, scal)


@pytest.mark.parametrize("kind", corners.KINDS)
def test_host_kernels_scheduling_corners(host_lib, exact_sqrt, kind):
    """The tile schedule's corners (``tests/icing_corner_cases.py``): an
    all-gated tile, tiles where every MINCOG item and where no item has a
    sign change, 81 heights in chunks, a grid of one tile and a point."""
    raw, scal = corners.corner_inputs(kind)
    _check_all(host_lib, [from_sentinel(a) for a in raw], scal)


def test_host_modstall_near_cap_items(host_lib):
    """B6 on a tile that mixes items leaving [0, 1] at steps 90-127, items
    forced at step 128 (the cap resolution) and 1-step items."""
    gate, planes, shallow, vsca, decay = corners.modstall_cap_planes()
    got = _host_launch(host_lib, planes, (gate, shallow), decay, vsca, None)
    trips = {"lanes": {}}
    ref = F._modstall_plain(gate, planes, shallow, vsca, decay, trips)
    _assert_same(got, ref, "modstall near the cap")
    lanes = trips["lanes"]
    steps = torch.stack([lanes.get(("height_warm", k), 0)
                         + lanes.get(("height_newton", k), 0)
                         for k in range(len(decay))])
    capped = sum(lanes[("height_cap", k)] for k in range(len(decay)))
    assert int(steps.max()) == 128 and int((steps >= 90).sum()) > 0
    assert int((steps == 1).sum()) > steps.numel() // 2
    assert int(capped.sum()) > 0
