"""The column-interpolation kernel's source, compiled for the host CPU,
against its plain version, bit for bit.

``csrc/vertical_interp.cu`` (B2 ``mf_vertical_interp``, with
``csrc/common.cuh``) is compiled by g++ through the stand-in
``cuda_runtime.h`` of ``cuda_host.py``, which runs each 256-column block
as one thread: the kernel's phases are block-stride loops (a, b and the
targets into shared memory with the block's vote on a and b, then the
columns), so one thread covers its block's columns one after the other.
With ``-ffp-contract=off`` every float operation rounds on its own, as the
card's ``-fmad=false`` build does, so the outputs can be held to
``hlevel_to_plevel_plain``: masks equal, values equal bit for bit at every
point.  The cases pin the kernel's two ways to a bracket, the binary search
on columns whose pressure cannot decrease and the walk over every level
pair elsewhere, to the rule "the last bracket wins": ties, non-monotone
columns, targets on a level, ps NaN / +-inf / 1e35 / negative, a single
level, no bracket at all, and a or b that fail the kernel's vote.  Calls of
more fields than one launch takes (31) pin the C entry's grouping: one
launch a group, counted by the entry itself, each writing its own slice,
and under ``all_defined`` every group writing the one shared mask plane.  The card checks the
same equality (``chip_smoke.py`` phases 6, 7 and 16).
"""

import ctypes

import numpy as np
import pytest
import torch

import chip_smoke
from cuda_host import host_library, run
from mi_fieldcalc_tpu_torch.field import Field
from mi_fieldcalc_tpu_torch.models import STANDARD_PLEVELS
from mi_fieldcalc_tpu_torch.ops import vertical_fused as vf

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return host_library(tmp_path_factory, "vertical_interp.cu", 2)


def _host_interp(lib, fields, ps, a, b, targets, log_p, all_defined):
    """One host call of B2's C entry on the arguments the wrapper launches
    with (``vertical_fused._launch_args``); the launches it reports are
    one for each group of up to 31 fields."""
    nvar = len(fields)
    out, args = vf._launch_args(fields, ps, a, b, targets, log_p,
                                all_defined)
    launched = ctypes.c_int(-1)
    assert run(lib, "mf_vertical_interp",
               (*args, ctypes.byref(launched))) == 0
    assert launched.value == -(-nvar // 31), (nvar, launched.value)
    return out


def _check(lib, fields, ps, al, bl, targets, log_p, all_defined, label):
    a, b = torch.from_numpy(np.asarray(al, np.float32)), torch.from_numpy(
        np.asarray(bl, np.float32))
    got = _host_interp(lib, fields, ps, a, b, targets, log_p, all_defined)
    ref = vf.hlevel_to_plevel_plain(fields, ps, a, b, targets, log_p,
                                    all_defined)
    for k, (g, r) in enumerate(zip(got, ref)):
        assert torch.equal(g.mask, r.mask), (label, k, int(
            (g.mask != r.mask).sum()))
        same = (g.values.view(torch.int32) == r.values.view(torch.int32)) | (
            torch.isnan(g.values) & torch.isnan(r.values))
        assert bool(same.all()), (label, k, int((~same).sum()))
    return got


def _fields(rng, nvar, nlev, ny, nx, undef_frac):
    out = []
    for _ in range(nvar):
        v = rng.normal(280.0, 10.0, (nlev, ny, nx)).astype(np.float32)
        m = rng.random((nlev, ny, nx)) >= undef_frac
        out.append(Field(torch.from_numpy(v), torch.from_numpy(m)))
    return tuple(out)


def _ps(values, undef=()):
    v = torch.from_numpy(np.asarray(values, np.float32))
    m = torch.ones(v.shape, dtype=torch.bool)
    for idx in undef:
        m[idx] = False
    return Field(v, m)


@pytest.mark.parametrize("shape", [(13, 5, 61), (137, 3, 101), (1, 4, 7)])
@pytest.mark.parametrize("all_defined", [False, True])
@pytest.mark.parametrize("log_p", [True, False])
def test_host_interp_config4_columns(host_lib, shape, all_defined, log_p):
    """BASELINE config 4's monotone columns (``chip_smoke.
    make_column_inputs``: model top 50 hPa, lowest level near 900 hPa, so
    1000 and 925 hPa and 20 hPa are never bracketed, 1100 hPa neither),
    across more than one block, and a single level; undefined points and
    an undefined ps point on the masked route."""
    raw = chip_smoke.make_column_inputs(*shape, seed=sum(shape),
                                        undef_frac=0.0 if all_defined
                                        else 0.03,
                                        undef_ps=not all_defined)
    rng = np.random.default_rng(sum(shape))
    fields = _fields(rng, 4, *shape, 0.0 if all_defined else 0.05)
    ps = _ps(raw[4], [] if all_defined else
             [(shape[1] // 2, shape[2] // 2)])
    targets = STANDARD_PLEVELS + (20.0, 1100.0)
    got = _check(host_lib, fields, ps, raw[5], raw[6], targets, log_p,
                 all_defined, (shape, all_defined, log_p))
    if shape[0] == 1:
        assert not any(bool(g.mask.any()) for g in got)


@pytest.mark.parametrize("all_defined", [False, True])
@pytest.mark.parametrize("log_p", [True, False])
def test_host_interp_edges_of_the_rule(host_lib, all_defined, log_p):
    """Sorted levels with ties (equal a and b, and b equal where ps = 0
    makes a alone count), targets equal to a level's pressure and to the
    top and bottom levels, and ps NaN, +-inf, 1e35, -0.0, 0 and negative:
    the search and the walk on one grid of columns."""
    al = np.array([10, 50, 50, 100, 150, 150, 200, 300, 300, 400], np.float32)
    bl = np.array([0, 0, 0, .1, .2, .2, .4, .6, .7, 1.0], np.float32)
    rng = np.random.default_rng(11)
    ny, nx = 3, 97
    psv = rng.uniform(900.0, 1050.0, (ny, nx)).astype(np.float32)
    specials = [np.nan, np.inf, -np.inf, 1e35, -0.0, 0.0, -5.0, -1e30,
                1e38, 3e38, 1e-40, 600.0]
    psv.reshape(-1)[:len(specials)] = specials
    fields = _fields(rng, 3, len(al), ny, nx, 0.0 if all_defined else 0.1)
    ps = _ps(psv, [] if all_defined else [(0, 3), (1, 7)])
    p_first = float(al[3] + bl[3] * psv[1, 20])
    targets = (10.0, 50.0, 150.0, 300.0, 400.0, 700.0, 1000.0, 1200.0,
               p_first, float(np.nextafter(np.float32(p_first), 0)),
               float(al[9] + bl[9] * psv[2, 30]), 5.0, 49.999996,
               296.75)          # ps = -5: bracketed at 6 and at 8
    _check(host_lib, fields, ps, al, bl, targets, log_p, all_defined,
           (all_defined, log_p))


@pytest.mark.parametrize("case", ["non_monotone_a", "non_finite_a",
                                  "non_finite_b", "unsorted_b",
                                  "reversed"])
def test_host_interp_levels_that_fail_the_vote(host_lib, case):
    """a or b not finite and non-decreasing: every column walks.  The
    phase-6 non-monotone column (57 hPa bracketed twice, the last bracket
    wins), a or b holding inf / NaN, sorted a with an unsorted b (850 hPa
    bracketed at level 2, where a search from the top finds no bracket),
    and a stack given top to bottom."""
    al = np.array([10, 60, 50, 60, 80, 100, 120, 100, 50], np.float32)
    bl = np.array([0, 0, .1, .2, .3, .45, .6, .8, 1.0], np.float32)
    if case == "non_finite_a":
        al = np.sort(al)
        bl = np.sort(bl)
        al[4] = np.inf
    elif case == "non_finite_b":
        al = np.sort(al)
        bl = np.sort(bl)
        bl[5] = np.nan
    elif case == "unsorted_b":
        al = np.sort(al)
        bl = np.array([1.0, .5, .5, .9, .2, .2, .1, 0, 0], np.float32)
    elif case == "reversed":
        al = np.sort(al)[::-1].copy()
        bl = np.sort(bl)[::-1].copy()
    rng = np.random.default_rng(3)
    psv = rng.uniform(980.0, 1030.0, (4, 67)).astype(np.float32)
    psv[1, 2] = 50.0
    psv[2, 5] = np.nan
    psv[3, 9] = -20.0
    fields = _fields(rng, 2, len(al), 4, 67, 0.1)
    ps = _ps(psv)
    targets = (57.0, 110.0, 500.0, 850.0, 1000.0)
    got = _check(host_lib, fields, ps, al, bl, targets, True, False, case)
    if case == "non_monotone_a":
        col = al + bl * psv[1, 2]
        assert [k for k in range(8) if col[k] <= 57.0 < col[k + 1]] == [0, 2]
        f = fields[0].values[:, 1, 2].numpy()
        x0, x1 = np.log(col[2]), np.log(col[3])
        want = f[2] + (f[3] - f[2]) * ((np.log(57.0) - x0) / (x1 - x0))
        assert abs(float(got[0].values[0, 1, 2]) - want) < 1e-4


def test_host_interp_no_target_bracketed(host_lib):
    """Targets all above the top and below the surface: zeros, masked."""
    raw = chip_smoke.make_column_inputs(9, 4, 33, seed=1, undef_frac=0.0)
    fields = _fields(np.random.default_rng(2), 2, 9, 4, 33, 0.0)
    got = _check(host_lib, fields, _ps(raw[4]), raw[5], raw[6],
                 (5.0, 20.0, 1100.0, 2000.0), True, True, "none")
    assert not bool(got[0].mask.any())
    assert bool((got[0].values == 0.0).all())


@pytest.mark.parametrize("nvar", [31, 32, 40])
@pytest.mark.parametrize("all_defined", [False, True])
def test_host_interp_field_groups(host_lib, nvar, all_defined):
    """31, 32 and 40 fields (one launch, then a group of 31 and one of 1
    or 9) on a grid of two blocks, masked and all-defined: every field's
    values and mask bit for bit the plain version's, each field distinct,
    so a group that read or wrote another group's slice would show."""
    shape = (7, 5, 61)
    raw = chip_smoke.make_column_inputs(*shape, seed=nvar, undef_frac=0.0)
    rng = np.random.default_rng(nvar + all_defined)
    fields = _fields(rng, nvar, *shape, 0.0 if all_defined else 0.1)
    fields = tuple(Field(f.values + 3.0 * v, f.mask)
                   for v, f in enumerate(fields))
    ps = _ps(raw[4], [] if all_defined else [(2, 30)])
    targets = (1000.0, 850.0, 700.0, 500.0, 300.0, 100.0)
    got = _check(host_lib, fields, ps, raw[5], raw[6], targets, True,
                 all_defined, (nvar, all_defined))
    assert len(got) == nvar
    if all_defined:
        assert all(g.mask.data_ptr() == got[0].mask.data_ptr() for g in got)
        assert bool(got[0].mask.any()) and not bool(got[0].mask.all())
    else:
        assert not torch.equal(got[0].mask, got[-1].mask)
