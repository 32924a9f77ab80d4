"""The column-interpolation kernel's source, compiled for the host CPU,
against its plain version, bit for bit.

``csrc/vertical_interp.cu`` (B2 ``mf_vertical_interp``, with
``csrc/common.cuh``) is compiled by g++ through the stand-in
``cuda_runtime.h`` of ``cuda_host.py``, which runs each 256-column block
as one thread: the kernel's phases are block-stride loops (a, b and the
targets into shared memory, then the columns), so one thread covers its
block's columns one after the other.
With ``-ffp-contract=off`` every float operation rounds on its own, as the
card's ``-fmad=false`` build does, so the outputs can be held to
``hlevel_to_plevel_plain``: masks equal, values equal bit for bit at every
point.  The cases pin the kernel's two ways to a bracket, the binary search
on columns whose rounded pressures do not decrease and the walk over every
level pair elsewhere, to the rule "the last bracket wins": ties, a
degenerate bracket, non-monotone columns, targets on a level, ps NaN /
+-inf / 1e35 / negative, a single level, no bracket at all, unsorted a or
b, ERA5's hybrid law, and blocks that mix the two routes.  Every call
also counts its searched columns into the kernel's counter, held to the
columns whose p_k = fl(a_k + fl(b_k * ps)) does not decrease (numpy's
float32 arithmetic, one rounding an operation), once a launch.  Calls of
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
from benchmark import harness, inputs_global
from cuda_host import host_library, run
from mi_fieldcalc_tpu_torch.field import Field
from mi_fieldcalc_tpu_torch.models import STANDARD_PLEVELS
from mi_fieldcalc_tpu_torch.ops import vertical_fused as vf
from mi_fieldcalc_tpu_torch.utils import profiling as tprof

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return host_library(tmp_path_factory, "vertical_interp.cu", 2)


def _host_interp(lib, fields, ps, a, b, targets, log_p, all_defined):
    """One host call of B2's C entry on the arguments the wrapper launches
    with (``vertical_fused._launch_args``), with a counter of searched
    columns; the launches it reports are one for each group of up to 31
    fields.  Returns the outputs and the count over a launch."""
    nvar = len(fields)
    searched = torch.zeros((), dtype=torch.int64)
    out, args = vf._launch_args(fields, ps, a, b, targets, log_p,
                                all_defined, searched)
    launched = ctypes.c_int(-1)
    assert run(lib, "mf_vertical_interp",
               (*args, ctypes.byref(launched))) == 0
    assert launched.value == -(-nvar // 31), (nvar, launched.value)
    n = int(searched)
    assert n % launched.value == 0, (n, launched.value)
    return out, n // launched.value


def _monotone_columns(al, bl, psv) -> np.ndarray:
    """The columns whose rounded p_k = fl(a_k + fl(b_k * ps)) does not
    decrease from the top level down, in float32 one rounding an
    operation (NaN fails the compare)."""
    a = np.asarray(al, np.float32)[:, None]
    b = np.asarray(bl, np.float32)[:, None]
    with np.errstate(all="ignore"):
        p = a + b * np.asarray(psv, np.float32).reshape(1, -1)
        return np.all(p[:-1] <= p[1:], axis=0)


def _check(lib, fields, ps, al, bl, targets, log_p, all_defined, label):
    a, b = torch.from_numpy(np.asarray(al, np.float32)), torch.from_numpy(
        np.asarray(bl, np.float32))
    got, searched = _host_interp(lib, fields, ps, a, b, targets, log_p,
                                 all_defined)
    assert searched == int(_monotone_columns(al, bl, ps.values).sum()), (
        label, searched)
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
    """a or b not finite and non-decreasing, which once made every column
    walk: now each column takes the route its own pressures allow.  The
    phase-6 non-monotone column (57 hPa bracketed twice, the last bracket
    wins; p rises down the columns of ps near 1000 hPa, which search), a
    or b holding inf / NaN (no column searches), sorted a with an unsorted
    b (850 hPa bracketed at level 2, where a search from the top finds no
    bracket), and a stack given top to bottom."""
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
    searching = _monotone_columns(al, bl, psv)
    if case == "non_monotone_a":
        assert searching.any() and not searching[1 * 67 + 2]
    elif case in ("non_finite_a", "non_finite_b", "reversed"):
        assert not searching.any()


ERA5 = harness.resolve(harness.benchmark_spec(), "era5_l137.iso")["config"]


def _era5_levels() -> tuple:
    """The ERA5 configuration's hybrid law as float32: A rises from the top
    to ~179 hPa and falls back to 0 at the surface."""
    return tuple(c.astype(np.float32)
                 for c in inputs_global.hybrid_law(ERA5))


@pytest.mark.parametrize("all_defined", [False, True])
@pytest.mark.parametrize("log_p", [True, False])
def test_host_interp_era5_law_searches_every_column(host_lib, all_defined,
                                                    log_p):
    """ERA5's 137 levels to its 37 surfaces: a hybrid A that is not sorted,
    whose columns of ps N(1000, 15) and N(680, 30) hPa all have rising
    pressures, so every column searches, over two blocks."""
    al, bl = _era5_levels()
    assert not (np.diff(al) >= 0).all()
    rng = np.random.default_rng(137)
    ny, nx = 3, 101
    psv = rng.normal(1000.0, 15.0, (ny, nx)).astype(np.float32)
    psv[2] = rng.normal(680.0, 30.0, nx)
    fields = _fields(rng, 4, len(al), ny, nx, 0.0 if all_defined else 0.05)
    ps = _ps(psv, [] if all_defined else [(1, 50)])
    _check(host_lib, fields, ps, al, bl, ERA5["plevels"], log_p,
           all_defined, (all_defined, log_p))
    assert _monotone_columns(al, bl, psv).all()


@pytest.mark.parametrize("law", ["era5", "sorted"])
def test_host_interp_a_block_mixes_searching_and_walking(host_lib, law):
    """One block whose columns take both routes: on ERA5's law a ps below
    ~370 hPa where its p stops rising and a NaN ps walk among columns
    that search; on config 4's sorted a and b a ps of -5 hPa still
    searches, one of -1000 hPa makes p fall and walks, and a NaN walks."""
    if law == "era5":
        al, bl = _era5_levels()
        special = {0: 200.0, 7: np.nan, 11: 369.0}
    else:
        raw = chip_smoke.make_column_inputs(40, 1, 1, seed=5,
                                            undef_frac=0.0)
        al, bl = raw[5], raw[6]
        special = {0: -5.0, 7: -1000.0, 11: np.nan}
    rng = np.random.default_rng(41)
    psv = rng.uniform(950.0, 1030.0, (1, 120)).astype(np.float32)
    for i, v in special.items():
        psv[0, i] = v
    searching = _monotone_columns(al, bl, psv)
    want = {"era5": [7, 11, 0], "sorted": [7, 11]}[law]
    assert sorted(np.flatnonzero(~searching)) == sorted(want)
    fields = _fields(rng, 3, len(al), 1, 120, 0.05)
    _check(host_lib, fields, _ps(psv), al, bl,
           tuple(STANDARD_PLEVELS) + (150.0, 100.0, 60.0), True, False, law)


@pytest.mark.parametrize("log_p", [True, False])
def test_host_interp_two_equal_levels(host_lib, log_p):
    """A table with two equal levels (a and b both repeated: p ties on
    every column, which still searches) and two B = 0 levels one float
    apart, whose ln p round to one value: a target on the lower one is
    bracketed with denom 0 under ln p, masked with the interpolation's
    value, bit for bit the plain version's."""
    top = np.float32(300.0)
    al = np.array([10, 100, 200, top, np.nextafter(top, np.float32(1e9)),
                   320, 320, 250, 100, 0], np.float32)
    bl = np.array([0, 0, 0, 0, 0, .1, .1, .4, .7, 1.0], np.float32)
    assert np.log(np.float32(al[3])) == np.log(np.float32(al[4]))
    rng = np.random.default_rng(2)
    psv = rng.uniform(960.0, 1040.0, (2, 150)).astype(np.float32)
    fields = _fields(rng, 2, len(al), 2, 150, 0.0)
    targets = (float(top), 250.0, 420.0, 700.0, 990.0)
    got = _check(host_lib, fields, _ps(psv), al, bl, targets, log_p, True,
                 log_p)
    assert _monotone_columns(al, bl, psv).all()
    # the target on the level one float below its neighbour: denom 0
    # under ln p alone
    assert bool(got[0].mask[0].any()) != log_p


def test_host_interp_pressure_falling_at_one_level(host_lib):
    """A table whose p falls from level 2 to 3 where ps < 200 hPa: those
    columns walk, a target bracketed on both sides of the fall takes the
    last bracket, bit for bit the plain version's, and the columns of
    ps near 1000 hPa search."""
    al = np.array([10, 100, 200, 180, 250, 300, 350, 400], np.float32)
    bl = np.array([0, 0, 0, .1, .3, .5, .8, 1.0], np.float32)
    rng = np.random.default_rng(8)
    psv = rng.uniform(900.0, 1040.0, (2, 90)).astype(np.float32)
    psv[0, :30] = rng.uniform(30.0, 150.0, 30)
    psv[0, 4] = 80.0
    searching = _monotone_columns(al, bl, psv).reshape(psv.shape)
    assert not searching[0, :30].any() and searching[:, 30:].all()
    fields = _fields(rng, 2, len(al), 2, 90, 0.05)
    got = _check(host_lib, fields, _ps(psv), al, bl,
                 (190.0, 150.0, 500.0, 900.0), True, False, "fall")
    col = al + bl * psv[0, 4]
    t = np.float32(190.0)
    brackets = [k for k in range(len(al) - 1)
                if col[k] <= t < col[k + 1]]
    assert len(brackets) == 2
    k = brackets[-1]
    f = fields[0].values[:, 0, 4].numpy()
    x0, x1 = np.log(col[k]), np.log(col[k + 1])
    want = f[k] + (f[k + 1] - f[k]) * ((np.log(t) - x0) / (x1 - x0))
    assert abs(float(got[0].values[0, 0, 4]) - want) < 1e-3


def _host_call(host_lib):
    """``_build.call`` for B2 on the host library: the entry's arguments as
    the wrapper hands them, all seen."""
    seen = []

    def call(fn, entry, dev, *args):
        seen.append(args)
        assert run(host_lib, entry, args) == 0
    return call, seen


def test_host_interp_counts_only_inside_a_profiler_session(host_lib,
                                                           monkeypatch):
    """The wrapper's own launch on host tensors, the host library in the
    card's place: outside a profiler session it hands the kernel a null
    counter and records nothing; inside one it hands it the session's
    slot, and the session reads the columns (``b2.columns``, once a
    launch) and those searched (``b2.searched_columns``)."""
    from torch.profiler import ProfilerActivity, profile
    call, seen = _host_call(host_lib)
    monkeypatch.setattr(vf._build, "call", call)
    al, bl = _era5_levels()
    rng = np.random.default_rng(5)
    psv = rng.normal(1000.0, 15.0, (2, 40)).astype(np.float32)
    psv[0, :3] = (100.0, np.nan, 300.0)
    fields = _fields(rng, 33, len(al), 2, 40, 0.0)
    ps = _ps(psv)
    a, b = torch.from_numpy(al), torch.from_numpy(bl)
    tprof.take()
    off = vf._launch(fields, ps, a, b, (500.0, 850.0), True, True)
    assert seen[-1][-2] is None
    assert tprof.recorded().counters == {}
    with profile(activities=[ProfilerActivity.CPU]):
        on = vf._launch(fields, ps, a, b, (500.0, 850.0), True, True)
    assert isinstance(seen[-1][-2], torch.Tensor)
    rec = tprof.take()
    assert rec.counters == {"b2.columns": 2 * 80,
                            "b2.searched_columns": 2 * 77}
    assert [s.name for s in rec.spans] == ["b2.kernel"]
    for x, y in zip(off, on):
        assert torch.equal(x.values.view(torch.int32),
                           y.values.view(torch.int32))
        assert torch.equal(x.mask, y.mask)


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
