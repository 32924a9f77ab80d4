"""The level-suite kernels' source, compiled for the host CPU, against their
plain versions, bit for bit.

``csrc/level_suite.cu`` (B3 ``mf_alevel_suite``, B4 ``mf_hlevel_suite``,
with ``csrc/common.cuh``) is compiled by g++ through the stand-in
``cuda_runtime.h`` of ``cuda_host.py``, which runs each block of the 2-D
grid (chunk of a level plane, level) as one thread: the kernel's phases are
block-stride loops (the table fill, the points of the chunk), so one thread
covers its block's chunk one point after the other.  With
``-ffp-contract=off`` every float operation rounds on its own, as the
card's ``-fmad=false`` build does, so the outputs can be held to
``alevel_suite_plain`` / ``hlevel_suite_plain`` here: masks equal, values
equal bit for bit on every point (NaN where NaN).  The card checks the same
(``test_torch_suite.py``'s ``cuda``-marked tests, ``chip_smoke.py`` phases 6
and 8).

The table search is pinned on its own: the padded shared-memory table
equals ``constants.EWT`` and is strictly increasing, and the 6-step search
gives the 41-step count at every entry, its float32 neighbours, signed
zeros, infinities, NaN and subnormals; the inverse built on it equals the
one on the constant table.
"""

import ctypes

import numpy as np
import pytest
import torch

import chip_smoke
from cuda_host import host_library, run
from mi_fieldcalc_tpu_torch.constants import EWT, N_EWT
from mi_fieldcalc_tpu_torch.field import from_sentinel
from mi_fieldcalc_tpu_torch.ops import fused_suite as fs

torch.set_num_threads(1)

#: a probe of common.cuh's table helpers, compiled beside the kernels
_PROBE = r"""
#include "common.cuh"
extern "C" {
void mf_host_ewt_table(float* out) {
  blockDim = dim3(1);
  threadIdx = dim3(0);
  ewt_to_shared(out);
}
void mf_host_ewt_count(const float* et, int n, int* out) {
  float tab[kEwtPad];
  mf_host_ewt_table(tab);
  for (int i = 0; i < n; ++i) out[i] = ewt_count(tab, et[i]);
}
void mf_host_ewt_inverse(const float* et, const int* l, int n, float* out,
                         float* out_constant) {
  float tab[kEwtPad];
  mf_host_ewt_table(tab);
  for (int i = 0; i < n; ++i) {
    out[i] = ewt_inverse_tab(tab, et[i], l[i]);
    out_constant[i] = ewt_inverse(et[i], l[i]);
  }
}
int mf_host_ewt_pad() { return kEwtPad; }
}
"""

#: the shapes: a point, phase 6's ragged ones, and a 2317-point plane
#: (odd, 4 full 512-point chunks and a tail of 269) over 3 levels
SHAPES = [(1, 1, 1), (3, 37, 61), (2, 5, 929), (3, 7, 331)]
MODES = {"all_modes": chip_smoke.ALL_MODES, "config2": chip_smoke.CONFIG2}


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    lib = host_library(tmp_path_factory, "level_suite.cu", 4,
                       [("ewt_probe.cpp", _PROBE)])
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mf_host_ewt_table.argtypes = [p]
    lib.mf_host_ewt_count.argtypes = [p, i, p]
    lib.mf_host_ewt_inverse.argtypes = [p, p, i, p, p]
    lib.mf_host_ewt_pad.restype = i
    return lib


def _host_suite(lib, hybrid, t, q, rh, p, alevel, blevel, reqs,
                all_defined) -> fs.SuiteStacked:
    """One host launch of B4 (``hybrid``) or B3 on the arguments the
    wrapper launches with (``fused_suite._launch_args``)."""
    out, args = fs._launch_args(hybrid, t, q, rh, p, alevel, blevel, reqs,
                                all_defined)
    assert run(lib, "mf_hlevel_suite" if hybrid else "mf_alevel_suite",
               args) == 0
    return out


def _assert_same(got, ref, label):
    """Masks equal; values equal bit for bit at every point, NaN where
    NaN."""
    assert got.mask_map == ref.mask_map, label
    assert torch.equal(got.masks, ref.masks), (
        label, int((got.masks != ref.masks).sum()))
    g, r = got.values, ref.values
    same = (g.view(torch.int32) == r.view(torch.int32)) | (
        torch.isnan(g) & torch.isnan(r))
    assert bool(same.all()), (label, int((~same).sum()))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("modes", sorted(MODES))
@pytest.mark.parametrize("all_defined", [False, True])
@pytest.mark.parametrize("hybrid", [False, True])
def test_host_suite_matches_plain(host_lib, shape, modes, all_defined,
                                  hybrid):
    """B3 / B4 on ``chip_smoke.make_suite_inputs``: temperatures beyond
    both table ends, p = 0 and p < 0 on the a-level path, and (masked)
    undefined points in every stack, an undefined p and ps point."""
    tk, q, rh, p, ps, al, bl = chip_smoke.make_suite_inputs(
        *shape, seed=sum(shape) + 1,
        undef_frac=0.0 if all_defined else 0.03)
    t, q, rh, p, ps = (from_sentinel(x) for x in (tk, q, rh, p, ps))
    a, b = torch.from_numpy(al), torch.from_numpy(bl)
    reqs = fs._build_reqs("test", *(MODES[modes].get(k, ()) for k in (
        "temps", "hums_q", "hums_rh", "thes", "ducts_q", "ducts_rh")))
    q, rh = fs._check_inputs("test", t, q, rh, reqs)
    if hybrid:
        got = _host_suite(host_lib, True, t, q, rh, ps, a, b, reqs,
                          all_defined)
        ref = fs.hlevel_suite_plain(t, q, rh, ps, a, b, reqs, all_defined)
    else:
        got = _host_suite(host_lib, False, t, q, rh, p, None, None, reqs,
                          all_defined)
        ref = fs.alevel_suite_plain(t, q, rh, p, reqs, all_defined)
    _assert_same(got, ref, (shape, modes, all_defined, hybrid))


def test_host_suite_planted_points_reach_every_branch(host_lib):
    """The planted points do what the test above relies on: out-of-table
    gates, NaN from p < 0 and masked-out undefined p / ps points."""
    tk, q, rh, p, ps, al, bl = chip_smoke.make_suite_inputs(
        3, 37, 61, seed=5, undef_frac=0.03)
    t, q, rh, p, ps = (from_sentinel(x) for x in (tk, q, rh, p, ps))
    reqs = fs._build_reqs("test", **chip_smoke.ALL_MODES)
    out = _host_suite(host_lib, False, t, q, rh, p, None, None, reqs, False)
    temp4 = reqs.index(("temp", 4))
    assert not bool(out.masks[temp4, 0, 0, 0])         # 520 K: no table
    assert not bool(out.masks[temp4, -1, -1, -1])      # 100 K: no table
    assert bool(torch.isnan(out.values[reqs.index(("temp", 3)), -1, -1, 0]))
    hq7 = reqs.index(("hum_rh", 7))
    assert not bool(out.masks[hq7, 0, 18, 30])         # undefined p
    hout = _host_suite(host_lib, True, t, q, rh, ps, torch.from_numpy(al),
                       torch.from_numpy(bl), reqs, False)
    assert not bool(hout.masks[reqs.index(("hum_q", 1)), :, 18, 30].any())
    assert bool(hout.masks[hq7, :, 18, 30].any())      # 7/11 ignore ps


def test_ewt_table_and_search(host_lib):
    tab = np.empty(host_lib.mf_host_ewt_pad(), np.float32)
    host_lib.mf_host_ewt_table(tab.ctypes.data)
    np.testing.assert_array_equal(tab[:N_EWT], EWT)
    assert np.isnan(tab[N_EWT:]).all()
    assert (np.diff(EWT.astype(np.float64)) > 0).all()    # strictly
    f32 = np.float32
    probes = [EWT, np.nextafter(EWT, f32(np.inf)),
              np.nextafter(EWT, f32(-np.inf)),
              np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45,
                        1e-40, np.finfo(f32).tiny, -1.0, 1e35, 2000.0],
                       f32)]
    et = np.concatenate(probes).astype(f32)
    got = np.empty(et.size, np.int32)
    host_lib.mf_host_ewt_count(et.ctypes.data, et.size, got.ctypes.data)
    with np.errstate(invalid="ignore"):
        want = (et[:, None] >= EWT[None, :]).sum(1)     # the 41-step count
    np.testing.assert_array_equal(got, want)
    assert got[np.isnan(et)].tolist() == [0]
    assert got[et == np.inf].tolist() == [N_EWT]
    assert got[:N_EWT].tolist() == list(range(1, N_EWT + 1))


def test_ewt_inverse_shared_equals_constant(host_lib):
    """The inverse on the shared table equals the one on the constant
    table (derived_fields.cu's) for every l the kernels pass."""
    rng = np.random.default_rng(0)
    et = np.concatenate([
        rng.uniform(0.0, 1100.0, 4000), 10.0 ** rng.uniform(-6, 3.1, 4000),
        EWT, np.nextafter(EWT, np.float32(0)),
        [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45]]).astype(np.float32)
    et = np.repeat(et, 3)
    l = rng.integers(-1, 41, et.size).astype(np.int32)
    out = np.empty(et.size, np.float32)
    ref = np.empty(et.size, np.float32)
    host_lib.mf_host_ewt_inverse(et.ctypes.data, l.ctypes.data, et.size,
                                 out.ctypes.data, ref.ctypes.data)
    same = (out.view(np.int32) == ref.view(np.int32)) | (
        np.isnan(out) & np.isnan(ref))
    assert same.all()
