"""The port's vessel icing against the JAX package: the deterministic
``exp_f32`` / ``tanh_f32``, the four operators of ``ops/icing.py``, the
kernel wrappers of ``ops/icing_fused.py`` (their plain versions on the CPU)
and the serving entry ``staging.run_vessel_icing_np``; and the port's four
products against the small icing goldens.

Inputs are seeded numpy: friendly and adversarial ranges (long wave periods
over shallow water drive the wave fixed point to its Newton phase and its
cap), scattered undefined points, ice-covered (gated-off) points, ``vs = 0``
(``vr = c``), and planted ``pw == 0`` (``a = inf``) and ``sal == 0`` (the
closed-form freezing fraction) points.

Tolerances.  ``exp_f32`` and ``tanh_f32`` are bitwise equal to the JAX
functions run op by op.  Masks are bitwise equal everywhere.  Mertins is
exact; Overland agrees within rtol 1e-6 (PyTorch's CPU ``sqrt`` of the
wind speed is not correctly rounded, and the cubic carries the ulp).  The
ModStall and MINCOG solvers agree within rtol 2e-4, atol 1e-5, the
contract the JAX package holds its own kernels to
(``tests/test_icing_fused.py``): their loop bodies run through XLA, which
may contract multiply-adds, so bitwise equality is not the bar against
JAX.  On the card the CUDA kernels equal the plain versions bit for bit
(the ``cuda``-marked tests and ``chip_smoke.py``).
"""

import math
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformance_cases import CASE_BY_NAME, case_inputs
from mi_fieldcalc_tpu import _libm as jlibm
from mi_fieldcalc_tpu.field import UNDEF, from_sentinel as j_from_sentinel
from mi_fieldcalc_tpu.ops import icing as jicing
from mi_fieldcalc_tpu.staging import run_vessel_icing_np as j_run_icing
from mi_fieldcalc_tpu_torch import _libm as tlibm
from mi_fieldcalc_tpu_torch import staging
from mi_fieldcalc_tpu_torch.field import f32, from_sentinel
from mi_fieldcalc_tpu_torch.ops import icing, icing_fused

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "mi_fieldcalc_tpu_torch" / "csrc"
GOLDENS = np.load(REPO / "tests" / "goldens" / "goldens.npz")
#: the operational scalars: 19 heights from 2 to 11 m
SCAL = (5.0, 0.52, 2.0, 11.0)
#: the JAX test's adversarial scalars: vs = 0 makes vr = c
SCAL_VS0 = (0.0, 0.0, 1.0, 4.0)
RTOL, ATOL = 2e-4, 1e-5


def _raw(ny, nx, seed=0, undefs=True, adversarial=False, plant=False):
    """The 11 sentinel inputs of ``tests/test_icing_fused.py``; ``plant``
    adds ``pw == 0`` and ``sal == 0`` points."""
    rng = np.random.default_rng(seed)

    def f(lo, hi):
        x = rng.uniform(lo, hi, (ny, nx)).astype(np.float32)
        if undefs:
            idx = rng.integers(0, x.size, max(1, x.size // 23))
            x.reshape(-1)[idx] = UNDEF
        return x

    sal = f(0.0, 35.0)
    wave = f(0.0 if adversarial else 0.1, 8.0)
    xw, yw = f(-25.0, 25.0), f(-25.0, 25.0)
    at, rh = f(-25.0, 2.0), f(0.3, 1.0)
    sst, p = f(-1.0, 8.0), f(960.0, 1040.0)
    pw = f(6.0, 14.0) if adversarial else f(2.0, 12.0)
    aice = f(0.0, 0.5)
    depth = f(2.0, 40.0) if adversarial else f(5.0, 500.0)
    if plant:
        pw.reshape(-1)[::7] = 0.0
        sal.reshape(-1)[3::11] = 0.0
    return [sal, wave, xw, yw, at, rh, sst, p, pw, aice, depth]


def _both(raw):
    return ([j_from_sentinel(a) for a in raw], [from_sentinel(a) for a in raw])


def _assert_close(got, ref, rtol=RTOL, atol=ATOL, exact=False):
    """Port Field vs JAX Field: masks bitwise, values on defined points."""
    mr = np.asarray(ref.mask)
    np.testing.assert_array_equal(got.mask.numpy(), mr)
    vr = np.asarray(ref.values)[mr]
    vg = got.values.numpy()[mr]
    if exact:
        np.testing.assert_array_equal(vg, vr)
    else:
        np.testing.assert_allclose(vg, vr, rtol=rtol, atol=atol)
    return mr


# ------------------------------------------------------------ exp and tanh

def _sweep() -> np.ndarray:
    rng = np.random.default_rng(0)
    edges = [0.0, -0.0, np.inf, -np.inf, np.nan, -104.0, 89.5, -104.001,
             89.501, 1e-45, -1e-45, 1e-40, -1e-40, 1.17e-38, 0.625, -0.625,
             0.62499, 9.0, -9.0, 9.0001, -9.0001, 3e38, -3e38]
    # odd negative exponents: n = round(x/ln2) = -1, -3, ..., -149
    odd = [-k * math.log(2.0) for k in range(1, 150, 2)]
    return np.concatenate([
        rng.uniform(-120.0, 100.0, 40000), rng.uniform(-2.0, 2.0, 40000),
        rng.normal(0.0, 5.0, 20000), -np.logspace(-8, 2, 5000),
        np.array(edges + odd)]).astype(np.float32)


def _subnormal(a) -> np.ndarray:
    a = np.abs(np.asarray(a, np.float32))
    return (a > 0) & (a < np.float32(1.1754944e-38))


@pytest.mark.parametrize("name", ["exp_f32", "tanh_f32"])
@pytest.mark.parametrize("flush", [False, True])
def test_exp_tanh_match_jax_bitwise(name, flush):
    """Bitwise over the whole range, run op by op.  XLA:CPU flushes
    subnormal operands and results to zero: with ``flush`` the port runs in
    the same mode (``torch.set_flush_denormal``) and every point must
    match; without it, every point whose input and outputs are normal or
    zero must."""
    x = _sweep()
    ref = np.asarray(getattr(jlibm, name)(jnp.asarray(x)))
    torch.set_flush_denormal(flush)
    try:
        got = getattr(tlibm, name)(torch.from_numpy(x)).numpy()
    finally:
        torch.set_flush_denormal(False)
    keep = np.ones(x.shape, bool) if flush else ~(
        _subnormal(x) | _subnormal(got) | _subnormal(ref))
    same = (got.view(np.int32) == ref.view(np.int32)) | (
        np.isnan(got) & np.isnan(ref))
    assert same[keep].all(), x[keep & ~same][:8]
    assert keep.sum() > 100000


def _hex_consts(src: str) -> dict:
    return {m.group(1): float.fromhex(m.group(2)) for m in re.finditer(
        r"constexpr float (k\w+) = (-?0x[0-9a-fA-F.]+p[-+]?\d+)f;", src)}


def _body_hex(src: str, fn: str) -> list:
    """The float hex literals of ``fn``'s body, in order."""
    body = re.search(r"float " + fn + r"\(float x\) \{(.*?)\n\}", src,
                     re.S).group(1)
    return [np.float32(float.fromhex(h)) for h in re.findall(
        r"(-?0x[0-9a-fA-F.]+p[-+]?\d+)f", body)]


def test_kernel_constants_match_the_port():
    """The icing kernel's float literals, and the exp / tanh polynomials
    of the shared header, equal the port's float32 constants bit for
    bit."""
    src = (CSRC / "vessel_icing.cu").read_text()
    common = (CSRC / "common.cuh").read_text()
    assert '#include "common.cuh"' in src
    consts = _hex_consts(src)
    consts.update(_hex_consts(common))
    f = np.float32
    want = {
        "kF1A": 0.6112, "kF1B": 17.67, "kSigma": 5.67e-8, "kTol": 1e-5,
        "kNewtonRel": 2e-5, "kEpsStep": 1.19e-7, "kStall": 3e-5,
        "k1em7": 1e-7, "kTiny": 1e-20, "kOneMinus1em7": 1.0 - 1e-7,
        "kOneMinus1em6": 1.0 - 1e-6, "k1em30": 1e-30,
        "kDecayRatio": 89.5 / 5.17, "kSixth": 1.0 / 6.0, "kRw": 6.46e-5,
        "kC012": 0.012012012, "kDF1": 17.67 * 243.5, "kFloor": 8e-7,
        "kPt2": 0.2, "kTdur0": 0.1230, "kTdur1": 0.7008, "kLwc1": 6.36e-5,
        "k4Pi": 4.0 * math.pi, "kLwc2": 9.5205e-4, "kPt7": 0.7,
        "kLfs": 3.33e5 * 0.7, "kBrine": 54.1126, "kInv07": 1.0 / 0.7,
        "kPt44": 0.44, "kDsb": -54112.6, "k4Sigma": 4.0 * 5.67e-8,
        "kRateScale": 3600.0 * 100.0 / 890.0, "k1em6": 1e-6,
        "kBisectB": 1.3, "kDenA": f(1.0) - f(0.7) * f(-0.5),
        "kDenB": f(1.0) - f(0.7) * f(1.3),
        "kLog2e": 1.44269504088896341}
    for name, value in want.items():
        assert f(consts[name]) == f(value), name
    assert _body_hex(common, "exp_f32") == [f(c) for c in tlibm._EXP_Q]
    assert _body_hex(common, "tanh_f32") == [f(c) for c in tlibm._TANH_P]


# -------------------------------------------------------- the operators

@pytest.mark.parametrize("op", ["overland", "mertins"])
def test_overland_mertins_match_jax(op):
    raw = _raw(23, 37, seed=4)
    jf, tf = _both(raw)
    six = (4, 6, 2, 3, 0, 9)    # airtemp, sst, x_wind, y_wind, sal, aice
    name = f"vessel_icing_{op}"
    ref = getattr(jicing, name)(*[jf[k] for k in six])
    got = getattr(icing, name)(*[tf[k] for k in six])
    m = _assert_close(got, ref, rtol=1e-6, atol=0.0, exact=op == "mertins")
    assert m.any() and not m.all()


@pytest.mark.parametrize("case", [
    ("mincog", 1, False, False, SCAL),
    ("mincog", 2, True, False, SCAL),
    ("mincog", 2, True, False, SCAL_VS0),
    ("mincog", 1, True, True, SCAL),
    ("modstall", None, False, False, SCAL),
    ("modstall", None, True, False, SCAL),
    ("modstall", None, True, True, SCAL_VS0),
], ids=["mincog1", "mincog2-adv", "mincog2-vs0", "mincog1-planted",
        "modstall", "modstall-adv", "modstall-planted-vs0"])
def test_solvers_match_jax(case):
    """The plain solvers against the JAX jnp path (whole-array while
    loops through XLA)."""
    op, alt, adversarial, plant, scal = case
    raw = _raw(40, 64, seed=11 + (alt or 0), adversarial=adversarial,
               plant=plant)
    jf, tf = _both(raw)
    extra = () if alt is None else (alt,)
    ref = getattr(jicing, f"vessel_icing_{op}")(*jf, *scal, *extra)
    got = getattr(icing, f"vessel_icing_{op}")(*tf, *scal, *extra)
    m = _assert_close(got, ref)
    vr = np.asarray(ref.values)[m]
    assert (vr > 0).sum() > 100          # the solvers ran on real lanes
    if plant:
        assert (m & (raw[8] == 0)).any() and (m & (raw[0] == 0)).any()


# --------------------------------------------------------- the wrappers

@pytest.mark.parametrize("alt", [1, 2, None], ids=["mincog1", "mincog2",
                                                    "modstall"])
def test_wrappers_on_cpu_run_the_plain_version(alt):
    """CPU tensors take the plain core: equal to the plain function bit
    for bit, 0 where the gate is off, no launch counted; ``trips``
    records the work behind the kernels' bounds."""
    tf = [from_sentinel(a) for a in _raw(21, 33, seed=5, adversarial=True,
                                          plant=True)]
    trips = {}
    if alt is None:
        entry = icing_fused.vessel_icing_modstall_fused
        got = entry(*tf, *SCAL)
        ref = icing_fused.vessel_icing_modstall_plain(*tf, *SCAL,
                                                      trips=trips)
        op = icing.vessel_icing_modstall(*tf, *SCAL)
    else:
        entry = icing_fused.vessel_icing_mincog_fused
        got = entry(*tf, *SCAL, alt)
        ref = icing_fused.vessel_icing_mincog_plain(*tf, *SCAL, alt,
                                                    trips=trips)
        op = icing.vessel_icing_mincog(*tf, *SCAL, alt)
    assert entry.launches == 0
    assert torch.equal(got.mask, ref.mask) and torch.equal(got.mask, op.mask)
    assert torch.equal(got.values.view(torch.int32),
                       ref.values.view(torch.int32))
    assert (got.values[~got.mask] == 0).all()
    m = op.mask
    assert torch.equal(got.values[m].view(torch.int32),
                       op.values[m].view(torch.int32))
    assert 0 < trips["solved"] <= int(m.sum())
    assert trips["wave_warm"] > 0 and trips["cap"] >= 0
    assert trips["tanh_poly"] + trips["tanh_exp"] >= trips["wave_warm"]
    assert ("height_warm" in trips) == ("height_cap" in trips) == (
        alt is None)
    if alt is not None:
        # every solved lane-height takes exactly one branch
        assert "gate" not in trips and trips["h_root"] > 0
        assert (trips["h_root"] + trips["h_noroot"] + trips["h_sal0"]
                == trips["solved"] * icing._number(*SCAL[2:]))


def test_wrapper_options_and_checks():
    tf = [from_sentinel(a) for a in _raw(5, 7, seed=1)]
    mincog = icing_fused.vessel_icing_mincog_fused
    modstall = icing_fused.vessel_icing_modstall_fused
    with pytest.raises(NotImplementedError):
        mincog(*tf, *SCAL, 1, stack_heights=True)
    with pytest.raises(NotImplementedError):
        modstall(*tf, *SCAL, stack_heights=True)
    with pytest.raises(NotImplementedError):
        modstall(*tf, *SCAL, warm_fp=8)
    for bad in ({"ty": 32}, {"ty": 16, "stack_heights": True}):
        with pytest.raises(ValueError):
            modstall(*tf, *SCAL, **bad)
    with pytest.raises(ValueError):
        mincog(*tf, *SCAL, 1, ty=32)
    # the JAX require checks
    for scal in ((5.0, 0.52, 4.0, 2.0), (5.0, 0.52, 2.0, 4.5),
                 (-1.0, 0.52, 2.0, 4.0), (5.0, -0.1, 2.0, 4.0)):
        for fn in (mincog, icing_fused.vessel_icing_mincog_plain,
                   icing.vessel_icing_mincog):
            with pytest.raises(ValueError):
                fn(*tf, *scal, 1)
        for fn in (modstall, icing_fused.vessel_icing_modstall_plain,
                   icing.vessel_icing_modstall):
            with pytest.raises(ValueError):
                fn(*tf, *scal)
    assert modstall(*tf, *SCAL, warm_fp=0).mask.shape == (5, 7)
    assert mincog.launches == 0 and modstall.launches == 0


# ------------------------------------------------------------ the entry

def _entry_inputs(ny=16, nx=24, seed=2):
    """The JAX staging test's inputs (test_staging.py), undefined points
    in every input."""
    rng = np.random.default_rng(seed)

    def f(lo, hi):
        return rng.uniform(lo, hi, (ny, nx)).astype(np.float32)

    a = [f(30, 36), f(0.5, 6), f(-25, 25), f(-25, 25), f(-25, -3),
         f(40, 95), f(-1, 8), f(960, 1040), f(6, 14), f(0, 0.5),
         f(5, 350)]
    for k, arr in enumerate(a):
        arr[(3 * k) % ny, (5 * k + 1) % nx] = UNDEF
    a[4][2, 2] = np.nan
    return a


_ENTRY_TOL = {"overland": dict(rtol=1e-6, atol=0.0),
              "mertins": dict(rtol=0.0, atol=0.0),
              "modstall": dict(rtol=RTOL, atol=ATOL),
              "mincog": dict(rtol=RTOL, atol=ATOL)}


@pytest.mark.parametrize("alt", [1, 2])
def test_run_vessel_icing_np_matches_jax(alt):
    args = _entry_inputs(seed=alt)
    got = staging.run_vessel_icing_np(*args, *SCAL, alt=alt, device="cpu")
    ref = j_run_icing(*args, *SCAL, alt=alt)
    assert list(got) == list(ref) == list(staging.ICING_PRODUCTS)
    for name, r in ref.items():
        g = got[name]
        assert g.shape == r.shape and g.dtype == np.float32, name
        undef = r == np.float32(UNDEF)
        np.testing.assert_array_equal(g == np.float32(UNDEF), undef,
                                      err_msg=name)
        assert undef.any() and not undef.all()
        np.testing.assert_allclose(g[~undef], r[~undef], err_msg=name,
                                   **_ENTRY_TOL[name])


def test_run_vessel_icing_np_subset_and_checks():
    args = _entry_inputs(seed=3)
    full = staging.run_vessel_icing_np(*args, *SCAL, device="cpu")
    stager = staging._stager_cache(11, UNDEF)
    buf = stager.values
    sub = staging.run_vessel_icing_np(*args, *SCAL, device="cpu",
                                      products=("mincog", "overland"))
    assert stager.values is buf                  # one reused decode block
    assert list(sub) == ["mincog", "overland"]
    for name in sub:
        np.testing.assert_array_equal(sub[name], full[name])
    with pytest.raises(ValueError):
        staging.run_vessel_icing_np(*args, *SCAL, device="cpu",
                                    products=("nope",))
    with pytest.raises(NotImplementedError):
        staging.run_vessel_icing_np(*args, *SCAL, device="cpu", align=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            staging.run_vessel_icing_np(*args, *SCAL)   # device="cuda"


def test_run_vessel_icing_np_empty_requests():
    """No products gives ``{}`` as the JAX entry does; an empty grid gives
    empty products and, through the wrappers, launches nothing."""
    args = _entry_inputs(seed=4)
    assert staging.run_vessel_icing_np(*args, *SCAL, device="cpu",
                                       products=()) == {}
    ref = j_run_icing(*args, *SCAL, products=())
    assert ref == {}
    empty = [np.zeros((0, 6), np.float32)] * 11
    out = staging.run_vessel_icing_np(*empty, *SCAL, device="cpu")
    assert list(out) == list(staging.ICING_PRODUCTS)
    assert all(o.shape == (0, 6) and o.dtype == np.float32
               for o in out.values())
    tf = [from_sentinel(a) for a in empty]
    assert icing_fused.vessel_icing_mincog_fused(*tf, *SCAL, 1).mask.shape \
        == (0, 6)
    assert icing_fused.vessel_icing_modstall_fused(*tf, *SCAL).mask.shape \
        == (0, 6)


def test_icing_entry_runs_without_jax():
    """The icing entry imports and serves with jax unimportable."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "sys.modules['mi_fieldcalc_tpu'] = None\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "import mi_fieldcalc_tpu_torch as m\n"
        "rng = np.random.default_rng(0)\n"
        "a = [rng.uniform(lo, hi, (4, 5)).astype(np.float32) for lo, hi in"
        " ((30, 36), (0.5, 6), (-25, 25), (-25, 25), (-25, -3), (0.4, 0.95),"
        " (-1, 8), (960, 1040), (6, 14), (0, 0.3), (5, 350))]\n"
        "a[4][1, 1] = 1e35\n"
        "out = m.run_vessel_icing_np(*a, 5.0, 0.52, 2.0, 3.0, device='cpu')\n"
        "assert sorted(out) == ['mertins', 'mincog', 'modstall', 'overland']\n"
        "assert all(o[1, 1] == np.float32(1e35) for o in out.values())\n"
        "assert 'jax' not in [k for k, v in sys.modules.items() if v]\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


# ------------------------------------------------------------ goldens

@pytest.mark.parametrize("name", [
    "vesselIcingOverland", "vesselIcingMertins", "vesselIcingModStall",
    "vesselIcingMincog_alt1", "vesselIcingMincog_alt2"])
def test_icing_goldens(name):
    """The small oracle goldens, with each case's own tolerance on the
    points both sides define (``tests/test_conformance.py``'s rule for
    ``mask_exact=False``)."""
    case = CASE_BY_NAME[name]
    fields = [from_sentinel(a) for a in case_inputs(case)]
    s = case.scalars
    if case.op == "vesselIcingOverland":
        out = icing.vessel_icing_overland(*fields)
    elif case.op == "vesselIcingMertins":
        out = icing.vessel_icing_mertins(*fields)
    elif case.op == "vesselIcingModStall":
        out = icing_fused.vessel_icing_modstall_fused(
            *fields, s["vs"], s["alpha"], s["zmin"], s["zmax"])
    else:
        out = icing_fused.vessel_icing_mincog_fused(
            *fields, s["vs"], s["alpha"], s["zmin"], s["zmax"], s["alt"])
    ref = GOLDENS[name + "__out"]
    ref_mask = (ref != np.float32(UNDEF)) & ~np.isnan(ref)
    both = out.mask.numpy() & ref_mask
    assert both.any()
    np.testing.assert_allclose(out.values.numpy()[both], ref[both],
                               rtol=case.rtol, atol=case.atol)


# ---------------------------------------------------- on the card only

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1), (3, 37), (37, 61), (9, 131),
                                   (64, 256)])
@pytest.mark.parametrize("alt", [1, 2, None], ids=["mincog1", "mincog2",
                                                    "modstall"])
def test_cuda_kernels_match_plain(cuda_device, shape, alt):
    """B5 / B6 equal their plain versions bit for bit (NaN where NaN),
    friendly and adversarial inputs with planted pw == 0 and sal == 0."""
    for adversarial in (False, True):
        raw = _raw(*shape, seed=sum(shape), adversarial=adversarial,
                   plant=adversarial)
        tf = [from_sentinel(a, device=cuda_device) for a in raw]
        if alt is None:
            entry = icing_fused.vessel_icing_modstall_fused
            before = entry.launches
            got = entry(*tf, *SCAL)
            ref = icing_fused.vessel_icing_modstall_plain(*tf, *SCAL)
        else:
            entry = icing_fused.vessel_icing_mincog_fused
            before = entry.launches
            got = entry(*tf, *SCAL, alt)
            ref = icing_fused.vessel_icing_mincog_plain(*tf, *SCAL, alt)
        torch.cuda.synchronize()
        assert entry.launches == before + 1
        assert torch.equal(got.mask, ref.mask)
        g, r = got.values, ref.values
        same = (g == r) | (torch.isnan(g) & torch.isnan(r))
        assert bool(same.all()), float((g - r).abs()[~same].max())
