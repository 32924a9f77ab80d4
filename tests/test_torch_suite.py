"""The port's level-conversion suites against the JAX package: the a- and
h-level operators of ``ops/levels.py`` and ``ops/thermo.py``, the suite
kernels' wrappers ``ops/fused_suite.py`` (their plain versions on the CPU)
and the serving entry ``staging.run_hlevel_suite_np``.

Inputs are seeded numpy: temperatures beyond both ends of the saturation
table, scattered undefined points in every stack, undefined surface
pressure points, and a zero and a negative pressure on the a-level path.

Tolerances.  Masks are bitwise equal everywhere.  Against the JAX
functions run op by op, values are bitwise equal (NaN equal to NaN).
Against the JAX suite kernels (``interpret=True``, jitted: XLA:CPU
contracts ``a + b*ps``, the Exner pow's multiply-adds and ``t*pidcp - t0``)
values agree within rtol 2e-5, plus 4 ulps of 273.15 (1.2e-4) absolute on
the outputs in degC (temp 1, hum 5-8), where a contracted multiply-add
rounds once instead of twice next to a 273.15 or 100 offset and the result
may be near zero.  Masks stay bitwise because every saturation gate's
table coordinate is shown to sit well clear of the table's two ends, where
a last-ulp change of the temperature could flip it.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mi_fieldcalc_tpu.ops as jops
from mi_fieldcalc_tpu.field import UNDEF, Field as JField
from mi_fieldcalc_tpu.ops import thermo as jthermo
from mi_fieldcalc_tpu.ops.fused_suite import (
    alevel_suite_fused as j_asuite, hlevel_suite_fused as j_hsuite,
)
from mi_fieldcalc_tpu.staging import run_hlevel_suite_np as j_run_suite
from mi_fieldcalc_tpu_torch import staging
from mi_fieldcalc_tpu_torch.constants import kappa
from mi_fieldcalc_tpu_torch.field import Field, from_arrays
from mi_fieldcalc_tpu_torch.ops import fused_suite, levels, thermo
from test_torch_staging import presampled

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
#: every valid mode of every family, in one request (fused_suite._VALID)
ALL_MODES = dict(temps=(1, 2, 3, 4, 5), hums_q=(1, 2, 5, 6, 9, 10),
                 hums_rh=(3, 4, 7, 8, 11, 12), thes=(1, 2), ducts_q=(1, 2),
                 ducts_rh=(3, 4))
#: outputs in degC, next to a 273.15 / 100 offset
CELSIUS = {("temp", 1)} | {(f, c) for f in ("hum_q", "hum_rh")
                           for c in (5, 6, 7, 8)}
#: 4 ulps of 273.15 in float32
CELSIUS_ATOL = 4 * float(np.spacing(np.float32(273.15)))
#: BASELINE config 2's request set
CONFIG2 = dict(temps=(3, 4), hums_q=(1, 5, 9), hums_rh=(3, 7, 11))


def _stacks(nlev=3, ny=13, nx=37, seed=0, undefs=True):
    """``(values, mask)`` numpy pairs for t, q, rh, p (a pressure field) and
    ps, and the hybrid coefficients."""
    rng = np.random.default_rng(seed)
    shape = (nlev, ny, nx)

    def pair(a, frac=0.04):
        m = (rng.random(a.shape) >= frac) if undefs else np.ones(a.shape,
                                                                 bool)
        return np.where(m, a, np.float32(UNDEF)).astype(np.float32), m

    t = rng.uniform(250.0, 300.0, shape).astype(np.float32)
    t[0, 2, 2] = 520.0            # beyond the table's warm end
    t[1, 3, 3] = 100.0            # beyond its cold end
    p = rng.uniform(300.0, 1000.0, shape).astype(np.float32)
    p[0, 4, 4] = 0.0              # p <= 0: the pow's edges
    p[1, 5, 5] = -5.0
    ps = rng.uniform(950.0, 1030.0, (ny, nx)).astype(np.float32)
    out = {"t": pair(t), "q": pair(rng.uniform(1e-4, 1e-2, shape).astype(
        np.float32)), "rh": pair(rng.uniform(5.0, 95.0, shape).astype(
            np.float32)), "p": pair(p), "ps": pair(ps, 0.03)}
    for k in ("t", "p"):          # keep the planted points defined
        v, m = out[k]
        m[0, 2, 2] = m[1, 3, 3] = m[0, 4, 4] = m[1, 5, 5] = True
        out[k] = (np.where(m, np.where(v == np.float32(UNDEF), 280.0, v),
                           np.float32(UNDEF)).astype(np.float32), m)
    if undefs:
        out["ps"][1][3, 3] = False
        out["ps"][0][3, 3] = np.float32(UNDEF)
    out["al"] = np.linspace(30.0, 0.0, nlev).astype(np.float32)
    out["bl"] = np.linspace(0.02, 1.0, nlev).astype(np.float32)
    return out


def _j(pair):
    return JField(jnp.asarray(pair[0]), jnp.asarray(pair[1]))


def _t(pair):
    return from_arrays(*pair)


def _assert_gates_clear(t, p):
    """Every saturation-table coordinate the suites compute (T-form,
    theta-form ``t * pidcp``, temp 5's ``t * pi / cp``), in float64, is at
    least 1e-3 from the table's ends (x = 0 and x = 40), where a last-ulp
    move of the temperature would flip the gate."""
    t = t.astype(np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        pid = np.where(p > 0, (np.maximum(p, 0) / 1000.0) ** float(kappa),
                       np.nan)
        for tk in (t, t * pid):
            x = (tk - 273.15 + 100.0) * 0.2
            gap = np.nanmin(np.minimum(np.abs(x), np.abs(x - 40.0)))
            assert gap > 1e-3, gap


def _assert_same_values(a: torch.Tensor, b: torch.Tensor) -> None:
    """Equal values and NaN at the same points (NaN payloads may differ
    between the kernel and PyTorch's own operations)."""
    nan = torch.isnan(a)
    assert torch.equal(nan, torch.isnan(b))
    assert torch.equal(a[~nan], b[~nan])


def _assert_fields(got, ref, exact: bool, label="", reqs=None):
    assert len(got) == len(ref)
    for k, (g, r) in enumerate(zip(got, ref)):
        atol = CELSIUS_ATOL if reqs is not None and reqs[k] in CELSIUS \
            else 0.0
        rm = np.asarray(r.mask)
        np.testing.assert_array_equal(g.mask.numpy(), rm,
                                      err_msg=f"{label} {k} mask")
        gv, rv = g.values.numpy()[rm], np.asarray(r.values)[rm]
        if exact:
            np.testing.assert_array_equal(gv, rv, err_msg=f"{label} {k}")
        else:
            np.testing.assert_allclose(gv, rv, rtol=2e-5, atol=atol,
                                       err_msg=f"{label} {k}")


def _a_ref(j, reqs):
    """The JAX a-level operators, op by op, one per request."""
    outs = []
    for fam, c in reqs:
        h = j["rh"] if fam in ("hum_rh", "duct_rh") else j["q"]
        if fam == "temp":
            outs.append(jops.aleveltemp(j["t"], j["p"], compute=c))
        elif fam in ("hum_q", "hum_rh"):
            outs.append(jops.alevelhum(j["t"], h, j["p"], compute=c))
        elif fam == "the":
            outs.append(jops.alevelthe(j["t"], j["q"], j["p"], compute=c))
        else:
            outs.append(jops.alevelducting(j["t"], h, j["p"], compute=c))
    return outs


def _h_ref(j, al, bl, reqs):
    """The JAX per-level hlevel operators, op by op, stacked."""
    fns = {"temp": jops.hleveltemp, "hum_q": jops.hlevelhum,
           "hum_rh": jops.hlevelhum, "the": jops.hlevelthe,
           "duct_q": jops.hlevelducting, "duct_rh": jops.hlevelducting}

    def lvl(f, k):
        return JField(f.values[k], f.mask[k])

    outs = []
    for fam, c in reqs:
        h = j["rh"] if fam in ("hum_rh", "duct_rh") else j["q"]
        per = []
        for k in range(len(al)):
            args = (lvl(j["t"], k),) if fam == "temp" else (
                lvl(j["t"], k), lvl(h, k))
            per.append(fns[fam](*args, j["ps"], float(al[k]), float(bl[k]),
                                compute=c))
        outs.append(JField(jnp.stack([f.values for f in per]),
                           jnp.stack([f.mask for f in per])))
    return outs


def _reqs(modes):
    return fused_suite._build_reqs("test", **{
        k: modes.get(k, ()) for k in ("temps", "hums_q", "hums_rh", "thes",
                                      "ducts_q", "ducts_rh")})


@pytest.mark.parametrize("all_defined", [False, True])
def test_alevel_suite_matches_jax_ops_op_by_op(all_defined):
    a = _stacks(seed=1, undefs=not all_defined)
    got = fused_suite.alevel_suite_fused(
        *(_t(a[k]) for k in ("t", "q", "rh", "p")), all_defined=all_defined,
        **ALL_MODES)
    assert len(got) == 23
    ref = _a_ref({k: _j(a[k]) for k in ("t", "q", "rh", "p")},
                 _reqs(ALL_MODES))
    _assert_fields(got, ref, exact=True)
    if all_defined:     # gate-free outputs share one constant-True mask
        assert got[0].mask is got[1].mask and bool(got[0].mask.all())


@pytest.mark.parametrize("all_defined", [False, True])
def test_alevel_suite_matches_jax_kernel(all_defined):
    a = _stacks(seed=2, undefs=not all_defined)
    _assert_gates_clear(a["t"][0], a["p"][0])
    jf = [_j(a[k]) for k in ("t", "q", "rh", "p")]
    ref = j_asuite(*jf, interpret=True, all_defined=all_defined,
                   **ALL_MODES)
    got = fused_suite.alevel_suite_fused(
        *(_t(a[k]) for k in ("t", "q", "rh", "p")), all_defined=all_defined,
        **ALL_MODES)
    _assert_fields(got, ref, exact=False, reqs=_reqs(ALL_MODES))


@pytest.mark.parametrize("all_defined", [False, True])
def test_hlevel_suite_matches_per_level_ops(all_defined):
    a = _stacks(seed=3, undefs=not all_defined)
    got = fused_suite.hlevel_suite_fused(
        *(_t(a[k]) for k in ("t", "q", "rh", "ps")), a["al"], a["bl"],
        all_defined=all_defined, **ALL_MODES)
    ref = _h_ref({k: _j(a[k]) for k in ("t", "q", "rh", "ps")}, a["al"],
                 a["bl"], _reqs(ALL_MODES))
    _assert_fields(got, ref, exact=True)


@pytest.mark.parametrize("all_defined", [False, True])
def test_hlevel_suite_matches_jax_kernel(all_defined):
    a = _stacks(seed=4, undefs=not all_defined)
    p = (a["al"][:, None, None] + a["bl"][:, None, None]
         * a["ps"][0][None].astype(np.float64))
    _assert_gates_clear(a["t"][0], np.where(a["ps"][1][None], p, 1000.0))
    jf = [_j(a[k]) for k in ("t", "q", "rh", "ps")]
    ref = j_hsuite(*jf, a["al"], a["bl"], interpret=True,
                   all_defined=all_defined, **ALL_MODES)
    got = fused_suite.hlevel_suite_fused(
        *(_t(a[k]) for k in ("t", "q", "rh", "ps")),
        torch.from_numpy(a["al"]), torch.from_numpy(a["bl"]),
        all_defined=all_defined, **ALL_MODES)
    _assert_fields(got, ref, exact=False, reqs=_reqs(ALL_MODES))


def test_hlevelhum_ps_gate_inversion():
    """An undefined ps masks every hlevelhum mode except the
    pressure-independent 7 and 11, which stay defined; the a-level family
    is the inverse (7/11 need a defined p)."""
    a = _stacks(seed=5, undefs=False)
    ps = _t(a["ps"])
    ps.mask[3, 3] = False
    t, q, rh, p = (_t(a[k]) for k in ("t", "q", "rh", "p"))
    out = fused_suite.hlevel_suite_fused(t, q, rh, ps, a["al"], a["bl"],
                                         hums_q=(1, 5), hums_rh=(3, 7, 11))
    col = [bool(f.mask[:, 3, 3].any()) for f in out]
    assert col == [False, False, False, True, True]
    for c, f in zip((1, 5, 3, 7, 11), out):
        per = levels.hlevelhum(Field(t.values[1], t.mask[1]),
                               Field((q if c in (1, 5) else rh).values[1],
                                     (q if c in (1, 5) else rh).mask[1]),
                               ps, float(a["al"][1]), float(a["bl"][1]), c)
        assert torch.equal(per.mask, f.mask[1])
    p.mask[:, 3, 3] = False
    aout = fused_suite.alevel_suite_fused(t, q, rh, p, hums_q=(1,),
                                          hums_rh=(7, 11))
    assert [bool(f.mask[:, 3, 3].any()) for f in aout] == [True, False,
                                                           False]


@pytest.mark.parametrize("family, modes", [
    ("temp", (1, 2, 3, 4, 5)), ("hum", tuple(range(1, 13))),
    ("the", (1, 2)), ("ducting", (1, 2, 3, 4))])
def test_level_operators_match_jax(family, modes):
    """The port's per-level hlevel and a-level operators, every mode,
    against the JAX functions op by op (bitwise)."""
    a = _stacks(seed=6)
    j = {k: _j(a[k]) for k in ("t", "q", "rh", "p", "ps")}
    tt = {k: _t(a[k]) for k in ("t", "q", "rh", "p", "ps")}

    def lvl(f, cls):
        return cls(f.values[1], f.mask[1])

    al, bl = float(a["al"][1]), float(a["bl"][1])
    for c in modes:
        hum = "rh" if (family == "ducting" and c > 2) or (
            family == "hum" and c in (3, 4, 7, 8, 11, 12)) else "q"
        pairs = []
        for o, f, cls in ((jops, j, JField), (levels, tt, Field)):
            h = getattr(o, "h" + ("level" + family if family != "ducting"
                                  else "levelducting"))
            al_op = getattr(o, "a" + ("level" + family if family != "ducting"
                                      else "levelducting"))
            if family == "temp":
                hh = h(lvl(f["t"], cls), f["ps"], al, bl, compute=c)
                aa = al_op(f["t"], f["p"], compute=c)
            else:
                hh = h(lvl(f["t"], cls), lvl(f[hum], cls), f["ps"], al, bl,
                       compute=c)
                aa = al_op(f["t"], f[hum], f["p"], compute=c)
            pairs.append((hh, aa))
        (jh, ja), (th, ta) = pairs
        _assert_fields([th, ta], [jh, ja], exact=True, label=f"{family}{c}")
    if family in ("temp", "hum"):
        unit_modes = (1, 2) if family == "temp" else (5, 6, 9, 10)
        for c in unit_modes:
            for unit in ("celsius", "kelvin"):
                if family == "temp":
                    r = jops.hleveltemp(lvl(j["t"], JField), j["ps"], al, bl,
                                        c, unit=unit)
                    g = levels.hleveltemp(lvl(tt["t"], Field), tt["ps"], al,
                                          bl, c, unit=unit)
                else:
                    r = jops.alevelhum(j["t"], j["q"], j["p"], c, unit=unit)
                    g = levels.alevelhum(tt["t"], tt["q"], tt["p"], c,
                                         unit=unit)
                _assert_fields([g], [r], exact=True, label=f"{c} {unit}")


def test_hlevelpressure_and_thermo_match_jax():
    a = _stacks(seed=7)
    jps, tps = _j(a["ps"]), _t(a["ps"])
    r = jops.hlevelpressure(jps, 20.0, 0.5)
    g = levels.hlevelpressure(tps, 20.0, 0.5)
    _assert_fields([g], [r], exact=True)
    t = a["t"][0][0]
    p = np.where(a["p"][1][0], a["p"][0][0], 500.0).astype(np.float32)
    rh = a["rh"][0][0]
    pi = np.float32(1004.0) * (p / np.float32(1000.0)) ** np.float32(0.286)
    jt, jp, jrh, jpi = (jnp.asarray(x) for x in (t, p, rh, pi))
    tt, tp, trh, tpi = (torch.from_numpy(np.asarray(x, np.float32))
                        for x in (t, p, rh, pi))
    for name, args_j, args_t in (
            ("t_thesat", (jt, jp, jpi), (tt, tp, tpi)),
            ("th_thesat", (jt, jp, jpi), (tt, tp, tpi)),
            ("tk_rh_q", (jt, jrh, jp), (tt, trh, tp)),
            ("tk_rh_td", (jt, jrh, 273.15), (tt, trh, 273.15)),
            ("tk_rh_duct", (jt, jrh, jp), (tt, trh, tp))):
        rv, rok = getattr(jthermo, name)(*args_j)
        gv, gok = getattr(thermo, name)(*args_t)
        np.testing.assert_array_equal(gok.numpy(), np.asarray(rok), name)
        assert not gok.numpy().all(), name      # the out-of-table points
        np.testing.assert_array_equal(gv.numpy()[gok.numpy()],
                                      np.asarray(rv)[np.asarray(rok)], name)


def test_suite_validation_errors():
    """The JAX suites' validation errors, raised before any kernel."""
    a = _stacks(nlev=2, ny=6, nx=7, seed=8)
    t, q, rh, p, ps = (_t(a[k]) for k in ("t", "q", "rh", "p", "ps"))
    for fn, args in ((fused_suite.alevel_suite_fused, (t, q, rh, p)),
                     (fused_suite.hlevel_suite_fused,
                      (t, q, rh, ps, a["al"], a["bl"]))):
        with pytest.raises(ValueError, match="no conversions requested"):
            fn(*args)
        with pytest.raises(ValueError, match="bad temp compute 9"):
            fn(*args, temps=(9,))
        with pytest.raises(ValueError, match="bad hum_rh compute 1"):
            fn(*args, hums_rh=(1,))            # a q-mode in hums_rh
        with pytest.raises(ValueError, match="bad hum_q compute 7"):
            fn(*args, hums_q=(7,))
        with pytest.raises(ValueError, match="bad duct_rh compute 1"):
            fn(*args, ducts_rh=(1,))
        with pytest.raises(ValueError, match="consumes q"):
            fn(t, None, *args[2:], hums_q=(1,))
        with pytest.raises(NotImplementedError, match=fn.__name__):
            fn(*args, temps=(3,), global_shape=(6, 7))
        with pytest.raises(NotImplementedError, match=fn.__name__):
            fn(*args, temps=(3,), grid_offsets=(0, 0))
    with pytest.raises(ValueError, match="bad a/b level"):
        fused_suite.hlevel_suite_fused(t, q, rh, ps, -a["al"] - 1,
                                       a["bl"] * 0 - 1, temps=(3,))
    with pytest.raises(ValueError, match="nlev entries"):
        fused_suite.hlevel_suite_fused(t, q, rh, ps, a["al"][:1],
                                       a["bl"][:1], temps=(3,))
    # the JAX entries raise the same
    with pytest.raises(ValueError, match="bad a/b level"):
        j_hsuite(_j(a["t"]), _j(a["q"]), _j(a["rh"]), _j(a["ps"]),
                 -a["al"] - 1, a["bl"] * 0 - 1, temps=(3,), interpret=True)
    # q and rh are optional where no request reads them; duplicates allowed
    out = fused_suite.alevel_suite_fused(t, None, None, p, temps=(3, 3))
    assert torch.equal(out[0].values, out[1].values)


def test_suite_stacked_layout_and_mask_map():
    """The stacked layout the kernels write: under ``all_defined`` at most
    3 gate planes (T, TH, TH5 in first-use order) and -1 for gate-free
    outputs; ``as_fields`` is the per-request list."""
    a = _stacks(seed=9, undefs=False)
    reqs = _reqs(ALL_MODES)
    args = [_t(a[k]) for k in ("t", "q", "rh", "p")]
    st = fused_suite.alevel_suite_stacked(*args, reqs, all_defined=True)
    assert fused_suite._gate_planes(reqs) == ("T", "TH5", "TH")
    assert st.masks.shape[0] == 3 and st.values.shape[0] == 23
    assert st.mask_map[:5] == (-1, -1, -1, 0, 1)
    masked = fused_suite.alevel_suite_stacked(*args, reqs)
    assert masked.masks.shape[0] == 23
    assert masked.mask_map == tuple(range(23))
    for f, g in zip(st.as_fields(), masked.as_fields()):
        assert torch.equal(f.mask, g.mask)
        _assert_same_values(f.values, g.values)
    st_t = fused_suite.alevel_suite_stacked(*args, _reqs({"temps": (1, 3)}),
                                            all_defined=True)
    assert st_t.masks.shape[0] == 0 and st_t.mask_map == (-1, -1)


def _suite_np(nlev=3, ny=11, nx=23, seed=0, undefs=True):
    rng = np.random.default_rng(seed)
    shape = (nlev, ny, nx)
    tk = rng.uniform(250.0, 300.0, shape).astype(np.float32)
    q = rng.uniform(1e-4, 1e-2, shape).astype(np.float32)
    rh = rng.uniform(5.0, 95.0, shape).astype(np.float32)
    ps = rng.uniform(950.0, 1030.0, (ny, nx)).astype(np.float32)
    tk[0, 1, 1] = 520.0
    if undefs:
        tk[:, ny // 3, nx // 3] = UNDEF
        q[1, 2, 3] = np.nan
        rh[rng.random(shape) < 0.05] = UNDEF
        ps[2, 2] = UNDEF
    al = np.linspace(30.0, 0.0, nlev).astype(np.float32)
    bl = np.linspace(0.02, 1.0, nlev).astype(np.float32)
    return tk, q, rh, ps, al, bl


@pytest.mark.parametrize("undefs", [True, False])
def test_run_hlevel_suite_np_matches_jax(undefs):
    args = _suite_np(seed=int(undefs), undefs=undefs)
    got = staging.run_hlevel_suite_np(*args, device="cpu", **CONFIG2)
    ref = j_run_suite(*args, **CONFIG2)
    assert list(got) == list(ref) == ["temp3", "temp4", "hum_q1", "hum_q5",
                                      "hum_q9", "hum_rh3", "hum_rh7",
                                      "hum_rh11"]
    for name, r in ref.items():
        g = got[name]
        assert g.shape == r.shape and g.dtype == np.float32, name
        undef = r == np.float32(UNDEF)
        np.testing.assert_array_equal(g == np.float32(UNDEF), undef,
                                      err_msg=name)
        if name.startswith("hum"):
            assert undef.any(), name   # the 520 K point at least
        np.testing.assert_array_equal(g[~undef], r[~undef], err_msg=name)


def test_run_hlevel_suite_np_routing_and_arguments():
    """Fully defined requests route to the all-defined path by the decode
    counts; only the consumed stacks are decoded; the stager is reused;
    ``align=True`` gives the pre-resampled request's products; q / rh may be
    None where unread."""
    tk, q, rh, ps, al, bl = _suite_np(seed=4, undefs=False)
    reqs = _reqs(CONFIG2)
    stager = staging.HostStager(3)
    host, all_defined = staging._suite_decode_step(tk, q, rh, ps, al, bl,
                                                   reqs, stager, UNDEF)
    assert all_defined and host[0].shape[0] == 3
    ps2 = ps.copy()
    ps2[0, 0] = UNDEF
    _, all_defined = staging._suite_decode_step(tk, q, rh, ps2, al, bl,
                                                reqs, stager, UNDEF)
    assert not all_defined
    out = staging.run_hlevel_suite_np(tk, None, None, ps, al, bl,
                                      temps=(3, 5), device="cpu")
    assert list(out) == ["temp3", "temp5"]
    stager1 = staging._stager_cache(1, UNDEF)
    buf = stager1.values
    staging.run_hlevel_suite_np(tk, None, None, ps, al, bl, temps=(3,),
                                device="cpu")
    assert stager1.values is buf
    aligned = staging.run_hlevel_suite_np(tk, q, rh, ps, al, bl, temps=(3,),
                                          hums_rh=(3,), align=True,
                                          device="cpu")
    pre = staging.run_hlevel_suite_np(
        *(presampled(a, (16, 128)) for a in (tk, q, rh, ps)), al, bl,
        temps=(3,), hums_rh=(3,), align=False, device="cpu")
    assert list(aligned) == list(pre) == ["temp3", "hum_rh3"]
    for name, a in aligned.items():
        assert a.shape == (3, 16, 128)
        assert a.tobytes() == pre[name].tobytes(), name
    with pytest.raises(ValueError, match="consumes rh"):
        staging.run_hlevel_suite_np(tk, q, None, ps, al, bl, hums_rh=(3,),
                                    device="cpu")
    with pytest.raises(ValueError, match="no conversions requested"):
        staging.run_hlevel_suite_np(tk, q, rh, ps, al, bl, device="cpu")


@pytest.mark.parametrize("bad", ["negative a", "a = b = 0", "b > 1"])
def test_bad_coefficients_same_error_numpy_and_tensor(bad, monkeypatch):
    """The serving entry checks its numpy coefficients on the host before
    the upload and never again from device tensors; a caller of the
    wrapper with tensors gets the same error as the entry."""
    tk, q, rh, ps, al, bl = _suite_np(seed=5)
    k = {"negative a": 0, "a = b = 0": 1, "b > 1": 2}[bad]
    al, bl = al.copy(), bl.copy()
    al[k], bl[k] = {0: (-1.0, bl[k]), 1: (0.0, 0.0), 2: (al[k], 1.5)}[k]
    with pytest.raises(ValueError) as from_numpy:
        staging.run_hlevel_suite_np(tk, q, rh, ps, al, bl, temps=(3,),
                                    device="cpu")
    fields = [from_arrays(np.where(a == UNDEF, 0, a), a != UNDEF)
              for a in (tk, q, rh, ps)]
    with pytest.raises(ValueError) as from_tensors:
        fused_suite.hlevel_suite_fused(*fields, torch.from_numpy(al),
                                       torch.from_numpy(bl), temps=(3,))
    assert str(from_numpy.value) == str(from_tensors.value) == \
        "hlevel_suite_fused: bad a/b level"
    # good numpy coefficients: the staging route never checks them again
    checked = []
    monkeypatch.setattr(fused_suite, "_check_coefficients",
                        lambda *a: checked.append(a))
    staging.run_hlevel_suite_np(tk, q, rh, ps, *_suite_np(seed=5)[4:],
                                temps=(3,), device="cpu")
    assert checked == []


def test_suite_inputs_from_numpy():
    a = _stacks(nlev=2, ny=6, nx=7, seed=10)
    args = fused_suite.suite_inputs_from_numpy(
        (a["t"], None, a["rh"], a["ps"], a["al"], a["bl"]))
    assert args[1] is None and isinstance(args[0], Field)
    assert args[4].dtype == torch.float32 and args[4].shape == (2,)
    with pytest.raises(ValueError, match="4 or 6"):
        fused_suite.suite_inputs_from_numpy((a["t"],))


def test_new_entries_run_without_jax():
    """Every module of the port imports, and the new entries serve, with
    jax unimportable."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "sys.modules['mi_fieldcalc_tpu'] = None\n"
        "import pkgutil, importlib, numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "import mi_fieldcalc_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from mi_fieldcalc_tpu_torch.staging import run_hlevel_suite_np\n"
        "from mi_fieldcalc_tpu_torch.models import derived_fields_isobaric\n"
        "from mi_fieldcalc_tpu_torch.field import from_sentinel\n"
        "rng = np.random.default_rng(0)\n"
        "s = (3, 6, 7)\n"
        "tk = rng.uniform(250, 300, s).astype(np.float32)\n"
        "q = rng.uniform(1e-4, 1e-2, s).astype(np.float32)\n"
        "ps = rng.uniform(950, 1030, s[1:]).astype(np.float32)\n"
        "al = np.linspace(30, 0, 3).astype(np.float32)\n"
        "bl = np.linspace(0.02, 1, 3).astype(np.float32)\n"
        "out = run_hlevel_suite_np(tk, q, None, ps, al, bl, temps=(3,),\n"
        "                          hums_q=(1,), device='cpu')\n"
        "assert list(out) == ['temp3', 'hum_q1']\n"
        "f = [from_sentinel(a) for a in (tk, q, q, q, ps)]\n"
        "m = torch.full(s[1:], 4e-7)\n"
        "iso = derived_fields_isobaric(*f, al, bl, m, m, m,\n"
        "                              plevels=(900.0,), fused=True)\n"
        "assert iso.th.values.shape == (1, 6, 7)\n"
        "assert 'jax' not in [k for k, v in sys.modules.items() if v]\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no CPU mode)")
    return torch.device("cuda")


def _on(dev, a, keys):
    return [from_arrays(*a[k], device=dev) for k in keys]


@pytest.mark.cuda
@pytest.mark.parametrize("hybrid", [False, True])
@pytest.mark.parametrize("all_defined", [False, True])
def test_cuda_suite_kernels_match_plain(cuda_device, hybrid, all_defined):
    a = _stacks(seed=11, undefs=not all_defined)
    reqs = _reqs(ALL_MODES)
    if hybrid:
        t, q, rh, ps = _on(cuda_device, a, ("t", "q", "rh", "ps"))
        co = [torch.from_numpy(a[k]).to(cuda_device) for k in ("al", "bl")]
        entry = fused_suite.hlevel_suite_fused
        before = entry.launches
        got = fused_suite.hlevel_suite_stacked(t, q, rh, ps, *co, reqs,
                                               all_defined)
        ref = fused_suite.hlevel_suite_plain(t, q, rh, ps, *co, reqs,
                                             all_defined)
    else:
        t, q, rh, p = _on(cuda_device, a, ("t", "q", "rh", "p"))
        entry = fused_suite.alevel_suite_fused
        before = entry.launches
        got = fused_suite.alevel_suite_stacked(t, q, rh, p, reqs,
                                               all_defined)
        ref = fused_suite.alevel_suite_plain(t, q, rh, p, reqs, all_defined)
    torch.cuda.synchronize()
    assert entry.launches == before + 1
    assert got.mask_map == ref.mask_map
    assert torch.equal(got.masks, ref.masks)
    for f, r in zip(got.as_fields(), ref.as_fields()):
        _assert_same_values(f.values[f.mask], r.values[r.mask])


@pytest.mark.cuda
def test_cuda_suite_rejects_long_request_lists(cuda_device):
    a = _stacks(nlev=2, ny=6, nx=7, seed=12)
    t, q, rh, p = _on(cuda_device, a, ("t", "q", "rh", "p"))
    with pytest.raises(ValueError, match="at most 32"):
        fused_suite.alevel_suite_fused(t, q, rh, p, temps=(3,) * 33)
