"""The port's vertical interpolation and isobaric pipeline against the JAX
package: ``_libm.log_f32``, ``ops/vertical.py``, the column-interpolation
kernel's wrapper ``ops/vertical_fused.py`` (its plain version on the CPU)
and ``models.derived_fields_isobaric``.

Tolerances.  Masks are bitwise equal everywhere.  ``log_f32`` is bitwise
equal to the JAX function run op by op.  The port takes ln p through
``log_f32`` where the JAX functions call ``jnp.log``, so interpolated values
carry that last-ulp difference through the weight: against the JAX
operator (run op by op) they agree within rtol 2e-5, against the JAX
kernel (``interpret=True``, jitted) within rtol 2e-5 / atol 1e-6.  The
jitted kernel contracts ``a + b*ps`` into an FMA, which could move a
bracket test where a target sits within an ulp of a level, so those tests
assert that no target comes within 4 ulps of any level.  At 137 levels the
ln p brackets are ~0.008 wide and one ulp of the log moves the weight by
~1e-4, so that stack is held to float64 truth within 1e-3, as the JAX
package's own test does.  The isobaric pipeline keeps the pipeline
kernel's terms (``test_torch_fused.py``): rtol 2e-5 on the 7 elementwise
planes and ``2e-5*|ref| + 2e-6*max|ref|`` on the
5 stencil planes, against a JAX reference whose interpolation takes the
same deterministic log (with the backend log the TFP plane, a derivative
of |grad T|, amplifies the weights' last-ulp difference past that term).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mi_fieldcalc_tpu import _libm as jlibm
from mi_fieldcalc_tpu.field import Field as JField, UNDEF
from mi_fieldcalc_tpu.field import from_sentinel as j_from_sentinel
from mi_fieldcalc_tpu.models.pipeline import (
    derived_fields_isobaric as j_isobaric,
)
from mi_fieldcalc_tpu.ops import hlevel_to_plevel as j_h2p
from mi_fieldcalc_tpu.ops.vertical_fused import (
    hlevel_to_plevel_fused as j_h2p_fused,
)
from mi_fieldcalc_tpu_torch import _libm as tlibm
from mi_fieldcalc_tpu_torch.field import Field, from_arrays
from mi_fieldcalc_tpu_torch.models import (
    DerivedFields, STANDARD_PLEVELS, derived_fields_isobaric,
    inputs_from_numpy,
)
from mi_fieldcalc_tpu_torch.ops import fused_suite, vertical_fused
from mi_fieldcalc_tpu_torch.ops.vertical import (
    hlevel_to_plevel, plevel_interp,
)

torch.set_num_threads(1)

CSRC = Path(vertical_fused.__file__).resolve().parent.parent / "csrc"
STENCIL = ("vort", "div", "tadv", "gradt", "tfp")
TARGETS = (1000.0, 925.0, 850.0, 500.0, 100.0, 50.0)


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def _t(f) -> Field:
    """A JAX Field carried into the port."""
    return from_arrays(np.asarray(f.values), np.asarray(f.mask))


def _column_inputs(nlev=13, ny=21, nx=37, seed=5, undefs=True):
    """The JAX package's interpolation test inputs (test_vertical.py):
    sorted random hybrid coefficients, ps in 900..1050 hPa, 3 fields
    around 280, 15% undefined points and one undefined ps point."""
    rng = np.random.default_rng(seed)
    al = np.sort(rng.uniform(0, 300, nlev)).astype(np.float32)
    bl = np.sort(rng.uniform(0, 1, nlev)).astype(np.float32)
    psv = rng.uniform(900, 1050, (ny, nx)).astype(np.float32)
    if undefs:
        psv[2, 3] = UNDEF
    fields = []
    for _ in range(3):
        fv = rng.normal(280, 10, (nlev, ny, nx)).astype(np.float32)
        if undefs:
            fv[rng.random((nlev, ny, nx)) < 0.15] = UNDEF
        fields.append(j_from_sentinel(fv))
    return fields, j_from_sentinel(psv), al, bl


def _jax_field(f: Field):
    """A port Field carried into the JAX package."""
    return JField(jnp.asarray(f.values.numpy()), jnp.asarray(f.mask.numpy()))


def _assert_clear_of_levels(al, bl, ps, targets, ulps=4):
    """No target within ``ulps`` ulps (of 1024 hPa) of any level's
    pressure, computed exactly in float64, so that no rounding of
    ``a + b*ps`` (fused or not) can move a bracket test."""
    p64 = (np.asarray(al, np.float64)[:, None, None]
           + np.asarray(bl, np.float64)[:, None, None]
           * np.asarray(ps, np.float64)[None])
    gap = min(float(np.min(np.abs(p64 - t))) for t in targets)
    assert gap > ulps * float(np.spacing(np.float32(1024.0))), gap


def test_log_f32_bitwise():
    """Normal floats from the smallest to the largest, zeros, negatives,
    infinities and NaN through the port's and the JAX package's log_f32
    (op by op): the same bits."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.uniform(1e-3, 2000.0, 50_000),
        np.geomspace(1.1754944e-38, 3.4e38, 20_000),
        -np.geomspace(1e-30, 1e30, 100),
        [0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, 2.0, 0.5, 1e35, 1000.0],
    ]).astype(np.float32)
    got = tlibm.log_f32(torch.from_numpy(x)).numpy()
    ref = np.asarray(jlibm.log_f32(jnp.asarray(x)))
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    pos = x[:70_000].astype(np.float64)
    assert np.max(np.abs(got[:70_000] - np.log(pos))
                  / np.maximum(np.abs(np.log(pos)), 1.0)) < 3e-7
    assert got[-10] == -np.inf and got[-8] == np.inf
    assert np.isnan(got[-7]) and np.isnan(got[-9 - 100])


@pytest.mark.parametrize("log_p", [True, False])
def test_hlevel_to_plevel_matches_jax_op_by_op(log_p):
    fields, ps, al, bl = _column_inputs()
    for f in fields:
        ref = j_h2p(f, ps, al, bl, TARGETS, log_p=log_p)
        got = hlevel_to_plevel(_t(f), _t(ps), al, bl, TARGETS, log_p=log_p)
        rm = np.asarray(ref.mask)
        np.testing.assert_array_equal(got.mask.numpy(), rm)
        assert rm.any() and not rm.all()
        np.testing.assert_allclose(got.values.numpy()[rm],
                                   np.asarray(ref.values)[rm], rtol=2e-5)


VARIANTS = ("packed", "inplace", "carrysel")


def _assert_matches_jax_kernel(got, ref, all_defined):
    if all_defined:
        assert all(g.mask is got[0].mask for g in got)   # one shared plane
    for g, r in zip(got, ref):
        rm = np.asarray(r.mask)
        np.testing.assert_array_equal(g.mask.numpy(), rm)
        assert rm.any() and not rm.all()
        np.testing.assert_allclose(g.values.numpy()[rm],
                                   np.asarray(r.values)[rm], rtol=2e-5,
                                   atol=1e-6)
        # unbracketed lanes are 0, as the kernel writes them
        assert not g.values.numpy()[~rm & (np.asarray(r.values) == 0)].any()


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("log_p", [True, False])
@pytest.mark.parametrize("all_defined", [False, True])
def test_fused_plain_matches_jax_kernel(log_p, all_defined, variant):
    """The kernel's plain version against the JAX kernel of the same
    variant name (``interpret=True``), masked with undefs in fields and
    ps, and ``all_defined`` on fully defined inputs."""
    fields, ps, al, bl = _column_inputs(seed=5 + all_defined,
                                        undefs=not all_defined)
    _assert_clear_of_levels(al, bl, np.asarray(ps.values), TARGETS)
    ref = j_h2p_fused(tuple(fields), ps, al, bl, TARGETS, log_p=log_p,
                      interpret=True, variant=variant,
                      all_defined=all_defined)
    got = vertical_fused.hlevel_to_plevel_fused(
        tuple(_t(f) for f in fields), _t(ps), torch.from_numpy(al),
        torch.from_numpy(bl), TARGETS, log_p=log_p, variant=variant,
        all_defined=all_defined)
    _assert_matches_jax_kernel(got, ref, all_defined)


@pytest.mark.parametrize("all_defined", [False, True])
def test_fused_33_fields_inplace_matches_jax_kernel(all_defined):
    """More fields than one launch takes (33 > 31) with
    ``variant="inplace"``, the one JAX variant that accepts them, against
    the JAX kernel at 6 levels x 8x16 -> 3 targets: masks bitwise, values
    within rtol 2e-5 / atol 1e-6 on defined points."""
    nlev, ny, nx, nvar = 6, 8, 16, 33
    rng = np.random.default_rng(33 + all_defined)
    al = np.sort(rng.uniform(0, 300, nlev)).astype(np.float32)
    bl = np.sort(rng.uniform(0, 1, nlev)).astype(np.float32)
    psv = rng.uniform(900, 1050, (ny, nx)).astype(np.float32)
    if not all_defined:
        psv[2, 3] = UNDEF
    fields = []
    for v in range(nvar):
        fv = rng.normal(280 + v, 10, (nlev, ny, nx)).astype(np.float32)
        if not all_defined:
            fv[rng.random((nlev, ny, nx)) < 0.15] = UNDEF
        fields.append(j_from_sentinel(fv))
    ps = j_from_sentinel(psv)
    targets = (950.0, 700.0, 400.0)
    _assert_clear_of_levels(al, bl, psv, targets)
    ref = j_h2p_fused(tuple(fields), ps, al, bl, targets, interpret=True,
                      variant="inplace", all_defined=all_defined)
    got = vertical_fused.hlevel_to_plevel_fused(
        tuple(_t(f) for f in fields), _t(ps), torch.from_numpy(al),
        torch.from_numpy(bl), targets, variant="inplace",
        all_defined=all_defined)
    assert len(got) == nvar
    _assert_matches_jax_kernel(got, ref, all_defined)


def _non_monotone_inputs(nlev=9, ny=4, nx=5):
    """Hybrid coefficients whose column is monotone for ps ~ 1000 hPa but
    not at one point with ps = 50 hPa: p = 10, 60, 55, 70, ..."""
    al = np.array([10, 60, 50, 60, 80, 100, 120, 100, 50], np.float32)
    bl = np.array([0, 0, 0.1, 0.2, 0.3, 0.45, 0.6, 0.8, 1.0], np.float32)
    rng = np.random.default_rng(3)
    psv = rng.uniform(980, 1030, (ny, nx)).astype(np.float32)
    psv[1, 2] = 50.0
    f = rng.normal(0.0, 1.0, (nlev, ny, nx)).astype(np.float32)
    return al, bl, psv, f


def test_fused_plain_non_monotone_column_last_bracket_wins():
    al, bl, psv, f = _non_monotone_inputs()
    targets = (57.0, 500.0, 850.0)
    p_col = al + bl * psv[1, 2]
    assert np.any(np.diff(p_col) < 0)
    _assert_clear_of_levels(al, bl, psv, targets)
    jf, jps = j_from_sentinel(f), j_from_sentinel(psv)
    ref = j_h2p_fused((jf,), jps, al, bl, targets, interpret=True)
    (got,) = vertical_fused.hlevel_to_plevel_fused(
        (_t(jf),), _t(jps), torch.from_numpy(al), torch.from_numpy(bl),
        targets)
    rm = np.asarray(ref[0].mask)
    np.testing.assert_array_equal(got.mask.numpy(), rm)
    np.testing.assert_allclose(got.values.numpy()[rm],
                               np.asarray(ref[0].values)[rm], rtol=2e-5,
                               atol=1e-6)
    # 57 hPa lies in both (10, 60) and (55, 70): the last one is used
    ks = [k for k in range(len(al) - 1)
          if p_col[k] <= 57.0 < p_col[k + 1]]
    assert ks == [0, 2] and bool(got.mask[0, 1, 2])
    x0, x1 = np.log(p_col[2]), np.log(p_col[3])
    w = (np.log(57.0) - x0) / (x1 - x0)
    want = f[2, 1, 2] + (f[3, 1, 2] - f[2, 1, 2]) * w
    assert abs(float(got.values[0, 1, 2]) - want) < 1e-5


def test_tall_stack_against_float64_truth():
    """137 levels: the operator and the kernel's plain version each within
    1e-3 of the float64 interpolation (no JAX call)."""
    nlev, ny, nx = 137, 9, 150
    rng = np.random.default_rng(9)
    al = np.linspace(50.0, 0.0, nlev).astype(np.float32)
    bl = np.linspace(0.05, 1.0, nlev).astype(np.float32)
    psv = rng.uniform(950, 1030, (ny, nx)).astype(np.float32)
    fv = rng.normal(0, 1, (nlev, ny, nx)).astype(np.float32)
    targets = (850.0, 500.0, 70.0)
    f = Field(torch.from_numpy(fv), torch.ones(fv.shape, dtype=torch.bool))
    ps = Field(torch.from_numpy(psv), torch.ones(psv.shape,
                                                 dtype=torch.bool))
    op = hlevel_to_plevel(f, ps, al, bl, targets)
    (kp,) = vertical_fused.hlevel_to_plevel_plain(
        (f,), ps, torch.from_numpy(al), torch.from_numpy(bl), targets)
    rm = op.mask.numpy()
    np.testing.assert_array_equal(kp.mask.numpy(), rm)
    pv64 = (al.astype(np.float64)[:, None, None]
            + bl.astype(np.float64)[:, None, None] * psv.astype(np.float64))
    fv64 = fv.astype(np.float64)
    checked = 0
    for t, tgt in enumerate(targets):
        cnt = (pv64 <= tgt).sum(axis=0)
        k = np.clip(cnt - 1, 0, nlev - 2)
        p0 = np.take_along_axis(pv64, k[None], 0)[0]
        p1 = np.take_along_axis(pv64, k[None] + 1, 0)[0]
        w = (np.log(tgt) - np.log(p0)) / (np.log(p1) - np.log(p0))
        f0 = np.take_along_axis(fv64, k[None], 0)[0]
        f1 = np.take_along_axis(fv64, k[None] + 1, 0)[0]
        truth = f0 + (f1 - f0) * w
        if not rm[t].any():          # 70 hPa sits above the model top
            continue
        for out in (op, kp):
            err = np.abs(out.values.numpy()[t] - truth)[rm[t]]
            assert err.max() < 1e-3, (t, err.max())
        checked += 1
    assert checked == 2


def _isobaric_inputs(nlev=6, ny=24, nx=40, seed=11, undefs=True):
    """The JAX package's isobaric test inputs (test_vertical.py) with an
    undefined temperature point and an undefined ps point."""
    rng = np.random.default_rng(seed)
    tk = rng.normal(275, 10, (nlev, ny, nx)).astype(np.float32)
    q = rng.uniform(1e-4, 1e-2, (nlev, ny, nx)).astype(np.float32)
    u = rng.normal(0, 10, (nlev, ny, nx)).astype(np.float32)
    v = rng.normal(0, 10, (nlev, ny, nx)).astype(np.float32)
    ps = rng.uniform(980, 1030, (ny, nx)).astype(np.float32)
    if undefs:
        tk[2, 5, 5] = UNDEF
        ps[3, 3] = UNDEF
    al = np.linspace(30.0, 0.0, nlev).astype(np.float32)
    bl = np.linspace(0.02, 1.0, nlev).astype(np.float32)
    xm = np.full((ny, nx), 4e-7, np.float32)
    ym = np.full((ny, nx), 4e-7, np.float32)
    fc = np.full((ny, nx), 1.2e-4, np.float32)
    jargs = tuple(j_from_sentinel(a) for a in (tk, q, u, v, ps)) + tuple(
        jnp.asarray(a) for a in (al, bl, xm, ym, fc))
    nargs = [(np.asarray(f.values), np.asarray(f.mask)) for f in jargs[:5]]
    return jargs, nargs + [al, bl, xm, ym, fc]


def _assert_pipeline_close(got, ref, names=DerivedFields._fields):
    for name in DerivedFields._fields:
        g, r = getattr(got, name), getattr(ref, name)
        rm = np.asarray(r.mask)
        np.testing.assert_array_equal(g.mask.numpy(), rm, err_msg=name)
        if name not in names:
            continue
        rv = np.asarray(r.values)[rm]
        atol = 2e-6 * float(np.abs(rv).max()) if name in STENCIL else 0.0
        np.testing.assert_allclose(g.values.numpy()[rm], rv, rtol=2e-5,
                                   atol=atol, err_msg=name)


class _JnpWithLogF32:
    """``jax.numpy`` with ``log`` replaced by the JAX package's own
    deterministic ``_libm.log_f32``, for the two interpolation modules."""

    log = staticmethod(jlibm.log_f32)

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture
def jax_interp_log_f32(monkeypatch):
    """Run the JAX interpolation (``vertical.py``, ``vertical_fused.py``)
    with ``log_f32`` in place of the backend ``jnp.log``: the port takes ln
    p through ``log_f32`` on purpose, and the TFP plane (a derivative of
    |grad T|) turns that last-ulp difference in the weights into up to
    2.5x the pipeline's stencil term at these seeds.  Jit caches are cleared on
    both sides of the swap so no trace crosses it."""
    import mi_fieldcalc_tpu.ops.vertical as jv
    import mi_fieldcalc_tpu.ops.vertical_fused as jvf

    jax.clear_caches()
    for mod in (jv, jvf):
        monkeypatch.setattr(mod, "jnp", _JnpWithLogF32())
    yield
    monkeypatch.undo()
    jax.clear_caches()


@pytest.mark.parametrize("fused", [True, False])
def test_isobaric_matches_jax(fused, jax_interp_log_f32):
    """``fused=True`` against the JAX fused path (both kernels,
    ``interpret``, jitted), ``fused=False`` against the JAX composition run
    op by op, at 6x24x40 with 2 surfaces and undefs; the JAX interpolation
    takes the same deterministic log as the port."""
    plv = (850.0, 700.0)
    jargs, nargs = _isobaric_inputs()
    _assert_clear_of_levels(nargs[5], nargs[6], nargs[4][0], plv)
    ref = j_isobaric(*jargs, plevels=plv, fused=fused)
    got = derived_fields_isobaric(*inputs_from_numpy(nargs), plevels=plv,
                                  fused=fused)
    assert isinstance(got, DerivedFields)
    assert got.th.values.shape == (2, 24, 40)
    assert not got.th.mask.all() and got.th.mask.any()
    _assert_pipeline_close(got, ref)


@pytest.mark.parametrize("fused", [True, False])
def test_isobaric_matches_jax_backend_log(fused):
    """Against the JAX package as it stands (backend ``jnp.log``): masks
    bitwise on all 12 outputs, the 7 elementwise planes within rtol 2e-5;
    the stencil planes are held by :func:`test_isobaric_matches_jax`."""
    plv = (850.0, 700.0)
    jargs, nargs = _isobaric_inputs(seed=13)
    _assert_clear_of_levels(nargs[5], nargs[6], nargs[4][0], plv)
    ref = j_isobaric(*jargs, plevels=plv, fused=fused)
    got = derived_fields_isobaric(*inputs_from_numpy(nargs), plevels=plv,
                                  fused=fused)
    _assert_pipeline_close(
        got, ref, names=[n for n in DerivedFields._fields
                         if n not in STENCIL])


def test_isobaric_layouts_and_all_defined():
    """The stacked layout is the per-field one; ``all_defined`` on fully
    defined inputs gives the masked path's result; the surfaces below the
    ground and above the top are masked."""
    plv = (1000.0, 850.0, 5.0)
    _, nargs = _isobaric_inputs(seed=12, undefs=False)
    args = inputs_from_numpy(nargs)
    per_field = derived_fields_isobaric(*args, plevels=plv, fused=True)
    stacked = derived_fields_isobaric(*args, plevels=plv, fused=True,
                                      stacked=True)
    fast = derived_fields_isobaric(*args, plevels=plv, fused=True,
                                   all_defined=True)
    assert stacked.values.shape == (12, 3, 24, 40)
    for i, name in enumerate(DerivedFields._fields):
        a, b, c = per_field[i], stacked.field(i), fast[i]
        assert torch.equal(a.mask, b.mask) and torch.equal(a.mask, c.mask)
        m = a.mask
        assert torch.equal(a.values[m], b.values[m]), name
        assert torch.equal(a.values[m], c.values[m]), name
    th = per_field.th.mask
    assert not th[2].any() and th[1].all()          # 5 hPa: above the top
    assert th[0].any() and not th[0].all()          # 1000 hPa: some below
    assert STANDARD_PLEVELS[0] == 1000.0 and len(STANDARD_PLEVELS) == 11


def test_isobaric_and_interp_argument_errors():
    _, nargs = _isobaric_inputs(nlev=3, ny=8, nx=8)
    args = inputs_from_numpy(nargs)
    with pytest.raises(ValueError, match="require fused=True"):
        derived_fields_isobaric(*args, stacked=True)
    with pytest.raises(NotImplementedError, match="derived_fields_isobaric"):
        derived_fields_isobaric(*args, fused=True, global_shape=(8, 8))
    tk, ps = args[0], args[4]
    # above 31 fields only "inplace", as the JAX function rules
    many = vertical_fused.hlevel_to_plevel_fused(
        (tk,) * 32, ps, args[5], args[6], (500.0,), variant="inplace")
    assert len(many) == 32
    for variant in ("packed", "carrysel", "nope"):
        with pytest.raises(ValueError, match="at most 31 fields"):
            vertical_fused.hlevel_to_plevel_fused(
                (tk,) * 32, ps, args[5], args[6], (500.0,), variant=variant)
        with pytest.raises(ValueError, match="at most 31 fields"):
            j_h2p_fused((_jax_field(tk),) * 32, _jax_field(ps),
                        args[5].numpy(), args[6].numpy(), (500.0,),
                        interpret=True, variant=variant)
    with pytest.raises(ValueError, match="bad variant 'nope'"):
        vertical_fused.hlevel_to_plevel_fused(
            (tk,), ps, args[5], args[6], (500.0,), variant="nope")
    with pytest.raises(ValueError, match="no targets"):
        vertical_fused.hlevel_to_plevel_fused((tk,), ps, args[5], args[6],
                                              ())
    with pytest.raises(ValueError, match="ps must be"):
        vertical_fused.hlevel_to_plevel_fused((tk,), tk, args[5], args[6],
                                              (500.0,))
    with pytest.raises(ValueError, match="no targets"):
        plevel_interp(tk, tk, ())
    # the TPU tuning arguments are accepted and change nothing
    a = vertical_fused.hlevel_to_plevel_fused(
        (tk,), ps, args[5], args[6], (900.0,), interpret=True, ty=16,
        unroll=1)
    b = vertical_fused.hlevel_to_plevel_fused((tk,), ps, args[5], args[6],
                                              (900.0,))
    assert torch.equal(a[0].values, b[0].values)


def _hex_consts(src: str) -> dict:
    return {m.group(1): float.fromhex(m.group(2)) for m in re.finditer(
        r"constexpr float (k\w+) = (-?0x[0-9a-fA-F.]+p[-+]?\d+)f;", src)}


def test_kernel_sources_match_the_port():
    """What the CUDA sources hard-code and the wrappers rely on: the log's
    constants, the interpolation kernel's limits and the suite kernel's
    family and gate codes."""
    consts = _hex_consts((CSRC / "common.cuh").read_text())
    for name, value in (("kLn2Hi", 0.693359375), ("kLn2Lo", -2.12194440e-4),
                        ("kCent", 0.01), ("kMinNormal", 1.1754944e-38)):
        assert np.float32(consts[name]) == np.float32(value), name
    interp = (CSRC / "vertical_interp.cu").read_text()
    for name, value in (("kGroupVars", vertical_fused._GROUP_VARS),
                        ("kMaxLev", vertical_fused._MAX_LEV),
                        ("kMaxTargets", vertical_fused._MAX_TARGETS)):
        assert re.search(rf"constexpr int {name} = (\d+);",
                         interp).group(1) == str(value), name
    suite = (CSRC / "level_suite.cu").read_text()
    fams = re.search(r"enum Family \{([^}]*)\}", suite).group(1)
    order = [t.split("=")[0].strip() for t in fams.split(",")]
    assert order == ["kTemp", "kHumQ", "kHumRh", "kThe", "kDuctQ",
                     "kDuctRh"]
    assert list(fused_suite._FAMILY_CODE.values()) == list(range(6))
    assert list(fused_suite._FAMILY_CODE) == list(fused_suite._VALID)
    gates = re.search(r"enum Gate \{([^}]*)\}", suite).group(1)
    assert gates.replace(" ", "") == "kGateT=0,kGateTH=1,kGateTH5=2"
    assert fused_suite._GATE_SLOT == {"T": 0, "TH": 1, "TH5": 2}
    assert re.search(r"constexpr int kMaxReq = (\d+);", suite).group(1) \
        == str(fused_suite._MAX_REQ)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("log_p", [True, False])
@pytest.mark.parametrize("all_defined", [False, True])
def test_cuda_interp_kernel_matches_plain(cuda_device, log_p, all_defined):
    fields, ps, al, bl = _column_inputs(undefs=not all_defined)
    dev = cuda_device
    tf = tuple(from_arrays(np.asarray(f.values), np.asarray(f.mask), dev)
               for f in fields)
    tps = from_arrays(np.asarray(ps.values), np.asarray(ps.mask), dev)
    a, b = torch.from_numpy(al).to(dev), torch.from_numpy(bl).to(dev)
    before = vertical_fused.hlevel_to_plevel_fused.launches
    got = vertical_fused.hlevel_to_plevel_fused(
        tf, tps, a, b, TARGETS, log_p=log_p, all_defined=all_defined)
    torch.cuda.synchronize()
    assert vertical_fused.hlevel_to_plevel_fused.launches == before + 1
    ref = vertical_fused.hlevel_to_plevel_plain(
        tf, tps, a, b, TARGETS, log_p=log_p, all_defined=all_defined)
    for g, r in zip(got, ref):
        assert torch.equal(g.mask, r.mask)
        assert torch.equal(g.values, r.values)


@pytest.mark.cuda
def test_cuda_interp_kernel_non_monotone(cuda_device):
    al, bl, psv, f = _non_monotone_inputs()
    dev = cuda_device
    ff = Field(torch.from_numpy(f).to(dev),
               torch.ones(f.shape, dtype=torch.bool, device=dev))
    ps = Field(torch.from_numpy(psv).to(dev),
               torch.ones(psv.shape, dtype=torch.bool, device=dev))
    a, b = torch.from_numpy(al).to(dev), torch.from_numpy(bl).to(dev)
    targets = (57.0, 500.0, 850.0)
    (got,) = vertical_fused.hlevel_to_plevel_fused((ff,), ps, a, b, targets)
    (ref,) = vertical_fused.hlevel_to_plevel_plain((ff,), ps, a, b, targets)
    assert torch.equal(got.mask, ref.mask)
    assert torch.equal(got.values, ref.values)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("all_defined", [False, True])
def test_cuda_interp_kernel_40_fields(cuda_device, variant, all_defined):
    """40 fields: under "inplace" two launches (31 + 9 fields), bit for
    bit the plain version; "packed" and "carrysel" refuse them."""
    dev = cuda_device
    fields, ps, al, bl = _column_inputs(undefs=not all_defined)
    tf = tuple(from_arrays(np.asarray(fields[v % 3].values) + v,
                           np.roll(np.asarray(fields[v % 3].mask), v, -1),
                           device=dev) for v in range(40))
    tps = from_arrays(np.asarray(ps.values), np.asarray(ps.mask), device=dev)
    a, b = torch.from_numpy(al).to(dev), torch.from_numpy(bl).to(dev)
    if variant != "inplace":
        with pytest.raises(ValueError, match="at most 31 fields"):
            vertical_fused.hlevel_to_plevel_fused(tf, tps, a, b, TARGETS,
                                                  variant=variant)
        return
    before = vertical_fused.hlevel_to_plevel_fused.launches
    got = vertical_fused.hlevel_to_plevel_fused(
        tf, tps, a, b, TARGETS, variant=variant, all_defined=all_defined)
    torch.cuda.synchronize()
    assert vertical_fused.hlevel_to_plevel_fused.launches == before + 2
    ref = vertical_fused.hlevel_to_plevel_plain(
        tf, tps, a, b, TARGETS, all_defined=all_defined)
    for g, r in zip(got, ref):
        assert torch.equal(g.mask, r.mask)
        assert torch.equal(g.values, r.values)
