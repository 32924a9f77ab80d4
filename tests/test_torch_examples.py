"""The port's end-to-end tour (``examples/forecast_products_torch.py``)
against the JAX tour (``examples/forecast_products.py``), and the Field
constructors' ``dtype`` against the JAX constructors.

The tour runs on the CPU (``main("cpu")``, the kernels' plain versions) at
the JAX tour's own size, 10x96x128, and every number it returns is held
to the JAX tour's same call on the same state: the JAX ``synthetic_state``,
its drop-in api calls, the jitted ``derived_fields`` and
``derived_fields_isobaric``, ``run_hlevel_suite_np``, its ``batch()``
storms and ``run_derived_fields_np(align=True)``.  Values within rtol 2e-5
(the port against jitted JAX), undefined counts, the suite's keys and the
aligned product grid equal.  The sharded section has no JAX number
here: it must agree with the single-device vorticity, on one process.

Tolerances of the constructors: masks and values bit for bit, float32 and
bfloat16 (NaN where NaN).
"""

import importlib.util
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mi_fieldcalc_tpu import field as jfield
from mi_fieldcalc_tpu_torch import field as tfield

torch.set_num_threads(1)

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tours():
    return _load("forecast_products"), _load("forecast_products_torch")


def _defined(a) -> np.ndarray:
    a = np.asarray(a)
    return a[a < 1e34]


def _jax_numbers(state) -> dict:
    """The JAX tour's sections 1, 2 and 4-8 on ``state``, as the port's
    ``main`` returns them."""
    import mi_fieldcalc_tpu.api as fc
    from mi_fieldcalc_tpu import from_sentinel
    from mi_fieldcalc_tpu.models import (derived_fields,
                                         derived_fields_isobaric)
    from mi_fieldcalc_tpu.staging import (run_derived_fields_np,
                                          run_hlevel_suite_np)

    tk, q, u, v, ps, alevel, blevel, mapr, fcor = state
    res = {}
    rh0 = fc.hlevelhum(tk[-1], q[-1], ps, float(alevel[-1]),
                       float(blevel[-1]), "kelvin", 1)
    chill = fc.windCooling(tk[-1], u[-1], v[-1], 1)
    res["rh_mean"] = float(np.nanmean(_defined(rh0)))
    res["chill_min"] = float(_defined(chill).min())
    fields = tuple(from_sentinel(a) for a in (tk, q, u, v, ps))
    coefs = (jnp.asarray(alevel), jnp.asarray(blevel))
    geo = (jnp.asarray(mapr), jnp.asarray(mapr), jnp.asarray(fcor))
    out = jax.jit(derived_fields)(*fields, *coefs, *geo)
    thetae = np.asarray(out.thetae.to_sentinel())
    res["thetae_max"] = float(_defined(thetae).max())
    res["thetae_undef"] = int((thetae >= 1e34).sum())
    iso = jax.jit(lambda *a: derived_fields_isobaric(
        *a, plevels=(850.0, 500.0)))(*fields, *coefs, *geo)
    res["td850_mean"] = float(
        np.asarray(iso.td.values)[0][np.asarray(iso.td.mask)[0]].mean())
    suite = run_hlevel_suite_np(tk, q, None, ps, alevel, blevel,
                                temps=(3,), hums_q=(1, 9))
    res["suite_td_mean"] = float(_defined(suite["hum_q9"]).mean())
    res["suite_keys"] = sorted(suite)
    t850 = np.asarray(tk[-1])
    rh850 = np.clip(np.abs(np.asarray(q[-1])) * 1e4, 5.0, 95.0)
    with fc.batch():
        tc = fc.cvtemp(t850, 1)
        hum = fc.plevelhum(t850, rh850, 850.0, "", 3)
        back = fc.cvtemp(tc, 2)
    res["storm_roundtrip"] = float(np.abs(np.asarray(back) - t850).max())
    res["storm_q850_mean"] = float(_defined(hum).mean())
    res["cycle_q850_mean"] = []
    for cycle in range(2):
        t_new = t850 + np.float32(0.1 * cycle)
        with fc.batch(cache_inputs=True):
            fc.cvtemp(t_new, 2)
            h = fc.plevelhum(t_new, rh850, 850.0, "", 3)
        res["cycle_q850_mean"].append(float(_defined(h).mean()))
    with fc.batch(cache_inputs=True):
        c1 = fc.cvtemp(t850, 1)
        h1 = fc.plevelhum(t850, rh850, 850.0, "", 3)
        fc.cvtemp(rh850, 2)
    cv, hv1 = fc.fetch(c1, h1)
    res["subset_tc_mean"] = float(_defined(cv).mean())
    res["subset_q850_mean"] = float(_defined(hv1).mean())
    rag = np.s_[..., :95, :121]
    out_al = run_derived_fields_np(tk[rag], q[rag], u[rag], v[rag],
                                   ps[rag], alevel, blevel, mapr[rag],
                                   mapr[rag], fcor[rag], align=True)
    res["aligned_grid"] = list(out_al["th"].shape[-2:])
    res["aligned_th_mean"] = float(_defined(out_al["th"]).mean())
    res["aligned_thetae_undef"] = int((out_al["thetae"] >= 1e34).sum())
    return res


def test_tour_matches_the_jax_tour(tours, capsys):
    """Every number the port's tour returns against the JAX tour's same
    call, and the tour's printed lines (the JAX tour's 11: section 8 names
    the aligned product grid)."""
    jtour, ttour = tours
    state = jtour.synthetic_state()
    for a, b in zip(state, ttour.synthetic_state()):
        np.testing.assert_array_equal(a, b)
    got = ttour.main("cpu", state)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 11
    assert lines[-1] == ("aligned ingest: product grid (96, 128) "
                         "(from (95, 121))")
    ref = _jax_numbers(state)
    assert got.pop("sharded_devices") == 1
    assert got.pop("sharded_agree") is True
    assert sorted(got) == sorted(ref)
    for key in ("thetae_undef", "suite_keys", "aligned_grid",
                "aligned_thetae_undef"):
        assert got.pop(key) == ref.pop(key), key
    for key, want in ref.items():
        np.testing.assert_allclose(got[key], want, rtol=2e-5, atol=0,
                                   err_msg=key)


def test_tour_raises_without_cuda(tours):
    """The default device is the card; without CUDA the tour raises and
    nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tours[1].main()


def test_tour_script_runs_without_jax():
    """``python examples/forecast_products_torch.py --device cpu``, from
    any directory, with ``jax`` and the JAX package unimportable: the
    tour's 11 lines."""
    script = str(EXAMPLES / "forecast_products_torch.py")
    code = ("import sys, runpy\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['mi_fieldcalc_tpu'] = None\n"
            f"sys.argv = [{script!r}, '--device', 'cpu']\n"
            f"runpy.run_path({script!r}, run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=EXAMPLES,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert len(lines) == 11 and lines[4].endswith("True"), lines


def _sentinel_input(seed=0) -> np.ndarray:
    """float32 values around the sentinel's magnitude and ordinary ones,
    the sentinel itself, NaNs, and values that round to the sentinel only
    in bfloat16."""
    rng = np.random.default_rng(seed)
    a = rng.normal(280.0, 30.0, (6, 33)).astype(np.float32)
    a[0, :5] = 1e35
    a[1, :3] = np.nan
    a[2, :8] = np.float32(1e35) * (1 + rng.uniform(-3e-3, 3e-3, 8))
    a[3, :4] = (-1e35, 0.0, -0.0, np.inf)
    return a


def _assert_same_bits(got: torch.Tensor, ref) -> None:
    """Port and JAX values widened to float32 (exact from bfloat16): the
    same bits, or both NaN (a NaN's sign and payload after rounding to
    bfloat16 differ between the two libraries)."""
    g = got.float().numpy()
    r = np.asarray(ref).astype(np.float32)
    same = (g.view(np.int32) == r.view(np.int32)) | (np.isnan(g)
                                                      & np.isnan(r))
    assert same.all(), (g[~same][:5], r[~same][:5])


DTYPES = [(torch.float32, jnp.float32), (np.float32, jnp.float32),
          ("float32", jnp.float32), (torch.bfloat16, jnp.bfloat16),
          (jnp.bfloat16, jnp.bfloat16)]


@pytest.mark.parametrize("tdt,jdt", DTYPES)
def test_from_sentinel_dtype_matches_jax(tdt, jdt):
    """``from_sentinel(values, undef, dtype)`` as the JAX call is written:
    values rounded to ``dtype``, the mask tested in that dtype."""
    a = _sentinel_input()
    got = tfield.from_sentinel(a, 1e35, tdt)
    ref = jfield.from_sentinel(a, 1e35, jdt)
    assert got.values.dtype == {jnp.float32: torch.float32,
                                jnp.bfloat16: torch.bfloat16}[jdt]
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    _assert_same_bits(got.values, ref.values)
    if jdt is jnp.bfloat16:      # more points meet the sentinel in bf16
        assert int((~got.mask).sum()) > int(
            (~tfield.from_sentinel(a).mask).sum())


@pytest.mark.parametrize("tdt,jdt", DTYPES)
def test_from_values_and_full_undef_dtype_match_jax(tdt, jdt):
    a = _sentinel_input(1)
    m = np.random.default_rng(2).random(a.shape) < 0.7
    for got, ref in ((tfield.from_values(a, None, tdt),
                      jfield.from_values(a, None, jdt)),
                     (tfield.from_values(a, m[0], tdt),
                      jfield.from_values(a, m[0], jdt)),
                     (tfield.full_undef(a.shape, tdt),
                      jfield.full_undef(a.shape, jdt))):
        np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
        _assert_same_bits(got.values, ref.values)
        assert str(got.values.dtype).endswith(np.dtype(jdt).name)


def test_device_is_keyword_only():
    """The third parameter is the dtype, as in JAX; ``device`` is keyword
    only, and a dtype with no torch counterpart raises."""
    f = tfield.from_sentinel(np.ones((2, 2)), 1e35, np.float32,
                             device="cpu")
    assert f.values.dtype == torch.float32 and f.values.device.type == "cpu"
    with pytest.raises(TypeError):
        tfield.from_sentinel(np.ones((2, 2)), 1e35, np.float32, "cpu")
    with pytest.raises(TypeError):
        tfield.full_undef((2, 2), torch.float32, "cpu")
    with pytest.raises(TypeError, match="no torch dtype"):
        tfield.from_values(np.ones(3), None, np.dtype("U3"))
