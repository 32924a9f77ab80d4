"""The port's aligned ingest (``mi_fieldcalc_tpu_torch/ingest.py``, the
codec's ``decode_resample_batch`` and ``align=`` on the serving entries)
against the JAX package's, on the CPU, on a ragged grid (13x37 -> 16x128).

The re-grid is host numpy and the codec is one library, so the grid, the
coordinates and the re-gridded inputs are the JAX package's bit for bit;
the codec against its numpy fallback at the JAX package's own tolerance
(masks and counts equal, values within 2e-6 relative: FP contraction).
The entries against the JAX entries under ``CONFORMANCE.md``'s
tolerances, as their unaligned tests hold them: the pipeline within rtol
2e-5 (``2e-6*max|ref|`` more on the 5 stencil outputs), the h-level suite
bit for bit, the icing products per product (``test_torch_icing.py``);
sentinels identical everywhere.
"""

import numpy as np
import pytest
import torch

from mi_fieldcalc_tpu import ingest as jingest
from mi_fieldcalc_tpu import native as jnative
from mi_fieldcalc_tpu import staging as jstaging
from mi_fieldcalc_tpu.field import UNDEF
from mi_fieldcalc_tpu_torch import ingest, native, staging
from test_torch_icing import _ENTRY_TOL, SCAL, _entry_inputs
from test_torch_staging import STENCIL, _inputs, presampled, presampled_args
from test_torch_suite import CONFIG2, _suite_np

torch.set_num_threads(1)

CPU = dict(device="cpu")
RAGGED = (3, 13, 37)
TARGET = (16, 128)


def _same_bytes(got: dict, ref: dict, label: str) -> None:
    assert list(got) == list(ref), label
    for name, r in ref.items():
        g = got[name]
        assert g.dtype == r.dtype and g.shape == r.shape, (label, name)
        assert g.tobytes() == r.tobytes(), (label, name)


# ------------------------------------------------------------ the grid

@pytest.mark.parametrize("shape", [(719, 929), (720, 1024), (1, 1),
                                   (13, 37), (9, 129), (8, 128), (0, 6)])
def test_aligned_target_matches_jax(shape):
    assert ingest.aligned_target(*shape) == jingest.aligned_target(*shape)


@pytest.mark.parametrize("n_src,n_dst", [(13, 16), (37, 128), (1, 8),
                                         (2, 8), (719, 720), (929, 1024),
                                         (128, 128)])
def test_axis_coords_bit_for_bit(n_src, n_dst):
    """The coordinates the codec samples: int64 indices and float32
    weights, the JAX function's bit for bit."""
    for got, ref in zip(ingest._axis_coords(n_src, n_dst),
                        jingest._axis_coords(n_src, n_dst)):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert got.tobytes() == ref.tobytes()


def _field(shape, seed, undefs=True):
    rng = np.random.default_rng(seed)
    a = rng.normal(275.0, 15.0, shape).astype(np.float32)
    if undefs:
        a[rng.random(shape) < 0.05] = UNDEF
        a[..., 4, :] = UNDEF                  # an undefined row
        a.reshape(-1)[7] = np.nan
    return a


RESAMPLE_CASES = {
    "mask-aware, undefined points": ((13, 37), True, True, None),
    "mask-aware, all defined": ((13, 37), False, True, None),
    "plain bilinear": ((13, 37), False, False, None),
    "a 3-D stack": (RAGGED, True, True, None),
    "all undefined": ((9, 17), "all", True, None),
    "to a given grid": ((13, 37), True, True, (40, 256)),
    "an aligned grid": ((16, 128), True, True, None),
}


@pytest.mark.parametrize("case", list(RESAMPLE_CASES))
def test_resample_align_matches_jax(case):
    shape, undefs, mask_aware, shape_to = RESAMPLE_CASES[case]
    a = (np.full(shape, UNDEF, np.float32) if undefs == "all"
         else _field(shape, 3, undefs))
    got = ingest.resample_align(a, UNDEF, shape_to, mask_aware)
    ref = jingest.resample_align(a, UNDEF, shape_to, mask_aware)
    assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape
    assert got.tobytes() == ref.tobytes()
    if shape == (16, 128):
        assert got is a                       # no copy on an aligned grid


@pytest.mark.parametrize("shape,shape_to", [((13, 37), None),
                                            ((1, 37), None),
                                            ((13, 37), (40, 256)),
                                            ((16, 128), None)])
def test_resample_maps_matches_jax(shape, shape_to):
    rng = np.random.default_rng(4)
    xm = rng.uniform(3e-7, 5e-7, shape).astype(np.float32)
    ym = rng.uniform(3e-7, 5e-7, shape).astype(np.float32)
    for got, ref in zip(ingest.resample_maps(xm, ym, *shape, shape_to),
                        jingest.resample_maps(xm, ym, *shape, shape_to)):
        assert got.dtype == np.float32 and got.shape == ref.shape
        assert got.tobytes() == ref.tobytes()


# ------------------------------------------------------------ the codec

def _codec_inputs():
    """The JAX package's codec test inputs (test_native.py:337-344)."""
    rng = np.random.default_rng(33)
    a = rng.uniform(200.0, 300.0, (3, 37, 53)).astype(np.float32)
    b = rng.uniform(0.0, 10.0, (3, 37, 53)).astype(np.float32)
    for arr in (a, b):
        arr[..., 5, 5] = UNDEF
        arr[0, 10, 20] = np.nan
        arr[..., :, 50] = UNDEF
    return [a, b], (40, 128)


@pytest.mark.parametrize("against", ["numpy fallback", "JAX binding"])
def test_decode_resample_batch(against, monkeypatch):
    """The native pass against the port's numpy fallback (masks and counts
    equal, values within 2e-6 relative) and against the JAX binding of the
    same library (bit for bit); the fallback against the numpy re-grid."""
    if native.codec() != "native":
        pytest.skip("no C++ compiler: the native codec did not build")
    arrays, (ny_t, nx_t) = _codec_inputs()
    out = np.empty((2, 3, ny_t, nx_t), np.float32)
    mask = np.empty(out.shape, np.uint8)
    vals, m, counts = native.decode_resample_batch(arrays, ny_t, nx_t,
                                                   out=out, mask=mask)
    assert vals is out and np.shares_memory(m, mask)
    if against == "JAX binding":
        assert jnative.available()
        rv, rm, rc = jnative.decode_resample_batch(arrays, ny_t, nx_t)
        assert vals.tobytes() == rv.tobytes()
        np.testing.assert_array_equal(m, rm)
        assert counts == list(rc)
        return
    monkeypatch.setattr(native, "_load", lambda: None)
    assert native.codec() == "numpy"
    fv, fm, fc = native.decode_resample_batch(arrays, ny_t, nx_t)
    np.testing.assert_array_equal(m, fm)
    assert counts == fc == [int(x.sum()) for x in fm]
    rel = np.abs(vals[m] - fv[fm]) / np.maximum(np.abs(fv[fm]), 1e-6)
    assert rel.max() <= 2e-6
    assert np.all(fv[~fm] == 0.0) and np.all(vals[~m] == 0.0)
    for i, a in enumerate(arrays):
        ref = jingest.resample_align(a, UNDEF, shape_to=(ny_t, nx_t))
        np.testing.assert_array_equal(fm[i], ref != np.float32(UNDEF))
        np.testing.assert_array_equal(fv[i][fm[i]], ref[fm[i]])


def test_decode_resample_batch_checks_its_buffers():
    arrays, (ny_t, nx_t) = _codec_inputs()
    with pytest.raises(ValueError, match="share a shape"):
        native.decode_resample_batch([arrays[0], arrays[1][:2]], ny_t, nx_t)
    with pytest.raises(ValueError, match="bad `out`"):
        native.decode_resample_batch(arrays, ny_t, nx_t,
                                     out=np.empty((2, 3, ny_t, 64),
                                                  np.float32))
    with pytest.raises(ValueError, match="bad `mask`"):
        native.decode_resample_batch(arrays, ny_t, nx_t,
                                     mask=np.empty((2, 3, ny_t, nx_t),
                                                   np.float32))


def test_decode_resample_fills_the_reused_block():
    """The stager's resampling decode writes into its own input block (a
    ragged request, an aligned one and a ragged one again share it), the
    counts are the target grid's defined points, and the upload carries
    the target grid."""
    args = _inputs(*RAGGED, seed=7)
    stager = staging.HostStager(4)
    staging._decode_step(args, stager, UNDEF, align=True)
    block = stager._vin
    host, _ = staging._decode_step(args, stager, UNDEF)
    assert host.values.shape == (4,) + RAGGED
    host, _ = staging._decode_step(args, stager, UNDEF, align=True)
    assert stager._vin is block
    assert np.shares_memory(host.values, block.numpy())
    assert host.values.shape == (4,) + RAGGED[:1] + TARGET
    ref_v, ref_m, ref_c = native.decode_resample_batch(args[:4], *TARGET)
    assert host.values.tobytes() == ref_v.tobytes()
    np.testing.assert_array_equal(host.mask.view(bool), ref_m)
    assert stager.counts == ref_c
    assert stager.ps_count == native.decode_resample_batch(
        [args[4]], *TARGET)[2][0]
    staged = staging._upload_step(host, torch.device("cpu"))
    assert all(t.shape[-2:] == TARGET for t in staged[5:] if t.dim() == 2)
    assert staged[4].values.shape == TARGET


# ------------------------------------------------------------ the entries

def _pipeline_args(undefs=True, shape=RAGGED, seed=3):
    return _inputs(*shape, seed=seed, undefs=undefs)


def _steps(shape=RAGGED):
    return [_inputs(*shape, seed=20 + i, undefs=i % 2 == 0)
            for i in range(3)]


def _suite_args(undefs=True, shape=RAGGED, seed=5):
    return _suite_np(*shape, seed=seed, undefs=undefs)


def _icing_args(shape=RAGGED, seed=2):
    return _entry_inputs(*shape[1:], seed=seed)


#: name -> (the port's call, the JAX package's call, inputs, tolerance);
#: each call takes (inputs, **kw) and returns a list of sentinel dicts
ENTRIES = {
    "run_derived_fields_np": (
        lambda a, **kw: [staging.run_derived_fields_np(*a, **kw, **CPU)],
        lambda a, **kw: [jstaging.run_derived_fields_np(*a, **kw)],
        _pipeline_args, "pipeline"),
    "run_derived_fields_np all-defined": (
        lambda a, **kw: [staging.run_derived_fields_np(*a, **kw, **CPU)],
        lambda a, **kw: [jstaging.run_derived_fields_np(*a, **kw)],
        lambda **s: _pipeline_args(False, **s), "pipeline"),
    "stream_derived_fields_np": (
        lambda a, **kw: list(staging.stream_derived_fields_np(a, **kw,
                                                              **CPU)),
        lambda a, **kw: list(jstaging.stream_derived_fields_np(a, **kw)),
        _steps, "pipeline"),
    "run_hlevel_suite_np": (
        lambda a, **kw: [staging.run_hlevel_suite_np(*a, **kw, **CONFIG2,
                                                     **CPU)],
        lambda a, **kw: [jstaging.run_hlevel_suite_np(*a, **kw, **CONFIG2)],
        _suite_args, "exact"),
    "run_hlevel_suite_np all-defined": (
        lambda a, **kw: [staging.run_hlevel_suite_np(*a, **kw, **CONFIG2,
                                                     **CPU)],
        lambda a, **kw: [jstaging.run_hlevel_suite_np(*a, **kw, **CONFIG2)],
        lambda **s: _suite_args(False, **s), "exact"),
    "run_vessel_icing_np": (
        lambda a, **kw: [staging.run_vessel_icing_np(*a, *SCAL, **kw,
                                                     **CPU)],
        lambda a, **kw: [jstaging.run_vessel_icing_np(*a, *SCAL, **kw)],
        _icing_args, "icing"),
}


def _assert_close(got: dict, ref: dict, tol: str, label: str) -> None:
    assert list(got) == list(ref), label
    for name, r in ref.items():
        g = got[name]
        assert g.shape == r.shape and g.dtype == np.float32, (label, name)
        undef = r == np.float32(UNDEF)
        np.testing.assert_array_equal(g == np.float32(UNDEF), undef,
                                      err_msg=f"{label} {name}")
        d = ~undef
        if tol == "exact":
            np.testing.assert_array_equal(g[d], r[d], err_msg=name)
            continue
        if tol == "icing":
            kw = _ENTRY_TOL[name]
        else:
            atol = 2e-6 * float(np.abs(r[d]).max()) if name in STENCIL \
                else 0.0
            kw = dict(rtol=2e-5, atol=atol)
        np.testing.assert_allclose(g[d], r[d], err_msg=f"{label} {name}",
                                   **kw)


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_entries_align_match_jax(entry):
    """``align=True`` on a ragged grid: the JAX entry's names and aligned
    shapes, sentinels identical, values within the entry's tolerance."""
    port, jax_entry, make, tol = ENTRIES[entry]
    args = make()
    got, ref = port(args, align=True), jax_entry(args, align=True)
    assert len(got) == len(ref) >= 1
    for i, (g, r) in enumerate(zip(got, ref)):
        assert all(a.shape[-2:] == TARGET for a in g.values())
        _assert_close(g, r, tol, f"{entry} [{i}]")


def _presampled_call(entry, args):
    """The entry's inputs re-gridded by hand, as ``align=True`` would."""
    if entry.startswith("run_derived"):
        return presampled_args(args, TARGET)
    if entry.startswith("stream"):
        return [presampled_args(s, TARGET) for s in args]
    if entry.startswith("run_hlevel"):
        tk, q, rh, ps, al, bl = args
        return (*(presampled(a, TARGET) for a in (tk, q, rh, ps)), al, bl)
    return [presampled(a, TARGET) for a in args]


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_align_equals_presampled_inputs(entry):
    """``align=True`` equals the inputs re-gridded first and run with
    ``align=False``, byte for byte (the JAX package's
    ``test_run_derived_fields_np_align_matches_pre_resampled``)."""
    port = ENTRIES[entry][0]
    args = ENTRIES[entry][2]()
    got = port(args, align=True)
    ref = port(_presampled_call(entry, args), align=False)
    for i, (g, r) in enumerate(zip(got, ref)):
        _same_bytes(g, r, f"{entry} [{i}]")


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_environment_switches_align(entry, monkeypatch):
    """``align=None`` reads ``MF_STAGING_ALIGN`` as the JAX entries do:
    ``1`` gives the aligned products, ``0`` the ragged ones."""
    port = ENTRIES[entry][0]
    args = ENTRIES[entry][2]()
    monkeypatch.setenv("MF_STAGING_ALIGN", "1")
    for g, r in zip(port(args), port(args, align=True)):
        _same_bytes(g, r, entry)
        assert all(a.shape[-2:] == TARGET for a in g.values())
    monkeypatch.setenv("MF_STAGING_ALIGN", "0")
    for g, r in zip(port(args), port(args, align=False)):
        _same_bytes(g, r, entry)
        assert all(a.shape[-2:] == RAGGED[1:] for a in g.values())


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_aligned_grid_is_a_no_op(entry):
    """On a grid that is aligned already, ``align=True`` changes nothing."""
    port = ENTRIES[entry][0]
    args = ENTRIES[entry][2](shape=(2,) + TARGET)
    for g, r in zip(port(args, align=True), port(args, align=False)):
        _same_bytes(g, r, entry)


@pytest.mark.parametrize("undefs", [True, False])
def test_all_defined_route_after_the_regrid(undefs, monkeypatch):
    """Bilinear weights keep a fully defined field fully defined, so a
    fully defined ragged request takes the kernels' all-defined path after
    the re-grid, by the target grid's decode counts; one undefined row
    keeps it masked."""
    routes = []
    compute = staging._compute

    def spy(staged, all_defined):
        routes.append(all_defined)
        return compute(staged, all_defined)

    monkeypatch.setattr(staging, "_compute", spy)
    args = _pipeline_args(undefs=False)
    if undefs:
        args[0][1, 4, :] = UNDEF
    staging.run_derived_fields_np(*args, align=True, **CPU)
    reqs = staging._build_reqs("t", CONFIG2["temps"], CONFIG2["hums_q"],
                               CONFIG2["hums_rh"], (), (), ())
    _, ad_suite = staging._suite_decode_step(
        *_suite_args(undefs), reqs, staging.HostStager(3), UNDEF, align=True)
    assert routes == [not undefs] and ad_suite == (not undefs)


def test_levpack_is_not_ported_and_no_type_error():
    """``run_derived_fields_np`` takes the JAX keywords ``levpack`` and
    ``align`` in the JAX order; ``levpack=True`` raises ``not_ported``."""
    args = _pipeline_args()
    with pytest.raises(NotImplementedError, match="not ported"):
        staging.run_derived_fields_np(*args, UNDEF, True, **CPU)
    out = staging.run_derived_fields_np(*args, UNDEF, False, True, **CPU)
    assert out["th"].shape == RAGGED[:1] + TARGET
