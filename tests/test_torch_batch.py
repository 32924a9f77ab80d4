"""Call-storm batching in the port (``mi_fieldcalc_tpu_torch/batch.py``),
on the CPU.

The JAX package's batch tests (``tests/test_batch.py``), each on the port's
``batch(device="cpu")`` at 24x33, with the port's own hooks where the JAX
tests patch ``jax.device_put`` (``batch._ship``: one call per shipped
stack), ``jax.device_get`` (``batch._to_host``: the one device-to-host
copy) or ``_compiled_batch``.  Every batched result is held byte for byte
to the port's eager api call on the same inputs.  Beside them: the 22-call
storm of ``tools/perf_lab_batch.py`` against the JAX ``batch()`` (the
sentinels identical, values within rtol 2e-5 plus 2e-6 of the field's
largest magnitude, ``tests/test_torch_api.py``'s tolerance), every api
function batched against its eager call, a ``TorchDispatchMode`` over the
program of each of those, of the storm and of an icing storm that finds
no host read and no tensor made from host data (what a CUDA graph cannot
capture), and the
capture-safety repair of the operators, each held bit for bit to its
result with the host-data constants it had before and to its JAX function.
"""

import functools

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

import mi_fieldcalc_tpu.api as japi
from mi_fieldcalc_tpu_torch import api, constants, ops
from mi_fieldcalc_tpu_torch import batch as B
from mi_fieldcalc_tpu_torch.tools import perf_lab_batch as lab
from torch_api_cases import api_call, api_inputs, api_names

torch.set_num_threads(1)

UNDEF = api.UNDEF
DEV = "cpu"


class _OnCPU:
    """The port's api with every call and batch on the CPU."""

    UNDEF = api.UNDEF
    fetch = staticmethod(api.fetch)

    def __getattr__(self, name):
        return functools.partial(getattr(api, name), device=DEV)

    @staticmethod
    def batch(cache_inputs=False, fetch_dtype=None):
        return api.batch(cache_inputs, fetch_dtype, device=DEV)


fc = _OnCPU()


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.tobytes() == b.tobytes()


def _grids(ny=24, nx=33, seed=0):
    rng = np.random.default_rng(seed)
    t = rng.uniform(250.0, 300.0, (ny, nx)).astype(np.float32)
    rh = rng.uniform(5.0, 95.0, (ny, nx)).astype(np.float32)
    q = rng.uniform(1e-4, 8e-3, (ny, nx)).astype(np.float32)
    t[0, 0] = UNDEF
    rh[1, 1] = UNDEF
    return t, rh, q


# ---------------------------------------------------------------------------
# tests/test_batch.py, on the port
# ---------------------------------------------------------------------------

def test_batch_matches_eager():
    t, rh, q = _grids()
    e1 = fc.abshum(t, rh, UNDEF)
    e2 = fc.cvtemp(t, 2)
    e3 = fc.alevelhum(t, q, t * 0 + 900.0, "", 1)
    with fc.batch():
        b1 = fc.abshum(t, rh, UNDEF)
        b2 = fc.cvtemp(t, 2)
        b3 = fc.alevelhum(t, q, t * 0 + 900.0, "", 1)
        assert isinstance(b1, B.Deferred) and b1.shape == e1.shape
    assert _same(e1, b1) and _same(e2, b2) and _same(e3, b3)


def test_batch_chaining_stays_in_program():
    """A Deferred fed to a later call equals the eager composition."""
    t, rh, q = _grids(seed=1)
    ec = fc.cvtemp(t, 2)                     # K -> C
    eh = fc.abshum(fc.cvtemp(ec, 1), rh, UNDEF)   # back to K, then abshum
    with fc.batch():
        c = fc.cvtemp(t, 2)
        k = fc.cvtemp(c, 1)
        h = fc.abshum(k, rh, UNDEF)
    assert _same(ec, c)
    assert _same(eh, h)


def test_batch_invalid_returns_none_eagerly():
    t, rh, _ = _grids()
    with fc.batch():
        bad_shape = fc.abshum(t, rh[:-1], UNDEF)      # mismatched shapes
        bad_param = fc.cvtemp(t, 99)                  # invalid compute
        ok = fc.cvtemp(t, 2)
        assert bad_shape is None
        assert bad_param is None
    assert _same(ok, fc.cvtemp(t, 2))


def test_batch_early_touch_flushes_segment_and_continues():
    t, rh, _ = _grids(seed=2)
    with fc.batch():
        a = fc.cvtemp(t, 2)
        av = np.asarray(a)                   # early materialization
        assert _same(av, fc.cvtemp(t, 2))
        b = fc.cvtemp(a, 1)                  # flushed Deferred as input
    assert np.allclose(np.asarray(b), t, rtol=1e-6)
    assert _same(b, fc.cvtemp(fc.cvtemp(t, 2), 1))


def test_batch_multi_output():
    ny, nx = 16, 20
    rng = np.random.default_rng(3)
    z = rng.uniform(100.0, 5000.0, (ny, nx)).astype(np.float32)
    xm = np.full((ny, nx), 1e-5, np.float32)
    ym = np.full((ny, nx), 1e-5, np.float32)
    fcor = np.full((ny, nx), 1e-4, np.float32)
    eg = fc.ilevelgwind(z, xm, ym, fcor)
    with fc.batch():
        bg = fc.ilevelgwind(z, xm, ym, fcor)
        assert isinstance(bg, tuple) and len(bg) == len(eg)
    for e, b in zip(eg, bg):
        assert _same(e, b)


def test_batch_undef_propagation():
    t, rh, _ = _grids(seed=4)
    with fc.batch():
        out = fc.abshum(t, rh, UNDEF)
    o = np.asarray(out)
    assert o[0, 0] == np.float32(UNDEF) and o[1, 1] == np.float32(UNDEF)


def test_batch_no_nesting():
    with fc.batch():
        with pytest.raises(B.BatchError):
            with fc.batch():
                pass


def test_deferred_operators_and_methods():
    """Plain-Python operations on a Deferred materialize and work."""
    t, rh, _ = _grids(seed=5)
    e = fc.cvtemp(t, 2)
    with fc.batch():
        d = fc.cvtemp(t, 2)
        plus = d + 1.0                       # operator inside the context
        elem = d[2, 3]
        mean = d.mean()
    assert np.allclose(plus, e + 1.0)
    assert elem == e[2, 3]
    assert mean == pytest.approx(e.mean())
    assert (2.0 * d).shape == e.shape        # reflected op after exit
    assert np.allclose(np.negative(d), -e)   # ufunc path


def test_batch_failure_marks_deferreds(monkeypatch):
    """A failing program re-raises on every later data access instead of
    silently yielding None."""
    t, rh, _ = _grids(seed=6)

    class Boom:
        def run(self, flat, keep=()):
            raise RuntimeError("injected device failure")

    with fc.batch():
        d = fc.cvtemp(t, 2)
        monkeypatch.setattr(B, "_compiled_batch", lambda *a: Boom())
        with pytest.raises(RuntimeError):
            np.asarray(d)                    # flush fails
    with pytest.raises(B.BatchError):
        np.asarray(d)                        # stays failed
    with pytest.raises(B.BatchError):
        with fc.batch():
            fc.cvtemp(d, 1)                  # failed Deferred as input
    monkeypatch.undo()
    with fc.batch():                         # the API recovers after
        ok = fc.cvtemp(t, 2)
    assert _same(ok, fc.cvtemp(t, 2))


def test_batch_cross_context_device_chaining():
    """A materialized Deferred from a previous batch() feeds a later
    batch() on the device with eager-equal values."""
    t, rh, _ = _grids(seed=7)
    with fc.batch():
        c = fc.cvtemp(t, 2)
    with fc.batch():
        k = fc.cvtemp(c, 1)                  # device-resident input
        h = fc.abshum(k, rh, UNDEF)
    eh = fc.abshum(fc.cvtemp(fc.cvtemp(t, 2), 1), rh, UNDEF)
    assert _same(h, eh)


def _counting_ship(monkeypatch):
    """Record the shape of every stack the batch ships."""
    shipped = []
    real = B._ship

    def ship(arrays, device):
        out = real(arrays, device)
        shipped.append(tuple(out.shape))
        return out

    monkeypatch.setattr(B, "_ship", ship)
    return shipped


def test_batch_input_cache_ships_only_changed(monkeypatch):
    """cache_inputs=True: a repeated storm re-ships only the arrays whose
    objects changed; values stay eager-equal."""
    B.clear_input_cache()
    t, rh, q = _grids(seed=8)
    ps = (t * 0 + 900.0).astype(np.float32)
    puts = _counting_ship(monkeypatch)

    def storm(tt, rr):
        with fc.batch(cache_inputs=True):
            a = fc.abshum(tt, rr, UNDEF)
            b = fc.cvtemp(tt, 2)
            c = fc.alevelhum(tt, q, ps, "", 1)
        return [np.asarray(x) for x in (a, b, c)]

    r1 = storm(t, rh)
    assert len(puts) >= 1                    # cold cycle ships stacks
    puts.clear()
    r2 = storm(t, rh)                        # identical cycle
    assert puts == []                        # nothing re-ships
    rh2 = np.ascontiguousarray(rh * 0.9)
    r3 = storm(t, rh2)                       # one changed input
    assert len(puts) == 1 and puts[0][0] == 1   # one 1-row stack
    for got, want in zip(
            r3, [fc.abshum(t, rh2, UNDEF), fc.cvtemp(t, 2),
                 fc.alevelhum(t, q, ps, "", 1)]):
        assert _same(got, want)
    assert _same(r1[0], r2[0])
    B.clear_input_cache()


def test_batch_member_ops_stack_in_program():
    """Ensemble reductions inside batch(): members record as individual
    2-D inputs (stacked in the program), Deferred members chain on the
    device, results equal the eager path."""
    t, rh, _ = _grids(seed=10)
    t2 = np.ascontiguousarray(t * 0.99)
    t3 = np.ascontiguousarray(t * 1.01)
    e_sum = fc.sumFields([t, t2, t3])
    e_mean = fc.meanValue([t, t2, t3])
    with fc.batch():
        s = fc.sumFields([t, t2, t3])
        m = fc.meanValue([t, t2, t3])
        c = fc.cvtemp(t, 2)
        chained = fc.maxvalueFields(fc.cvtemp(c, 1), t2)  # Deferred member
        bad = fc.sumFields([t, t2[:-1]])                  # shape mismatch
        assert bad is None
        assert fc.sumFields([]) is None
    assert _same(s, e_sum)
    assert _same(m, e_mean)
    e_ch = fc.maxvalueFields(fc.cvtemp(fc.cvtemp(t, 2), 1), t2)
    assert _same(chained, e_ch)


def _bf16(a):
    """``a`` rounded to bfloat16 and widened, its sentinel re-snapped."""
    r = torch.from_numpy(np.asarray(a)).to(torch.bfloat16).float().numpy()
    return np.where(np.asarray(a) == np.float32(UNDEF), np.float32(UNDEF), r)


def test_batch_bf16_fetch():
    """fetch_dtype='bfloat16': results come back float32 as the bfloat16
    rounding of the eager ones, the sentinel re-snapped EXACTLY, and a
    bf16-fetched Deferred chained into a later (full-precision) batch
    re-snaps in the program."""
    t, rh, _ = _grids(seed=11)
    e = fc.abshum(t, rh, UNDEF)
    with fc.batch(fetch_dtype="bfloat16"):
        a = fc.abshum(t, rh, UNDEF)
        b = fc.cvtemp(t, 2)
    av = np.asarray(a)
    assert av.dtype == np.float32
    und = e == np.float32(UNDEF)
    assert np.array_equal(av == np.float32(UNDEF), und)
    assert np.allclose(av[~und], e[~und], rtol=1e-2)
    assert _same(av, _bf16(e))
    with fc.batch():
        c = fc.cvtemp(b, 1)                  # bf16 Deferred as input
    cv = np.asarray(c)
    t_und = t == np.float32(UNDEF)
    assert np.array_equal(cv == np.float32(UNDEF), t_und)
    assert np.allclose(cv[~t_und], t[~t_und], rtol=1e-2)
    assert _same(cv, fc.cvtemp(_bf16(fc.cvtemp(t, 2)), 1))
    with pytest.raises(ValueError):
        fc.batch(fetch_dtype="float16")


def test_batch_fetched_stack_is_readonly():
    """Materialized Deferreds view a per-shape-group host stack shared by
    every sibling; the view is read-only."""
    t, rh, _ = _grids(seed=12)
    with fc.batch():
        a = fc.abshum(t, rh, UNDEF)
        b = fc.cvtemp(t, 2)
    av = np.asarray(a)
    with pytest.raises(ValueError):
        av[0, 0] = 42.0
    aw = av.copy()
    aw[0, 0] = 42.0
    assert np.asarray(b)[0, 0] != 42.0


def test_batch_cache_stats_and_temporaries(monkeypatch):
    """cache_stats(): hit/miss/put/eviction telemetry; per-call conversion
    temporaries (float64 inputs) are neither cached nor counted."""
    B.clear_input_cache()
    B.cache_stats(reset=True)
    t, rh, _ = _grids(seed=13)
    t64 = t.astype(np.float64)               # converted per call

    def storm():
        with fc.batch(cache_inputs=True):
            a = fc.abshum(t, rh, UNDEF)      # t, rh owned -> cacheable
            b = fc.cvtemp(t64, 2)            # temporary -> never cached
        return np.asarray(a), np.asarray(b)

    r1 = storm()
    s = B.cache_stats()
    assert s["entries"] == 2 and s["puts"] == 2      # only t and rh
    assert s["misses"] == 2 and s["hits"] == 0
    assert s["resident_bytes"] > 0
    assert s["budget_bytes"] == B._cache_budget()
    r2 = storm()                             # warm cycle: both hit
    s = B.cache_stats()
    assert s["hits"] == 2 and s["misses"] == 2 and s["entries"] == 2
    assert _same(r1[0], r2[0]) and _same(r1[1], r2[1])

    monkeypatch.setenv("MF_BATCH_CACHE_MB", "0")
    t2 = np.ascontiguousarray(t + 1.0)
    with fc.batch(cache_inputs=True):
        c = fc.cvtemp(t2, 2)
    np.asarray(c)
    s = B.cache_stats(reset=True)
    assert s["evictions"] >= 1
    assert B.cache_stats()["hits"] == 0      # reset zeroed counters
    B.clear_input_cache()


def _counting_to_host(monkeypatch):
    gets = []
    real = B._to_host

    def to_host(t):
        gets.append(t.numel() * t.element_size())
        return real(t)

    monkeypatch.setattr(B, "_to_host", to_host)
    return gets


def test_fetch_subset_grouped(monkeypatch):
    """fc.fetch(): subset consumers copy once per dtype with only the
    requested rows; results equal np.asarray, later full fetches still
    work, and already-fetched rows come from the row cache."""
    t, rh, q = _grids(seed=20)
    with fc.batch():
        a = fc.abshum(t, rh, UNDEF)
        b = fc.cvtemp(t, 2)
        c = fc.alevelhum(t, q, t * 0 + 900.0, "", 1)
        d = fc.cvtemp(rh, 2)
    gets = _counting_to_host(monkeypatch)
    got_a, got_c = fc.fetch(a, c)
    assert len(gets) == 1                    # one copy of two planes
    assert gets[0] == 2 * t.size * 4
    assert _same(got_a, fc.abshum(t, rh, UNDEF))
    assert _same(got_c, fc.alevelhum(t, q, t * 0 + 900.0, "", 1))
    gets.clear()
    av = np.asarray(a)                       # cached row: no new copy
    assert gets == [] and not av.flags.writeable
    bv = np.asarray(b)                       # untouched sibling: one copy
    assert len(gets) == 1
    assert _same(bv, fc.cvtemp(t, 2))
    assert _same(d, fc.cvtemp(rh, 2))
    (x,) = fc.fetch(t)                       # non-Deferreds pass through
    assert _same(x, t)


def test_fetch_subset_bf16():
    """fc.fetch composes with fetch_dtype='bfloat16': half-width rows,
    exact sentinel re-snap."""
    t, rh, _ = _grids(seed=21)
    e = fc.abshum(t, rh, UNDEF)
    with fc.batch(fetch_dtype="bfloat16"):
        a = fc.abshum(t, rh, UNDEF)
        fc.cvtemp(t, 2)
    (av,) = fc.fetch(a)
    assert av.dtype == np.float32
    und = e == np.float32(UNDEF)
    assert np.array_equal(av == np.float32(UNDEF), und)
    assert np.allclose(av[~und], e[~und], rtol=1e-2)
    assert _same(av, _bf16(e))


def test_fetch_failure_surfaces_as_batcherror(monkeypatch):
    """fc.fetch keeps the error contract: a device failure raises
    BatchError and is CACHED on the stack handle, so a retry re-raises
    instead of re-running the gather."""
    t, rh, _ = _grids(seed=30)
    with fc.batch():
        a = fc.abshum(t, rh, UNDEF)
        fc.cvtemp(t, 2)
    calls = []

    def boom(x):
        calls.append(1)
        raise RuntimeError("simulated async device failure")

    monkeypatch.setattr(B, "_to_host", boom)
    with pytest.raises(B.BatchError):
        fc.fetch(a)
    assert calls == [1]
    with pytest.raises(B.BatchError):        # cached: no second gather
        fc.fetch(a)
    assert calls == [1]
    with pytest.raises(B.BatchError):        # np.asarray agrees
        np.asarray(a)


# ---------------------------------------------------------------------------
# the 22-call storm, every api function, the device contract
# ---------------------------------------------------------------------------

def _batched_storm(g, **kw):
    with fc.batch(**kw):
        out = lab.storm(fc, g)
    return lab.fetch_all(out)


def test_storm_matches_eager_byte_for_byte():
    """The storm's first flush and a repeated one (the graph's replay on
    CUDA) against the eager calls."""
    g = lab.inputs(24, 33)
    eager = lab.fetch_all(lab.storm(fc, g))
    assert len(eager) == 22
    for _ in range(2):
        got = _batched_storm(g)
        assert all(_same(e, b) for e, b in zip(eager, got))


def test_storm_matches_jax_batch():
    """The port's batched storm against the JAX package's ``batch()``."""
    g = lab.inputs(24, 33)
    with japi.batch():
        ref = lab.storm(japi, g)
    got = _batched_storm(g)
    for i, (r, o) in enumerate(zip(ref, got)):
        r = np.asarray(r)
        assert o.shape == r.shape and o.dtype == np.float32, i
        undef = r == np.float32(UNDEF)
        np.testing.assert_array_equal(o == np.float32(UNDEF), undef,
                                      err_msg=str(i))
        d = ~undef
        np.testing.assert_allclose(o[d], r[d], rtol=2e-5,
                                   atol=2e-6 * float(np.abs(r[d]).max()),
                                   err_msg=str(i))


@pytest.mark.parametrize("name", api_names(api.__all__))
def test_api_function_batches_like_eager(monkeypatch, name):
    """Each api function recorded in a batch, twice (the second a repeated
    signature), equals its eager call byte for byte; the icing calls go
    through the B5 / B6 wrappers, as on CUDA.  The second flush's program
    (what a CUDA graph captures after the warm-up) does no host read and
    makes no tensor from host data."""
    ins = api_inputs(name, (8, 9), undef_frac=0.05)
    ref = api_call(api, name, ins, device=DEV)
    refs = ref if isinstance(ref, tuple) else (ref,)
    _kernels_as_on_cuda(monkeypatch)
    modes = []
    for k in range(2):
        if k == 1:
            _watch_program(monkeypatch, modes)
        with fc.batch():
            d = api_call(api, name, ins, device=DEV)
        ds = d if isinstance(d, tuple) else (d,)
        assert len(ds) == len(refs)
        for r, x in zip(refs, ds):
            assert _same(r, x), name
    # copy_field is host-only and records nothing
    assert len(modes) == (name != "copy_field"), name
    assert [m.seen for m in modes] == [[]] * len(modes), name


def test_batch_device_contract(monkeypatch):
    """A call that names another device than its batch raises BatchError;
    a batch on CUDA raises where CUDA is missing."""
    t, rh, _ = _grids(seed=40)
    b = B._Batch(device=torch.device("cuda", 0))
    monkeypatch.setattr(B._state, "batch", b, raising=False)
    with pytest.raises(B.BatchError):
        api.cvtemp(t, 2, device="cpu")
    with pytest.raises(B.BatchError):
        api.sumFields([t, t], device="cpu")
    monkeypatch.setattr(B._state, "batch", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.batch()


# ---------------------------------------------------------------------------
# capture safety: what a CUDA graph cannot capture, found on the CPU
# ---------------------------------------------------------------------------

#: operations a graph capture refuses or would replay stale: a tensor made
#: from host data, a read of device data on the host, an output whose size
#: depends on the data
_HOST_OPS = ("aten.lift_fresh", "aten._local_scalar_dense", "aten.nonzero",
             "aten.masked_select", "aten.item", "aten.is_nonzero",
             "aten.equal", "aten._unique")


class _HostWork(TorchDispatchMode):
    """Records every host read or host-data tensor it dispatches, and every
    copy between tensors on different devices."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if name.startswith(_HOST_OPS):
            self.seen.append(name)
        elif "copy" in name:
            devs = {a.device for a in args if isinstance(a, torch.Tensor)}
            if len(devs) > 1:
                self.seen.append(f"{name} {sorted(map(str, devs))}")
        return func(*args, **(kwargs or {}))


def _kernels_as_on_cuda(monkeypatch):
    """Route the api's icing calls through the B5 / B6 wrappers, as on
    CUDA.  Each launch (opaque to the dispatcher on the card) is stood in
    by the wrapper's own tensor work and, outside every dispatch mode, the
    plain solver's result, so the outputs stay the eager CPU call's."""
    from mi_fieldcalc_tpu_torch.ops import icing_fused as F

    def launch(entry, names, planes, flags, decay, vsca, alt):
        out, args = F._launch_args(entry.__name__, names, planes, flags,
                                   decay, vsca, alt)
        if args is None:
            return out           # an empty grid or meta: nothing to launch
        with _disable_current_modes():
            if alt is None:
                res = F._modstall_plain(flags[0], planes, flags[1], vsca,
                                        decay, None)
            else:
                res = F._mincog_plain(flags[0], planes, flags[1], flags[2],
                                      vsca, alt, decay, None)
            out.copy_(res)
        return out

    monkeypatch.setattr(F, "_route", lambda name, dev: True)
    monkeypatch.setattr(F, "_launch", launch)
    monkeypatch.setattr(api, "_icing_mincog_auto",
                        ops.vessel_icing_mincog_fused)
    monkeypatch.setattr(api, "_icing_modstall_auto",
                        ops.vessel_icing_modstall_fused)


def _watch_program(monkeypatch, modes: list) -> None:
    """Run every later flush's program under a fresh :class:`_HostWork`,
    appended to ``modes``."""
    real = B._storm

    def watched(*a):
        mode = _HostWork()
        modes.append(mode)
        with mode:
            return real(*a)

    monkeypatch.setattr(B, "_storm", watched)


def _icing_storm():
    ins = api_inputs("vesselIcingMincog", (24, 33))
    sc = dict(vs=5.0, alpha=0.52, zmin=2.0, zmax=11.0)
    return [fc.vesselIcingMincog(*ins, **sc, alt=1),
            fc.vesselIcingMincog(*ins, **sc, alt=2),
            fc.vesselIcingModStall(*ins, **sc)]


@pytest.mark.parametrize("which", ["storm", "icing"])
def test_flush_program_is_capture_safe(monkeypatch, which):
    """The program a flush runs (what a CUDA graph captures after the
    eager warm-up) does no host read and makes no tensor from host data,
    and gives the eager calls' bytes.  The icing storm goes through the
    B5 / B6 wrappers, as on CUDA (:func:`_kernels_as_on_cuda`)."""
    if which == "icing":
        record = _icing_storm
        eager = [np.asarray(o) for o in record()]
        _kernels_as_on_cuda(monkeypatch)
    else:
        g = lab.inputs(24, 33)
        record = functools.partial(lab.storm, fc, g)
        eager = lab.fetch_all(record())
    with fc.batch():                         # the warm-up flush
        record()
    modes = []
    _watch_program(monkeypatch, modes)
    with fc.batch():
        out = record()
    assert len(modes) == 1 and len(out) in (3, 22)
    assert modes[0].seen == []
    assert all(_same(e, o) for e, o in zip(eager, out))
    # and the mode does see what it looks for
    probe = _HostWork()
    with probe:
        torch.tensor(0.5)
        bool(torch.ones(2).all())
    assert probe.seen == ["aten.lift_fresh.default",
                          "aten._local_scalar_dense.default"]


# ---------------------------------------------------------------------------
# the capture-safety repair: each touched operator bit for bit as before,
# and against its JAX function
# ---------------------------------------------------------------------------

class _HostScalars:
    """``torch`` as the repaired modules saw it before: a 0-dim
    ``torch.full`` is ``torch.tensor`` of the value, a copy of host
    data."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def full(size, fill_value, *, dtype=None, device=None, **kw):
        if tuple(size) == ():
            return torch.tensor(fill_value, dtype=dtype, device=device)
        return torch.full(size, fill_value, dtype=dtype, device=device,
                          **kw)


def _fields(seed=50, shape=(9, 13), lo=250.0, hi=300.0, nmem=None):
    """A (port Field, JAX Field) pair on the same seeded values."""
    import jax.numpy as jnp
    from mi_fieldcalc_tpu.field import Field as JField
    from mi_fieldcalc_tpu_torch.field import Field as TField
    rng = np.random.default_rng(seed)
    full = ((nmem,) if nmem else ()) + shape
    v = rng.uniform(lo, hi, full).astype(np.float32)
    m = rng.random(full) > 0.1
    v = np.where(m, v, np.float32(UNDEF))
    return (TField(torch.from_numpy(v.copy()), torch.from_numpy(m.copy())),
            JField(jnp.asarray(v), jnp.asarray(m)))


def _case_const():
    from mi_fieldcalc_tpu.ops import elementwise as je
    t, j = _fields()
    return ((lambda: ops.field_oper_constant(4, t, 3.0)),
            (lambda: je.field_oper_constant(4, j, 3.0)))


def _case_abshum():
    from mi_fieldcalc_tpu.ops import elementwise as je
    (t, j), (rt, rj) = _fields(), _fields(51, lo=0.05, hi=0.95)
    return (lambda: ops.abshum(t, rt)), (lambda: je.abshum(j, rj))


def _case_to_sentinel():
    t, j = _fields()
    return (lambda: t.to_sentinel(-999.0)), (lambda: j.to_sentinel(-999.0))


def _case_sanitized():
    t, j = _fields()
    return (lambda: t.sanitized(273.15)), (lambda: j.sanitized(273.15))


def _case_pow():
    import jax.numpy as jnp
    from mi_fieldcalc_tpu import _libm as jl
    from mi_fieldcalc_tpu_torch import _libm as tl
    x = np.random.default_rng(52).uniform(1e-3, 1.1, 999).astype(np.float32)
    x[:3] = (0.0, -1.0, 1e35)
    return ((lambda: tl.pow_posc_f32(torch.from_numpy(x), 0.2857)),
            (lambda: jl.pow_posc_f32(jnp.asarray(x), 0.2857)))


def _case_th_thesat():
    from mi_fieldcalc_tpu.ops import thermo as jt
    from mi_fieldcalc_tpu_torch.ops import thermo as tt
    (th, jth), (p, jp) = _fields(lo=280.0, hi=320.0), \
        _fields(53, lo=500.0, hi=1000.0)
    (pi, jpi) = _fields(54, lo=0.8, hi=1.0)
    return ((lambda: tt.th_thesat(th.values, p.values, pi.values)[0]),
            (lambda: jt.th_thesat(jth.values, jp.values, jpi.values)[0]))


def _case_plevel_interp():
    import jax.numpy as jnp
    from mi_fieldcalc_tpu.field import Field as JField
    from mi_fieldcalc_tpu.ops import vertical as jv
    from mi_fieldcalc_tpu_torch.field import Field as TField
    from mi_fieldcalc_tpu_torch.ops import vertical as tv
    f, jf = _fields(nmem=6)
    p = np.linspace(1000.0, 300.0, 6, dtype=np.float32)[:, None, None] \
        + np.zeros((6, 9, 13), np.float32)
    m = np.ones(p.shape, bool)
    tp = TField(torch.from_numpy(p.copy()), torch.from_numpy(m))
    jp = JField(jnp.asarray(p), jnp.asarray(m))
    tg = (850.0, 500.0)
    return ((lambda: tv.plevel_interp(f, tp, tg)),
            (lambda: jv.plevel_interp(jf, jp, tg)))


def _case_stencil_numbers():
    from mi_fieldcalc_tpu.ops import stencil as js
    (u, ju), (v, jv) = _fields(lo=-20.0, hi=20.0), \
        _fields(55, lo=-20.0, hi=20.0)
    return ((lambda: (ops.relvort(u, v, 2e-5, 3e-5),
                      ops.momentum_x_coordinate(v, 2e-5, 1.2e-4, 1e-5))),
            (lambda: (js.relvort(ju, jv, 2e-5, 3e-5),
                      js.momentum_x_coordinate(jv, 2e-5, 1.2e-4, 1e-5))))


def _case_shapiro():
    from mi_fieldcalc_tpu.ops import stencil as js
    t, j = _fields()
    return ((lambda: ops.shapiro2_filter(t, all_defined=False)),
            (lambda: js.shapiro2_filter(j, all_defined=False)))


def _case_esat():
    from mi_fieldcalc_tpu.ops import thermo as jt
    from mi_fieldcalc_tpu_torch.ops import thermo as tt
    t, j = _fields(lo=200.0, hi=320.0)
    return ((lambda: tt.esat_table(t.values)[0]),
            (lambda: jt.esat_table(j.values)[0]))


def _case_member_flags():
    from mi_fieldcalc_tpu.ops import ensemble as jens
    t, j = _fields(nmem=4)
    flags = (0, 2, 1, 0)
    return ((lambda: (ops.mean_value(t, flags),
                      ops.probability(1, t, [275.0], flags))),
            (lambda: (jens.mean_value(j, flags),
                      jens.probability(1, j, [275.0], flags))))


#: case -> (its inputs, the modules' ``torch`` to set back, attributes to
#: set back to their host-data form, bit for bit against JAX)
_OLD_EWT = (lambda device: torch.as_tensor(constants.EWT, device=device))
_OLD_FLAGS = (lambda flags, device: torch.as_tensor(flags, dtype=torch.bool,
                                                    device=device))
REPAIRS = {
    "harness.const": (_case_const, ("ops._harness",), (), False),
    "harness.div": (_case_abshum, ("ops._harness", "field"), (), False),
    "field.to_sentinel": (_case_to_sentinel, ("field",), (), True),
    "field.sanitized": (_case_sanitized, ("field",), (), True),
    "libm.pow_posc_f32": (_case_pow, ("_libm",), (), True),
    "thermo.th_thesat": (_case_th_thesat, ("ops.thermo",), (), False),
    "vertical.plevel_interp": (_case_plevel_interp, ("ops.vertical",), (),
                               False),
    "stencil.number_args": (_case_stencil_numbers, ("ops._harness",), (),
                            False),
    "stencil.shapiro2_filter": (_case_shapiro, ("ops.stencil", "field"),
                                (), False),
    "constants.ewt": (_case_esat, (), (("constants", "_ewt", _OLD_EWT),),
                      True),
    "ensemble.member_flags": (_case_member_flags, ("field",),
                              (("ops.ensemble", "bool_vector",
                                _OLD_FLAGS),), False),
}


def _flat(out):
    """numpy arrays of a result: tensors, Fields (values where defined
    and the mask) and tuples of them."""
    from mi_fieldcalc_tpu_torch.field import Field as TField
    if isinstance(out, tuple):
        return [a for o in out for a in _flat(o)]
    if isinstance(out, TField) or type(out).__name__ == "Field":
        m = np.asarray(out.mask)
        return [np.where(m, np.asarray(out.values), 0).astype(np.float32),
                m]
    return [np.asarray(out)]


@pytest.mark.parametrize("case", sorted(REPAIRS))
def test_capture_safe_repair_matches_before_and_jax(monkeypatch, case):
    import importlib
    make, mods, attrs, exact = REPAIRS[case]
    port, jax_fn = make()
    with torch.no_grad():
        now = _flat(port())
    for m in mods:
        monkeypatch.setattr(importlib.import_module(
            f"mi_fieldcalc_tpu_torch.{m}"), "torch", _HostScalars())
    for m, name, fn in attrs:
        monkeypatch.setattr(importlib.import_module(
            f"mi_fieldcalc_tpu_torch.{m}"), name, fn)
    before = _flat(port())
    monkeypatch.undo()
    assert len(now) == len(before)
    for a, b in zip(now, before):
        assert _same(a, b), case
    for a, r in zip(now, _flat(jax_fn())):
        if a.dtype == np.bool_ or exact:
            assert _same(a, r.astype(a.dtype)), case
        else:
            np.testing.assert_allclose(a, r, rtol=2e-5, atol=1e-30,
                                       err_msg=case)


def test_decay_table_built_once_and_matches_jax():
    """B5 / B6's decay table is one kept tensor per (table, device), the
    float32 rounding of the JAX package's table."""
    from mi_fieldcalc_tpu.ops import icing as ji
    from mi_fieldcalc_tpu_torch.ops import icing_fused as F
    from mi_fieldcalc_tpu_torch.ops.icing import _mincog_decay, _number
    decay = _mincog_decay(2.0, _number(2.0, 11.0))
    a = F._decay_tensor(decay, torch.device("cpu"))
    assert F._decay_tensor(list(decay), torch.device("cpu")) is a
    assert _same(a.numpy(), torch.tensor(decay, dtype=torch.float32).numpy())
    ref = np.asarray(ji._mincog_decay(2.0, _number(2.0, 11.0)), np.float32)
    assert _same(a.numpy(), ref)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graph capture and kernels B5 "
                    "/ B6; no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_storm_graph_replays_match_eager_on_the_card(cuda_device):
    """The storm and the icing storm as CUDA graphs: one capture each,
    replays byte for byte the eager calls on the card."""
    dev = cuda_device
    g = lab.inputs(96, 128)
    eager = lab.fetch_all(lab.storm(api, g, device=dev))
    B._program_stats(reset=True)
    for _ in range(3):
        with api.batch(device=dev):
            out = lab.storm(api, g, device=dev)
        assert all(_same(e, b) for e, b in zip(eager, lab.fetch_all(out)))
    stats = B._program_stats()
    assert stats["captures"] == 1 and stats["replays"] == 3
    ins = api_inputs("vesselIcingMincog", (37, 61))
    sc = dict(vs=5.0, alpha=0.52, zmin=2.0, zmax=11.0)
    calls = [dict(alt=1), dict(alt=2), None]

    def istorm():
        return [api.vesselIcingMincog(*ins, **sc, **c, device=dev) if c
                else api.vesselIcingModStall(*ins, **sc, device=dev)
                for c in calls]

    ieager = istorm()
    for _ in range(2):
        with api.batch(device=dev):
            out = istorm()
        assert all(_same(e, b) for e, b in zip(ieager, out))
