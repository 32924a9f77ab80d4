"""The port's measurement probes (``mi_fieldcalc_tpu_torch/tools/``, kernels
in ``csrc/probes.cu``) against the JAX-era probes and their definitions.

* P2 (``perf_lab_dma``) against JAX's own ``pallas_add1(ty, nbuf)`` and
  ``pallas_add1_flat`` run in the TPU interpreter
  (``force_tpu_interpret_mode``) at a small ragged shape: equal bit for
  bit (``x + 1`` rounds once on both sides).
* P4 (``probe_mincog_kernel``) against JAX's ``kernel`` through
  ``pl.pallas_call(..., interpret=True)`` with the tool's grid spec, at the
  tool's 64x256 from seed 0.  JAX takes ``jnp.tanh`` and the port its
  deterministic ``tanh_f32``, so the two differ by ulps in each iteration.
  Converged lanes stop within 1e-5 of their last step on either side but
  may stop one iteration apart when an ulp moves the error across the
  tolerance, so their ``c`` agree to ~2e-5 and the output (sum of the
  decay table = 3 times ``c``) within atol 6e-5 (measured 3.1e-5).  Lanes
  still moving at the 100-iteration cap run a contracting map, so the
  per-iteration ulp differences (~2.4e-7 relative) do not grow: rtol 2e-5
  (measured 1.2e-6).
* P1 (``bench_copy``) and P3 (``perf_lab_element``) have no JAX run on the
  CPU: P1 is a closure inside ``bench.main`` built for the TPU's padded
  layout, and P3's out-of-bounds window raises in the TPU interpreter (and
  with ``out_of_bounds_reads="uninitialized"`` its centre rows come out
  wrong).  Their plain versions are held to numpy statements of their
  definitions instead, bit for bit.

Every wrapper runs its plain version on CPU tensors and counts no launch.
The ``cuda``-marked test holds each kernel to its plain version on the card
and skips where there is none.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from mi_fieldcalc_tpu_torch._libm import tanh_f32
from mi_fieldcalc_tpu_torch.field import Field
from mi_fieldcalc_tpu_torch.tools import (
    _lab, bench_copy, perf_lab_dma, perf_lab_element, probe_mincog_kernel,
)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
_CACHE_KEYS = ("jax_compilation_cache_dir",
               "jax_persistent_cache_min_compile_time_secs")


def _jax_tool(name: str):
    """``tools/<name>.py`` imported as a module of its own.  Its import
    points JAX's compilation cache into the repository; the settings are
    restored after it."""
    saved = {k: getattr(jax.config, k) for k in _CACHE_KEYS}
    spec = importlib.util.spec_from_file_location(
        f"_jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


@pytest.fixture
def jax_dma():
    return _jax_tool("perf_lab_dma")


@pytest.fixture
def jax_mincog():
    return _jax_tool("probe_mincog_kernel")


def test_tool_import_restores_the_cache_setting():
    before = jax.config.jax_compilation_cache_dir
    _jax_tool("probe_mincog_kernel")
    assert jax.config.jax_compilation_cache_dir == before


# ---------------------------------------------------------------- P2


@pytest.mark.parametrize("ty,nbuf", [(8, 3), (48, 1)])
def test_add1_matches_jax_pallas_add1(jax_dma, monkeypatch, ty, nbuf):
    shape = (3, 37, 41)
    for name, n in zip(("NLEV", "NY", "NX"), shape):
        monkeypatch.setattr(jax_dma, name, n)
    x = np.random.default_rng(ty).normal(size=shape).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_dma.pallas_add1(ty, nbuf)(jnp.asarray(x))
        flat = jax_dma.pallas_add1_flat(jnp.asarray(x))
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = perf_lab_dma.add1(torch.as_tensor(x), nbuf, ty)
    assert len(got) == len(ref) == nbuf
    for g, r in zip(got, ref):
        assert np.array_equal(g.numpy(), np.asarray(r))
    assert np.array_equal(perf_lab_dma.add1(torch.as_tensor(x), 1,
                                            shape[1])[0].numpy(),
                          np.asarray(flat))


# ---------------------------------------------------------------- P4


def test_solver_matches_jax_probe_kernel(jax_mincog):
    ny, nx = probe_mincog_kernel.TOOL_SHAPE
    c0, a, decay = probe_mincog_kernel.solver_inputs((ny, nx), seed=0)
    spec = pl.BlockSpec((8, 128), lambda y, x, *_: (y, x),
                        memory_space=pltpu.VMEM)
    gs = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(ny // 8, nx // 128),
        in_specs=[spec, spec], out_specs=spec)
    ref = np.asarray(pl.pallas_call(
        jax_mincog.kernel, grid_spec=gs,
        out_shape=jax.ShapeDtypeStruct((ny, nx), jnp.float32),
        interpret=True)(*(jnp.asarray(t.numpy()) for t in (decay, c0, a))))
    got = probe_mincog_kernel.solver(c0, a, decay).numpy()
    _, done = probe_mincog_kernel.solver_trips(c0, a)
    done = done.numpy()
    assert np.isfinite(ref).all() and np.isfinite(got).all()
    assert 0 < int((~done).sum()) < done.size
    err = np.abs(got - ref)
    assert err[done].max() <= 6e-5
    assert (err[~done] <= 2e-5 * np.abs(ref[~done])).all()


def test_solver_lane_grouping_does_not_matter():
    c0, a, decay = probe_mincog_kernel.solver_inputs((64, 256), seed=0)
    whole = probe_mincog_kernel.solver_plain(c0, a, decay)
    parts = torch.cat([probe_mincog_kernel.solver_plain(c0[i:i + 8],
                                                        a[i:i + 8], decay)
                       for i in range(0, 64, 8)])
    assert torch.equal(whole, parts)


def _branches_numpy(c0: np.ndarray, a: np.ndarray) -> tuple:
    """The loop in numpy float32, every lane iterated until it freezes or
    reaches the cap, its tanh from the port's ``tanh_f32``: the
    lane-iterations with |a / c| below 0.625, above 9, and the rest (NaN
    with them), and every lane's trips."""
    m = probe_mincog_kernel
    c = np.ones_like(c0)
    live = np.ones(c0.shape, bool)
    trips = np.zeros(c0.shape, np.int64)
    counts = {"poly": 0, "exp": 0, "saturated": 0}
    for _ in range(m.MAX_ITER):
        x = a / c
        ax = np.abs(x)
        poly, sign = live & (ax < 0.625), live & (ax > 9.0)
        counts["poly"] += int(poly.sum())
        counts["saturated"] += int(sign.sum())
        counts["exp"] += int((live & ~poly & ~sign).sum())
        trips += live
        c_new = c0 * tanh_f32(torch.from_numpy(x)).numpy()
        frozen = np.abs(c_new - c) <= np.float32(1e-5)
        c = np.where(live, c_new, c)
        live &= ~frozen
    return counts, trips


def test_solver_branch_counts_match_a_numpy_loop():
    c0, a, _ = probe_mincog_kernel.solver_inputs((16, 64), seed=5)
    a[0, :4] = torch.tensor([float("nan"), -3.0, 200.0, 0.01])
    c0[1, :2] = torch.tensor([float("nan"), 1.0])
    a[1, 1] = 20.0
    got = probe_mincog_kernel.solver_branches(c0, a)
    ref, ref_trips = _branches_numpy(c0.numpy(), a.numpy())
    trips, _ = probe_mincog_kernel.solver_trips(c0, a)
    assert got == ref
    assert np.array_equal(trips.numpy(), ref_trips)
    assert sum(got.values()) == int(trips.sum())
    assert all(v > 0 for v in got.values())
    assert probe_mincog_kernel.solver_ops(got, c0.numel()) == (
        15 * got["poly"] + 30 * got["exp"] + 3 * got["saturated"]
        + 10 * c0.numel())


def test_solver_maps_nan_to_zero():
    c0 = torch.tensor([2.0, 3.0, float("nan")])
    a = torch.tensor([0.0, float("nan"), 1.0])
    out = probe_mincog_kernel.solver_plain(c0, a, torch.tensor(
        probe_mincog_kernel.DECAY, dtype=torch.float32))
    assert torch.equal(out, torch.zeros(3))


# ---------------------------------------------------------------- P1


def _copy_numpy(args, all_defined):
    """P1's definition (csrc/probes.cu, bench_copy) in numpy float32."""
    tk, q, u, v, ps, _, _, xmapr, ymapr, _ = (
        a if isinstance(a, Field) else a.numpy() for a in args)
    nlev, ny, nx = tk.values.shape
    cy = np.clip(np.arange(ny), 1, ny - 2)[:, None]
    cx = np.clip(np.arange(nx), 1, nx - 2)[None, :]
    s = tk.values.numpy() + q.values.numpy()
    for t in (u.values, v.values, ps.values):
        s = s + t.numpy()
    for f in (tk, u, v):
        fv = f.values.numpy()
        for dy, dx in ((0, -1), (0, 1), (-1, 0), (1, 0)):
            s = s + fv[:, cy + dy, cx + dx]
    s = s + xmapr[cy, cx]
    s = s + ymapr[cy, cx]
    values = np.stack([s + np.float32(k) for k in range(12)])
    if all_defined:
        return values, np.ones((2, nlev, ny, nx), bool)
    m = (tk.mask.numpy() & q.mask.numpy() & u.mask.numpy() & v.mask.numpy()
         & ps.mask.numpy())
    return values, np.broadcast_to(m, (9, nlev, ny, nx))


@pytest.mark.parametrize("all_defined", [False, True],
                         ids=["masked", "all_defined"])
@pytest.mark.parametrize("shape", [(2, 9, 33), (1, 3, 3)])
def test_copy_probe_matches_its_definition(shape, all_defined):
    args = bench_copy.probe_inputs(*shape, seed=3, all_defined=all_defined,
                                   device="cpu")
    values, masks = bench_copy.copy_probe(*args[:5], args[7], args[8],
                                          all_defined)
    ref_v, ref_m = _copy_numpy(args, all_defined)
    assert values.dtype == torch.float32 and masks.dtype == torch.bool
    assert np.array_equal(values.numpy().view(np.int32),
                          ref_v.view(np.int32))
    assert np.array_equal(masks.numpy(), ref_m)


def test_copy_bytes_is_b1s_layout():
    # 4 value + 4 mask stacks, ps + mask, 2 map planes; 12 + 9 planes out
    assert bench_copy.copy_bytes(2, 3, 5, False) == (
        (4 * 5 + 12 * 4 + 9) * 30 + (5 + 8) * 15)
    assert bench_copy.copy_bytes(2, 3, 5, True) == (
        (4 * 4 + 12 * 4 + 2) * 30 + 12 * 15)


# ---------------------------------------------------------------- P3


def _window_numpy(x, y, ty):
    """P3's definition: window j holds rows [j*ty - 4, j*ty + ty + 4) of x,
    0.0 outside [0, ny); o = x + y."""
    ny = x.shape[-2]
    jy = -(-ny // ty)
    rows = []
    for j in range(jy):
        for r in range(j * ty - 4, j * ty + ty + 4):
            rows.append(x[..., r, :] if 0 <= r < ny
                        else np.zeros_like(x[..., 0, :]))
    return x + y.reshape(x.shape), np.stack(rows, axis=-2)


@pytest.mark.parametrize("shape,ty", [((32, 256), 8), ((2, 37, 29), 8),
                                      ((1, 1, 7), 32), ((3, 70, 5), 32)])
def test_window_matches_its_definition(shape, ty):
    rng = np.random.default_rng(ty)
    x = rng.normal(size=shape).astype(np.float32)
    y = rng.normal(size=(1,) * (3 - len(shape)) + shape).astype(np.float32)
    o, ow = perf_lab_element.window(torch.as_tensor(x), torch.as_tensor(y),
                                    ty)
    ref_o, ref_ow = _window_numpy(x, y, ty)
    assert np.array_equal(o.numpy(), ref_o)
    assert np.array_equal(ow.numpy(), ref_ow)


def test_window_bytes():
    # x, y, o: 3 planes; ow: 5 windows of 16 rows
    assert perf_lab_element.window_bytes(2, 37, 3, 8) == 4 * 2 * 3 * (
        3 * 37 + 5 * 16)


# ---------------------------------------------------------------- wrappers


def test_wrappers_on_cpu_run_the_plain_versions_and_count_nothing(
        monkeypatch):
    wrappers = (bench_copy.copy_probe, perf_lab_dma.add1,
                perf_lab_element.window, probe_mincog_kernel.solver)
    for w in wrappers:
        monkeypatch.setattr(w, "launches", 0)
    args = bench_copy.probe_inputs(1, 5, 6, seed=0, all_defined=False,
                                   device="cpu")
    got = bench_copy.copy_probe(*args[:5], args[7], args[8])
    ref = bench_copy.copy_probe_plain(*args[:5], args[7], args[8])
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    x = torch.ones((2, 3, 4))
    assert torch.equal(perf_lab_dma.add1(x, 2)[1], x + 1)
    assert torch.equal(perf_lab_element.window(x, x, 8)[0], x + x)
    c0, a, decay = probe_mincog_kernel.solver_inputs((3, 5))
    assert torch.equal(probe_mincog_kernel.solver(c0, a, decay),
                       probe_mincog_kernel.solver_plain(c0, a, decay))
    assert [w.launches for w in wrappers] == [0, 0, 0, 0]


def test_wrappers_raise_on_a_device_with_no_kernel():
    x = torch.empty((2, 3, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        perf_lab_dma.add1(x)
    with pytest.raises(ValueError, match="no kernel"):
        _lab.route("solver", x)


@pytest.mark.parametrize("module", [bench_copy, perf_lab_dma,
                                    perf_lab_element, probe_mincog_kernel])
def test_lab_main_on_the_cpu(module, capsys):
    assert module.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "cpu (plain versions, host clock)" in out
    assert "False" not in out


def test_lab_main_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        perf_lab_dma.main([])


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_probe_kernels_equal_plain_on_the_card(cuda_device):
    dev = cuda_device
    args = bench_copy.probe_inputs(3, 37, 61, seed=1, all_defined=False,
                                   device=dev)
    sel = args[:5] + (args[7], args[8])
    n = bench_copy.copy_probe.launches
    got, ref = bench_copy.copy_probe(*sel), bench_copy.copy_probe_plain(*sel)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert bench_copy.copy_probe.launches == n + 1
    x = torch.randn((3, 37, 41), device=dev)
    for o in perf_lab_dma.add1(x, 3, 8):
        assert torch.equal(o, x + 1)
    # x one float past its allocation's 16-byte boundary, the outputs on
    # theirs: the kernel moves it 4 bytes at a time
    shifted = torch.empty(x.numel() + 1, device=dev)[1:].view(x.shape)
    shifted.copy_(x)
    for ty in (8, 37):
        for o in perf_lab_dma.add1(shifted, 2, ty):
            assert torch.equal(o, x + 1)
    got, ref = (perf_lab_element.window(x, x, 8),
                perf_lab_element.window_plain(x, x, 8))
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    # the tool's shape, the serving grid and one lane, launched back to
    # back on one stream before any is read (the kernel leaves its counter
    # at zero for the next)
    m = probe_mincog_kernel
    cases = [m.solver_inputs(shape, 0, dev)
             for shape in (m.TOOL_SHAPE, m.GRID_SHAPE, (1, 1))]
    cases.append(m.solver_inputs(m.GRID_SHAPE, 1, dev))
    n = m.solver.launches
    outs = [m.solver(*case) for case in cases]
    assert m.solver.launches == n + len(cases)
    for out, case in zip(outs, cases):
        assert torch.equal(out, m.solver_plain(*case))
