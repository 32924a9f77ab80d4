"""The sharded cases of ``tests/test_torch_parallel.py`` and
``tests/test_torch_parallel_fused.py``, shared by the test modules and the
gloo ranks that run them (``tests/torch_parallel_worker.py``).

A case holds its grid shape, ``sharded(grid)``, which every rank runs on
its own blocks and which returns the same value on every rank (global
arrays through ``distributed.gather``, or the ranks' answers gathered
with ``all_gather_object``), and ``unsharded()``, the same call on the
whole grid in one process.  Inputs are made from seeds with numpy, as the
JAX tests' are (``tests/test_parallel.py`` ``_grids``,
``tests/test_fused.py`` ``_inputs``), so the JAX package can take the
same arrays.  Imports torch and the port, never jax.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from mi_fieldcalc_tpu_torch import ops
from mi_fieldcalc_tpu_torch.field import UNDEF, Field, from_sentinel
from mi_fieldcalc_tpu_torch.models.ensemble import ensemble_derived_summary
from mi_fieldcalc_tpu_torch.models.pipeline import derived_fields_isobaric
from mi_fieldcalc_tpu_torch.ops.fused import derived_fields_fused
from mi_fieldcalc_tpu_torch.parallel import distributed, halo, run_sharded
from mi_fieldcalc_tpu_torch.parallel.fused import (
    derived_fields_fused_sharded, derived_fields_isobaric_sharded,
    ensemble_summary_sharded)
from mi_fieldcalc_tpu_torch.parallel.mesh import partition_spec


@dataclasses.dataclass(frozen=True)
class Case:
    mesh: Tuple[int, int, int]
    sharded: Callable
    unsharded: Optional[Callable] = None


# ---------------------------------------------------------------- inputs

def grids(ny=32, nx=48, batch=None, seed=0, holes=True):
    """``test_parallel._grids`` as sentinel numpy arrays: z, t and the
    map factors and coriolis planes."""
    rng = np.random.default_rng(seed)
    shape = (ny, nx) if batch is None else (batch, ny, nx)
    z = rng.normal(5000, 100, shape).astype(np.float32)
    t = rng.normal(280, 5, shape).astype(np.float32)
    if holes:
        z[..., 3, 7] = UNDEF
        z[..., 0, 0] = UNDEF      # physical corner
        t[..., 15, 23] = UNDEF    # interior of a different shard
        t[..., 16, 0] = UNDEF     # physical left edge, shard seam row
    xm = np.full(shape, 1e-5, np.float32)
    ym = np.full(shape, 1.1e-5, np.float32)
    fc = np.full(shape, 1e-4, np.float32)
    return z, t, xm, ym, fc


def pipeline_inputs(nlev, ny, nx, seed=0, undefs=True):
    """``test_fused._inputs`` as numpy: five sentinel arrays (tk, q, u, v,
    ps) and alevel, blevel, xmapr, ymapr, fcoriolis."""
    rng = np.random.default_rng(seed)
    tk = rng.normal(275, 15, (nlev, ny, nx)).astype(np.float32)
    q = rng.uniform(1e-4, 1e-2, (nlev, ny, nx)).astype(np.float32)
    u = rng.normal(0, 12, (nlev, ny, nx)).astype(np.float32)
    v = rng.normal(0, 12, (nlev, ny, nx)).astype(np.float32)
    ps = rng.normal(1000, 15, (ny, nx)).astype(np.float32)
    if undefs:
        for arr in (tk, q, u, v):
            idx = rng.integers(0, arr.size, arr.size // 37)
            arr.reshape(-1)[idx] = UNDEF
        tk[0, 0, 0] = UNDEF
        tk[-1, -1, -1] = UNDEF
        tk[0, 1, 1] = 500.0
        ps[ny // 2, nx // 2] = UNDEF
    alevel = np.linspace(0, 50, nlev).astype(np.float32)
    blevel = np.linspace(1, 0.5, nlev).astype(np.float32)
    xm = rng.uniform(3e-7, 5e-7, (ny, nx)).astype(np.float32)
    ym = rng.uniform(3e-7, 5e-7, (ny, nx)).astype(np.float32)
    fc = np.full((ny, nx), 1.2e-4, np.float32)
    return [tk, q, u, v, ps, alevel, blevel, xm, ym, fc]


def isobaric_inputs(nlev, ny, nx, seed, undefs=True):
    """``test_parallel_fused``'s isobaric inputs: monotone hybrid columns
    (model top first)."""
    a = pipeline_inputs(nlev, ny, nx, seed, undefs)
    a[5] = np.linspace(50, 300, nlev).astype(np.float32)
    a[6] = (np.linspace(0.0, 0.7, nlev) ** 1.5).astype(np.float32)
    return a


def all_defined_inputs(nlev, ny, nx, seed):
    """Fully defined inputs that still reach both data-dependent gates: a
    point beyond the e_sat table and a |grad T| = 0 plateau."""
    a = pipeline_inputs(nlev, ny, nx, seed, undefs=False)
    a[0][0, 3, 3] = 500.0
    a[0][-1, ny // 2:ny // 2 + 4, 5:9] = 290.0
    return a


def _port(arrays, grid=None):
    """The pipeline's 10 arguments in the port: Fields for the five
    sentinel arrays, tensors for the rest; with ``grid``, this rank's
    blocks (alevel / blevel cut over lev)."""
    def cut(a):
        return (torch.from_numpy(np.ascontiguousarray(a)) if grid is None
                else distributed.local_shard_array(a, grid))

    return ([from_sentinel(cut(a)) for a in arrays[:5]]
            + [cut(a) for a in arrays[5:]])


def _field(a, grid=None) -> Field:
    return from_sentinel(torch.from_numpy(a) if grid is None
                         else distributed.local_shard_array(a, grid))


def _tensor(a, grid=None) -> torch.Tensor:
    return (torch.from_numpy(a) if grid is None
            else distributed.local_shard_array(a, grid))


def assert_same(ref, got, label=""):
    """Fields (or trees of them): masks equal, values equal bit for bit
    where defined (NaN where NaN)."""
    if isinstance(ref, Field):
        assert torch.equal(ref.mask, got.mask), (label, "mask")
        rv, gv = ref.values[ref.mask], got.values[ref.mask]
        same = (rv.view(torch.int32) == gv.view(torch.int32)) | (
            torch.isnan(rv) & torch.isnan(gv))
        assert bool(same.all()), (label, int((~same).sum()))
        return
    if isinstance(ref, torch.Tensor):
        assert torch.equal(ref, got), label
        return
    assert len(ref) == len(got), label
    for i, (r, g) in enumerate(zip(ref, got)):
        assert_same(r, g, f"{label}[{i}]")


def per_rank(obj):
    """Every rank's ``obj``, in rank order, on every rank."""
    import torch.distributed as dist
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


# ------------------------------------------------------ the stencil cases

OPS = [
    ("gradient_dx", lambda f, x, y: ops.gradient(f, x, y, 1), 1, "zt_xy"),
    ("gradient_abs", lambda f, x, y: ops.gradient(f, x, y, 3), 1, "zt_xy"),
    ("gradient_lapl", lambda f, x, y: ops.gradient(f, x, y, 4), 1, "zt_xy"),
    ("relvort", ops.relvort, 1, "uv_xy"),
    ("divergence", ops.divergence, 1, "uv_xy"),
    ("jacobian", ops.jacobian, 1, "uv_xy"),
    ("gwind_x", ops.plevelgwind_xcomp, 1, "z_xyf"),
    ("gvort", ops.plevelgvort, 1, "z_xyf"),
    ("qvector", lambda z, t, x, y, f: ops.plevelqvector(
        z, t, x, y, f, p=500.0, compute=1), 2, "ztxyf"),
    ("tfp", ops.thermal_front_parameter, 2, "t_xy"),
]

MESHES = [(1, 2, 2), (1, 4, 1), (1, 1, 4), (2, 2, 1)]


def _build_args(kind, arrays, grid):
    z, t, xm, ym, fc = arrays
    f = {"z": _field(z, grid), "t": _field(t, grid)}
    x, y, c = (_tensor(a, grid) for a in (xm, ym, fc))
    return {"zt_xy": (f["z"], x, y), "uv_xy": (f["z"], f["t"], x, y),
            "z_xyf": (f["z"], x, y, c), "ztxyf": (f["z"], f["t"], x, y, c),
            "t_xy": (f["t"], x, y)}[kind]


def _op_case(mesh, fn, radius, kind, arrays):
    def sharded(grid):
        args = _build_args(kind, arrays, grid)
        return distributed.gather(run_sharded(fn, grid, radius, *args),
                                  grid)

    return Case(mesh, sharded, lambda: fn(*_build_args(kind, arrays, None)))


def _qvector3(*a):
    return ops.plevelqvector(*a, p=500.0, compute=3)


def _momentum(which):
    if which == "x":
        return lambda v, m, f: ops.momentum_x_coordinate(v, m, f, 1e-5)
    return lambda u, m, f: ops.momentum_y_coordinate(u, m, f, 1e-5)


def _exchange_case(mesh, axis):
    """Packed legs against the per-array exchange, and both against the
    global array: mixed 2-D / 3-D float32 and bool arrays."""
    rng = np.random.default_rng(3)
    ny, nx, h = 30, 46, 2
    arrs = [rng.normal(size=(3, ny, nx)).astype(np.float32),
            rng.normal(size=(ny, nx)).astype(np.float32),
            rng.random((3, ny, nx)) < 0.5, rng.random((ny, nx)) < 0.5]
    leg = (halo.packed_exchange_rows if axis == "gy"
           else halo.packed_exchange_cols)
    dim = -2 if axis == "gy" else -1

    def sharded(grid):
        loc = [distributed.local_shard_array(a, grid) for a in arrs]
        packed = leg(loc, h, grid)
        single = [leg([a], h, grid)[0] for a in loc]
        (r0, r1), (c0, c1) = grid.block("gy", ny), grid.block("gx", nx)
        ok = []
        for a, p, s in zip(arrs, packed, single):
            pad = [(0, 0)] * (a.ndim - 2) + [(h, h) if dim == -2 else (0, 0),
                                             (h, h) if dim == -1 else (0, 0)]
            g = np.pad(a, pad)
            want = (g[..., r0:r1 + 2 * h, c0:c1] if dim == -2
                    else g[..., r0:r1, c0:c1 + 2 * h])
            ok.append(bool(torch.equal(p, s)) and p.dtype == s.dtype
                      and np.array_equal(p.numpy(), want))
        return per_rank(ok)

    return Case(mesh, sharded)


def _sendrecv_case():
    """``packed_sendrecv`` on pre-sliced strips taller than a block, with
    rank-dependent payloads: the neighbour's strip arrives, zeros at the
    physical edges, bool restored."""
    rng = np.random.default_rng(9)
    nys = 20
    f3 = torch.from_numpy(rng.normal(size=(2, nys, 2)).astype(np.float32))
    f2 = torch.from_numpy(rng.normal(size=(nys, 2)).astype(np.float32))
    b3 = torch.from_numpy(rng.random((2, nys, 2)) < 0.5)

    def sharded(grid):
        ix = float(grid.coords[2])
        prev, nxt = halo.packed_sendrecv([f3 + ix, f2 + ix, b3],
                                         [f3 - ix, f2 - ix, ~b3], grid, "gx")
        return per_rank((prev[0], nxt[1], prev[2]))

    return Case((1, 1, 4), sharded), (f3, f2, b3)


def _grid_case():
    """``grid_mesh``: coordinates, ranks, neighbours, and the shapes its
    arguments give."""
    def sharded(grid):
        from mi_fieldcalc_tpu_torch.parallel import grid_mesh
        g2 = grid_mesh((2, 2), device="cpu")
        g1 = grid_mesh((4,), device="cpu")
        gs = grid_mesh(grid_shape=(30, 46), device="cpu")
        gd = grid_mesh(device="cpu")
        return per_rank({"coords": grid.coords, "rank": grid.rank,
                         "gy": grid.neighbours("gy"),
                         "gx": grid.neighbours("gx"),
                         "shapes": [g.shape for g in (g2, g1, gs, gd)],
                         "g1_gx": g1.neighbours("gx")})

    return Case((1, 2, 2), sharded)


def _neighbour_case(mesh, compute, consts):
    _, t, _, _, _ = grids(ny=40, nx=64, holes=False)
    rng_ = int(consts[0] if compute < 4 else consts[1])
    step = (int(consts[-1]) if len(consts) >= (2 if compute < 4 else 3)
            else 3)

    def fn(f):
        return ops.neighbour_functions(f, consts, compute)

    return Case(mesh, lambda g: distributed.gather(
        run_sharded(fn, g, rng_ + step - 1, _field(t, g)), g),
        lambda: fn(_field(t)))


def _neighbour_prob_case(mesh):
    _, t, _, _, _ = grids(ny=40, nx=64, holes=False)

    def fn(f):
        return ops.neighbour_prob_functions(f, (280.0, 4.0), 5)

    return Case(mesh, lambda g: distributed.gather(
        run_sharded(fn, g, 4, _field(t, g)), g), lambda: fn(_field(t)))


def _cvtemp_case(mesh, compute):
    v = np.zeros((32, 48), np.float32)
    v[:16] = 10.0          # Celsius-looking half
    v[16:] = 290.0         # Kelvin-looking half; global mean 150 > t0 / 2

    def fn(f):
        return ops.cvtemp(f, compute)

    return Case(mesh, lambda g: distributed.gather(
        run_sharded(fn, g, 0, _field(v, g)), g), lambda: fn(_field(v)))


def _probability_case(mesh):
    vals = np.full((4, 32, 48), 12.0, np.float32)
    vals[1] = UNDEF
    vals[1, :4, :4] = 9.0       # defined only in the top-left shard

    def fn(m):
        return ops.probability(1, m, [10.0])

    return Case(mesh, lambda g: distributed.gather(
        run_sharded(fn, g, 0, _field(vals, g)), g), lambda: fn(_field(vals)))


def _ops_cases() -> Dict[str, Case]:
    cases = {}
    base = grids()
    for name, fn, radius, kind in OPS:
        cases[f"op_{name}"] = _op_case((1, 2, 2), fn, radius, kind, base)
    # an uneven cut on both axes: 30 rows over 4 and 46 columns over 4
    uneven = grids(ny=30, nx=46)
    for mesh in MESHES:
        cases[f"qvector_{mesh}"] = _op_case(mesh, _qvector3, 2, "ztxyf",
                                            uneven)
    cases["tuple_output"] = _op_case((1, 2, 2), ops.ilevelgwind, 1,
                                     "z_xyf", base)
    cases["batched"] = _op_case((2, 2, 1), ops.relvort, 1, "uv_xy",
                                grids(batch=4))
    for mesh in [(1, 2, 2), (1, 4, 1), (1, 1, 4)]:
        for which, kind in (("x", "z_xyf"), ("y", "z_xyf")):
            z, t, xm, ym, fc = grids(holes=False)
            arrs = (z, t, xm if which == "x" else ym, ym, fc)
            fn = _momentum(which)
            cases[f"momentum_{which}_{mesh}"] = Case(
                mesh,
                functools.partial(
                    lambda g, fn, arrs: distributed.gather(run_sharded(
                        fn, g, 0, _field(arrs[0], g), _tensor(arrs[2], g),
                        _tensor(arrs[4], g)), g), fn=fn, arrs=arrs),
                functools.partial(
                    lambda fn, arrs: fn(_field(arrs[0]), _tensor(arrs[2]),
                                        _tensor(arrs[4])), fn, arrs))
    for mesh in [(1, 2, 2), (1, 4, 1)]:
        for holes in (False, True):
            t = grids(holes=holes)[1]
            cases[f"shapiro_{mesh}_{holes}"] = Case(
                mesh, functools.partial(
                    lambda g, t: distributed.gather(run_sharded(
                        ops.shapiro2_filter, g, 2, _field(t, g)), g), t=t),
                functools.partial(
                    lambda t: ops.shapiro2_filter(_field(t)), t))
    cases["exchange_gy"] = _exchange_case((1, 4, 1), "gy")
    cases["exchange_gx"] = _exchange_case((1, 1, 4), "gx")
    cases["exchange_gy_2d"] = _exchange_case((1, 2, 2), "gy")
    cases["exchange_gx_2d"] = _exchange_case((1, 2, 2), "gx")
    cases["sendrecv"] = _sendrecv_case()[0]
    cases["grid_mesh"] = _grid_case()
    for mesh in [(1, 2, 2), (1, 4, 1), (1, 1, 4)]:
        for compute, consts in NEIGHBOUR_CONSTS:
            cases[f"neighbour_{mesh}_{compute}_{consts}"] = _neighbour_case(
                mesh, compute, consts)
    for mesh in [(1, 2, 2), (1, 4, 1)]:
        cases[f"neighbour_prob_{mesh}"] = _neighbour_prob_case(mesh)
    for mesh in [(1, 2, 2), (1, 4, 1)]:
        for compute in (3, 4):
            cases[f"cvtemp_{mesh}_{compute}"] = _cvtemp_case(mesh, compute)
    cases["probability"] = _probability_case((1, 2, 2))
    cases["elementwise"] = _elementwise_case((1, 2, 2))
    return cases


def _elementwise_case(mesh):
    """A pointwise operator needs no halo: radius 0."""
    _, t, _, _, _ = grids(holes=False)
    rh = np.random.default_rng(1).uniform(10, 95, (32, 48)).astype(
        np.float32)
    return Case(mesh, lambda g: distributed.gather(run_sharded(
        ops.abshum, g, 0, _field(t, g), _field(rh, g)), g),
        lambda: ops.abshum(_field(t), _field(rh)))


NEIGHBOUR_CONSTS = [
    (1, (3.0, 3.0)),         # mean, rng=3 step=3
    (2, (2.0, 4.0)),         # max, rng=2 step=4
    (4, (30.0, 2.0, 3.0)),   # 30th percentile, rng=2 step=3
    (5, (280.0, 3.0, 2.0)),  # prob above, rng=3 step=2
    (1, (2.0, 1.0)),         # step=1: every point its own sample
]


# ------------------------------------------------------- the fused cases

FUSED_SHAPES = [
    ((1, 2, 2), 2, 48, 64),
    ((2, 2, 1), 4, 40, 137),    # lev-cut + y-split, ragged nx
    ((1, 4, 1), 2, 64, 96),     # deep y-split
    ((1, 1, 4), 2, 32, 128),    # x-split only
    ((1, 4, 1), 2, 30, 50),     # uneven: 30 rows over 4
]

ISOBARIC_SHAPES = [
    ((1, 2, 2), 10, 48, 64),
    ((1, 4, 1), 8, 64, 96),
    ((1, 1, 4), 8, 32, 128),
]

#: the cuts that stand in for the JAX padded-layout cases
UNEVEN_SHAPES = [
    ((1, 4, 1), 2, 45, 130),    # 45 rows over 4: 12, 11, 11, 11
    ((2, 2, 1), 2, 41, 96),     # lev-cut, 41 rows over 2
    ((1, 2, 2), 2, 45, 141),    # 45 rows over 2, 141 columns over 2
]

#: the slice as a whole against the JAX package: 2x24x32 on (1, 2, 2)
JAX_SHAPE = (2, 24, 32)
JAX_SEED = 56


def _fused_case(mesh, arrays, overlap, **kw):
    """The sharded pipeline; its reference is the whole-grid kernel's
    masked route, per field."""
    def sharded(grid):
        return distributed.gather(derived_fields_fused_sharded(
            grid, *_port(arrays, grid), overlap=overlap, **kw), grid,
            spec=(None,) + partition_spec(3) if kw.get("stacked") else None)

    return Case(mesh, sharded,
                lambda: derived_fields_fused(*_port(arrays), stacked=False))


def _isobaric_case(mesh, arrays, plv, overlap, **kw):
    def sharded(grid):
        return distributed.gather(derived_fields_isobaric_sharded(
            grid, *_port(arrays, grid), plevels=plv, overlap=overlap, **kw),
            grid)

    return Case(mesh, sharded, lambda: derived_fields_isobaric(
        *_port(arrays), plevels=plv, fused=True))


def _isobaric_rejects_lev_case():
    arrays = pipeline_inputs(4, 16, 32)

    def sharded(grid):
        try:
            derived_fields_isobaric_sharded(grid, *_port(arrays, grid),
                                            plevels=(900.0,))
        except ValueError as e:
            return str(e)
        return None

    return Case((2, 2, 1), sharded)


def ensemble_inputs(nmem=3, nlev=2, ny=32, nx=64):
    """``test_parallel_fused``'s ensemble: member 2's tk defined only in
    the top-left corner.  Returns sentinel member stacks (tk, q, u, v, ps)
    and alevel, blevel, xmapr, ymapr, fcoriolis."""
    members = [pipeline_inputs(nlev, ny, nx, seed=100 + m)
               for m in range(nmem)]
    stacks = [np.stack([mm[i] for mm in members]) for i in range(5)]
    tk2 = np.full((nlev, ny, nx), UNDEF, np.float32)
    tk2[:, :4, :4] = stacks[0][2, :, :4, :4]
    stacks[0][2] = tk2
    return stacks + members[0][5:]


def _ensemble_case(mesh):
    arrays = ensemble_inputs()

    def sharded(grid):
        args = _port(arrays, grid)
        return distributed.gather(ensemble_summary_sharded(grid, *args),
                                  grid)

    return Case(mesh, sharded, lambda: ensemble_derived_summary(
        *_port(arrays), fused=True))


def _fused_cases() -> Dict[str, Case]:
    cases = {}
    for overlap in (False, True):
        for mesh, nlev, ny, nx in FUSED_SHAPES:
            cases[f"fused_{mesh}_{ny}x{nx}_{overlap}"] = _fused_case(
                mesh, pipeline_inputs(nlev, ny, nx, seed=ny + nx), overlap)
        for mesh, nlev, ny, nx in ISOBARIC_SHAPES:
            cases[f"isobaric_{mesh}_{overlap}"] = _isobaric_case(
                mesh, isobaric_inputs(nlev, ny, nx, seed=7 * ny + nx),
                (925.0, 850.0, 700.0, 500.0, 300.0), overlap)
        for mesh, nlev, ny, nx in UNEVEN_SHAPES:
            cases[f"uneven_{mesh}_{ny}x{nx}_{overlap}"] = _fused_case(
                mesh, pipeline_inputs(nlev, ny, nx, seed=5 * ny + nx),
                overlap)
        args = pipeline_inputs(2, 32, 64, seed=17)
        cases[f"stacked_{overlap}"] = _fused_case((1, 2, 2), args, overlap,
                                                  stacked=True)
        for mesh, nlev, ny, nx in FUSED_SHAPES[:4:1]:
            if mesh[0] != 1:
                continue
            a = all_defined_inputs(nlev, ny, nx, seed=5 * ny + nx)
            cases[f"all_defined_{mesh}_{overlap}"] = _fused_case(
                mesh, a, overlap, all_defined=True)
            cases[f"all_defined_stacked_{mesh}_{overlap}"] = _fused_case(
                mesh, a, overlap, all_defined=True, stacked=True)
        cases[f"isobaric_all_defined_{overlap}"] = _isobaric_case(
            (1, 2, 2), isobaric_inputs(8, 48, 64, seed=13, undefs=False),
            (925.0, 850.0, 500.0), overlap, all_defined=True)
        cases[f"uneven_all_defined_{overlap}"] = _fused_case(
            (1, 2, 2), all_defined_inputs(2, 43, 117, seed=11 * 43), overlap,
            all_defined=True)
        cases[f"jax_{overlap}"] = _fused_case(
            (1, 2, 2), pipeline_inputs(*JAX_SHAPE, seed=JAX_SEED), overlap)
    cases["isobaric_rejects_lev"] = _isobaric_rejects_lev_case()
    for mesh in [(1, 2, 2), (1, 4, 1)]:
        cases[f"ensemble_{mesh}"] = _ensemble_case(mesh)
    return cases


# ------------------------------------------- the MEPS-30 cell's cases

#: the seed of the MEPS-30 cases' inputs
MEPS_SEED = 2 ** 31 + 28
#: the MEPS-30 block reference's levels a block (the cell's 8 would hold
#: the 3 levels of the CPU size in one)
MEPS_LEVEL_BLOCK = 2


def meps_config() -> tuple:
    """The cell ``meps30_l65.ens30``'s configuration at its ``cpu_test``
    size (30 members, 3 levels, 21x19, ragged blocks over (1, 2, 2)) and
    its traffic, as ``benchmark/`` holds them."""
    import json
    from pathlib import Path

    root = Path(__file__).resolve().parents[1] / "benchmark"
    config = json.loads((root / "configs" / "meps30_l65.json").read_text())
    traffic = json.loads((root / "traffic" / "ens30.json").read_text())
    return dict(config, **config["cpu_test"]), traffic


def meps_case(block):
    """The cell's inputs of one lead time on ``block`` (``((r0, r1), (c0,
    c1))``), drawn by ``benchmark.inputs_sharded`` as the cell draws them."""
    from benchmark.inputs_sharded import BlockCase
    config, traffic = meps_config()
    return BlockCase(MEPS_SEED, config, traffic, (1, config["members"]),
                     block, torch.device("cpu"))


def meps_block(grid) -> tuple:
    config, _ = meps_config()
    return grid.block("gy", config["ny"]), grid.block("gx", config["nx"])


def _meps_summary(grid, case):
    config, traffic = meps_config()
    args = [Field(v[0], m[0]) for v, m in
            (case.fields[n] for n in ("tk", "q", "u", "v", "ps"))]
    return ensemble_summary_sharded(
        grid, *args, case.alevel, case.blevel, case.xmapr, case.ymapr,
        case.fcoriolis, wind_limit=float(traffic["wind_limit"]),
        global_shape=(config["ny"], config["nx"]))


def _meps_summary_case():
    def sharded(grid):
        return distributed.gather(
            _meps_summary(grid, meps_case(meps_block(grid))), grid)

    return Case((1, 2, 2), sharded)


def _max_over_ranks(flags):
    import torch.distributed as dist
    dist.all_reduce(flags, op=dist.ReduceOp.MAX)
    return flags


def _meps_blocks_case():
    """Every rank's answer of the block reference, with its block."""
    from benchmark.reference import ensemble_block

    def sharded(grid):
        config, traffic = meps_config()
        case = meps_case(meps_block(grid))
        ref = ensemble_block.summary(
            lambda levels: case.window(0, levels), config["members"],
            config["levels"], case.alevel, case.blevel, case.win_xmapr,
            case.win_ymapr, case.crop, float(traffic["wind_limit"]),
            MEPS_LEVEL_BLOCK, reduce_flags=_max_over_ranks)
        return per_rank((case.block, ref))

    return Case((1, 2, 2), sharded)


def _meps_spans_case():
    """One sharded summary under a profiler session, then one without:
    each rank's spans (name, its parent's name), counters and block, and
    what the second summary left recorded."""
    from torch.profiler import ProfilerActivity, profile

    from mi_fieldcalc_tpu_torch.utils import profiling

    def sharded(grid):
        case = meps_case(meps_block(grid))
        with profile(activities=[ProfilerActivity.CPU]):
            _meps_summary(grid, case)
        rec = profiling.take()
        names = {s.id: s.name for s in rec.spans}
        _meps_summary(grid, case)
        after = profiling.recorded()
        return per_rank({"spans": [(s.name, names.get(s.parent))
                                   for s in rec.spans],
                         "counters": rec.counters, "block": case.block,
                         "after": (len(after.spans), after.counters)})

    return Case((1, 2, 2), sharded)


def _meps_cases() -> Dict[str, Case]:
    return {"summary": _meps_summary_case(), "blocks": _meps_blocks_case(),
            "spans": _meps_spans_case()}


CASES = {"ops": _ops_cases, "fused": _fused_cases, "meps": _meps_cases}


def run_ranks(group: str, out_dir, world: int = 4, timeout: float = 120.0,
              attempts: int = 2):
    """``CASES[group]`` on ``world`` gloo ranks (``torch_parallel_worker``
    processes on this host), their results as rank 0 saved them.  Every
    process is killed when a run ends; a rank that fails or a run past
    ``timeout`` seconds is tried again on a new port (another process may
    have taken the free one) and then raises with the ranks' output."""
    for attempt in range(attempts):
        try:
            return _run_ranks(group, out_dir, world, timeout, attempt)
        except RuntimeError:
            if attempt == attempts - 1:
                raise


def _run_ranks(group, out_dir, world, timeout, attempt):
    import socket
    import subprocess
    import sys
    import time
    from pathlib import Path

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out_dir = Path(out_dir) / f"attempt{attempt}"
    out_dir.mkdir(parents=True, exist_ok=True)
    out = Path(out_dir) / f"{group}.pt"
    worker = Path(__file__).resolve().parent / "torch_parallel_worker.py"
    logs = [open(Path(out_dir) / f"{group}_{r}.log", "w+")
            for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(worker), group, str(r),
                               str(world), str(port), str(out)],
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]
    try:
        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    except subprocess.TimeoutExpired:
        failed = list(range(world))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed or not out.is_file():
        text = []
        for r, log in enumerate(logs):
            log.seek(0)
            text.append(f"--- rank {r} (rc {procs[r].returncode})\n"
                        + log.read()[-3000:])
        raise RuntimeError(f"gloo ranks of {group!r} failed:\n"
                           + "\n".join(text))
    for log in logs:
        log.close()
    return torch.load(out, weights_only=False)
