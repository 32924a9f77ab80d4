"""The probe kernels' source, compiled for the host CPU, against their plain
versions, bit for bit.

``csrc/probes.cu`` (P1 ``mf_probe_copy``, P2 ``mf_probe_add1``, P3
``mf_probe_window``, P4 ``mf_probe_solver``, with ``csrc/common.cuh``) is
compiled by g++ through the stand-in ``cuda_runtime.h`` of
``cuda_host.py``, which runs each block as one thread: every phase of
P1-P3 is a block-stride loop, so one thread covers its block's work, and
P4's threads take lanes from their warp's pool and a counter until none
is left, so the blocks run in turn cover every lane.
With ``-ffp-contract=off`` every float operation rounds on its own, as the
card's ``-fmad=false`` build does, so each output is held to the plain
version of ``mi_fieldcalc_tpu_torch/tools/`` on every point, bit for bit.
Shapes: a ragged edge against each kernel's tile and a single row (P1's
grid needs 3 rows and 3 columns, as B1's does, so its smallest case is
3x3); P1 also on values spread over six decades, where its sum's order
shows in the rounding.  P1 and P2 move whole 16-byte groups and do the
unaligned head and tail of each run a value at a time, so their cases
also take widths of 4k, 4k+1 and 4k+3, strips and pieces that end past
the grid, and inputs and outputs at every 16-byte phase (views offset by
1-3 floats or 1-15 bytes; P2 also with the input at another phase than
its outputs, where it moves a float at a time).  P4 takes lane counts
that are not multiples of a warp's chunk, far more lanes than the host
grid's threads, inputs on which every lane runs to the cap, and two
launches in turn on one workspace, which the kernel must leave at zero.
The card checks the same (``chip_smoke.py`` phase 10).
"""

import ctypes

import numpy as np
import pytest
import torch

from cuda_host import host_library, run
from mi_fieldcalc_tpu_torch.field import Field
from mi_fieldcalc_tpu_torch.tools import (
    bench_copy, perf_lab_dma, perf_lab_element, probe_mincog_kernel,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return host_library(tmp_path_factory, "probes.cu", 5)


def _same_bits(got: torch.Tensor, ref: torch.Tensor) -> bool:
    return (got.shape == ref.shape and got.dtype == ref.dtype
            and torch.equal(got.view(torch.int32) if got.dtype ==
                            torch.float32 else got,
                            ref.view(torch.int32) if ref.dtype ==
                            torch.float32 else ref))


def _mixed_scales(args, seed):
    """The same fields with values of random sign spread over six decades,
    so that a sum taken in another order rounds differently."""
    rng = np.random.default_rng(seed)

    def draw(t):
        a = rng.choice([-1.0, 1.0], t.shape) * 10.0 ** rng.uniform(
            -3, 3, t.shape)
        return torch.as_tensor(a.astype(np.float32))

    out = []
    for a in args:
        out.append(Field(draw(a.values), a.mask) if isinstance(a, Field)
                   else draw(a))
    return tuple(out)


def _offset(t: torch.Tensor, k: int) -> torch.Tensor:
    """A copy of ``t`` whose data start ``k`` elements past a 16-byte (and
    64-byte) boundary of its storage."""
    buf = torch.empty(t.numel() + k + 64 // t.element_size(), dtype=t.dtype)
    skip = (-buf.data_ptr() % 64) // t.element_size() + k
    out = buf[skip:skip + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def _copy_on_host(host_lib, args, shape, all_defined, offsets=None):
    """P1's C entry on ``args``, each input moved ``offsets[i]`` elements
    off its 16-byte boundary, the outputs too where ``offsets`` has 16
    entries; returns (values, masks) and holds them to the plain version
    bit for bit."""
    tk, q, u, v, ps, _, _, xmapr, ymapr, _ = args
    nlev, ny, nx = shape
    ins = [tk.values, q.values, u.values, v.values, tk.mask, q.mask, u.mask,
           v.mask, ps.values, ps.mask, xmapr, ymapr]
    values = torch.full((12,) + shape, float("nan"))
    masks = torch.zeros((2 if all_defined else 9,) + shape, dtype=torch.bool)
    outs = [values, masks]
    if offsets is not None:
        ins = [_offset(t, k) for t, k in zip(ins, offsets)]
        if len(offsets) > 12:
            outs = [_offset(t, k) for t, k in zip(outs, offsets[12:])]
    if all_defined:
        for i in (4, 5, 6, 7, 9):
            ins[i] = None
    assert run(host_lib, "mf_probe_copy", (*ins, *outs, nlev, ny, nx,
                                           int(all_defined), 0)) == 0
    ref_v, ref_m = bench_copy.copy_probe_plain(tk, q, u, v, ps, xmapr, ymapr,
                                               all_defined)
    assert _same_bits(outs[0], ref_v)
    assert torch.equal(outs[1], ref_m)
    if not all_defined:
        assert 0 < int(ref_m.sum()) < ref_m.numel()


@pytest.mark.parametrize("all_defined", [False, True],
                         ids=["masked", "all_defined"])
@pytest.mark.parametrize("shape,mixed", [
    ((1, 3, 3), False), ((2, 9, 33), False), ((3, 17, 70), False),
    ((2, 9, 33), True), ((2, 7, 37), False), ((3, 5, 39), False),
    ((1, 4, 40), False)],
    ids=["3x3", "ragged", "two_tiles", "mixed_scales", "width_4k1",
         "width_4k3", "width_4k"])
def test_copy_probe_host_equals_plain(host_lib, shape, mixed, all_defined):
    args = bench_copy.probe_inputs(*shape, seed=sum(shape),
                                   all_defined=all_defined, device="cpu")
    if mixed:
        args = _mixed_scales(args, sum(shape))
    _copy_on_host(host_lib, args, shape, all_defined)


@pytest.mark.parametrize("all_defined", [False, True],
                         ids=["masked", "all_defined"])
@pytest.mark.parametrize("shape,seed,offsets", [
    ((2, 7, 37), 12, (1, 2, 3, 0, 1, 5, 15, 9, 3, 7, 2, 1)),
    ((3, 5, 39), 14, (3, 3, 3, 3, 11, 11, 11, 11, 2, 13, 1, 1, 2, 6)),
    ((1, 3, 3), 2, (2, 0, 1, 3, 4, 8, 12, 0, 1, 2, 3, 0, 1, 15))],
    ids=["inputs", "inputs_and_outputs", "3x3"])
def test_copy_probe_host_at_every_phase(host_lib, shape, seed, offsets,
                                        all_defined):
    args = bench_copy.probe_inputs(*shape, seed=seed,
                                   all_defined=all_defined, device="cpu")
    _copy_on_host(host_lib, args, shape, all_defined, offsets)


def _add1_on_host(host_lib, shape, ty, nbuf, threads, x_at=0, out_at=0):
    """P2's C entry with x and every output ``x_at`` / ``out_at`` floats
    off a 16-byte boundary, held to the plain version bit for bit."""
    x = _offset(torch.as_tensor(np.random.default_rng(ty).normal(size=shape)
                                .astype(np.float32)), x_at)
    outs = [_offset(torch.full(shape, float("nan")), out_at)
            for _ in range(nbuf)]
    ptrs = (ctypes.c_void_p * nbuf)(*(o.data_ptr() for o in outs))
    assert run(host_lib, "mf_probe_add1",
               (x, ptrs, nbuf, ty, threads, *shape)) == 0
    for got, ref in zip(outs, perf_lab_dma.add1_plain(x, nbuf)):
        assert _same_bits(got, ref)


# threads 32: spans of 512 floats, so that the small shapes take both the
# cut of a long unit into pieces and the grouping of short units
@pytest.mark.parametrize("shape,ty,nbuf,threads", [
    ((3, 37, 41), 8, 3, 256), ((2, 1, 41), 48, 2, 512),
    ((3, 37, 41), 37, 1, 256), ((1, 5, 7), 2, 24, 256),
    ((2, 9, 40), 4, 2, 32), ((2, 9, 41), 4, 2, 32), ((2, 9, 43), 4, 2, 32),
    ((3, 37, 41), 37, 2, 32), ((3, 37, 41), 1, 1, 32),
    ((2, 5, 41), 9, 32, 32)],
    ids=["ragged", "single_row", "flat", "24_buffers", "nx_4k", "nx_4k1",
         "nx_4k3", "flat_pieces", "ty1_grouped", "ty_above_ny_32_buffers"])
def test_add1_host_equals_plain(host_lib, shape, ty, nbuf, threads):
    _add1_on_host(host_lib, shape, ty, nbuf, threads)


@pytest.mark.parametrize("x_at,out_at", [
    (1, 1), (2, 2), (3, 3), (1, 0), (0, 3), (2, 1)])
@pytest.mark.parametrize("ty", [4, 37], ids=["grouped", "pieces"])
def test_add1_host_at_every_phase(host_lib, ty, x_at, out_at):
    _add1_on_host(host_lib, (3, 37, 41), ty, 2, 32, x_at, out_at)


@pytest.mark.parametrize("shape,ty", [
    ((32, 256), 8), ((2, 37, 300), 8), ((1, 1, 5), 32), ((3, 70, 61), 32)],
    ids=["tool", "ragged", "single_row", "ty32"])
def test_window_host_equals_plain(host_lib, shape, ty):
    rng = np.random.default_rng(len(shape) + ty)
    x = torch.as_tensor(rng.normal(size=shape).astype(np.float32))
    y = torch.as_tensor(rng.normal(size=(1,) * (3 - len(shape)) + shape)
                        .astype(np.float32))
    ref_o, ref_ow = perf_lab_element.window_plain(x, y, ty)
    o = torch.full_like(ref_o, float("nan"))
    ow = torch.full_like(ref_ow, float("nan"))
    nlev, ny, nx = y.shape
    assert run(host_lib, "mf_probe_window",
               (x, y, o, ow, ty, nlev, ny, nx)) == 0
    assert _same_bits(o, ref_o)
    assert _same_bits(ow, ref_ow)


def _never_freezing(shape):
    """Inputs on which every lane runs to the cap: a < 0 sends c from one
    sign to the other each iteration, and NaN stays NaN."""
    c0, a, decay = probe_mincog_kernel.solver_inputs(shape, seed=3)
    a = -a
    a[0, :2] = float("nan")
    c0[-1, -2:] = float("nan")
    trips, done = probe_mincog_kernel.solver_trips(c0, a)
    assert not done.any()
    assert bool((trips == probe_mincog_kernel.MAX_ITER).all())
    return c0, a, decay


# the host card holds 3 blocks of one thread, and a warp's first chunk is
# 32 lanes: n = 111 and 385 are not multiples of 32, 41000 lanes are far
# more than the grid's threads (most come from claimed chunks); two
# launches in turn share one workspace, which the kernel leaves at zero
@pytest.mark.parametrize("shape,kind", [
    ((1, 1), None), ((3, 37), "planted"), ((64, 256), None),
    ((41, 1000), None), ((7, 45), "capped"), ((5, 77), "twice")],
    ids=["one_lane", "ragged", "tool", "many_chunks", "all_capped",
         "back_to_back"])
def test_solver_host_equals_plain(host_lib, shape, kind):
    if kind == "capped":
        inputs = [_never_freezing(shape)]
    else:
        inputs = [probe_mincog_kernel.solver_inputs(shape, seed=s)
                  for s in ((0, 1) if kind == "twice" else (0,))]
    if kind == "planted":
        inputs[0][1][0, :3] = torch.tensor([float("nan"), 0.0, -3.0])
    work = torch.zeros(2, dtype=torch.int32)
    for c0, a, decay in inputs:
        out = torch.full_like(c0, float("nan"))
        assert run(host_lib, "mf_probe_solver",
                   (c0, a, decay, out, work, c0.numel())) == 0
        assert _same_bits(out, probe_mincog_kernel.solver_plain(c0, a,
                                                                decay))
        assert work.tolist() == [0, 0]


def test_entries_refuse_what_the_kernels_do_not_take(host_lib):
    x = torch.zeros((1, 4, 4))
    pp = (ctypes.c_void_p * 1)(x.data_ptr())
    assert host_lib.mf_probe_copy(*([None] * 14), 1, 2, 3, 1, 0, None) != 0
    assert host_lib.mf_probe_copy(*([None] * 14), 1, 3, 3, 1, -1, None) != 0
    assert host_lib.mf_probe_copy(*([None] * 14), 1, 3, 3, 1, 232449,
                                  None) != 0
    # a row too wide for a strip's shared buffers, on each route
    for ad in (False, True):
        assert host_lib.mf_probe_copy(*([None] * 14), 1, 3, 232448 // 4,
                                      int(ad), 0, None) != 0
    assert run(host_lib, "mf_probe_add1", (x, pp, 33, 8, 256, 1, 4, 4)) != 0
    assert run(host_lib, "mf_probe_add1", (x, pp, 1, 8, 16, 1, 4, 4)) != 0
    assert host_lib.mf_probe_window(*([None] * 4), 33, 1, 4, 4, None) != 0
    assert host_lib.mf_probe_solver(*([None] * 5), 0, None) != 0
