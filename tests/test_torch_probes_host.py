"""The probe kernels' source, compiled for the host CPU, against their plain
versions, bit for bit.

``csrc/probes.cu`` (P1 ``mf_probe_copy``, P2 ``mf_probe_add1``, P3
``mf_probe_window``, P4 ``mf_probe_solver``, with ``csrc/common.cuh``) is
compiled by g++ through the stand-in ``cuda_runtime.h`` of
``cuda_host.py``, which runs each block as one thread: every phase of the
four kernels is a block-stride loop, so one thread covers its block's work.
With ``-ffp-contract=off`` every float operation rounds on its own, as the
card's ``-fmad=false`` build does, so each output is held to the plain
version of ``mi_fieldcalc_tpu_torch/tools/`` on every point, bit for bit.
Shapes: a ragged edge against each kernel's tile and a single row (P1's
grid needs 3 rows and 3 columns, as B1's does, so its smallest case is
3x3); P1 also on values spread over six decades, where its sum's order
shows in the rounding.  The card checks the same (``chip_smoke.py`` phase 10).
"""

import ctypes

import numpy as np
import pytest
import torch

from cuda_host import host_library
from mi_fieldcalc_tpu_torch.field import Field
from mi_fieldcalc_tpu_torch.tools import (
    bench_copy, perf_lab_dma, perf_lab_element, probe_mincog_kernel,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    lib = host_library(tmp_path_factory, "probes.cu", 5)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mf_probe_copy.argtypes = [p] * 14 + [i] * 5 + [p]
    lib.mf_probe_add1.argtypes = [p, ctypes.POINTER(p)] + [i] * 6 + [p]
    lib.mf_probe_window.argtypes = [p] * 4 + [i] * 4 + [p]
    lib.mf_probe_solver.argtypes = [p] * 4 + [i, p]
    return lib


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr()) if t is not None else None


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


@pytest.mark.parametrize("all_defined", [False, True],
                         ids=["masked", "all_defined"])
@pytest.mark.parametrize("shape,mixed", [
    ((1, 3, 3), False), ((2, 9, 33), False), ((3, 17, 70), False),
    ((2, 9, 33), True)], ids=["3x3", "ragged", "two_tiles", "mixed_scales"])
def test_copy_probe_host_equals_plain(host_lib, shape, mixed, all_defined):
    args = bench_copy.probe_inputs(*shape, seed=sum(shape),
                                   all_defined=all_defined, device="cpu")
    if mixed:
        args = _mixed_scales(args, sum(shape))
    tk, q, u, v, ps, _, _, xmapr, ymapr, _ = args
    nlev, ny, nx = shape
    values = torch.empty((12,) + shape)
    masks = torch.empty((2 if all_defined else 9,) + shape,
                        dtype=torch.bool)

    def m(f):
        return None if all_defined else _ptr(f.mask)

    assert host_lib.mf_probe_copy(
        _ptr(tk.values), _ptr(q.values), _ptr(u.values), _ptr(v.values),
        m(tk), m(q), m(u), m(v), _ptr(ps.values), m(ps), _ptr(xmapr),
        _ptr(ymapr), _ptr(values), _ptr(masks), nlev, ny, nx,
        int(all_defined), 0, None) == 0
    ref_v, ref_m = bench_copy.copy_probe_plain(tk, q, u, v, ps, xmapr, ymapr,
                                               all_defined)
    assert _same_bits(values, ref_v)
    assert torch.equal(masks, ref_m)
    if not all_defined:
        assert 0 < int(ref_m.sum()) < ref_m.numel()


@pytest.mark.parametrize("shape,ty,nbuf,threads", [
    ((3, 37, 41), 8, 3, 256), ((2, 1, 41), 48, 2, 512),
    ((3, 37, 41), 37, 1, 256), ((1, 5, 7), 2, 24, 256)],
    ids=["ragged", "single_row", "flat", "24_buffers"])
def test_add1_host_equals_plain(host_lib, shape, ty, nbuf, threads):
    x = torch.as_tensor(np.random.default_rng(ty).normal(size=shape)
                        .astype(np.float32))
    outs = [torch.full_like(x, float("nan")) for _ in range(nbuf)]
    ptrs = (ctypes.c_void_p * nbuf)(*(o.data_ptr() for o in outs))
    assert host_lib.mf_probe_add1(
        _ptr(x), ctypes.cast(ptrs, ctypes.POINTER(ctypes.c_void_p)), nbuf, ty,
        threads, *shape, None) == 0
    for got, ref in zip(outs, perf_lab_dma.add1_plain(x, nbuf)):
        assert _same_bits(got, ref)


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
    assert host_lib.mf_probe_window(_ptr(x), _ptr(y), _ptr(o), _ptr(ow), ty,
                                    nlev, ny, nx, None) == 0
    assert _same_bits(o, ref_o)
    assert _same_bits(ow, ref_ow)


@pytest.mark.parametrize("shape", [(1, 1), (3, 37), (64, 256)],
                         ids=["one_lane", "ragged", "tool"])
def test_solver_host_equals_plain(host_lib, shape):
    c0, a, decay = probe_mincog_kernel.solver_inputs(shape, seed=0)
    if shape == (3, 37):
        a[0, :3] = torch.tensor([float("nan"), 0.0, -3.0])
    out = torch.full_like(c0, float("nan"))
    assert host_lib.mf_probe_solver(_ptr(c0), _ptr(a), _ptr(decay),
                                    _ptr(out), c0.numel(), None) == 0
    assert _same_bits(out, probe_mincog_kernel.solver_plain(c0, a, decay))


def test_entries_refuse_what_the_kernels_do_not_take(host_lib):
    x = torch.zeros((1, 4, 4))
    ptrs = (ctypes.c_void_p * 1)(x.data_ptr())
    pp = ctypes.cast(ptrs, ctypes.POINTER(ctypes.c_void_p))
    assert host_lib.mf_probe_copy(*([None] * 14), 1, 2, 3, 1, 0, None) != 0
    assert host_lib.mf_probe_copy(*([None] * 14), 1, 3, 3, 1, -1, None) != 0
    assert host_lib.mf_probe_copy(*([None] * 14), 1, 3, 3, 1, 232449,
                                  None) != 0
    assert host_lib.mf_probe_add1(_ptr(x), pp, 33, 8, 256, 1, 4, 4,
                                  None) != 0
    assert host_lib.mf_probe_add1(_ptr(x), pp, 1, 8, 16, 1, 4, 4, None) != 0
    assert host_lib.mf_probe_window(*([None] * 4), 33, 1, 4, 4, None) != 0
    assert host_lib.mf_probe_solver(*([None] * 4), 0, None) != 0
