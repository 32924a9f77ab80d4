"""The icing kernels' source, compiled for the host CPU, against their plain
versions, bit for bit.

``csrc/vessel_icing.cu`` (with ``csrc/common.cuh``) is compiled by g++ as
plain C++ through a stand-in ``cuda_runtime.h``: the CUDA qualifiers are
empty, ``__int_as_float`` is a ``memcpy``, and each ``<<<grid, block>>>``
launch becomes a host loop over blockIdx and threadIdx.  With
``-ffp-contract=off`` every float operation rounds on its own, as the
card's ``-fmad=false`` build does, so the per-point arithmetic of B5 and B6
can be held to the plain versions here, where no card is.  PyTorch's CPU
``sqrt`` is not correctly rounded (the card's is, and so is the host
``sqrtf``), so the plain versions run with a correctly rounded one.
The card itself checks the same equality (``test_torch_icing.py``'s
``cuda``-marked tests, ``chip_smoke.py`` phase 9).
"""

import ctypes
import math
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from mi_fieldcalc_tpu_torch.field import from_sentinel
from mi_fieldcalc_tpu_torch.ops import icing_fused as F
from mi_fieldcalc_tpu_torch.ops.icing import _mincog_decay, _number

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parent.parent / "mi_fieldcalc_tpu_torch" \
    / "csrc"
SCAL = (5.0, 0.52, 2.0, 11.0)
SCAL_VS0 = (0.0, 0.0, 1.0, 4.0)

_SHIM = r"""
#pragma once
#include <math.h>
#include <string.h>
#include <stdint.h>
#include <algorithm>
#define __device__
#define __global__
#define __forceinline__ inline
#define __constant__
#define __launch_bounds__(x)
typedef void* cudaStream_t;
static const int cudaErrorInvalidValue = 1;
static inline int cudaGetLastError() { return 0; }
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
static dim3 blockIdx, threadIdx, blockDim;
static inline float __int_as_float(int i) {
  float f;
  memcpy(&f, &i, 4);
  return f;
}
static inline int __float_as_int(float f) {
  int i;
  memcpy(&i, &f, 4);
  return i;
}
template <class T> static inline T __ldg(const T* p) { return *p; }
using std::min;
using std::max;
template <class K, class P>
void host_launch(K kernel, dim3 grid, unsigned block, const P& params) {
  blockDim = dim3(block);
  for (unsigned b = 0; b < grid.x; ++b) {
    blockIdx = dim3(b);
    for (unsigned t = 0; t < block; ++t) {
      threadIdx = dim3(t);
      kernel(params);
    }
  }
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the host")
    d = tmp_path_factory.mktemp("vessel_icing_host")
    (d / "cuda_runtime.h").write_text(_SHIM)
    shutil.copy(CSRC / "common.cuh", d / "common.cuh")
    # kernel<<<grid, block, ...>>>(params);  ->  a host loop over both
    src, n = re.subn(
        r"(\w+)<<<\s*([^,>]+),\s*([^,>]+)(?:,.*?)?>>>\(\s*(\w+)\s*\);",
        r"host_launch(\1, \2, \3, \4);",
        (CSRC / "vessel_icing.cu").read_text())
    assert n == 2
    (d / "vessel_icing_host.cpp").write_text(src)
    so = d / "libvessel_icing_host.so"
    proc = subprocess.run(
        [gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-fno-fast-math",
         "-fPIC", "-shared", "-I", str(d), str(d / "vessel_icing_host.cpp"),
         "-o", str(so)], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(so))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    pp = ctypes.POINTER(ctypes.c_void_p)
    lib.mf_vessel_icing_mincog.argtypes = [pp] + [p] * 4 + [i, f, i, p, i,
                                                            p]
    lib.mf_vessel_icing_modstall.argtypes = [pp] + [p] * 3 + [i, f, p, i, p]
    return lib


@pytest.fixture
def exact_sqrt(monkeypatch):
    """A correctly rounded float32 sqrt (through float64), as the card's."""
    sqrt = torch.sqrt
    monkeypatch.setattr(torch, "sqrt", lambda x: sqrt(x.double()).float())


def _inputs(ny, nx, seed, adversarial, plant):
    """``tests/test_torch_icing.py``'s input pattern."""
    rng = np.random.default_rng(seed)

    def f(lo, hi):
        x = rng.uniform(lo, hi, (ny, nx)).astype(np.float32)
        x.reshape(-1)[rng.integers(0, x.size, max(1, x.size // 23))] = 1e35
        return x

    a = [f(0.0, 35.0), f(0.0 if adversarial else 0.1, 8.0),
         f(-25.0, 25.0), f(-25.0, 25.0), f(-25.0, 2.0), f(0.3, 1.0),
         f(-1.0, 8.0), f(960.0, 1040.0),
         f(6.0, 14.0) if adversarial else f(2.0, 12.0), f(0.0, 0.5),
         f(2.0, 40.0) if adversarial else f(5.0, 500.0)]
    if plant:
        a[8].reshape(-1)[::7] = 0.0
        a[0].reshape(-1)[3::11] = 0.0
    return [from_sentinel(x) for x in a]


def _host_run(lib, fields, scal, alt):
    """One host launch of B5 (``alt``) or B6 on the wrapper's prologue."""
    vs, alpha, zmin, zmax = scal
    if alt is None:
        gate, planes, shallow = F._modstall_prologue(*fields)
        names = F._MS_PLANES
    else:
        gate, planes, shallow, skip0 = F._mincog_prologue(*fields, vs, alpha)
        names = F._PLANES
    assert all(planes[k].is_contiguous() for k in names)
    decay = torch.tensor(_mincog_decay(zmin, _number(zmin, zmax)),
                         dtype=torch.float32)
    out = torch.empty(gate.shape, dtype=torch.float32)
    ptrs = (ctypes.c_void_p * len(names))(
        *[planes[k].data_ptr() for k in names])
    vsca = float(vs * math.cos(alpha))
    if alt is None:
        err = lib.mf_vessel_icing_modstall(
            ptrs, gate.data_ptr(), shallow.data_ptr(), decay.data_ptr(),
            decay.numel(), vsca, out.data_ptr(), gate.numel(), None)
    else:
        err = lib.mf_vessel_icing_mincog(
            ptrs, gate.data_ptr(), shallow.data_ptr(), skip0.data_ptr(),
            decay.data_ptr(), decay.numel(), vsca, alt, out.data_ptr(),
            gate.numel(), None)
    assert err == 0
    return out


@pytest.mark.parametrize("shape", [(1, 1), (3, 37), (37, 61), (9, 131),
                                   (64, 256)])
@pytest.mark.parametrize("kind", ["friendly", "adversarial", "vs0"])
def test_host_kernels_match_plain(host_lib, exact_sqrt, shape, kind):
    adversarial = kind != "friendly"
    scal = SCAL_VS0 if kind == "vs0" else SCAL
    fields = _inputs(*shape, seed=sum(shape) + len(kind),
                     adversarial=adversarial, plant=adversarial)
    for alt in (1, 2, None):
        got = _host_run(host_lib, fields, scal, alt)
        if alt is None:
            ref = F.vessel_icing_modstall_plain(*fields, *scal)
        else:
            ref = F.vessel_icing_mincog_plain(*fields, *scal, alt)
        r = ref.values
        same = (got.view(torch.int32) == r.view(torch.int32)) | (
            torch.isnan(got) & torch.isnan(r))
        assert bool(same.all()), (alt, float((got - r).abs()[~same].max()))
