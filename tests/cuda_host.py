"""Compile a CUDA kernel source of the port for the host CPU.

A ``csrc/*.cu`` file (with ``csrc/common.cuh``) is compiled by g++ as plain
C++ through a stand-in ``cuda_runtime.h``: the CUDA qualifiers are empty,
``__shared__`` is ``static``, ``__syncthreads()`` does nothing,
``__syncthreads_and(p)`` is the one thread's own vote ``p``, ``atomicAdd``,
``atomicMin``, ``atomicMax`` and ``atomicOr`` are a plain add, min, max and or, ``cudaMemsetAsync`` a ``memset``,
and ``__threadfence()`` does nothing, a warp is that one
thread at lane 0 (``__ballot_sync(m, p)`` is ``p`` as bit 0,
``__any_sync(m, p)`` is ``p``, ``__shfl_sync(m, v, src)`` is ``v``,
``__popc`` counts bits), ``__int_as_float`` is a ``memcpy``, ``float4`` and
``uint4`` are 16-byte aligned structs, ``__stcs`` a plain store, the card
has 3 SMs that hold one
block each (``cudaDeviceGetAttribute``,
``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), ``common.cuh``'s
``dynamic_shared<T>()`` is one static 1 MiB buffer, and each
``<<<grid, block>>>`` launch becomes a host loop over ``blockIdx`` (z, y,
then x) that runs each block as one thread (``blockDim`` = 1 in every
dimension, ``gridDim`` the grid).  That is right
for kernels whose every phase is a block-stride loop, where one thread runs
all of its block's work in turn, and for kernels whose threads pull work
from a counter until none is left, where the blocks, run one after the
other, take every piece between them.  With ``-ffp-contract=off`` every float
operation rounds on its own, as the card's ``-fmad=false`` build does, and
with ``-fno-strict-aliasing`` a kernel may read its shared buffers through
the types it stages them as (bytes as words, floats as ``float4``), so
the kernels' arithmetic can be held bit for bit to the plain versions where
no card is.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest

from mi_fieldcalc_tpu_torch import _build

CSRC = Path(__file__).resolve().parent.parent / "mi_fieldcalc_tpu_torch" \
    / "csrc"

SHIM = r"""
#pragma once
#include <math.h>
#include <string.h>
#include <stdint.h>
#include <algorithm>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __constant__
#define __launch_bounds__(...)
#define __shared__ static
typedef void* cudaStream_t;
typedef int cudaError_t;
static const int cudaErrorInvalidValue = 1;
static inline int cudaGetLastError() { return 0; }
static inline void __syncthreads() {}
static inline int __syncthreads_and(int p) { return p != 0; }
template <class T> static inline T atomicAdd(T* p, T v) {
  const T old = *p;
  *p = old + v;
  return old;
}
template <class T> static inline T atomicMin(T* p, T v) {
  const T old = *p;
  if (v < old) *p = v;
  return old;
}
template <class T> static inline T atomicMax(T* p, T v) {
  const T old = *p;
  if (v > old) *p = v;
  return old;
}
template <class T> static inline T atomicOr(T* p, T v) {
  const T old = *p;
  *p = old | v;
  return old;
}
static inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n,
                                          cudaStream_t) {
  memset(p, v, n);
  return 0;
}
static inline void __threadfence() {}
// a warp of one thread, lane 0: its own vote, its own value
static inline unsigned __ballot_sync(unsigned, int p) { return p != 0; }
static inline int __any_sync(unsigned, int p) { return p != 0; }
static inline int __popc(unsigned v) { return __builtin_popcount(v); }
template <class T> static inline T __shfl_sync(unsigned, T v, int) {
  return v;
}
struct cudaFuncAttributes {
  int numRegs;
  size_t sharedSizeBytes, localSizeBytes;
};
template <class K>
static inline cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a, K) {
  *a = cudaFuncAttributes();
  return 0;
}
static const int cudaFuncAttributeMaxDynamicSharedMemorySize = 8;
template <class K>
static inline cudaError_t cudaFuncSetAttribute(K, int, int) { return 0; }
// a card of 3 SMs holding 1 block each, so that a grid sized from them
// leaves each block several units of work
static const int cudaDevAttrMultiProcessorCount = 16;
static inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
static inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) {
  *v = 3;
  return 0;
}
template <class K>
static inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* n, K, int, size_t) {
  *n = 1;
  return 0;
}
struct alignas(16) float4 {
  float x, y, z, w;
};
struct alignas(16) uint4 {
  unsigned x, y, z, w;
};
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
static dim3 blockIdx, threadIdx, blockDim, gridDim;
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
template <class T> static inline void __stcs(T* p, T v) { *p = v; }
static inline const char* cudaGetErrorString(int) { return "host error"; }
// common.cuh's dynamic shared memory: one static buffer (blocks run one
// after the other)
#define MF_HOST_SHIM 1
alignas(16) static unsigned char mf_host_dynamic_smem[1 << 20];
template <class T> static inline T* dynamic_shared() {
  return reinterpret_cast<T*>(mf_host_dynamic_smem);
}
using std::min;
using std::max;
template <class K, class P>
void host_launch(K kernel, dim3 grid, dim3, const P& params) {
  blockDim = dim3(1);
  gridDim = grid;
  threadIdx = dim3(0, 0, 0);
  for (unsigned z = 0; z < grid.z; ++z) {
    for (unsigned y = 0; y < grid.y; ++y) {
      for (unsigned b = 0; b < grid.x; ++b) {
        blockIdx = dim3(b, y, z);
        kernel(params);
      }
    }
  }
}
"""

#: kernel<<<grid, block, ...>>>(params);  (the kernel name may carry
#: template arguments)
_LAUNCH = re.compile(r"(\w+(?:<[^<>;]*>)?)<<<\s*([^,>]+),\s*([^,>]+)"
                     r"(?:,.*?)?>>>\(\s*(\w+)\s*\);")


def host_library(tmp_path_factory, source: str, launches: int,
                 extra_sources=()) -> ctypes.CDLL:
    """``csrc/<source>`` compiled for the host, its ``launches`` kernel
    launches turned into host loops, with ``extra_sources`` (name, C++
    text) pairs compiled beside it in one shared library, its entries
    declared as the package's library declares them.  Skips without
    g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the host")
    stem = Path(source).stem
    d = tmp_path_factory.mktemp(stem + "_host")
    (d / "cuda_runtime.h").write_text(SHIM)
    shutil.copy(CSRC / "common.cuh", d / "common.cuh")
    src, n = _LAUNCH.subn(r"host_launch(\1, \2, \3, \4);",
                          (CSRC / source).read_text())
    assert n == launches, n
    files = [d / f"{stem}_host.cpp"]
    files[0].write_text(src)
    for name, text in extra_sources:
        files.append(d / name)
        files[-1].write_text(text)
    so = d / f"lib{stem}_host.so"
    proc = subprocess.run(
        [gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-fno-fast-math",
         "-fno-strict-aliasing",
         "-fPIC", "-shared", "-I", str(d), *map(str, files), "-o", str(so)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return _build._declare(ctypes.CDLL(str(so)))


def run(lib, entry: str, args) -> int:
    """``entry`` of a host library on a wrapper's launch arguments
    (``_launch_args``: all but the stream), with no stream; its error."""
    return getattr(lib, entry)(*_build._c_args(entry, tuple(args)))
