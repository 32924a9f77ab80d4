// The port's measurement probes: four small CUDA kernels for Hopper
// (sm_90a) that sit on no serving path.  Each answers one question about
// what the card attains, and each has a plain PyTorch version beside its
// wrapper in mi_fieldcalc_tpu_torch/tools/ that it equals bit for bit.
//
//   P1 copy_kernel    replaces bench.py:212 _ck (pallas_call :233), the
//                     structure-matched copy of the pipeline kernel B1:
//                     B1's reads and writes with trivial compute.  Its time
//                     is the rate B1's access pattern attains on this card.
//   P2 add1_kernel    replaces tools/perf_lab_dma.py:43 pallas_add1 (:57)
//                     and :72 pallas_add1_flat (:80): x + 1 into nbuf
//                     outputs, ty rows of one level a block.
//   P3 window_kernel  replaces tools/perf_lab_element.py:28 probe (kernel
//                     :38, pallas_call :62): overlapping (ty + 8)-row
//                     windows of x staged through shared memory.
//   P4 solver_kernel  replaces tools/probe_mincog_kernel.py:20 kernel
//                     (pallas_call :62): the icing solvers' constructs, a
//                     loop that ends when the block votes every lane done.
//
// What bounds them: P1-P3 move bytes and compute almost nothing, so device
// memory bounds them; P4 reads and writes 12 bytes a lane and runs up to
// 100 tanh iterations on each, so operations bound it.
//
// Every phase of every kernel is a block-stride loop over the block's
// work, so the host build of tests/cuda_host.py, which runs a block as one
// thread, covers the whole grid.  Built with -fmad=false and without
// --use_fast_math (common.cuh): each add and multiply rounds on its own and
// '/' is IEEE, as in the plain versions.

#include "common.cuh"

namespace {

// ---- P1: the structure-matched copy of B1 --------------------------------
//
// B1's grid (32x8 blocks, gridDim.z = nlev; derived_fields.cu:206-212) and
// B1's reads at each point: the centres of tk, q, u, v and ps, the x+-1
// and y+-1 neighbours of tk, u and v at the clamped point
// (derived_fields.cu:126-140) and the two map factors there, and, unless
// all_defined, the five masks.  It writes B1's 12 value planes (s + k) and
// 9 mask planes (the AND of the five masks; 2 planes of ones when
// all_defined, as B1's all-defined route writes 2 gate planes and reads no
// mask).  The TPU probe instead broadcasts the row above and below each
// 48-row tile (bench.py:215-216, clamped block indices :226-231), an
// artefact of the TPU's padded tiling; this one reads per point what B1
// reads per point, which is what "structure-matched" means on this card.
// Without B1's compute between its stores the copy's 21 stores a thread
// come in one burst, and at full occupancy that pattern runs slower than
// B1 itself; the launch may therefore reserve dynamic shared memory (which
// the kernel does not touch) to cap the blocks an SM holds, and the
// attainable rate is the fastest cap's.

constexpr int kCopyTileX = 32;
constexpr int kCopyTileY = 8;
constexpr int kMaxDynamicSmem = 232448;   // 227 KB, Hopper's most a block

struct CopyParams {
  const float* __restrict__ tk;
  const float* __restrict__ q;
  const float* __restrict__ u;
  const float* __restrict__ v;
  const uint8_t* __restrict__ tkm;
  const uint8_t* __restrict__ qm;
  const uint8_t* __restrict__ um;
  const uint8_t* __restrict__ vm;
  const float* __restrict__ ps;
  const uint8_t* __restrict__ psm;
  const float* __restrict__ xmapr;
  const float* __restrict__ ymapr;
  float* __restrict__ out_values;
  uint8_t* __restrict__ out_masks;
  int nlev, ny, nx;
};

// s + the four neighbours of `f` around c, in the plain version's order
__device__ __forceinline__ float add_ring(float s, const float* f, int64_t c,
                                          int nx) {
  s = s + __ldg(f + c - 1);
  s = s + __ldg(f + c + 1);
  s = s + __ldg(f + c - nx);
  return s + __ldg(f + c + nx);
}

template <bool kAllDefined>
__global__ void __launch_bounds__(kCopyTileX * kCopyTileY)
copy_kernel(const CopyParams P) {
  const int nt = blockDim.x * blockDim.y;
  const int nx = P.nx, ny = P.ny;
  const int64_t plane2 = static_cast<int64_t>(ny) * nx;
  const int64_t n3 = plane2 * P.nlev;
  const int64_t lev0 = plane2 * blockIdx.z;
  for (int t = threadIdx.y * blockDim.x + threadIdx.x;
       t < kCopyTileX * kCopyTileY; t += nt) {
    const int x = blockIdx.x * kCopyTileX + t % kCopyTileX;
    const int y = blockIdx.y * kCopyTileY + t / kCopyTileX;
    if (x >= nx || y >= ny) continue;
    const int64_t i2 = static_cast<int64_t>(y) * nx + x;
    const int64_t i = lev0 + i2;
    const int cy = min(max(y, 1), ny - 2);
    const int cx = min(max(x, 1), nx - 2);
    const int64_t r = static_cast<int64_t>(cy) * nx + cx;
    const int64_t c = lev0 + r;
    // the masks are loaded first, as B1 loads them, so that every load of
    // the point is in flight before its first store
    uint8_t m = 1;
    if (!kAllDefined) {
      m = __ldg(P.tkm + i) & __ldg(P.qm + i) & __ldg(P.um + i) &
          __ldg(P.vm + i) & __ldg(P.psm + i2);
    }
    float s = __ldg(P.tk + i) + __ldg(P.q + i);
    s = s + __ldg(P.u + i);
    s = s + __ldg(P.v + i);
    s = s + __ldg(P.ps + i2);
    s = add_ring(s, P.tk, c, nx);
    s = add_ring(s, P.u, c, nx);
    s = add_ring(s, P.v, c, nx);
    s = s + __ldg(P.xmapr + r);
    s = s + __ldg(P.ymapr + r);
    float* ov = P.out_values + i;
    for (int k = 0; k < 12; ++k) ov[k * n3] = s + static_cast<float>(k);
    uint8_t* om = P.out_masks + i;
    for (int k = 0; k < (kAllDefined ? 2 : 9); ++k) om[k * n3] = m;
  }
}

// ---- P2: x + 1 into nbuf outputs -----------------------------------------
//
// Grid (ceil(ny / ty), nlev) as the TPU probe's; each block covers ty rows
// of one level with its threads striding over them.  The input pointer is
// passed once and read once for each output, as the TPU probe passes it
// nbuf times (perf_lab_dma.py:65-67).  ty = ny is the flat variant: one
// block a level.  Each thread issues kUnroll loads before their stores, so
// that enough bytes are in flight to reach the copy rate.

constexpr int kMaxBuffers = 32;
constexpr int kUnroll = 4;
constexpr int kAdd1MaxThreads = 1024;

struct Add1Params {
  const float* __restrict__ x;
  float* out[kMaxBuffers];
  int nbuf, ty, ny, nx;
};

__global__ void __launch_bounds__(kAdd1MaxThreads)
add1_kernel(const Add1Params P) {
  const int y0 = blockIdx.x * P.ty;
  const int rows = min(P.ty, P.ny - y0);
  const int n = rows * P.nx;
  const int64_t base =
      (static_cast<int64_t>(blockIdx.y) * P.ny + y0) * P.nx;
  const int nt = blockDim.x;
  const float* __restrict__ x = P.x + base;
  for (int b = 0; b < P.nbuf; ++b) {
    float* __restrict__ o = P.out[b] + base;
    for (int i0 = threadIdx.x; i0 < n; i0 += kUnroll * nt) {
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * nt;
        v[u] = i < n ? __ldg(x + i) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * nt;
        if (i < n) o[i] = v[u] + 1.0f;
      }
    }
  }
}

// ---- P3: overlapping windows staged through shared memory ----------------
//
// Window j of a level holds rows [j*ty - 4, j*ty + ty + 4) of x; a block
// stages one window's rows over kWinCols columns into shared memory, then
// writes the window to ow (rows j*(ty + 8) ...) and its ty centre rows plus
// y to o.  Rows outside [0, ny) read as 0.0: the TPU probe leaves them
// undefined, the port pins them.

constexpr int kHalo = 4;
constexpr int kWinCols = 256;
constexpr int kWinMaxTy = 32;
constexpr int kWinMaxRows = kWinMaxTy + 2 * kHalo;   // 40 KB of floats

struct WindowParams {
  const float* __restrict__ x;
  const float* __restrict__ y;
  float* __restrict__ o;
  float* __restrict__ ow;
  int ty, jy, ny, nx;
};

__global__ void __launch_bounds__(256) window_kernel(const WindowParams P) {
  __shared__ float tile[kWinMaxRows * kWinCols];
  const int nt = blockDim.x;
  const int c0 = blockIdx.x * kWinCols;
  const int w = min(kWinCols, P.nx - c0);
  const int j = blockIdx.y;
  const int rows = P.ty + 2 * kHalo;
  const int row0 = j * P.ty - kHalo;
  const int64_t plane = static_cast<int64_t>(P.ny) * P.nx;
  const int64_t lev0 = plane * blockIdx.z;
  const float* __restrict__ x = P.x + lev0 + c0;
  const int n = rows * kWinCols;
  for (int i0 = threadIdx.x; i0 < n; i0 += kUnroll * nt) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * nt;
      const int r = i / kWinCols, c = i % kWinCols;
      const int row = row0 + r;
      v[u] = (i < n && c < w && row >= 0 && row < P.ny)
                 ? __ldg(x + static_cast<int64_t>(row) * P.nx + c)
                 : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * nt;
      if (i < n) tile[i] = v[u];
    }
  }
  __syncthreads();
  float* ow = P.ow + (static_cast<int64_t>(blockIdx.z) * P.jy + j) * rows *
                         static_cast<int64_t>(P.nx) + c0;
  for (int i = threadIdx.x; i < n; i += nt) {
    const int r = i / kWinCols, c = i % kWinCols;
    const int row = row0 + r;
    if (c >= w) continue;
    ow[static_cast<int64_t>(r) * P.nx + c] = tile[i];
    if (r >= kHalo && r < kHalo + P.ty && row < P.ny) {
      const int64_t k = lev0 + static_cast<int64_t>(row) * P.nx + c0 + c;
      P.o[k] = tile[i] + __ldg(P.y + k);
    }
  }
}

// ---- P4: the solver constructs -------------------------------------------
//
// One lane a point, kLanes lanes a block.  Each lane iterates
// c <- c0 * tanh(a / c) from c = 1 and freezes on the iteration that brings
// |c_new - c| <= 1e-5 (keeping that c_new); the block stops when it votes
// every lane frozen (__syncthreads_and) or after 100 iterations.  Then
// sum_k decay[k] * c over the 5 entries in order, and NaN -> 0.  A lane's
// result does not depend on how lanes are grouped into blocks: it freezes
// on its own iteration and every lane runs until frozen or the cap
// (probe_mincog_kernel.py:25-35).  tanh is common.cuh's tanh_f32.  The
// lanes' state lives in shared memory, each lane touched only by the
// thread that owns it.

constexpr int kLanes = 256;
constexpr int kSolverMaxIter = 100;
constexpr int kDecay = 5;
constexpr float kSolverTol = 0x1.4f8b58p-17f;   // float32(1e-5)

struct SolverParams {
  const float* __restrict__ c0;
  const float* __restrict__ a;
  const float* __restrict__ decay;
  float* __restrict__ out;
  int n;
};

__global__ void __launch_bounds__(kLanes) solver_kernel(const SolverParams P) {
  __shared__ float s_c0[kLanes], s_a[kLanes], s_c[kLanes];
  __shared__ int s_done[kLanes];
  const int nt = blockDim.x;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kLanes;
  const int64_t left = P.n - base;
  const int cnt = left < kLanes ? static_cast<int>(left) : kLanes;
  for (int i = threadIdx.x; i < cnt; i += nt) {
    s_c0[i] = __ldg(P.c0 + base + i);
    s_a[i] = __ldg(P.a + base + i);
    s_c[i] = 1.0f;
    s_done[i] = 0;
  }
  for (int j = 0; j < kSolverMaxIter; ++j) {
    int all_done = 1;
    for (int i = threadIdx.x; i < cnt; i += nt) {
      if (s_done[i]) continue;
      const float c = s_c[i];
      const float c_new = s_c0[i] * tanh_f32(s_a[i] / c);
      s_c[i] = c_new;
      if (fabsf(c_new - c) <= kSolverTol) {
        s_done[i] = 1;
      } else {
        all_done = 0;
      }
    }
    if (__syncthreads_and(all_done)) break;
  }
  for (int i = threadIdx.x; i < cnt; i += nt) {
    const float c = s_c[i];
    float acc = 0.0f;
    for (int k = 0; k < kDecay; ++k) acc = acc + __ldg(P.decay + k) * c;
    P.out[base + i] = acc != acc ? 0.0f : acc;
  }
}

}  // namespace

extern "C" {

// Each entry launches its kernel on `stream` and returns
// cudaGetLastError() as an int (cudaErrorInvalidValue for arguments the
// kernel does not take).

// P1.  Mask pointers may be null when all_defined != 0; out_masks holds 2
// planes then, else 9.  smem_bytes of dynamic shared memory are reserved a
// block (0 to 227 KB) to cap the blocks an SM holds.
int mf_probe_copy(const float* tk, const float* q, const float* u,
                  const float* v, const uint8_t* tkm, const uint8_t* qm,
                  const uint8_t* um, const uint8_t* vm, const float* ps,
                  const uint8_t* psm, const float* xmapr, const float* ymapr,
                  float* out_values, uint8_t* out_masks, int nlev, int ny,
                  int nx, int all_defined, int smem_bytes, void* stream) {
  if (nlev < 1 || nlev > 65535 || ny < 3 || nx < 3 ||
      (ny + kCopyTileY - 1) / kCopyTileY > 65535 || smem_bytes < 0 ||
      smem_bytes > kMaxDynamicSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const CopyParams P{tk, q, u, v, tkm, qm, um, vm, ps, psm, xmapr, ymapr,
                     out_values, out_masks, nlev, ny, nx};
  const dim3 block(kCopyTileX, kCopyTileY);
  const dim3 grid((nx + kCopyTileX - 1) / kCopyTileX,
                  (ny + kCopyTileY - 1) / kCopyTileY, nlev);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (all_defined) {
    cudaFuncSetAttribute(copy_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem_bytes);
    copy_kernel<true><<<grid, block, smem_bytes, s>>>(P);
  } else {
    cudaFuncSetAttribute(copy_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem_bytes);
    copy_kernel<false><<<grid, block, smem_bytes, s>>>(P);
  }
  return static_cast<int>(cudaGetLastError());
}

// P2.  `outs` is a host array of nbuf device pointers; threads a block in
// [32, 1024].
int mf_probe_add1(const float* x, float* const* outs, int nbuf, int ty,
                  int threads, int nlev, int ny, int nx, void* stream) {
  if (nbuf < 1 || nbuf > kMaxBuffers || ty < 1 || ny < 1 || nx < 1 ||
      nlev < 1 || nlev > 65535 || threads < 32 ||
      threads > kAdd1MaxThreads ||
      static_cast<int64_t>(ty) * nx > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Add1Params P{};
  P.x = x;
  for (int b = 0; b < nbuf; ++b) P.out[b] = outs[b];
  P.nbuf = nbuf;
  P.ty = ty < ny ? ty : ny;
  P.ny = ny;
  P.nx = nx;
  const dim3 grid((ny + P.ty - 1) / P.ty, nlev);
  add1_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

// P3.  ow holds nlev * ceil(ny / ty) windows of ty + 8 rows; ty <= 32.
int mf_probe_window(const float* x, const float* y, float* o, float* ow,
                    int ty, int nlev, int ny, int nx, void* stream) {
  if (ty < 1 || ty > kWinMaxTy || ny < 1 || nx < 1 || nlev < 1 ||
      nlev > 65535 || (ny + ty - 1) / ty > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int jy = (ny + ty - 1) / ty;
  const WindowParams P{x, y, o, ow, ty, jy, ny, nx};
  const dim3 grid((nx + kWinCols - 1) / kWinCols, jy, nlev);
  window_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

// P4.  `decay` holds 5 device floats; c0, a and out n lanes.
int mf_probe_solver(const float* c0, const float* a, const float* decay,
                    float* out, int n, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const SolverParams P{c0, a, decay, out, n};
  const int grid = (n + kLanes - 1) / kLanes;
  solver_kernel<<<grid, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
