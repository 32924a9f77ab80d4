// The port's measurement probes: four small CUDA kernels for Hopper
// (sm_90a) that sit on no serving path.  Each answers one question about
// what the card attains, and each has a plain PyTorch version beside its
// wrapper in mi_fieldcalc_tpu_torch/tools/ that it equals bit for bit.
//
//   P1 copy_kernel    replaces bench.py:212 _ck (pallas_call :233): B1's
//                     bytes moved at the best rate this card gives them.
//                     It reads B1's inputs in B1's layout and writes B1's
//                     12 value and 9 (2) mask planes, with trivial compute
//                     and without B1's per-point store order.  B1's time
//                     over P1's says how much B1 could still gain.
//   P2 add1_kernel    replaces tools/perf_lab_dma.py:43 pallas_add1 (:57)
//                     and :72 pallas_add1_flat (:80): x + 1 into nbuf
//                     outputs, a unit of work ty rows of one level.
//   P3 window_kernel  replaces tools/perf_lab_element.py:28 probe (kernel
//                     :38, pallas_call :62): overlapping (ty + 8)-row
//                     windows of x staged through shared memory.
//   P4 solver_kernel  replaces tools/probe_mincog_kernel.py:20 kernel
//                     (pallas_call :62): the icing solvers' constructs, a
//                     loop whose lanes stop on their own iterations; a
//                     thread takes a new lane as soon as its lane stops.
//
// What bounds them: P1-P3 move bytes and compute almost nothing, so device
// memory bounds them; P4 reads and writes 12 bytes a lane and runs up to
// 100 dependent tanh iterations on each, so its slowest lane's chain and
// the card's issue slots bound it (its section says how).
//
// Every phase of P1-P3 is a block-stride loop over the block's work, and
// P4's threads pull lanes until none is left, so the host build of
// tests/cuda_host.py, which runs a block as one thread, covers the whole
// grid.  Built with -fmad=false and without
// --use_fast_math (common.cuh): each add and multiply rounds on its own and
// '/' is IEEE, as in the plain versions.

#include "common.cuh"

namespace {

constexpr int kMaxDynamicSmem = 232448;   // 227 KB, Hopper's most a block

// The 16-byte phase of a pointer, in elements of T: the index of the first
// element of a 16-byte aligned group is -phase (mod 16 / sizeof(T)).
template <class T>
__host__ __device__ __forceinline__ int phase16(const T* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) & 15) / sizeof(T));
}

// 16 bytes from global to shared memory, asynchronously (cp.async, no
// register staging); both addresses 16-byte aligned.  cp_async_wait()
// waits for this thread's copies; a __syncthreads() after it publishes
// them to the block.
__device__ __forceinline__ void copy16_async(void* smem, const void* gmem) {
#ifdef MF_HOST_SHIM
  memcpy(smem, gmem, 16);
#else
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(smem))),
               "l"(gmem));
#endif
}

// A compiler barrier: no memory access moves across it, so that every load
// above is issued before the first store below
__device__ __forceinline__ void loads_then_stores() {
  asm volatile("" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait() {
#ifndef MF_HOST_SHIM
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// ---- P1: B1's bytes at the best rate this card gives them ----------------
//
// What P1 keeps of B1: the inputs and outputs and their layout (the
// centres of tk, q, u, v and ps; the x+-1 and y+-1 neighbours of tk, u and
// v at the clamped point cy, cx in [1, n-2] (derived_fields.cu's
// fillEdges point); the two map factors there; unless all_defined the five
// masks), and so B1's bytes.  Each point's s is the plain version's 18
// adds in its order; value plane k is s + k; every mask plane is the AND
// of the five masks (2 planes of ones when all_defined, as B1's
// all-defined route writes 2 gate planes and reads no mask).  What it
// drops: B1's per-point store order.  The TPU probe broadcast the row above
// and below each 48-row tile (bench.py:215-216), an artefact of the TPU's
// padded tiling that is not carried over.
//
// The design: the unit of work is a strip of kCopyRows full-width rows of
// one level, so each output plane's share of a strip is one contiguous run
// (kCopyRows * nx values).  A block stages a strip's inputs in dynamic
// shared memory with 16-byte asynchronous copies (cp.async): the rows of
// tk, u and v that the clamped ring reaches (Strip::lo .. hi), and the
// strip's rows of q and the five masks.  ps and the map factors, planes
// that every level reads again and that the L2 keeps, are read from device
// memory at each point: staging them too would cost 22 KB a block and hold
// an SM to 2 blocks instead of 3 (PERF.md prices both).
// Each staged run keeps its 16-byte phase in shared memory, so that every
// aligned group of the run lands on an aligned group there.  s and the mask
// AND are computed once a point into buffers of their own, and the block
// writes plane by plane: all of value plane 0's run in 16-byte stores,
// then plane 1, ..., then the mask planes, 16 mask bytes a store; a warp's
// store is 512 contiguous bytes of one plane.  Each run's unaligned head
// and tail are written a value (or a byte) at a time.  The grid is as many
// blocks as the card holds at once, each walking the strips: the copies of
// its next strip are issued before it writes the current strip's planes,
// so that every block keeps loads in flight while it stores.
//
// The launch may reserve more dynamic shared memory than the buffers need,
// to cap the blocks an SM holds (bench_copy.CAPS).

constexpr int kCopyRows = 2;
constexpr int kCopyThreads = 512;
// blocks an SM, set by the registers allowed (and shared memory): the
// masked route runs fastest at 3 (40 registers), the all-defined one at 2
// (held to 40 registers it keeps 24 bytes on the stack; PERF.md)
constexpr int kCopyBlocksMasked = 3;
constexpr int kCopyBlocksDefined = 2;
constexpr int kValuePlanes = 12;
constexpr int kMaskPlanes = 9;
constexpr int kDefinedPlanes = 2;

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

// A block's shared buffers: 3 ring buffers (tk, u, v; kCopyRows + 2 rows),
// a centre buffer for q (kCopyRows rows) and one for the sums, then, unless
// all_defined, 5 mask buffers of kCopyRows rows and one for their AND.
// Each holds its run after a phase of up to 16 bytes and is a multiple of
// 16 bytes long; a mask buffer has 4 bytes more for the word reads of
// mask_group16.
struct CopyLayout {
  int ring, centre, mask;   // floats, floats, bytes a buffer
  int64_t bytes;
};

__host__ __device__ __forceinline__ CopyLayout copy_layout(int nx,
                                                           bool all_defined) {
  CopyLayout L;
  const int64_t row = nx;
  L.ring = static_cast<int>(((kCopyRows + 2) * row + 3 + 3) / 4 * 4);
  L.centre = static_cast<int>((kCopyRows * row + 3 + 3) / 4 * 4);
  L.mask = all_defined ? 0
                       : static_cast<int>((kCopyRows * row + 15 + 4 + 15) /
                                          16 * 16);
  L.bytes = 4 * (3 * static_cast<int64_t>(L.ring) + 2 * L.centre) +
            6 * static_cast<int64_t>(L.mask);
  return L;
}

// Stage the run src[0, n) into buf (16-byte aligned): element e at
// buf[phase + e], whole 16-byte groups by cp.async, the partial head and
// tail groups an element at a time.  Returns the phase.
template <class T>
__device__ __forceinline__ int stage(T* buf, const T* src, int n, int tid,
                                     int nt) {
  constexpr int kPer = 16 / sizeof(T);
  const int ph = phase16(src);
  T* d = buf + ph;
  const int groups = (ph + n + kPer - 1) / kPer;
  for (int g = tid; g < groups; g += nt) {
    const int e0 = g * kPer - ph;
    if (e0 >= 0 && e0 + kPer <= n) {
      copy16_async(d + e0, src + e0);
    } else {
      for (int e = max(e0, 0); e < min(e0 + kPer, n); ++e) d[e] = src[e];
    }
  }
  return ph;
}

// s + the four neighbours of f around c, in the plain version's order
__device__ __forceinline__ float add_ring(float s, const float* f, int c,
                                          int nx) {
  s = s + f[c - 1];
  s = s + f[c + 1];
  s = s + f[c - nx];
  return s + f[c + nx];
}

// The 16-byte stores of the write phase, marked evict-first (st.global.cs):
// the planes are written once, and the L2 keeps the rows and planes that
// neighbouring strips and later levels read again
__device__ __forceinline__ void store16(float* dst, float4 v) {
  __stcs(reinterpret_cast<float4*>(dst), v);
}

__device__ __forceinline__ void store16(uint8_t* dst, uint4 v) {
  __stcs(reinterpret_cast<uint4*>(dst), v);
}

// Group g of the value run dst[0, n): its 16-byte aligned window of dst,
// with dst[e] = s[e] + add.
__device__ __forceinline__ void value_group(float* dst, const float* s,
                                            int n, int g, float add) {
  const int e0 = 4 * g - phase16(dst);
  if (e0 >= 0 && e0 + 4 <= n) {
    float4 w;
    if (phase16(s + e0) == 0) {
      w = *reinterpret_cast<const float4*>(s + e0);
    } else {
      w.x = s[e0];
      w.y = s[e0 + 1];
      w.z = s[e0 + 2];
      w.w = s[e0 + 3];
    }
    w.x = w.x + add;
    w.y = w.y + add;
    w.z = w.z + add;
    w.w = w.w + add;
    store16(dst + e0, w);
  } else {
    for (int e = max(e0, 0); e < min(e0 + 4, n); ++e) dst[e] = s[e] + add;
  }
}

// 16 bytes of shared memory from any byte address, by aligned words
__device__ __forceinline__ uint4 mask_group16(const uint8_t* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
  const int sh = static_cast<int>(a & 3) * 8;
  uint32_t r[5];
  for (int i = 0; i < 4; ++i) r[i] = w[i];
  r[4] = sh ? w[4] : 0u;
  uint32_t o[4];
  for (int i = 0; i < 4; ++i) {
    o[i] = sh ? (r[i] >> sh) | (r[i + 1] << (32 - sh)) : r[i];
  }
  uint4 v;
  v.x = o[0];
  v.y = o[1];
  v.z = o[2];
  v.w = o[3];
  return v;
}

// Group g of the mask run dst[0, n): m[e], or 1 where m is null
__device__ __forceinline__ void mask_group(uint8_t* dst, const uint8_t* m,
                                           int n, int g) {
  const int e0 = 16 * g - phase16(dst);
  if (e0 >= 0 && e0 + 16 <= n) {
    uint4 w;
    if (m != nullptr) {
      w = mask_group16(m + e0);
    } else {
      w.x = w.y = w.z = w.w = 0x01010101u;
    }
    store16(dst + e0, w);
  } else {
    for (int e = max(e0, 0); e < min(e0 + 16, n); ++e) {
      dst[e] = m != nullptr ? m[e] : uint8_t(1);
    }
  }
}

// A strip's geometry: rows y0 .. y1 - 1 of level lev; the rows lo .. hi of
// tk, u and v that its centres and clamped rings reach; `at`, its first
// point in a 3-D array.
struct Strip {
  int y0, y1, lo, hi;
  int64_t lev0, at;
};

__device__ __forceinline__ Strip strip_at(const CopyParams& P, unsigned s,
                                          int sy) {
  Strip t;
  const unsigned lev = s / static_cast<unsigned>(sy);
  const int ny = P.ny;
  t.y0 = static_cast<int>(s - lev * sy) * kCopyRows;
  t.y1 = min(t.y0 + kCopyRows, ny);
  t.lo = max(0, min(t.y0 - 1, ny - 3));
  t.hi = min(ny - 1, max(t.y1, 2));
  t.lev0 = static_cast<int64_t>(lev) * ny * P.nx;
  t.at = t.lev0 + static_cast<int64_t>(t.y0) * P.nx;
  return t;
}

// The shared buffers of a strip's inputs, each pointer past its run's phase
struct Staged {
  float *tk, *u, *v, *q;
  uint8_t* m[5];
};

// Issue the copies of strip t's inputs into the buffers (no wait)
template <bool kAllDefined>
__device__ __forceinline__ Staged stage_strip(const CopyParams& P,
                                              const CopyLayout& L,
                                              const Strip& t, float* f,
                                              uint8_t* mb, int tid, int nt) {
  const int nx = P.nx;
  const int n = (t.y1 - t.y0) * nx;
  const int64_t ring0 = t.lev0 + static_cast<int64_t>(t.lo) * nx;
  const int nring = (t.hi - t.lo + 1) * nx;
  const int64_t row0 = static_cast<int64_t>(t.y0) * nx;
  Staged s;
  s.tk = f + stage(f, P.tk + ring0, nring, tid, nt);
  f += L.ring;
  s.u = f + stage(f, P.u + ring0, nring, tid, nt);
  f += L.ring;
  s.v = f + stage(f, P.v + ring0, nring, tid, nt);
  f += L.ring;
  s.q = f + stage(f, P.q + t.at, n, tid, nt);
  if (!kAllDefined) {
    const uint8_t* src[5] = {P.tkm + t.at, P.qm + t.at, P.um + t.at,
                             P.vm + t.at, P.psm + row0};
    for (int k = 0; k < 5; ++k) {
      uint8_t* buf = mb + k * L.mask;
      s.m[k] = buf + stage(buf, src[k], n, tid, nt);
    }
  }
  return s;
}

// Block-stride over the groups of `planes` runs of `groups` groups each,
// plane by plane: fn(k, g) for plane k's group g, one division in all.
template <class Fn>
__device__ __forceinline__ void plane_major(int planes, int groups, int tid,
                                            int nt, Fn fn) {
  int k = tid / groups, g = tid - k * groups;
  while (k < planes) {
    fn(k, g);
    g += nt;
    while (g >= groups) {
      g -= groups;
      ++k;
    }
  }
}

template <bool kAllDefined>
__global__ void __launch_bounds__(
    kCopyThreads, kAllDefined ? kCopyBlocksDefined : kCopyBlocksMasked)
copy_kernel(const CopyParams P) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nx = P.nx, ny = P.ny;
  const int sy = (ny + kCopyRows - 1) / kCopyRows;   // strips a level
  const unsigned strips = static_cast<unsigned>(sy) * P.nlev;   // < 2^31
  const int64_t n3 = static_cast<int64_t>(ny) * nx * P.nlev;
  const CopyLayout L = copy_layout(nx, kAllDefined);
  // inputs: 3 ring buffers, q's, 5 mask buffers; then the sums (a centre
  // buffer) and the mask AND (a mask buffer)
  float* f = dynamic_shared<float>();
  float* sums = f + 3 * L.ring + L.centre;
  uint8_t* mb = reinterpret_cast<uint8_t*>(sums + L.centre);
  uint8_t* ands = mb + 5 * L.mask;

  unsigned strip = blockIdx.x;
  Staged in;
  if (strip < strips) {
    in = stage_strip<kAllDefined>(P, L, strip_at(P, strip, sy), f, mb, tid,
                                  nt);
  }
  cp_async_wait();
  __syncthreads();
  for (; strip < strips; strip += gridDim.x) {
    const Strip t = strip_at(P, strip, sy);
    const int n = (t.y1 - t.y0) * nx;
    // s and the mask AND once a point, at the phases of q's and tk's mask
    // runs
    float* sum = sums + phase16(in.q);
    uint8_t* m = kAllDefined ? nullptr : ands + phase16(in.m[0]);
    for (int dy = 0; dy < t.y1 - t.y0; ++dy) {
      const int y = t.y0 + dy;
      const int cy = min(max(y, 1), ny - 2);
      const float* ps = P.ps + static_cast<int64_t>(y) * nx;
      const float* xm = P.xmapr + static_cast<int64_t>(cy) * nx;
      const float* ym = P.ymapr + static_cast<int64_t>(cy) * nx;
      for (int x = tid; x < nx; x += nt) {
        const int cx = min(max(x, 1), nx - 2);
        const int j = dy * nx + x;
        const int c = (y - t.lo) * nx + x;
        const int r = (cy - t.lo) * nx + cx;
        float v = in.tk[c] + in.q[j];
        v = v + in.u[c];
        v = v + in.v[c];
        v = v + __ldg(ps + x);
        v = add_ring(v, in.tk, r, nx);
        v = add_ring(v, in.u, r, nx);
        v = add_ring(v, in.v, r, nx);
        v = v + __ldg(xm + cx);
        v = v + __ldg(ym + cx);
        sum[j] = v;
        if (!kAllDefined) {
          m[j] = in.m[0][j] & in.m[1][j] & in.m[2][j] & in.m[3][j] &
                 in.m[4][j];
        }
      }
    }
    __syncthreads();
    // the next strip's copies fly while this one's planes are written
    const unsigned next = strip + gridDim.x;
    if (next < strips) {
      in = stage_strip<kAllDefined>(P, L, strip_at(P, next, sy), f, mb, tid,
                                    nt);
    }
    float* values = P.out_values + t.at;
    plane_major(kValuePlanes, (n + 6) / 4, tid, nt, [&](int k, int g) {
      value_group(values + k * n3, sum, n, g, static_cast<float>(k));
    });
    uint8_t* masks = P.out_masks + t.at;
    plane_major(kAllDefined ? kDefinedPlanes : kMaskPlanes, (n + 30) / 16,
                tid, nt, [&](int k, int g) {
                  mask_group(masks + k * n3, m, n, g);
                });
    cp_async_wait();
    __syncthreads();
  }
}

// P1's launch: as many blocks as the card holds at once (SMs x blocks an
// SM at this shared memory), each walking the strips.
template <bool kAllDefined>
int launch_copy(const CopyParams& P, int smem, cudaStream_t s) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncSetAttribute(copy_kernel<kAllDefined>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, copy_kernel<kAllDefined>, kCopyThreads, smem);
  const int64_t strips =
      static_cast<int64_t>((P.ny + kCopyRows - 1) / kCopyRows) * P.nlev;
  const int64_t resident = static_cast<int64_t>(sms) * per_sm;
  const int64_t grid = strips < resident ? strips : resident;
  if (grid < 1 || strips > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 blocks(static_cast<unsigned>(grid));
  copy_kernel<kAllDefined><<<blocks, kCopyThreads, smem, s>>>(P);
  return static_cast<int>(cudaGetLastError());
}

// ---- P2: x + 1 into nbuf outputs -----------------------------------------
//
// A unit of work is ty rows of one level (ty >= ny: the flat variant, one
// unit a level); the units tile x in memory order.  The input pointer is
// passed once and read once for each output, as the TPU probe passes it
// nbuf times (perf_lab_dma.py:65-67).
//
// The design: a block takes one span of 4 to 8 float4 a thread, so that
// the grid holds thousands of blocks and fills every SM whatever ty is.  A
// block's rows are `rows` rows of one level: one unit when a unit is long,
// cut into `pieces` pieces (at most 65535) of at least kAdd1Span float4 a
// thread whose inner ends lie on 16-byte boundaries, or several whole units
// when units are short.  The grid is (row blocks a level, pieces, nlev), so
// a block finds its span without a division.  Over its span a thread
// issues its 16-byte loads (4 to 8, kAdd1Unroll at most) before their stores:
// plain (coherent) loads, which neither nvcc nor ptxas may move across a
// store to memory they might alias, with a compiler barrier between the
// two (with read-only __ldg loads ptxas sank 6 of 8 loads below the first
// store, which waits for the first load).  The span's unaligned head and
// tail go a float at a time.  16-byte accesses need x and every output at
// one 16-byte phase (the C entry checks); where they are not, the same
// spans run a float at a time.

constexpr int kMaxBuffers = 32;
constexpr int kAdd1MaxThreads = 1024;
constexpr int kAdd1Unroll = 8;
constexpr int kAdd1Span = 4;      // float4 a thread a span, at least

struct Add1Params {
  const float* __restrict__ x;
  float* out[kMaxBuffers];
  int nbuf, rows, ny, nx;         // rows: a block's rows of one level
  int64_t piece;                  // floats a piece (gridDim.y > 1)
};

template <bool kVec>
__global__ void __launch_bounds__(kAdd1MaxThreads)
add1_kernel(const Add1Params P) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int y0 = blockIdx.x * P.rows;
  const int y1 = y0 + P.rows < P.ny ? y0 + P.rows : P.ny;
  const int64_t lev = static_cast<int64_t>(blockIdx.z) * P.ny;
  const int64_t a = (lev + y0) * P.nx, e = (lev + y1) * P.nx;
  int64_t s0 = a, s1 = e;
  if (gridDim.y > 1) {
    const int64_t a0 = a + (4 - phase16(P.x + a)) % 4;   // first boundary
    const int k = blockIdx.y;
    s0 = k == 0 ? a : a0 + k * P.piece;
    s1 = a0 + (k + 1) * P.piece;   // pieces * piece >= e - a0
    s0 = s0 < e ? s0 : e;
    s1 = s1 < e ? s1 : e;
  }
  const int n = static_cast<int>(s1 - s0);
  const float* x = P.x + s0;
  const int h = kVec ? min(n, (4 - phase16(x)) % 4) : n;   // the head
  const int nv = (n - h) / 4;                               // float4
  const float4* x4 = reinterpret_cast<const float4*>(x + h);
  for (int ob = 0; ob < P.nbuf; ++ob) {
    float* o = P.out[ob] + s0;
    float4* o4 = reinterpret_cast<float4*>(o + h);
    for (int i0 = tid; i0 < nv; i0 += kAdd1Unroll * nt) {
      float4 w[kAdd1Unroll];
#pragma unroll
      for (int k = 0; k < kAdd1Unroll; ++k) {
        const int i = i0 + k * nt;
        if (i < nv) w[k] = x4[i];
      }
      loads_then_stores();
#pragma unroll
      for (int k = 0; k < kAdd1Unroll; ++k) {
        const int i = i0 + k * nt;
        if (i < nv) {
          w[k].x = w[k].x + 1.0f;
          w[k].y = w[k].y + 1.0f;
          w[k].z = w[k].z + 1.0f;
          w[k].w = w[k].w + 1.0f;
          o4[i] = w[k];
        }
      }
    }
    // the head (every float when the phases differ), then the tail
    for (int i0 = tid; i0 < h; i0 += kAdd1Unroll * nt) {
      float w[kAdd1Unroll];
#pragma unroll
      for (int k = 0; k < kAdd1Unroll; ++k) {
        const int i = i0 + k * nt;
        w[k] = i < h ? x[i] : 0.0f;
      }
      loads_then_stores();
#pragma unroll
      for (int k = 0; k < kAdd1Unroll; ++k) {
        const int i = i0 + k * nt;
        if (i < h) o[i] = w[k] + 1.0f;
      }
    }
    for (int i = h + 4 * nv + tid; i < n; i += nt) o[i] = x[i] + 1.0f;
  }
}

// ---- P3: overlapping windows staged through shared memory ----------------
//
// Window j of a level holds rows [j*ty - 4, j*ty + ty + 4) of x; a block
// stages one window's rows over kWinCols columns into shared memory, then
// writes the window to ow (rows j*(ty + 8) ...) and its ty centre rows plus
// y to o.  Rows outside [0, ny) read as 0.0: the TPU probe leaves them
// undefined, the port pins them.

constexpr int kUnroll = 4;
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
// Each lane iterates c <- c0 * tanh(a / c) from c = 1 and freezes on the
// iteration that brings |c_new - c| <= 1e-5 (keeping that c_new), or stops
// after its own 100th iteration; then sum_k decay[k] * c over the 5 entries
// in order, and NaN -> 0.  tanh is common.cuh's tanh_f32, the quotient an
// IEEE division.  A lane's result does not depend on how lanes are grouped
// (probe_mincog_kernel.py:25-35), so the kernel schedules them freely.
//
// What bounds it: not its bytes (12 a lane) nor the operations its lanes
// need, but the slowest lane's chain of 100 dependent iterations (the floor
// at small sizes: no schedule beats it) and, at 719x929, issue slots: a
// lane needs 15 iterations on average and 3% of lanes run to the cap, so a
// block that waits for its slowest lane (the first design: 256 lanes a
// block in shared memory, a block vote every iteration) runs ~85% of its
// lane-iterations idle.
//
// The design: a grid of resident blocks; each thread keeps one lane's c0,
// a, c and trip count in registers, with no shared memory and no barrier
// in the loop.  When its lane freezes or reaches the cap, the thread writes
// the lane's sum and takes the next lane from its warp's pool.  A warp's
// pool starts as its own chunk of kChunk lanes; when the slots that need a
// lane outnumber the pool, lane 0 claims the next chunk from a counter in
// device memory with one atomicAdd (one claim per kChunk lanes: one
// address takes only ~1e9 atomics a second, so a claim a lane or a claim
// a warp for exactly its free slots was slower), and every slot takes its
// lane by its rank among them (__ballot_sync, __popc).  A warp leaves when
// its pool is past n and none of its slots holds a lane.
//
// Two choices set against the drain, measured (PERF.md, PR 14):
// - kSolverBlocksPerSm.  When the counter runs out, a warp runs until its
//   slowest lane in flight is done, and most warps hold a capped one then.
//   The more slots, the fewer lanes each gets before that: at the
//   occupancy limit (64 warps an SM) two thirds of the warp-iterations
//   drained; 16 warps an SM still hide an iteration's latency.
// - kRound.  Between refills a slot runs up to kRound iterations with no
//   vote; a slot whose lane stops early idles for the rest of the round.
//
// The counter returns to zero inside the kernel: the last warp out resets
// it and the count of warps out, so a call is one launch and launches in
// turn on one stream each find zeros.  Two launches that share a workspace
// must not run at once; the wrapper keeps one workspace a stream.
//
// The host build of tests/cuda_host.py runs a block as one thread, a warp
// of one slot: it takes its pool and then claims chunks until the counter
// is spent, so the blocks run one after the other cover every lane.

constexpr int kSolverThreads = 128;
constexpr int kSolverBlocksPerSm = 4;
constexpr int kRound = 8;
constexpr unsigned kChunk = 32;
constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kSolverMaxIter = 100;
constexpr int kDecay = 5;
constexpr float kSolverTol = 0x1.4f8b58p-17f;   // float32(1e-5)

struct SolverParams {
  const float* __restrict__ c0;
  const float* __restrict__ a;
  const float* __restrict__ decay;
  float* __restrict__ out;
  // [0] chunks claimed beyond the warps' own, [1] warps out; zero between
  // launches
  unsigned* __restrict__ work;
  unsigned n;
};

__global__ void __launch_bounds__(kSolverThreads)
    solver_kernel(const SolverParams P) {
  float decay[kDecay];
  for (int k = 0; k < kDecay; ++k) decay[k] = __ldg(P.decay + k);
  const unsigned per_block = (blockDim.x + 31) / 32;
  const unsigned warps = gridDim.x * per_block;
  const unsigned slot = threadIdx.x & 31;
  const unsigned below = (1u << slot) - 1u;
  // the warp's pool of lanes not yet started, [next, end)
  unsigned next = (blockIdx.x * per_block + threadIdx.x / 32) * kChunk;
  unsigned end = next + kChunk;
  bool live = false;
  unsigned i = 0;
  int trips = 0;
  float c0 = 0.0f, a = 0.0f, c = 1.0f;
  for (;;) {
    const unsigned want = __ballot_sync(kFullWarp, !live);
    if (want != 0 && next < P.n) {
      const unsigned k = __popc(want), have = end - next;
      unsigned base = 0;
      if (k > have) {
        if (slot == 0) base = (warps + atomicAdd(P.work, 1u)) * kChunk;
        base = __shfl_sync(kFullWarp, base, 0);
      }
      if (!live) {
        const unsigned r = __popc(want & below);
        i = r < have ? next + r : base + (r - have);
        if (i < P.n) {
          c0 = __ldg(P.c0 + i);
          a = __ldg(P.a + i);
          c = 1.0f;
          trips = 0;
          live = true;
        }
      }
      if (k > have) {
        next = base + (k - have);
        end = base + kChunk;
      } else {
        next += k;
      }
    }
    if (!__any_sync(kFullWarp, live)) break;
    if (live) {
      // up to kRound iterations before the warp refills again
      bool stop = false;
      for (int j = 0; j < kRound && !stop; ++j) {
        const float c_new = c0 * tanh_f32(a / c);
        ++trips;
        stop = fabsf(c_new - c) <= kSolverTol || trips == kSolverMaxIter;
        c = c_new;
      }
      if (stop) {
        float acc = 0.0f;
        for (int k = 0; k < kDecay; ++k) acc = acc + decay[k] * c;
        P.out[i] = acc != acc ? 0.0f : acc;
        live = false;
      }
    }
  }
  if (slot == 0) {
    // every claim of this warp before its count out; the last warp's reset
    // after every other warp's claims
    __threadfence();
    if (atomicAdd(P.work + 1, 1u) == warps - 1) {
      __threadfence();
      P.work[0] = 0;
      P.work[1] = 0;
    }
  }
}

}  // namespace

extern "C" {

// Each entry launches its kernel on `stream` and returns
// cudaGetLastError() as an int (cudaErrorInvalidValue for arguments the
// kernel does not take).

// P1.  Mask pointers may be null when all_defined != 0; out_masks holds 2
// planes then, else 9.  A block stages its strips in dynamic shared
// memory; smem_bytes (0 to 227 KB) is the least a block reserves, to cap
// the blocks an SM holds.  A row too wide for a strip's buffers in 227 KB
// is refused (copy_layout).
int mf_probe_copy(const float* tk, const float* q, const float* u,
                  const float* v, const uint8_t* tkm, const uint8_t* qm,
                  const uint8_t* um, const uint8_t* vm, const float* ps,
                  const uint8_t* psm, const float* xmapr, const float* ymapr,
                  float* out_values, uint8_t* out_masks, int nlev, int ny,
                  int nx, int all_defined, int smem_bytes, void* stream) {
  if (nlev < 1 || nlev > 65535 || ny < 3 || nx < 3 || smem_bytes < 0 ||
      smem_bytes > kMaxDynamicSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t need = copy_layout(nx, all_defined != 0).bytes;
  if (need > kMaxDynamicSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = need > smem_bytes ? static_cast<int>(need) : smem_bytes;
  const CopyParams P{tk, q, u, v, tkm, qm, um, vm, ps, psm, xmapr, ymapr,
                     out_values, out_masks, nlev, ny, nx};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return all_defined ? launch_copy<true>(P, smem, s)
                     : launch_copy<false>(P, smem, s);
}

// P2.  `outs` is a host array of nbuf device pointers; threads a block in
// [32, 1024].  16-byte accesses when x and every output share one 16-byte
// phase, else 4-byte ones.
int mf_probe_add1(const float* x, float* const* outs, int nbuf, int ty,
                  int threads, int nlev, int ny, int nx, void* stream) {
  if (nbuf < 1 || nbuf > kMaxBuffers || ty < 1 || ny < 1 || nx < 1 ||
      nlev < 1 || nlev > 65535 || threads < 32 || threads > kAdd1MaxThreads ||
      static_cast<int64_t>(ty) * nx > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Add1Params P{};
  P.x = x;
  bool vec = true;
  for (int b = 0; b < nbuf; ++b) {
    P.out[b] = outs[b];
    vec = vec && phase16(outs[b]) == phase16(x);
  }
  P.nbuf = nbuf;
  P.ny = ny;
  P.nx = nx;
  const int tyc = ty < ny ? ty : ny;
  const int64_t unit = static_cast<int64_t>(tyc) * nx;
  const int64_t span = 4LL * kAdd1Span * threads;
  int64_t pieces = unit > span ? unit / span : 1;
  pieces = pieces < 65535 ? pieces : 65535;
  const int64_t units = unit > span ? 1 : (span + unit - 1) / unit;
  const int64_t rows = tyc * units < ny ? tyc * units : ny;
  const int64_t row_blocks = (ny + rows - 1) / rows;
  P.rows = static_cast<int>(rows);
  P.piece = ((unit + pieces - 1) / pieces + 3) / 4 * 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(row_blocks),
                  static_cast<unsigned>(pieces), nlev);
  if (vec) {
    add1_kernel<true><<<grid, threads, 0, s>>>(P);
  } else {
    add1_kernel<false><<<grid, threads, 0, s>>>(P);
  }
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

// P4.  `decay` holds 5 device floats; c0, a and out n lanes; `work` 2
// device unsigned ints, zero before the first launch (the kernel leaves
// them zero), used by one launch at a time.  As many blocks as the card
// holds at once, or fewer where the lanes fill fewer.
int mf_probe_solver(const float* c0, const float* a, const float* decay,
                    float* out, unsigned* work, int n, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, solver_kernel,
                                                kSolverThreads, 0);
  per_sm = per_sm < kSolverBlocksPerSm ? per_sm : kSolverBlocksPerSm;
  const int64_t need = (static_cast<int64_t>(n) + kSolverThreads - 1) /
                       kSolverThreads;
  const int64_t resident = static_cast<int64_t>(sms) * per_sm;
  const int64_t grid = need < resident ? need : resident;
  if (grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  const SolverParams P{c0, a, decay, out, work, static_cast<unsigned>(n)};
  const dim3 blocks(static_cast<unsigned>(grid));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  solver_kernel<<<blocks, kSolverThreads, 0, s>>>(P);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
