// Hybrid-level -> pressure-level column interpolation in one CUDA kernel,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// mi_fieldcalc_tpu/ops/vertical_fused.py:_interp_kernel (entry
// hlevel_to_plevel_fused, vertical_fused.py:272; pallas_call at :359).
// It interpolates nvar fields [nlev, ny, nx] from hybrid levels, whose
// pressure p_k = a[k] + b[k] * ps is rebuilt per level and never stored, to
// nt pressure targets, linearly in ln p (or in p), and writes values
// f32[nvar, nt, ny, nx] and masks u8[nvar or 1, nt, ny, nx].
//
// The rule is the JAX kernel's, and the port's plain version
// (ops/vertical_fused.hlevel_to_plevel_plain) follows it op for op:
// - target t is bracketed at level k where p_k <= t < p_{k+1}; on a
//   non-monotone column the LAST such k wins (later levels overwrite);
// - x = log_f32(p > 0 ? p : 1) (or p itself), w = (x_t - x_k) * dinv with
//   dinv = 1 / (denom != 0 ? denom : 1), denom = x_{k+1} - x_k, and the
//   value f_k + (f_{k+1} - f_k) * w;
// - mask: both bracket levels defined, ps defined and denom != 0; under
//   all_defined one plane holding the bracket and denom != 0;
// - a target with no bracket gives 0, masked (every target, on a single
//   level).
//
// What bounds it: device-memory bytes, and not many of them.  A column
// reads ps, its own bracket levels (2 values + 2 mask bytes per field and
// target) and writes nvar * nt values and masks; the level loop is a
// multiply, an add and two compares per level and target, on a and b
// held in shared memory.
//
// Design (the first, simple version): one thread per (y, x) column,
// 256-thread blocks over the flattened plane.  Targets are the outer loop,
// so no nvar x nt accumulators sit in registers; for each target the
// thread walks all level pairs to find the last bracket, then reads only
// the two bracket levels of each field.  Neighbouring threads hold
// neighbouring columns, so every read and write is coalesced where
// neighbouring columns share a bracket.

#include "common.cuh"

namespace {

constexpr int kMaxVar = 31;      // the packed variant's limit (JAX)
constexpr int kMaxLev = 4096;    // a, b and the targets in shared memory
constexpr int kMaxTargets = 1024;

struct InterpParams {
  const float* f[kMaxVar];
  const uint8_t* fm[kMaxVar];
  const float* __restrict__ ps;
  const uint8_t* __restrict__ psm;
  const float* __restrict__ alevel;
  const float* __restrict__ blevel;
  const float* __restrict__ targets;
  float* __restrict__ out_values;
  uint8_t* __restrict__ out_masks;
  int nvar, nt, nlev;
  int64_t plane;
};

__device__ __forceinline__ float level_x(float p, bool log_p) {
  return log_p ? log_f32(p > 0.0f ? p : 1.0f) : p;
}

template <bool kAllDefined, bool kLogP>
__global__ void __launch_bounds__(256)
interp_kernel(const InterpParams P) {
  extern __shared__ float s_coef[];        // a[nlev], b[nlev], targets[nt]
  float* s_a = s_coef;
  float* s_b = s_coef + P.nlev;
  float* s_t = s_coef + 2 * P.nlev;
  for (int k = threadIdx.x; k < P.nlev; k += blockDim.x) {
    s_a[k] = P.alevel[k];
    s_b[k] = P.blevel[k];
  }
  for (int t = threadIdx.x; t < P.nt; t += blockDim.x) {
    s_t[t] = P.targets[t];
  }
  __syncthreads();

  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= P.plane) return;
  const float ps = __ldg(P.ps + i);
  const bool psm = kAllDefined ? true : __ldg(P.psm + i) != 0;
  const int64_t n_out = P.plane * P.nt;     // one output field

  for (int t = 0; t < P.nt; ++t) {
    const float xt = s_t[t];
    int kb = -1;
    float p_k = s_a[0] + s_b[0] * ps;
    for (int k = 0; k + 1 < P.nlev; ++k) {
      const float p_k1 = s_a[k + 1] + s_b[k + 1] * ps;
      if (p_k <= xt && p_k1 > xt) kb = k;
      p_k = p_k1;
    }
    const int64_t o = static_cast<int64_t>(t) * P.plane + i;
    if (kb < 0) {
      for (int v = 0; v < P.nvar; ++v) P.out_values[v * n_out + o] = 0.0f;
      if (kAllDefined) {
        P.out_masks[o] = 0;
      } else {
        for (int v = 0; v < P.nvar; ++v) P.out_masks[v * n_out + o] = 0;
      }
      continue;
    }
    const float x0 = level_x(s_a[kb] + s_b[kb] * ps, kLogP);
    const float x1 = level_x(s_a[kb + 1] + s_b[kb + 1] * ps, kLogP);
    const float denom = x1 - x0;
    const bool ok = denom != 0.0f;
    const float dinv = 1.0f / (ok ? denom : 1.0f);
    const float lxt = kLogP ? log_f32(xt) : xt;
    const float w = (lxt - x0) * dinv;
    const int64_t i0 = static_cast<int64_t>(kb) * P.plane + i;
    const int64_t i1 = i0 + P.plane;
    for (int v = 0; v < P.nvar; ++v) {
      const float f0 = __ldg(P.f[v] + i0);
      const float f1 = __ldg(P.f[v] + i1);
      P.out_values[v * n_out + o] = f0 + (f1 - f0) * w;
      if (!kAllDefined) {
        P.out_masks[v * n_out + o] =
            (__ldg(P.fm[v] + i0) && __ldg(P.fm[v] + i1) && ok && psm) ? 1
                                                                      : 0;
      }
    }
    if (kAllDefined) P.out_masks[o] = ok ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns cudaGetLastError() as an int.
// fvals / fmasks are host arrays of nvar device pointers (fmasks and psm
// may be null when all_defined != 0: they are not read).  out_values is
// [nvar, nt, ny, nx]; out_masks is [1, nt, ny, nx] when all_defined != 0,
// else [nvar, nt, ny, nx].
int mf_vertical_interp(const float* const* fvals,
                       const uint8_t* const* fmasks, int nvar,
                       const float* ps, const uint8_t* psm,
                       const float* alevel, const float* blevel,
                       const float* targets, int nt, float* out_values,
                       uint8_t* out_masks, int nlev, int ny, int nx,
                       int log_p, int all_defined, void* stream) {
  if (nvar < 1 || nvar > kMaxVar || nt < 1 || nt > kMaxTargets ||
      nlev < 1 || nlev > kMaxLev || ny < 1 || nx < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  InterpParams P{};
  for (int v = 0; v < nvar; ++v) {
    P.f[v] = fvals[v];
    P.fm[v] = all_defined ? nullptr : fmasks[v];
  }
  P.ps = ps;
  P.psm = psm;
  P.alevel = alevel;
  P.blevel = blevel;
  P.targets = targets;
  P.out_values = out_values;
  P.out_masks = out_masks;
  P.nvar = nvar;
  P.nt = nt;
  P.nlev = nlev;
  P.plane = static_cast<int64_t>(ny) * nx;
  const int block = 256;
  const int64_t grid = (P.plane + block - 1) / block;
  if (grid > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(nlev) + nt);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 g(static_cast<unsigned>(grid));
  if (all_defined) {
    if (log_p) {
      interp_kernel<true, true><<<g, block, smem, s>>>(P);
    } else {
      interp_kernel<true, false><<<g, block, smem, s>>>(P);
    }
  } else if (log_p) {
    interp_kernel<false, true><<<g, block, smem, s>>>(P);
  } else {
    interp_kernel<false, false><<<g, block, smem, s>>>(P);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
