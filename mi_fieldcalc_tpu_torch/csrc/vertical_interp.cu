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
// What bounds it: device-memory bytes, and not many of them, once the
// bracket is found without a walk.  A column reads ps, its own bracket
// levels (2 values + 2 mask bytes per field and target) and writes
// nvar * nt values and masks.  The first design walked all nlev - 1 level
// pairs for every column and target (~1.0e9 pair steps at BASELINE config
// 4, 137 levels -> 11 targets over 719x929, each two shared-memory loads,
// a multiply, an add and two compares): that walk, not the bytes, set its
// time.
//
// Design:
// - one thread per (y, x) column, 256-thread blocks over the flattened
//   plane; targets are the outer loop, so no nvar x nt accumulators sit in
//   registers; neighbouring threads hold neighbouring columns, so every
//   read and write is coalesced where neighbouring columns share a bracket;
// - each block copies a, b and the targets into shared memory and checks
//   there, with one block vote, that a and b are finite and non-decreasing;
// - on such levels, a column whose ps is finite and >= 0 has
//   non-decreasing p_k = fl(a_k + fl(b_k * ps)) (b_k * ps is non-decreasing
//   in k, rounding is monotone, and a finite a_k and b_k give no NaN), so
//   "p_k <= t" holds on a prefix of the levels and at most one k has
//   p_k <= t < p_{k+1}: the last prefix level, if the next one exists and
//   lies above t.  A binary search of ceil(log2(nlev + 1)) steps finds the
//   prefix's length, and the bracket is the same k the walk finds;
// - every other column (ps NaN, infinite or negative), and every column
//   of a launch whose a or b fails the vote, walks all level pairs and
//   keeps the last bracket, as the rule says.  Both paths evaluate p_k with
//   the same two operations, so they agree wherever both apply;
// - ln t of each target is taken once per block, into shared memory;
// - every phase is a block-stride loop, so the source also runs on the
//   host with one thread per block (tests/test_torch_vertical_host.py);
// - a launch takes at most kGroupVars fields, their pointers in the
//   parameter struct; the C entry launches once for each group of that
//   many fields, each launch writing its own slice of the outputs, so a
//   call takes any number of fields and a call of up to kGroupVars runs
//   the one launch (and the same kernel) it always did.
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py --interp-times,
// the launch alone, 3 pairs against the walk): config 4, random ps,
// masked 0.3172-0.3225 ms against 0.4159-0.4861; on a smooth ps of the
// same range 0.2468-0.2525 against 0.4068-0.4266 (bytes moved once: 0.1326
// ms at 3.35 TB/s).  What is left is mostly the bracket gathers: on the
// random ps the 32 columns of a warp bracket a near-surface target at up
// to ~8 levels, so their loads touch several times the sectors they use.
// Loading a group of 4 or 8 targets' brackets before their stores, and
// streaming (evict-first) stores, were measured and were slower.  At 40
// fields (two launches, 31 + 9) the launches take 2.99 ms masked against
// the bytes bound's 1.32 ms (chip_smoke.py phase 16): each launch repeats
// the bracket search, which fields of one group share.

#include "common.cuh"

namespace {

constexpr int kGroupVars = 31;   // fields a launch (the parameter struct)
constexpr int kMaxLev = 4096;    // a, b and the targets in shared memory
constexpr int kMaxTargets = 1024;
constexpr int kBlock = 256;      // columns (and threads) a block

struct InterpParams {
  const float* f[kGroupVars];
  const uint8_t* fm[kGroupVars];
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

// The last k with p_k <= xt < p_{k+1}, or -1: every level pair in turn.
__device__ __forceinline__ int bracket_walk(const float* s_a,
                                            const float* s_b, int nlev,
                                            float ps, float xt) {
  int kb = -1;
  float p_k = s_a[0] + s_b[0] * ps;
  for (int k = 0; k + 1 < nlev; ++k) {
    const float p_k1 = s_a[k + 1] + s_b[k + 1] * ps;
    if (p_k <= xt && p_k1 > xt) kb = k;
    p_k = p_k1;
  }
  return kb;
}

// The same k on a column whose p_k does not decrease: the length of the
// prefix of levels with p_k <= xt (steps of top, top/2, ..., 1; top the
// largest power of two <= nlev), then the bracket below the first level
// above xt.
__device__ __forceinline__ int bracket_search(const float* s_a,
                                              const float* s_b, int nlev,
                                              int top, float ps, float xt) {
  int cnt = 0;
  for (int step = top; step >= 1; step >>= 1) {
    const int k = cnt + step - 1;
    if (k < nlev && s_a[k] + s_b[k] * ps <= xt) cnt += step;
  }
  if (cnt < 1 || cnt >= nlev) return -1;
  return s_a[cnt] + s_b[cnt] * ps > xt ? cnt - 1 : -1;
}

template <bool kAllDefined, bool kLogP>
__global__ void __launch_bounds__(kBlock)
interp_kernel(const InterpParams P) {
  // a[nlev], b[nlev], the targets and their x (ln t or t) in shared memory
  float* s_a = dynamic_shared<float>();
  float* s_b = s_a + P.nlev;
  float* s_t = s_b + P.nlev;
  float* s_xt = s_t + P.nt;
  bool sorted = true;           // a and b finite and non-decreasing
  for (int k = threadIdx.x; k < P.nlev; k += blockDim.x) {
    const float a = P.alevel[k];
    const float b = P.blevel[k];
    s_a[k] = a;
    s_b[k] = b;
    sorted = sorted && isfinite(a) && isfinite(b) &&
             (k == 0 || (P.alevel[k - 1] <= a && P.blevel[k - 1] <= b));
  }
  for (int t = threadIdx.x; t < P.nt; t += blockDim.x) {
    s_t[t] = P.targets[t];
    s_xt[t] = kLogP ? log_f32(P.targets[t]) : P.targets[t];
  }
  const bool search = __syncthreads_and(sorted);
  int top = 1;
  while (2 * top <= P.nlev) top *= 2;

  // the block's kBlock columns, one a thread on the card
  const int64_t end =
      min(P.plane, static_cast<int64_t>(blockIdx.x + 1) * kBlock);
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
       i < end; i += blockDim.x) {
    const float ps = __ldg(P.ps + i);
    const bool psm = kAllDefined ? true : __ldg(P.psm + i) != 0;
    // finite and >= 0 (NaN fails both compares)
    const bool monotone = search && ps >= 0.0f && ps <= 0x1.fffffep+127f;
    const int64_t n_out = P.plane * P.nt;     // one output field

    for (int t = 0; t < P.nt; ++t) {
      const float xt = s_t[t];
      const int kb =
          monotone ? bracket_search(s_a, s_b, P.nlev, top, ps, xt)
                   : bracket_walk(s_a, s_b, P.nlev, ps, xt);
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
      const float w = (s_xt[t] - x0) * dinv;
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
}

template <bool kAllDefined>
void launch(const InterpParams& P, bool log_p, dim3 grid, size_t smem,
            cudaStream_t stream) {
  if (log_p) {
    interp_kernel<kAllDefined, true><<<grid, kBlock, smem, stream>>>(P);
  } else {
    interp_kernel<kAllDefined, false><<<grid, kBlock, smem, stream>>>(P);
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`, once for each group of at most
// kGroupVars fields, and stores in *launched how many launches it made;
// returns the first nonzero cudaGetLastError() as an int, or 0.  fvals /
// fmasks are host arrays of nvar device pointers (fmasks and psm may be
// null when all_defined != 0: they are not read).  out_values is [nvar,
// nt, ny, nx]; out_masks is [1, nt, ny, nx] when all_defined != 0, else
// [nvar, nt, ny, nx].
int mf_vertical_interp(const float* const* fvals,
                       const uint8_t* const* fmasks, int nvar,
                       const float* ps, const uint8_t* psm,
                       const float* alevel, const float* blevel,
                       const float* targets, int nt, float* out_values,
                       uint8_t* out_masks, int nlev, int ny, int nx,
                       int log_p, int all_defined, void* stream,
                       int* launched) {
  *launched = 0;
  if (nvar < 1 || nt < 1 || nt > kMaxTargets || nlev < 1 ||
      nlev > kMaxLev || ny < 1 || nx < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t plane = static_cast<int64_t>(ny) * nx;
  const int64_t grid = (plane + kBlock - 1) / kBlock;
  if (grid > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * 2 * (static_cast<size_t>(nlev) + nt);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 g(static_cast<unsigned>(grid));
  const int64_t n_out = plane * nt;     // one output field
  for (int v0 = 0; v0 < nvar; v0 += kGroupVars) {
    InterpParams P{};
    P.nvar = nvar - v0 < kGroupVars ? nvar - v0 : kGroupVars;
    for (int v = 0; v < P.nvar; ++v) {
      P.f[v] = fvals[v0 + v];
      P.fm[v] = all_defined ? nullptr : fmasks[v0 + v];
    }
    P.ps = ps;
    P.psm = psm;
    P.alevel = alevel;
    P.blevel = blevel;
    P.targets = targets;
    P.out_values = out_values + v0 * n_out;
    P.nt = nt;
    P.nlev = nlev;
    P.plane = plane;
    if (all_defined) {
      // the fields share one mask plane, and every group writes it: the
      // same bytes each time, since the gate reads only ps, a, b and the
      // targets
      P.out_masks = out_masks;
      launch<true>(P, log_p != 0, g, smem, s);
    } else {
      P.out_masks = out_masks + v0 * n_out;
      launch<false>(P, log_p != 0, g, smem, s);
    }
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    ++*launched;
  }
  return 0;
}

}  // extern "C"
