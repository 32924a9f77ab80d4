// The ensemble reductions of one member-stacked field in one pass (Hopper,
// sm_90a): for every point of a [nmem, npts] stack of values and masks, the
// defined count, the mean and the population spread over the defined
// members, and, where asked, how many defined members pass a limit.
//
// It replaces no TPU kernel: the JAX package leaves these reductions
// (mi_fieldcalc_tpu/ops/ensemble.py mean_value, stddev_value, probability)
// to XLA.  The port's plain versions (ops/ensemble.py) read each stack
// several times and write whole-stack temporaries; this kernel reads each
// value and mask byte once and writes only the outputs.
//
// What bounds it: bytes.  A point moves 5 * nmem bytes in and 9 (13 with
// the count) out, and costs about 5 * nmem float operations.  What the
// design does about it:
//   - neighbouring threads take neighbouring points, so each member's
//     loads are coalesced 4-byte (values) and 1-byte (masks) accesses, and
//     a member plane may start at any offset (on MEPS's grid nlev*ny*nx is
//     odd, so every other plane is off a 16-byte boundary): no load
//     assumes an alignment;
//   - up to kCap members (a compile-time cap: 10, MEPS's count, or 32,
//     which holds GEFS's 31) a thread issues all of its point's value and
//     mask loads before it uses one, so 5 * nmem bytes a thread are in
//     flight, and keeps the values in registers for the spread's second
//     pass; above 32 members the second pass reads the values again
//     (correct, slower: a thread's loads then wait on each other);
//   - a grid of resident blocks walks the points, so the member flags cost
//     one shared-memory pass and one atomic a block and member.
//
// Arithmetic (built -fmad=false, without --use_fast_math: common.cuh):
// the sums run over the members in order from +0, skipping undefined
// members (the plain versions add +0 for them, which leaves every sum
// unchanged); the mean is the sum over the count as float32, or over 1
// where none is defined; the spread is the two-pass sqrt(sum of (v -
// mean)^2 / n), as ops/ensemble.stddev_value, not Welford's recurrence nor
// E[x^2] - E[x]^2.  The probability's divisor counts the members defined
// anywhere in the field (on a shard: over all shards), so it is known only
// after the whole stack is read: the stats kernel writes the count of
// passing members as a float, and prob_kernel scales that plane in place by
// 100 / nfields, in the plain version's order (count * 100, then / n).
//
// Both kernels are block-stride loops over the points, so the host build of
// tests/cuda_host.py, which runs a block as one thread, covers the grid.

#include "common.cuh"

namespace {

constexpr int kStatsThreads = 256;
// the most members a thread keeps in registers (one bit each in a word)
constexpr int kMaxCap = 32;
// the most members whose whole-field flags a block gathers in shared
// memory (the probability's divisor)
constexpr int kMaxFlagMembers = 1024;

struct StatsParams {
  const float* values;    // [nmem, npts]
  const uint8_t* mask;    // [nmem, npts], 0 or 1
  float* mean;            // [npts]
  float* spread;          // [npts]
  uint8_t* some;          // [npts]: some member is defined there
  float* count;           // [npts]: defined members past the limit
  int* seen;              // [nmem]: member defined somewhere (OR'd in)
  int64_t npts;
  int nmem;
  int below;              // 0: count v > limit, 1: count v < limit
  float limit;
};

struct ProbParams {
  float* prob;            // [npts]: the count in, the probability (%) out
  uint8_t* some;          // one byte: some member is defined anywhere
  const int* seen;        // [nmem]
  int64_t npts;
  int nmem;
};

__device__ __forceinline__ int passes(float v, const StatsParams& P) {
  return P.below ? (v < P.limit) : (v > P.limit);
}

// kCap > 0: up to kCap members, every load of a point issued before the
// first is used, the values kept in registers for the second pass.
// kCap == 0: any number of members, the values read twice.
template <int kCap, bool kProb>
__global__ void __launch_bounds__(kStatsThreads)
    stats_kernel(const StatsParams P) {
  __shared__ int s_seen[kProb ? kMaxFlagMembers : 1];
  if constexpr (kProb) {
    for (int m = threadIdx.x; m < P.nmem; m += blockDim.x) s_seen[m] = 0;
    __syncthreads();
  }
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  uint32_t seen = 0;      // kCap > 0: the members this thread found defined
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       p < P.npts; p += step) {
    const float* vp = P.values + p;
    const uint8_t* mp = P.mask + p;
    float sum = 0.0f, sq = 0.0f;
    int n = 0, c = 0;
    if constexpr (kCap > 0) {
      float v[kCap];
      uint32_t def = 0;
#pragma unroll
      for (int m = 0; m < kCap; ++m) {
        if (m < P.nmem) {
          v[m] = __ldg(vp + m * P.npts);
          def |= static_cast<uint32_t>(__ldg(mp + m * P.npts) != 0) << m;
        } else {
          v[m] = 0.0f;
        }
      }
#pragma unroll
      for (int m = 0; m < kCap; ++m) {
        if ((def >> m) & 1u) {
          sum += v[m];
          ++n;
        }
      }
      const float mean = sum / (n > 0 ? static_cast<float>(n) : 1.0f);
#pragma unroll
      for (int m = 0; m < kCap; ++m) {
        if ((def >> m) & 1u) {
          const float d = v[m] - mean;
          sq += d * d;
          if constexpr (kProb) c += passes(v[m], P);
        }
      }
      P.mean[p] = mean;
      seen |= def;
    } else {
      for (int m = 0; m < P.nmem; ++m) {
        if (__ldg(mp + m * P.npts)) {
          sum += __ldg(vp + m * P.npts);
          ++n;
        }
      }
      const float mean = sum / (n > 0 ? static_cast<float>(n) : 1.0f);
      for (int m = 0; m < P.nmem; ++m) {
        if (__ldg(mp + m * P.npts)) {
          const float x = __ldg(vp + m * P.npts);
          const float d = x - mean;
          sq += d * d;
          if constexpr (kProb) {
            c += passes(x, P);
            s_seen[m] = 1;
          }
        }
      }
      P.mean[p] = mean;
    }
    P.spread[p] = sqrtf(sq / (n > 0 ? static_cast<float>(n) : 1.0f));
    P.some[p] = n > 0;
    if constexpr (kProb) P.count[p] = static_cast<float>(c);
  }
  if constexpr (kProb) {
    if (kCap > 0) {
      for (int m = 0; m < P.nmem; ++m) {
        if ((seen >> m) & 1u) s_seen[m] = 1;
      }
    }
    __syncthreads();
    for (int m = threadIdx.x; m < P.nmem; m += blockDim.x) {
      if (s_seen[m]) atomicOr(P.seen + m, 1);
    }
  }
}

__global__ void __launch_bounds__(kStatsThreads)
    prob_kernel(const ProbParams P) {
  int nfields = 0;
  for (int m = 0; m < P.nmem; ++m) nfields += P.seen[m] != 0;
  const float nf = nfields > 0 ? static_cast<float>(nfields) : 1.0f;
  if (blockIdx.x == 0 && threadIdx.x == 0) *P.some = nfields > 0;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       p < P.npts; p += step) {
    P.prob[p] = P.prob[p] * 100.0f / nf;
  }
}

// Blocks for npts points: as many as the card holds at once, fewer for a
// small field, at least one; 0 when the kernel cannot be resident.
template <class K>
unsigned resident_blocks(K kernel, int64_t npts) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                kStatsThreads, 0);
  const int64_t need = (npts + kStatsThreads - 1) / kStatsThreads;
  const int64_t resident = static_cast<int64_t>(sms) * per_sm;
  if (resident < 1) return 0;
  const int64_t grid = need < resident ? need : resident;
  return static_cast<unsigned>(grid > 1 ? grid : 1);
}

template <int kCap, bool kProb>
int launch_stats(const StatsParams& P, cudaStream_t s) {
  const unsigned blocks = resident_blocks(stats_kernel<kCap, kProb>, P.npts);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  stats_kernel<kCap, kProb><<<blocks, kStatsThreads, 0, s>>>(P);
  return static_cast<int>(cudaGetLastError());
}

// The register caps: 10 for MEPS's members and up to 10, 32 up to GEFS's
// 31, the re-read path above.  Every register a thread holds costs
// occupancy and every load beyond nmem an issue slot, so the cap fits the
// count it serves (on an H100 at 10 x 65 x 949 x 739, 10 members under a
// cap of 16 took 1.62 ms a field with the probability, under a cap of 10
// 1.30); add a cap only where a member count that is run shows it pays.
template <bool kProb>
int dispatch_stats(const StatsParams& P, cudaStream_t s) {
  if (P.nmem <= 10) return launch_stats<10, kProb>(P, s);
  if (P.nmem <= kMaxCap) return launch_stats<kMaxCap, kProb>(P, s);
  return launch_stats<0, kProb>(P, s);
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() as an int
// (cudaErrorInvalidValue for arguments the kernel does not take).

// The stats of one field.  compute 0: mean, spread and the defined mask
// only (count and seen null); 1: also the defined members above `limit`
// per point into `count`, and each member's whole-field flag OR'd into
// `seen` (zeroed here first); 2: the same below `limit`.
int mf_ensemble_stats(const float* values, const uint8_t* mask, float* mean,
                      float* spread, uint8_t* some, float* count, int* seen,
                      int nmem, int64_t npts, int compute, float limit,
                      void* stream) {
  const bool prob = compute != 0;
  if (nmem < 1 || npts < 0 || compute < 0 || compute > 2 ||
      (prob && (count == nullptr || seen == nullptr ||
                nmem > kMaxFlagMembers))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (prob) {
    const cudaError_t err = cudaMemsetAsync(
        seen, 0, sizeof(int) * static_cast<size_t>(nmem), s);
    if (err != 0) return static_cast<int>(err);
  }
  if (npts == 0) return 0;
  const StatsParams P{values, mask, mean, spread, some, count, seen,
                      npts,   nmem, compute == 2 ? 1 : 0, limit};
  return prob ? dispatch_stats<true>(P, s) : dispatch_stats<false>(P, s);
}

// The probability (%) from mf_ensemble_stats's counts, in place, and
// whether any member is defined anywhere, from the (shard-reduced) flags.
int mf_ensemble_prob(float* prob, uint8_t* some, const int* seen, int nmem,
                     int64_t npts, void* stream) {
  if (nmem < 1 || npts < 0) return static_cast<int>(cudaErrorInvalidValue);
  const ProbParams P{prob, some, seen, npts, nmem};
  const unsigned blocks = resident_blocks(prob_kernel, npts);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  prob_kernel<<<blocks, kStatsThreads, 0, s>>>(P);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
