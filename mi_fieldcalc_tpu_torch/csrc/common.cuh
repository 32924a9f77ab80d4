// Device helpers shared by the package's CUDA kernels (sm_90a).
//
// Every function and the __constant__ table are `static`: the library's
// .cu files are compiled one by one without -rdc, so each translation unit
// keeps its own copy.
//
// Numerics: the kernels are built with -fmad=false and without
// --use_fast_math.  No multiply-add is contracted, '/' and sqrtf stay
// IEEE, and the deterministic pow, log, exp and tanh below give the bits of
// the JAX package's _libm.pow_posc_f32, log_f32, exp_f32 and tanh_f32 (and
// of the port's torch versions in _libm.py).  The table coordinate's
// float-to-int conversion follows XLA's (truncate, saturate, NaN -> 0)
// through a clamp to [-1, 40] in float before the cast.  Constants are hex
// literals equal bit for bit to the numpy float32 constants of the port
// (checked by tests/test_torch_fused.py and tests/test_torch_icing.py).

#ifndef MF_COMMON_CUH_
#define MF_COMMON_CUH_

#include <cuda_runtime.h>
#include <stdint.h>

// float32 constants (constants.py / _libm.py of the port)
static constexpr float kT0 = 0x1.112666p+8f;       // 273.15
static constexpr float kCp = 1004.0f;
static constexpr float kEps = 0x1.3e76c8p-1f;      // 0.622
static constexpr float kXlh = 2501000.0f;
static constexpr float kP0inv = 0x1.0624dep-10f;   // 1/1000
static constexpr float kRhmin = 0x1.47ae14p-6f;    // 0.02
static constexpr float kRhmax = 1.0f;
static constexpr float kEwtScale = 0x1.99999ap-3f;  // 0.2
static constexpr float kCent = 0x1.47ae14p-7f;      // 0.01
static constexpr float kDuct1 = 0x1.366666p+6f;     // 77.6
static constexpr float kDuct2 = 373000.0f;
static constexpr float kUndef = 0x1.342618p+116f;   // 1e35
static constexpr float kAdvScale = -3600.0f;        // -3600 * 1 hour

// pow_posc_f32(x, kappa): range constants and the exact split of kappa
static constexpr float kMinNormal = 0x1p-126f;
static constexpr float kSqrtHalf = 0x1.6a09e6p-1f;
static constexpr float kLn2 = 0x1.62e43p-1f;
static constexpr float kKappaHi = 0x1.24cp-2f;
static constexpr float kKappaLo = -0x1.0d4p-15f;
static constexpr float kKappaL2e = 0x1.a64d32p-2f;
// log_f32: the Cephes split of ln2
static constexpr float kLn2Hi = 0x1.63p-1f;         // 0.693359375
static constexpr float kLn2Lo = -0x1.bd0106p-13f;   // -2.12194440e-4

static constexpr int kNEwt = 41;

// e_w(T) for T = -100, -95, ..., +100 degC (MetConstants.h:56-59)
static __constant__ float c_ewt[kNEwt] = {
    0x1.1d3672p-15f, 0x1.754b06p-14f, 0x1.cd5f9ap-13f, 0x1.0f0e9p-11f,
    0x1.2ec6bcp-10f, 0x1.44028ep-9f, 0x1.4cec42p-8f, 0x1.495182p-7f,
    0x1.3abc94p-6f, 0x1.230fdp-5f, 0x1.04577ep-4f, 0x1.c710ccp-4f,
    0x1.8346dcp-3f, 0x1.416fp-2f, 0x1.04817p-1f, 0x1.9d2f1ap-1f,
    0x1.410624p+0f, 0x1.e96bbap+0f, 0x1.6e6cf4p+1f, 0x1.0dbf48p+2f,
    0x1.86e632p+2f, 0x1.1703bp+3f, 0x1.88b43ap+3f, 0x1.10b43ap+4f,
    0x1.75f7cep+4f, 0x1.fabc6ap+4f, 0x1.5370a4p+5f, 0x1.c1e354p+5f,
    0x1.271ba6p+6f, 0x1.7f6b86p+6f, 0x1.ed999ap+6f, 0x1.3aeb86p+7f,
    0x1.8e851ep+7f, 0x1.f451ecp+7f, 0x1.37b0a4p+8f, 0x1.818f5cp+8f,
    0x1.d9ab86p+8f, 0x1.210b86p+9f, 0x1.5e90a4p+9f, 0x1.a6a3d8p+9f,
    0x1.faap+9f};

// clip that propagates NaN, like jnp.clip and torch.clamp
static __device__ __forceinline__ float clip_nan(float v, float lo,
                                                 float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// _libm.pow_posc_f32(x, kappa), literally
static __device__ __forceinline__ float pow_kappa(float x) {
  x = x != x ? x : fmaxf(x, kMinNormal);   // jnp.maximum keeps NaN
  const int xi = __float_as_int(x);
  int e = ((xi >> 23) & 0xFF) - 126;
  float m = __int_as_float((xi & 0x007FFFFF) | (126 << 23));
  const bool big = m > kSqrtHalf;
  m = big ? m : m * 2.0f;
  e = big ? e : e - 1;
  const float z = m - 1.0f;
  float p = 0x1.204376p-4f;                // Cephes logf, degree 8
  p = p * z + -0x1.d7a37p-4f;
  p = p * z + 0x1.de4a34p-4f;
  p = p * z + -0x1.fcba9ep-4f;
  p = p * z + 0x1.23d37ep-3f;
  p = p * z + -0x1.555cap-3f;
  p = p * z + 0x1.999d58p-3f;
  p = p * z + -0x1.fffff8p-3f;
  p = p * z + 0x1.555554p-2f;
  const float zz = z * z;
  const float lnm = z + (z * zz * p - zz * 0.5f);
  const float ef = static_cast<float>(e);
  const float th = kKappaHi * ef;
  const float r = kKappaLo * ef + kKappaL2e * lnm;
  const float t = th + r;
  const float n = floorf(t + 0.5f);
  const float f = (th - n) + r;
  const float w = f * kLn2;
  float qq = 0x1.a0d2cep-13f;               // Cephes exp polynomial
  qq = qq * w + 0x1.6e879cp-10f;
  qq = qq * w + 0x1.11121p-7f;
  qq = qq * w + 0x1.555382p-5f;
  qq = qq * w + 0x1.555554p-3f;
  qq = qq * w + 0x1p-1f;
  const float e2 = w * w * qq + w + 1.0f;
  const int ni = static_cast<int>(fminf(fmaxf(n, -126.0f), 127.0f));
  return e2 * __int_as_float((ni + 127) << 23);
}

// constants.pidcp_from_p: (p/p0)**kappa with the reference powf edges as
// literals (p == 0 gives 0; p < 0 and NaN give NaN).
static __device__ __forceinline__ float pidcp_edge(float p) {
  const float x = p * kP0inv;
  if (x > 0.0f) return pow_kappa(x);
  return x == 0.0f ? 0.0f : __int_as_float(0x7fc00000);
}

// _libm.log_f32, literally: the Cephes logf polynomial on the mantissa,
// e*ln2 re-added in two parts, libm's edges.  Subnormal positives take
// logf, as the JAX function takes the backend log there.
static __device__ __forceinline__ float log_f32(float x) {
  const int xi = __float_as_int(x);
  int e = ((xi >> 23) & 0xFF) - 126;
  float m = __int_as_float((xi & 0x007FFFFF) | (126 << 23));
  const bool big = m > kSqrtHalf;
  m = big ? m : m * 2.0f;
  e = big ? e : e - 1;
  const float ef = static_cast<float>(e);
  const float z = m - 1.0f;
  float p = 0x1.204376p-4f;
  p = p * z + -0x1.d7a37p-4f;
  p = p * z + 0x1.de4a34p-4f;
  p = p * z + -0x1.fcba9ep-4f;
  p = p * z + 0x1.23d37ep-3f;
  p = p * z + -0x1.555cap-3f;
  p = p * z + 0x1.999d58p-3f;
  p = p * z + -0x1.fffff8p-3f;
  p = p * z + 0x1.555554p-2f;
  const float zz = z * z;
  float r = z + (z * zz * p - zz * 0.5f);
  r = r + ef * kLn2Lo;
  r = r + ef * kLn2Hi;
  const float inf = __int_as_float(0x7f800000);
  if (!(x > 0.0f)) {                       // 0 -> -inf; < 0 and NaN -> NaN
    return x == 0.0f ? -inf : __int_as_float(0x7fc00000);
  }
  if (x < kMinNormal) return logf(x);
  return x == inf ? x : r;
}

// NaN-propagating maximum and minimum with torch.maximum / torch.minimum's
// operand order (jnp.maximum / jnp.minimum propagate NaN too; fmaxf and
// fminf drop it).
static __device__ __forceinline__ float max_nan(float a, float b) {
  return a != a ? a : (b != b ? b : (a < b ? b : a));
}
static __device__ __forceinline__ float min_nan(float a, float b) {
  return a != a ? a : (b != b ? b : (b < a ? b : a));
}

// _libm.exp_f32, literally: clip to [-104, 89.5], reduce by ln2 in two
// parts, the Cephes degree-5 polynomial, and 2^n as two bitcast factors.
// The split n1 = n >> 1 is the floor division of JAX's n // 2 (C's '/'
// truncates, which differs for odd negative n); a NaN z converts to 0.
static constexpr float kLog2e = 0x1.715476p+0f;     // 1.44269504088896341
static __device__ __forceinline__ float exp_f32(float x) {
  x = clip_nan(x, -104.0f, 89.5f);
  const float z = floorf(kLog2e * x + 0.5f);
  float r = x - z * kLn2Hi;
  r = r - z * kLn2Lo;
  float p = 0x1.a0d2cep-13f;
  p = p * r + 0x1.6e879cp-10f;
  p = p * r + 0x1.11121p-7f;
  p = p * r + 0x1.555382p-5f;
  p = p * r + 0x1.555554p-3f;
  p = p * r + 0x1p-1f;
  const float e = r * r * p + r + 1.0f;
  const float zc = z != z ? 0.0f : fminf(fmaxf(z, -252.0f), 254.0f);
  const int n = static_cast<int>(zc);
  const int n1 = n >> 1;
  const int n2 = n - n1;
  return (e * __int_as_float((n1 + 127) << 23)) *
         __int_as_float((n2 + 127) << 23);
}

// _libm.tanh_f32, literally: the odd polynomial below 0.625, else
// 1 - 2/(exp_f32(2|x|) + 1) with the sign restored, and sign(x) beyond 9.
static __device__ __forceinline__ float tanh_f32(float x) {
  const float ax = fabsf(x);
  const float z2 = x * x;
  float p = -0x1.75e1d4p-8f;
  p = p * z2 + 0x1.52269cp-6f;
  p = p * z2 + -0x1.b83c5ap-5f;
  p = p * z2 + 0x1.110726p-3f;
  p = p * z2 + -0x1.555532p-2f;
  const float small = z2 * x * p + x;
  float big = 1.0f - 2.0f / (exp_f32(2.0f * ax) + 1.0f);
  big = x < 0.0f ? -big : big;
  const float out = ax < 0.625f ? small : big;
  return ax > 9.0f ? copysignf(1.0f, x) : out;
}

// Table coordinate and saturation vapour pressure (esat_table).
static __device__ __forceinline__ float esat(float tk, bool* ok,
                                             int* l_out) {
  const float x = (tk - kT0 + 100.0f) * kEwtScale;
  float lf = truncf(x);
  lf = lf != lf ? 0.0f : fminf(fmaxf(lf, -1.0f), 40.0f);
  const int l = static_cast<int>(lf);
  const int ls = min(max(l, 0), kNEwt - 2);
  const float e0 = c_ewt[ls];
  const float e1 = c_ewt[ls + 1];
  *ok = l >= 0 && l < kNEwt - 1;
  *l_out = l;
  return e0 + (e1 - e0) * (x - static_cast<float>(ls));
}

// Monotone-table inverse: a count over all 41 entries, clipped to
// [0, clip(l, 0, 39)] (NaN counts 0).
static __device__ __forceinline__ float ewt_inverse(float et, int l) {
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < kNEwt; ++k) cnt += et >= c_ewt[k] ? 1 : 0;
  const int ll = min(max(cnt - 1, 0), min(max(l, 0), kNEwt - 2));
  const float e0 = c_ewt[ll];
  const float e1 = c_ewt[ll + 1];
  const float rr = (et - e0) / (e1 - e0);
  return -100.0f + (static_cast<float>(ll) + rr) * 5.0f;
}

// ---- the table in shared memory (the level suites) ----------------------
// A copy of c_ewt padded with NaN to kEwtPad entries: per-thread lookups at
// divergent indices go to shared memory (at most 2-way bank conflicts)
// instead of the constant cache, which serves one address per cycle.

static constexpr int kEwtPad = 64;

// Fills tab[kEwtPad]: a block-stride loop; the caller then synchronises.
static __device__ __forceinline__ void ewt_to_shared(float* tab) {
  for (int k = threadIdx.x; k < kEwtPad; k += blockDim.x) {
    tab[k] = k < kNEwt ? c_ewt[k] : __int_as_float(0x7fc00000);
  }
}

// The count of entries <= et (ewt_inverse's), by a 6-step search.  The
// table is strictly increasing and its NaN padding compares false, so
// "et >= tab[k]" holds on a prefix of the 64 entries and the steps 32 .. 1
// add up its length: NaN counts 0, +inf counts 41.
static __device__ __forceinline__ int ewt_count(const float* tab, float et) {
  int pos = 0;
#pragma unroll
  for (int step = kEwtPad / 2; step >= 1; step >>= 1) {
    pos = et >= tab[pos + step - 1] ? pos + step : pos;
  }
  return pos;
}

// esat and ewt_inverse above, reading the table from tab.
static __device__ __forceinline__ float esat_tab(const float* tab, float tk,
                                                 bool* ok, int* l_out) {
  const float x = (tk - kT0 + 100.0f) * kEwtScale;
  float lf = truncf(x);
  lf = lf != lf ? 0.0f : fminf(fmaxf(lf, -1.0f), 40.0f);
  const int l = static_cast<int>(lf);
  const int ls = min(max(l, 0), kNEwt - 2);
  const float e0 = tab[ls];
  const float e1 = tab[ls + 1];
  *ok = l >= 0 && l < kNEwt - 1;
  *l_out = l;
  return e0 + (e1 - e0) * (x - static_cast<float>(ls));
}

static __device__ __forceinline__ float ewt_inverse_tab(const float* tab,
                                                        float et, int l) {
  const int cnt = ewt_count(tab, et);
  const int ll = min(max(cnt - 1, 0), min(max(l, 0), kNEwt - 2));
  const float e0 = tab[ll];
  const float e1 = tab[ll + 1];
  const float rr = (et - e0) / (e1 - e0);
  return -100.0f + (static_cast<float>(ll) + rr) * 5.0f;
}

// ---- the block's dynamic shared memory ------------------------------------
// (the launch's third argument, 16-byte aligned); tests/cuda_host.py's host
// build defines its own.
#ifndef MF_HOST_SHIM
template <class T>
static __device__ __forceinline__ T* dynamic_shared() {
  extern __shared__ __align__(16) unsigned char mf_dynamic_smem[];
  return reinterpret_cast<T*>(mf_dynamic_smem);
}
#endif

#endif  // MF_COMMON_CUH_
