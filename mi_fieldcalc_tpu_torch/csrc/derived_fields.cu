// The 12-output derived-field pipeline in one CUDA kernel, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel mi_fieldcalc_tpu/ops/fused.py:_kernel
// (entry derived_fields_fused, fused.py:680; pallas_call at fused.py:955).
// It computes, in one pass, the 12 outputs of
// mi_fieldcalc_tpu_torch.models.pipeline.derived_fields in the stacked
// layout: values f32[12, nlev, ny, nx] in DerivedFields order
// (p th rh td the duc ws vo dv ad gt tf) and either the 9 deduplicated
// mask planes (p th rh the ws vo ad gt tf) or, on the all-defined fast
// path, the 2 data-dependent gates (the humidity table gate and TFP's
// |grad T| != 0), as 0/1 bytes.
//
// What bounds it: device-memory bytes.  Per point the work is a few dozen
// flops, a table lookup and a 41-step compare loop, against 4 f32 + 4 mask
// bytes read and 12 f32 + 9 mask bytes written; the JAX design notes
// (fused.py:1-11) find the same trivial arithmetic intensity on the TPU.
//
// Design (the first, simple version): one thread per (lev, y, x), x
// fastest, 32x8 blocks, gridDim.z = nlev.  Neighbours are read straight
// from global memory through the read-only path, so each input byte moves
// from device memory about once and L1/L2 absorb the halo reuse.  There
// are no shared-memory tiles yet.
//
// fillEdges (copy column 1 -> 0 and nx-2 -> nx-1, then row 1 -> 0 and
// ny-2 -> ny-1) equals evaluating the raw stencil at the clamped point
// (clamp(y, 1, ny-2), clamp(x, 1, nx-2)), whose neighbours always lie in
// range.  TFP reads the *filled* |grad T| at its 4 neighbours; each is
// recomputed here at its own clamped point, so one kernel does one pass.
//
// Numerics: build with -fmad=false and without --use_fast_math.  No
// multiply-add is contracted, '/' and sqrtf stay IEEE, and the
// deterministic pow below gives the bits of the JAX package's
// _libm.pow_posc_f32.  The table coordinate's float-to-int conversion
// follows XLA's (truncate, saturate, NaN -> 0) through a clamp to
// [-1, 40] in float before the cast.  Constants are hex literals equal bit
// for bit to the numpy float32 constants of the port (checked by
// tests/test_torch_fused.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// float32 constants (constants.py / _libm.py of the port)
constexpr float kT0 = 0x1.112666p+8f;       // 273.15
constexpr float kCp = 1004.0f;
constexpr float kEps = 0x1.3e76c8p-1f;      // 0.622
constexpr float kXlh = 2501000.0f;
constexpr float kP0inv = 0x1.0624dep-10f;   // 1/1000
constexpr float kRhmin = 0x1.47ae14p-6f;    // 0.02
constexpr float kRhmax = 1.0f;
constexpr float kEwtScale = 0x1.99999ap-3f;  // 0.2
constexpr float kDuct1 = 0x1.366666p+6f;     // 77.6
constexpr float kDuct2 = 373000.0f;
constexpr float kUndef = 0x1.342618p+116f;   // 1e35
constexpr float kAdvScale = -3600.0f;        // -3600 * 1 hour

// pow_posc_f32(x, kappa): range constants and the exact split of kappa
constexpr float kMinNormal = 0x1p-126f;
constexpr float kSqrtHalf = 0x1.6a09e6p-1f;
constexpr float kLn2 = 0x1.62e43p-1f;
constexpr float kKappaHi = 0x1.24cp-2f;
constexpr float kKappaLo = -0x1.0d4p-15f;
constexpr float kKappaL2e = 0x1.a64d32p-2f;

constexpr int kNEwt = 41;

// e_w(T) for T = -100, -95, ..., +100 degC (MetConstants.h:56-59)
__constant__ float c_ewt[kNEwt] = {
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

struct Params {
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
  const float* __restrict__ alevel;
  const float* __restrict__ blevel;
  const float* __restrict__ xmapr;
  const float* __restrict__ ymapr;
  float* __restrict__ out_values;
  uint8_t* __restrict__ out_masks;
  int nlev, ny, nx;
};

// clip that propagates NaN, like jnp.clip and torch.clamp
__device__ __forceinline__ float clip_nan(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// _libm.pow_posc_f32(x, kappa), literally
__device__ __forceinline__ float pow_kappa(float x) {
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

// Table coordinate and saturation vapour pressure (esat_table).
__device__ __forceinline__ float esat(float tk, bool* ok, int* l_out) {
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
__device__ __forceinline__ float ewt_inverse(float et, int l) {
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < kNEwt; ++k) cnt += et >= c_ewt[k] ? 1 : 0;
  const int ll = min(max(cnt - 1, 0), min(max(l, 0), kNEwt - 2));
  const float e0 = c_ewt[ll];
  const float e1 = c_ewt[ll + 1];
  const float rr = (et - e0) / (e1 - e0);
  return -100.0f + (static_cast<float>(ll) + rr) * 5.0f;
}

// Raw |grad T| at an interior point r = yy*nx + xx of level `lev0`.
__device__ __forceinline__ float grad_abs(const Params& P, int64_t lev0,
                                          int64_t r) {
  const float* t = P.tk + lev0;
  const float dfdx = 0.5f * __ldg(P.xmapr + r) *
                     (__ldg(t + r + 1) - __ldg(t + r - 1));
  const float dfdy = 0.5f * __ldg(P.ymapr + r) *
                     (__ldg(t + r + P.nx) - __ldg(t + r - P.nx));
  return sqrtf(dfdx * dfdx + dfdy * dfdy);
}

// tk defined at the 4 neighbours of interior point r (gradient's mask).
__device__ __forceinline__ bool ring4(const uint8_t* m, int64_t r, int nx) {
  return __ldg(m + r - 1) && __ldg(m + r + 1) && __ldg(m + r - nx) &&
         __ldg(m + r + nx);
}

template <bool kAllDefined>
__global__ void __launch_bounds__(256)
derived_fields_kernel(const Params P) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int lev = blockIdx.z;
  const int nx = P.nx, ny = P.ny;
  if (x >= nx || y >= ny) return;

  const int64_t plane2 = static_cast<int64_t>(ny) * nx;
  const int64_t n3 = plane2 * P.nlev;           // one output plane
  const int64_t lev0 = plane2 * lev;
  const int64_t i2 = static_cast<int64_t>(y) * nx + x;
  const int64_t i = lev0 + i2;
  float* ov = P.out_values + i;
  uint8_t* om = P.out_masks + i;

  // ---- elementwise family (levels.py formulas) -------------------------
  const float tkv = __ldg(P.tk + i);
  const float qv = __ldg(P.q + i);
  const float uv = __ldg(P.u + i);
  const float vv = __ldg(P.v + i);
  const float p_raw = __ldg(P.alevel + lev) +
                      __ldg(P.blevel + lev) * __ldg(P.ps + i2);
  const float pidcp = pow_kappa(p_raw * kP0inv);
  bool psm = true, tkm = true, qm = true, um = true, vm = true;
  if (!kAllDefined) {
    psm = __ldg(P.psm + i2);
    tkm = __ldg(P.tkm + i);
    qm = __ldg(P.qm + i);
    um = __ldg(P.um + i);
    vm = __ldg(P.vm + i);
  }
  // alevelhum quirk: an undefined ps lets the sentinel into qsat
  const float p_sent = psm ? p_raw : kUndef;
  bool ok;
  int l;
  const float et = esat(tkv, &ok, &l);
  const float qsat = kEps * et / p_sent;
  const float rhc = clip_nan(qv / qsat, kRhmin, kRhmax);

  ov[0 * n3] = p_raw;
  ov[1 * n3] = tkv / pidcp;
  ov[2 * n3] = 100.0f * qv / qsat;
  ov[3 * n3] = ewt_inverse(rhc * et, l) + kT0;
  ov[4 * n3] = (tkv * kCp + qv * kXlh) / (kCp * pidcp);
  ov[5 * n3] = kDuct1 * (p_raw / tkv) +
               kDuct2 * (qv * p_raw) / (kEps * tkv * tkv);
  ov[6 * n3] = sqrtf(uv * uv + vv * vv);

  // ---- radius-1 stencils at the clamped point (fillEdges) --------------
  const int cy = min(max(y, 1), ny - 2);
  const int cx = min(max(x, 1), nx - 2);
  const int64_t r = static_cast<int64_t>(cy) * nx + cx;
  const int64_t c = lev0 + r;
  const float xm = __ldg(P.xmapr + r);
  const float ym = __ldg(P.ymapr + r);
  const float dtx = __ldg(P.tk + c + 1) - __ldg(P.tk + c - 1);
  const float dty = __ldg(P.tk + c + nx) - __ldg(P.tk + c - nx);

  ov[7 * n3] = 0.5f * xm * (__ldg(P.v + c + 1) - __ldg(P.v + c - 1)) -
               0.5f * ym * (__ldg(P.u + c + nx) - __ldg(P.u + c - nx));
  ov[8 * n3] = 0.5f * xm * (__ldg(P.u + c + 1) - __ldg(P.u + c - 1)) +
               0.5f * ym * (__ldg(P.v + c + nx) - __ldg(P.v + c - nx));
  ov[9 * n3] = (__ldg(P.u + c) * 0.5f * xm * dtx +
                __ldg(P.v + c) * 0.5f * ym * dty) * kAdvScale;

  // ---- |grad T| (filled) and TFP ----------------------------------------
  const float a_c = grad_abs(P, lev0, r);
  ov[10 * n3] = a_c;
  // filled |grad T| at the 4 neighbours = raw at their clamped points
  const int64_t rxm = static_cast<int64_t>(cy) * nx + max(cx - 1, 1);
  const int64_t rxp = static_cast<int64_t>(cy) * nx + min(cx + 1, nx - 2);
  const int64_t rym = static_cast<int64_t>(max(cy - 1, 1)) * nx + cx;
  const int64_t ryp = static_cast<int64_t>(min(cy + 1, ny - 2)) * nx + cx;
  const float dadx = 0.5f * xm * (grad_abs(P, lev0, rxp) -
                                  grad_abs(P, lev0, rxm));
  const float dady = 0.5f * ym * (grad_abs(P, lev0, ryp) -
                                  grad_abs(P, lev0, rym));
  const bool nonzero = a_c != 0.0f;
  const float ainv = 1.0f / (nonzero ? a_c : 1.0f);
  const float dtdxa = 0.5f * xm * dtx * ainv;
  const float dtdya = 0.5f * ym * dty * ainv;
  ov[11 * n3] = -(dadx * dtdxa + dady * dtdya);

  if (kAllDefined) {
    om[0] = ok;
    om[n3] = nonzero;
    return;
  }
  const uint8_t* tkm_l = P.tkm + lev0;
  const uint8_t* um_l = P.um + lev0;
  const uint8_t* vm_l = P.vm + lev0;
  const bool vort_m = __ldg(vm_l + r - 1) && __ldg(vm_l + r + 1) &&
                      __ldg(um_l + r - nx) && __ldg(um_l + r + nx);
  const bool gt_m = ring4(tkm_l, r, nx);
  om[0 * n3] = psm;
  om[1 * n3] = tkm && psm;
  om[2 * n3] = tkm && qm && ok;
  om[3 * n3] = tkm && qm && psm;
  om[4 * n3] = um && vm;
  om[5 * n3] = vort_m;   // also divergence's mask (reference quirk)
  om[6 * n3] = __ldg(um_l + r) && __ldg(vm_l + r) && gt_m;
  om[7 * n3] = gt_m;
  om[8 * n3] = gt_m && nonzero && ring4(tkm_l, rxm, nx) &&
               ring4(tkm_l, rxp, nx) && ring4(tkm_l, rym, nx) &&
               ring4(tkm_l, ryp, nx);
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns cudaGetLastError() as an int.
// Mask pointers may be null when all_defined != 0 (they are not read).
// out_masks holds 2 planes when all_defined != 0, else 9.
int mf_derived_fields(const float* tk, const float* q, const float* u,
                      const float* v, const uint8_t* tkm, const uint8_t* qm,
                      const uint8_t* um, const uint8_t* vm, const float* ps,
                      const uint8_t* psm, const float* alevel,
                      const float* blevel, const float* xmapr,
                      const float* ymapr, float* out_values,
                      uint8_t* out_masks, int nlev, int ny, int nx,
                      int all_defined, void* stream) {
  if (nlev < 1 || nlev > 65535 || ny < 3 || nx < 3 ||
      (ny + 7) / 8 > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params P{tk, q, u, v, tkm, qm, um, vm, ps, psm, alevel, blevel,
                 xmapr, ymapr, out_values, out_masks, nlev, ny, nx};
  const dim3 block(32, 8);
  const dim3 grid((nx + 31) / 32, (ny + 7) / 8, nlev);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (all_defined) {
    derived_fields_kernel<true><<<grid, block, 0, s>>>(P);
  } else {
    derived_fields_kernel<false><<<grid, block, 0, s>>>(P);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* mf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
