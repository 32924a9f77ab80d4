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
// Numerics: built with -fmad=false and without --use_fast_math (see
// common.cuh, which holds the constants, the EWT table, the deterministic
// pow and the table lookups this kernel shares with the others).

#include "common.cuh"

namespace {

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
