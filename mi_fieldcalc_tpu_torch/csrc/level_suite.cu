// The level-conversion suites in one CUDA kernel each, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels of mi_fieldcalc_tpu/ops/fused_suite.py:
// - _suite_kernel (entry alevel_suite_fused, fused_suite.py:273;
//   pallas_call at :360 and :365): any set of aleveltemp / alevelhum /
//   alevelthe / alevelducting modes over t, q, rh and a pressure FIELD p;
// - _hsuite_kernel (entry hlevel_suite_fused, :429; pallas_call at :528):
//   the same suite on hybrid levels, p = a[k] + b[k] * ps rebuilt per
//   level and never stored, with the hlevel gates.
// One template, with the pressure source as its parameter, gives both
// __global__ entries; mf_alevel_suite and mf_hlevel_suite launch them.
//
// Semantics per mode are ops/levels.py's (the port's, and the JAX
// package's), written out in the same operation order:
// - alevel: an undefined p flows into the humidity modes as the sentinel
//   1e35 (alevelhum's quirk); modes 7/11 need a defined p, the others do
//   not.  Every other family is gated by p's mask, so p is replaced by
//   the sentinel once per point where it is undefined: the outputs that
//   read it there are masked out.
// - hlevel: ps must be defined except for the pressure-independent
//   humidity modes 7/11 (hlevelhum's inverted gate).
// - Each saturation spelling is evaluated at most once per point, as the
//   JAX package's esat_memo intends: T-form esat(t), TH-form
//   esat(t * pidcp(p)) and temp 5's TH5-form esat(t * (pidcp*cp) / cp).
//   Their table gates are the 3 gate planes of the all-defined path.
//
// What bounds it: device-memory bytes.  Per point it reads up to 4 f32
// inputs and their mask bytes and writes nout f32 values and nout (or at
// most 3) mask bytes; the arithmetic is a few dozen flops, up to 3 table
// lookups, one deterministic pow and a 41-step compare loop per dewpoint.
//
// Design (the first, simple version): one thread per (level, y, x) point
// over the flattened stack, 256-thread blocks.  The request list is a
// fixed-capacity array in the kernel's parameters, identical for every
// thread, so the loop over it never diverges.  Coalesced reads and writes;
// no shared memory.

#include "common.cuh"

namespace {

constexpr int kMaxReq = 32;

// request families, in the order of ops/fused_suite.py's _VALID
enum Family { kTemp = 0, kHumQ, kHumRh, kThe, kDuctQ, kDuctRh };
// gate kinds (ops/fused_suite.py _gate_kind): the T-form, TH-form and
// temp 5's TH5-form table gates, as indices of gate_plane
enum Gate { kGateT = 0, kGateTH = 1, kGateTH5 = 2 };

struct SuiteParams {
  const float* __restrict__ t;
  const float* __restrict__ q;
  const float* __restrict__ rh;
  const float* __restrict__ p;        // alevel: the pressure field
  const uint8_t* __restrict__ tm;
  const uint8_t* __restrict__ qm;
  const uint8_t* __restrict__ rhm;
  const uint8_t* __restrict__ pm;     // alevel: p's mask; hlevel: ps's
  const float* __restrict__ ps;       // hlevel
  const float* __restrict__ alevel;   // hlevel
  const float* __restrict__ blevel;   // hlevel
  float* __restrict__ out_values;
  uint8_t* __restrict__ out_masks;
  int64_t plane, n3;
  int nreq;
  int8_t fam[kMaxReq];
  int8_t comp[kMaxReq];
  int gate_plane[3];                  // all-defined: plane per gate kind
  bool need_t, need_th, need_th5, need_pid;
};

inline bool valid_mode(int fam, int c) {
  switch (fam) {
    case kTemp: return c >= 1 && c <= 5;
    case kHumQ: return c == 1 || c == 2 || c == 5 || c == 6 || c == 9 ||
                       c == 10;
    case kHumRh: return c == 3 || c == 4 || c == 7 || c == 8 || c == 11 ||
                        c == 12;
    case kThe: return c == 1 || c == 2;
    case kDuctQ: return c == 1 || c == 2;
    case kDuctRh: return c == 3 || c == 4;
    default: return false;
  }
}

template <bool kHybrid, bool kAllDefined>
__global__ void __launch_bounds__(256)
suite_kernel(const SuiteParams P) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= P.n3) return;

  // ---- pressure and its gate -----------------------------------------
  float p;
  bool pm = true;
  if (kHybrid) {
    const int lev = static_cast<int>(i / P.plane);
    const int64_t i2 = i - static_cast<int64_t>(lev) * P.plane;
    p = __ldg(P.alevel + lev) + __ldg(P.blevel + lev) * __ldg(P.ps + i2);
    if (!kAllDefined) pm = __ldg(P.pm + i2) != 0;
  } else {
    p = __ldg(P.p + i);
    if (!kAllDefined) pm = __ldg(P.pm + i) != 0;
    if (!pm) p = kUndef;        // alevelhum: the sentinel flows in
  }
  const float t = __ldg(P.t + i);
  const float q = P.q ? __ldg(P.q + i) : 0.0f;
  const float rh = P.rh ? __ldg(P.rh + i) : 0.0f;
  bool tm = true, qm = true, rhm = true;
  if (!kAllDefined) {
    tm = __ldg(P.tm + i) != 0;
    qm = P.qm ? __ldg(P.qm + i) != 0 : false;
    rhm = P.rhm ? __ldg(P.rhm + i) != 0 : false;
  }

  // ---- shared quantities, each at most once ----------------------------
  const float pid = P.need_pid ? pidcp_edge(p) : 0.0f;
  float et_t = 0.0f, et_th = 0.0f, et_5 = 0.0f;
  bool ok_t = false, ok_th = false, ok_5 = false;
  int l_t = 0, l_th = 0, l5 = 0;
  const float tk_th = t * pid;
  const float pi5 = pid * kCp;
  if (P.need_t) et_t = esat(t, &ok_t, &l_t);
  if (P.need_th) et_th = esat(tk_th, &ok_th, &l_th);
  if (P.need_th5) et_5 = esat(t * pi5 / kCp, &ok_5, &l5);

  // ---- the requests ------------------------------------------------------
  for (int r = 0; r < P.nreq; ++r) {
    const int fam = P.fam[r];
    const int c = P.comp[r];
    const bool odd = (c % 2) == 1;
    const float h = (fam == kHumRh || fam == kDuctRh) ? rh : q;
    const bool hm = (fam == kHumRh || fam == kDuctRh) ? rhm : qm;
    const float tk = odd ? t : tk_th;
    const float et = odd ? et_t : et_th;
    const int l = odd ? l_t : l_th;
    float v = 0.0f;
    bool m = false;
    switch (fam) {
      case kTemp:
        m = tm && pm;
        if (c == 1) {
          v = t * pid - kT0;
        } else if (c == 2) {
          v = t * pid;
        } else if (c == 3) {
          v = t / pid;
        } else if (c == 4) {
          const float qsat = kEps * et_t / p;
          v = (kCp * t + kXlh * qsat) / pi5;
          m = m && ok_t;
        } else {
          const float qsat = kEps * et_5 / p;
          v = t + kXlh * qsat / pi5;
          m = m && ok_5;
        }
        break;
      case kHumQ:
      case kHumRh: {
        const bool p_free = c == 7 || c == 11;
        // alevel: only 7/11 need p; hlevel: all but 7/11 need ps
        const bool gate_p = kHybrid ? !p_free : p_free;
        m = tm && hm && (gate_p ? pm : true) && (odd ? ok_t : ok_th);
        const float tdconv = c >= 9 ? kT0 : 0.0f;
        if (c == 1 || c == 2) {
          const float qsat = kEps * et / p;
          v = 100.0f * h / qsat;
        } else if (c == 3 || c == 4) {
          const float qsat = kEps * et / p;
          v = kCent * h * qsat;
        } else if (c == 5 || c == 6 || c == 9 || c == 10) {
          const float qsat = kEps * et / p;
          const float rhc = clip_nan(h / qsat, kRhmin, kRhmax);
          v = ewt_inverse(rhc * et, l) + tdconv;
        } else {
          const float rhc = clip_nan(kCent * h, kRhmin, kRhmax);
          v = ewt_inverse(rhc * et, l) + tdconv;
        }
        break;
      }
      case kThe: {
        m = tm && qm && pm;
        const float pi = kCp * pid;
        v = c == 1 ? (t * kCp + q * kXlh) / pi : t + q * kXlh / pi;
        break;
      }
      default: {                  // kDuctQ, kDuctRh
        m = tm && hm && pm;
        if (fam == kDuctQ) {
          v = kDuct1 * (p / tk) + kDuct2 * (h * p) / (kEps * tk * tk);
        } else {
          const float rhc = clip_nan(h * kCent, kRhmin, kRhmax);
          v = kDuct1 * (p / tk) + kDuct2 * rhc * et / (tk * tk);
          m = m && (odd ? ok_t : ok_th);
        }
        break;
      }
    }
    P.out_values[r * P.n3 + i] = v;
    if (!kAllDefined) P.out_masks[r * P.n3 + i] = m ? 1 : 0;
  }
  if (kAllDefined) {
    if (P.gate_plane[kGateT] >= 0) {
      P.out_masks[P.gate_plane[kGateT] * P.n3 + i] = ok_t ? 1 : 0;
    }
    if (P.gate_plane[kGateTH] >= 0) {
      P.out_masks[P.gate_plane[kGateTH] * P.n3 + i] = ok_th ? 1 : 0;
    }
    if (P.gate_plane[kGateTH5] >= 0) {
      P.out_masks[P.gate_plane[kGateTH5] * P.n3 + i] = ok_5 ? 1 : 0;
    }
  }
}

// Fills the request part of P from reqs = (family, compute) pairs and
// gate_planes[3]; returns false on an invalid request list.
bool set_requests(SuiteParams* P, const int* reqs, int nreq,
                  const int* gate_planes, bool all_defined) {
  if (nreq < 1 || nreq > kMaxReq) return false;
  P->nreq = nreq;
  P->need_t = P->need_th = P->need_th5 = P->need_pid = false;
  for (int r = 0; r < nreq; ++r) {
    const int fam = reqs[2 * r], c = reqs[2 * r + 1];
    if (!valid_mode(fam, c)) return false;
    P->fam[r] = static_cast<int8_t>(fam);
    P->comp[r] = static_cast<int8_t>(c);
    const bool odd = (c % 2) == 1;
    // which shared quantities the request reads (see suite_kernel)
    if (fam == kTemp) {
      P->need_pid = true;
      P->need_t = P->need_t || c == 4;
      P->need_th5 = P->need_th5 || c == 5;
    } else if (fam == kThe) {
      P->need_pid = true;
    } else if (fam == kHumQ || fam == kHumRh) {
      P->need_t = P->need_t || odd;
      P->need_th = P->need_th || !odd;
      P->need_pid = P->need_pid || !odd;
    } else {
      P->need_t = P->need_t || c == 3;
      P->need_th = P->need_th || c == 4;
      P->need_pid = P->need_pid || !odd;
    }
  }
  for (int k = 0; k < 3; ++k) {
    P->gate_plane[k] = all_defined ? gate_planes[k] : -1;
  }
  return true;
}

int launch(const SuiteParams& P, bool hybrid, bool all_defined,
           void* stream) {
  const int block = 256;
  const int64_t grid = (P.n3 + block - 1) / block;
  if (grid > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 g(static_cast<unsigned>(grid));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hybrid) {
    if (all_defined) {
      suite_kernel<true, true><<<g, block, 0, s>>>(P);
    } else {
      suite_kernel<true, false><<<g, block, 0, s>>>(P);
    }
  } else if (all_defined) {
    suite_kernel<false, true><<<g, block, 0, s>>>(P);
  } else {
    suite_kernel<false, false><<<g, block, 0, s>>>(P);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (cudaErrorInvalidValue
// for a bad request list or grid).  reqs holds nreq (family, compute)
// pairs, family in _VALID's order (temp, hum_q, hum_rh, the, duct_q,
// duct_rh); gate_planes[3] gives the all-defined path's plane of the T,
// TH and TH5 gates (-1: not written).  out_values is [nreq, nlev, ny, nx];
// out_masks is [nreq, nlev, ny, nx], or the gate planes when
// all_defined != 0.  q / rh (and their masks) may be null when no request
// reads them; masks may be null when all_defined != 0.

int mf_alevel_suite(const float* t, const float* q, const float* rh,
                    const float* p, const uint8_t* tm, const uint8_t* qm,
                    const uint8_t* rhm, const uint8_t* pm, const int* reqs,
                    int nreq, const int* gate_planes, float* out_values,
                    uint8_t* out_masks, int nlev, int ny, int nx,
                    int all_defined, void* stream) {
  if (nlev < 1 || ny < 1 || nx < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SuiteParams P{};
  if (!set_requests(&P, reqs, nreq, gate_planes, all_defined != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  P.t = t; P.q = q; P.rh = rh; P.p = p;
  P.tm = tm; P.qm = qm; P.rhm = rhm; P.pm = pm;
  P.out_values = out_values;
  P.out_masks = out_masks;
  P.plane = static_cast<int64_t>(ny) * nx;
  P.n3 = P.plane * nlev;
  return launch(P, false, all_defined != 0, stream);
}

int mf_hlevel_suite(const float* t, const float* q, const float* rh,
                    const uint8_t* tm, const uint8_t* qm, const uint8_t* rhm,
                    const float* ps, const uint8_t* psm,
                    const float* alevel, const float* blevel,
                    const int* reqs, int nreq, const int* gate_planes,
                    float* out_values, uint8_t* out_masks, int nlev, int ny,
                    int nx, int all_defined, void* stream) {
  if (nlev < 1 || ny < 1 || nx < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SuiteParams P{};
  if (!set_requests(&P, reqs, nreq, gate_planes, all_defined != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  P.t = t; P.q = q; P.rh = rh;
  P.tm = tm; P.qm = qm; P.rhm = rhm; P.pm = psm;
  P.ps = ps;
  P.alevel = alevel;
  P.blevel = blevel;
  P.out_values = out_values;
  P.out_masks = out_masks;
  P.plane = static_cast<int64_t>(ny) * nx;
  P.n3 = P.plane * nlev;
  return launch(P, true, all_defined != 0, stream);
}

}  // extern "C"
