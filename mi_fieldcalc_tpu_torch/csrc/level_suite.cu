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
//   Their table gates are the 3 gate planes of the all-defined path.  So
//   are the other subexpressions that several modes spell the same way:
//   qsat = eps * esat / p of each form, and each dewpoint inverse (modes
//   5 and 9, 6 and 10, 7 and 11, 8 and 12 differ only by tdconv).
// Each output's mask is the AND of the point's flag bits that its mode
// needs (input masks, p's or ps's mask, one table gate), a bit set the
// host derives once per request (need_flags).
//
// What bounds it: the latency of each point's chain of dependent
// instructions, with neither the issue slots nor the bytes saturated.
// Per point it reads up to 4 f32 inputs and their mask bytes and writes
// nout f32 values and nout (or at most 3) mask bytes: 55 bytes a point for
// BASELINE config 2's 8 outputs on the h-level suite.  Its arithmetic is
// one deterministic pow (~50 instructions), up to 3 table lookups, IEEE
// divisions (~10 instructions each; -fmad=false and bitwise parity rule
// out the approximate ones) and per dewpoint a table inverse: ~560 SASS
// instructions a point for config 2, against ~1080 in the first version
// (a 41-step compare count per dewpoint, a 64-bit integer division for the
// level, the request switch decoded per point, every mode's qsat and
// inverse computed anew).  On the H100 that issues under half of the SMs'
// issue slots and moves about half the copy rate: the rest are stalls on
// the pow, the divisions and the searches, which only more resident warps
// hide, so the design keeps a thread's state small.
//
// Design:
// - a 2-D grid: blockIdx.y is the level, blockIdx.x a chunk of kBlock
//   points of its plane.  The level, alevel[k] and blevel[k] are per block;
//   no division per point, and offsets inside the chunk are 32-bit;
// - a thread takes one point.  ptxas builds each instantiation in 40
//   registers, which leaves room for three 512-thread blocks (48 warps)
//   an SM, and spills 4 bytes a thread to the stack (12 in the all-defined
//   h-level one): a few local stores and loads a point against ~560
//   instructions.  That is accepted because the variants with more
//   registers a thread (43-45 with 256-thread blocks, 59-70 with 2
//   points) ran slower, and so did a cap at 32 registers.
//   Several points a thread, as the design first planned (2, 4 or 8, held
//   at once or taken in rounds, 256- or 512-thread blocks), were measured
//   and dropped: each step costs more in occupancy and per-thread state
//   than its loads in flight gain (PERF.md section 6).  Each thread issues
//   its loads before the barrier that publishes the table;
// - the host decodes each request once into an Op, its tdconv and its
//   mask bits (decode, need_flags), and the union of the shared quantities
//   the requests read; per point the request loop takes one jump a request
//   and stores one coalesced value (and mask byte) per output plane;
// - the 41-entry table is copied into shared memory once per block,
//   padded with NaN to 64 entries; esat's two lookups read it there, and
//   the inverse finds its count by a 6-step search (common.cuh ewt_count)
//   instead of 41 compares;
// - every phase is a block-stride loop (the table fill, the points of the
//   chunk), so the source also runs on the host with one thread per block
//   (tests/test_torch_suite_host.py).
// Each output's value is the same sequence of float32 operations as the
// plain versions' (ops/fused_suite.py alevel_suite_plain /
// hlevel_suite_plain); only who computes a shared subexpression, and how
// often, differs.  The kernel equals them bit for bit.

#include "common.cuh"

namespace {

constexpr int kMaxReq = 32;
constexpr int kBlock = 512;             // = the points of a plane a block

// request families, in the order of ops/fused_suite.py's _VALID
enum Family { kTemp = 0, kHumQ, kHumRh, kThe, kDuctQ, kDuctRh };
// gate kinds (ops/fused_suite.py _gate_kind): the T-form, TH-form and
// temp 5's TH5-form table gates, as indices of gate_plane
enum Gate { kGateT = 0, kGateTH = 1, kGateTH5 = 2 };
// a point's flag bits: the input masks, then the table gates (kOkT << gate)
enum Flag : unsigned {
  kFt = 1u, kFq = 2u, kFrh = 4u, kFp = 8u,
  kOkT = 16u << kGateT, kOkTH = 16u << kGateTH, kOk5 = 16u << kGateTH5,
};

// What a request computes, decoded once on the host (decode): its leaf of
// the per-mode arithmetic.  The humidity modes take q for 1/2, 5/6, 9/10
// and RH for 3/4, 7/8, 11/12 (ops/fused_suite.py _VALID); odd modes read
// the T-form esat, even ones the TH-form.
enum Op : int8_t {
  kOpTemp1, kOpTemp2, kOpTemp3, kOpTemp4, kOpTemp5,
  kOpRhT, kOpRhTH,            // hum 1 / 2: RH% from q
  kOpQT, kOpQTH,              // hum 3 / 4: q from RH%
  kOpTdQT, kOpTdQTH,          // hum 5, 9 / 6, 10: dewpoint from q
  kOpTdRhT, kOpTdRhTH,        // hum 7, 11 / 8, 12: dewpoint from RH%
  kOpThe1, kOpThe2,
  kOpDuctQT, kOpDuctQTH,      // duct_q 1 / 2
  kOpDuctRhT, kOpDuctRhTH,    // duct_rh 3 / 4
};
// Per-point quantities that several outputs share, each computed at most
// once per point when a request reads it: pidcp, the three esat
// spellings, the T- and TH-form qsat = eps * esat / p, and the four
// dewpoint inverses (modes 5 and 9, 7 and 11, ... differ only by tdconv)
enum Use : unsigned {
  kUsePid = 1u, kUseEsatT = 2u, kUseEsatTH = 4u, kUseEsat5 = 8u,
  kUseQsatT = 16u, kUseQsatTH = 32u,
  kUseTdQT = 64u, kUseTdQTH = 128u, kUseTdRhT = 256u, kUseTdRhTH = 512u,
};

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
  unsigned uses;                      // Use bits any request reads
  int8_t op[kMaxReq];
  uint8_t need[kMaxReq];              // Flag bits the output's mask ANDs
  float tdconv[kMaxReq];              // dewpoints: 0 (degC) or t0 (K)
  int gate_plane[3];                  // all-defined: plane per gate kind
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

// Request (fam, c) -> its Op and the shared quantities it reads.
void decode(int fam, int c, int8_t* op, unsigned* uses) {
  const bool odd = (c % 2) == 1;
  const unsigned esat = odd ? kUseEsatT : kUsePid | kUseEsatTH;
  const unsigned qsat = esat | (odd ? kUseQsatT : kUseQsatTH);
  switch (fam) {
    case kTemp:
      *op = static_cast<int8_t>(kOpTemp1 + c - 1);
      *uses = kUsePid | (c == 4 ? kUseEsatT | kUseQsatT : 0u) |
              (c == 5 ? kUseEsat5 : 0u);
      return;
    case kHumQ:
    case kHumRh:
      if (c <= 2) {
        *op = odd ? kOpRhT : kOpRhTH;
        *uses = qsat;
      } else if (c <= 4) {
        *op = odd ? kOpQT : kOpQTH;
        *uses = qsat;
      } else if (c == 5 || c == 6 || c == 9 || c == 10) {
        *op = odd ? kOpTdQT : kOpTdQTH;
        *uses = qsat | (odd ? kUseTdQT : kUseTdQTH);
      } else {
        *op = odd ? kOpTdRhT : kOpTdRhTH;
        *uses = esat | (odd ? kUseTdRhT : kUseTdRhTH);
      }
      return;
    case kThe:
      *op = c == 1 ? kOpThe1 : kOpThe2;
      *uses = kUsePid;
      return;
    case kDuctQ:
      *op = odd ? kOpDuctQT : kOpDuctQTH;
      *uses = odd ? 0u : kUsePid;
      return;
    default:                              // kDuctRh
      *op = odd ? kOpDuctRhT : kOpDuctRhTH;
      *uses = esat;
      return;
  }
}

// The flags whose AND is output (fam, c)'s mask: t's mask, the humidity's,
// p's (ps's) where the family gates on it, and the table gate of its
// temperature spelling.  alevelhum gates only 7/11 on p; hlevelhum gates
// all but 7/11 on ps.
unsigned need_flags(int fam, int c, bool hybrid) {
  const bool odd = (c % 2) == 1;
  const unsigned hm = (fam == kHumRh || fam == kDuctRh) ? kFrh : kFq;
  const unsigned ok = odd ? kOkT : kOkTH;
  switch (fam) {
    case kTemp:
      return kFt | kFp | (c == 4 ? kOkT : 0u) | (c == 5 ? kOk5 : 0u);
    case kHumQ:
    case kHumRh: {
      const bool p_free = c == 7 || c == 11;
      const bool gate_p = hybrid ? !p_free : p_free;
      return kFt | hm | (gate_p ? kFp : 0u) | ok;
    }
    case kThe: return kFt | kFq | kFp;
    case kDuctQ: return kFt | hm | kFp;
    default: return kFt | hm | kFp | ok;    // kDuctRh
  }
}

template <bool kHybrid, bool kAllDefined>
__global__ void __launch_bounds__(kBlock)
suite_kernel(const SuiteParams P) {
  __shared__ float tab[kEwtPad];
  ewt_to_shared(tab);

  // ---- the block's chunk: level blockIdx.y, points c0 .. c0 + n - 1 ------
  const int lev = blockIdx.y;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kBlock;
  const int n = static_cast<int>(
      P.plane - c0 < kBlock ? P.plane - c0 : static_cast<int64_t>(kBlock));
  const int64_t o3 = static_cast<int64_t>(lev) * P.plane + c0;
  const int64_t o2 = kHybrid ? c0 : o3;     // the pressure source's offset
  const float* tv = P.t + o3;
  const float* qv = P.q ? P.q + o3 : nullptr;
  const float* rhv = P.rh ? P.rh + o3 : nullptr;
  const float* pv = kHybrid ? P.ps + o2 : P.p + o2;
  const uint8_t* tmv = kAllDefined ? nullptr : P.tm + o3;
  const uint8_t* qmv = P.qm && !kAllDefined ? P.qm + o3 : nullptr;
  const uint8_t* rhmv = P.rhm && !kAllDefined ? P.rhm + o3 : nullptr;
  const uint8_t* pmv = kAllDefined ? nullptr : P.pm + o2;
  const float a_lev = kHybrid ? __ldg(P.alevel + lev) : 0.0f;
  const float b_lev = kHybrid ? __ldg(P.blevel + lev) : 0.0f;
  const unsigned uses = P.uses;
  const int nt = blockDim.x;

  for (int r0 = 0; r0 < n; r0 += nt) {
    // ---- the thread's point (a tail lane reads point 0, stores nothing) -
    const int o = r0 + static_cast<int>(threadIdx.x);
    const bool in = o < n;
    const int k = in ? o : 0;
    float p;
    bool pm = true;
    if (kHybrid) {
      p = a_lev + b_lev * __ldg(pv + k);
      if (!kAllDefined) pm = __ldg(pmv + k) != 0;
    } else {
      p = __ldg(pv + k);
      if (!kAllDefined) pm = __ldg(pmv + k) != 0;
      if (!pm) p = kUndef;        // alevelhum: the sentinel flows in
    }
    const float t = __ldg(tv + k);
    const float q = qv ? __ldg(qv + k) : 0.0f;
    const float rh = rhv ? __ldg(rhv + k) : 0.0f;
    bool tm = true, qm = true, rhm = true;
    if (!kAllDefined) {
      tm = __ldg(tmv + k) != 0;
      qm = qmv ? __ldg(qmv + k) != 0 : false;
      rhm = rhmv ? __ldg(rhmv + k) != 0 : false;
    }
    unsigned fl = (tm ? kFt : 0u) | (qm ? kFq : 0u) | (rhm ? kFrh : 0u) |
                  (pm ? kFp : 0u);
    __syncthreads();   // the table is in place; the loads are in flight

    // ---- shared quantities, each at most once per point -----------------
    // (a quantity no request reads is left unset and never read)
    float et_t, et_th, et_5, qsat_t, qsat_th, td_qt, td_qth, td_rht, td_rhth;
    bool ok;
    int l_t = 0, l_th = 0, l5;
    const float pid = uses & kUsePid ? pidcp_edge(p) : 0.0f;
    if (uses & kUseEsatT) {
      et_t = esat_tab(tab, t, &ok, &l_t);
      fl |= ok ? kOkT : 0u;
    }
    if (uses & kUseEsatTH) {
      et_th = esat_tab(tab, t * pid, &ok, &l_th);
      fl |= ok ? kOkTH : 0u;
    }
    if (uses & kUseEsat5) {
      et_5 = esat_tab(tab, t * (pid * kCp) / kCp, &ok, &l5);
      fl |= ok ? kOk5 : 0u;
    }
    if (uses & kUseQsatT) qsat_t = kEps * et_t / p;
    if (uses & kUseQsatTH) qsat_th = kEps * et_th / p;
    if (uses & kUseTdQT) {
      const float rhc = clip_nan(q / qsat_t, kRhmin, kRhmax);
      td_qt = ewt_inverse_tab(tab, rhc * et_t, l_t);
    }
    if (uses & kUseTdQTH) {
      const float rhc = clip_nan(q / qsat_th, kRhmin, kRhmax);
      td_qth = ewt_inverse_tab(tab, rhc * et_th, l_th);
    }
    if (uses & kUseTdRhT) {
      const float rhc = clip_nan(kCent * rh, kRhmin, kRhmax);
      td_rht = ewt_inverse_tab(tab, rhc * et_t, l_t);
    }
    if (uses & kUseTdRhTH) {
      const float rhc = clip_nan(kCent * rh, kRhmin, kRhmax);
      td_rhth = ewt_inverse_tab(tab, rhc * et_th, l_th);
    }

    // ---- the requests: one jump each, a coalesced store per plane --------
    float* vo = P.out_values + o3;
    uint8_t* mo = P.out_masks + o3;
    for (int r = 0; r < P.nreq; ++r, vo += P.n3, mo += P.n3) {
      float v;
      switch (P.op[r]) {
        case kOpTemp1: v = t * pid - kT0; break;
        case kOpTemp2: v = t * pid; break;
        case kOpTemp3: v = t / pid; break;
        case kOpTemp4: v = (kCp * t + kXlh * qsat_t) / (pid * kCp); break;
        case kOpTemp5: {
          const float qsat = kEps * et_5 / p;
          v = t + kXlh * qsat / (pid * kCp);
          break;
        }
        case kOpRhT: v = 100.0f * q / qsat_t; break;
        case kOpRhTH: v = 100.0f * q / qsat_th; break;
        case kOpQT: v = kCent * rh * qsat_t; break;
        case kOpQTH: v = kCent * rh * qsat_th; break;
        case kOpTdQT: v = td_qt + P.tdconv[r]; break;
        case kOpTdQTH: v = td_qth + P.tdconv[r]; break;
        case kOpTdRhT: v = td_rht + P.tdconv[r]; break;
        case kOpTdRhTH: v = td_rhth + P.tdconv[r]; break;
        case kOpThe1: v = (t * kCp + q * kXlh) / (kCp * pid); break;
        case kOpThe2: v = t + q * kXlh / (kCp * pid); break;
        case kOpDuctQT:
          v = kDuct1 * (p / t) + kDuct2 * (q * p) / (kEps * t * t);
          break;
        case kOpDuctQTH: {
          const float tk = t * pid;
          v = kDuct1 * (p / tk) + kDuct2 * (q * p) / (kEps * tk * tk);
          break;
        }
        case kOpDuctRhT: {
          const float rhc = clip_nan(rh * kCent, kRhmin, kRhmax);
          v = kDuct1 * (p / t) + kDuct2 * rhc * et_t / (t * t);
          break;
        }
        default: {                        // kOpDuctRhTH
          const float tk = t * pid;
          const float rhc = clip_nan(rh * kCent, kRhmin, kRhmax);
          v = kDuct1 * (p / tk) + kDuct2 * rhc * et_th / (tk * tk);
          break;
        }
      }
      if (in) {
        vo[o] = v;
        if (!kAllDefined) mo[o] = (fl & P.need[r]) == P.need[r] ? 1 : 0;
      }
    }
    if (kAllDefined && in) {
      for (int g = kGateT; g <= kGateTH5; ++g) {
        if (P.gate_plane[g] >= 0) {
          P.out_masks[P.gate_plane[g] * P.n3 + o3 + o] =
              (fl & (kOkT << g)) ? 1 : 0;
        }
      }
    }
  }
}

// Fills the request part of P from reqs = (family, compute) pairs and
// gate_planes[3]; returns false on an invalid request list.
bool set_requests(SuiteParams* P, const int* reqs, int nreq,
                  const int* gate_planes, bool hybrid, bool all_defined) {
  if (nreq < 1 || nreq > kMaxReq) return false;
  P->nreq = nreq;
  P->uses = 0;
  for (int r = 0; r < nreq; ++r) {
    const int fam = reqs[2 * r], c = reqs[2 * r + 1];
    if (!valid_mode(fam, c)) return false;
    unsigned uses;
    decode(fam, c, &P->op[r], &uses);
    P->uses |= uses;
    P->need[r] = static_cast<uint8_t>(need_flags(fam, c, hybrid));
    P->tdconv[r] = (fam == kHumQ || fam == kHumRh) && c >= 9 ? kT0 : 0.0f;
  }
  for (int k = 0; k < 3; ++k) {
    P->gate_plane[k] = all_defined ? gate_planes[k] : -1;
  }
  return true;
}

int launch(const SuiteParams& P, int nlev, bool hybrid, bool all_defined,
           void* stream) {
  const int64_t chunks = (P.plane + kBlock - 1) / kBlock;
  if (chunks > 2147483647LL || nlev > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 g(static_cast<unsigned>(chunks), static_cast<unsigned>(nlev));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hybrid) {
    if (all_defined) {
      suite_kernel<true, true><<<g, kBlock, 0, s>>>(P);
    } else {
      suite_kernel<true, false><<<g, kBlock, 0, s>>>(P);
    }
  } else if (all_defined) {
    suite_kernel<false, true><<<g, kBlock, 0, s>>>(P);
  } else {
    suite_kernel<false, false><<<g, kBlock, 0, s>>>(P);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (cudaErrorInvalidValue
// for a bad request list or grid: more than 65535 levels).  reqs holds
// nreq (family, compute) pairs, family in _VALID's order (temp, hum_q,
// hum_rh, the, duct_q, duct_rh); gate_planes[3] gives the all-defined
// path's plane of the T, TH and TH5 gates (-1: not written).  out_values
// is [nreq, nlev, ny, nx]; out_masks is [nreq, nlev, ny, nx], or the gate
// planes when all_defined != 0.  q / rh (and their masks) may be null when
// no request reads them; masks may be null when all_defined != 0.

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
  if (!set_requests(&P, reqs, nreq, gate_planes, false, all_defined != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  P.t = t; P.q = q; P.rh = rh; P.p = p;
  P.tm = tm; P.qm = qm; P.rhm = rhm; P.pm = pm;
  P.out_values = out_values;
  P.out_masks = out_masks;
  P.plane = static_cast<int64_t>(ny) * nx;
  P.n3 = P.plane * nlev;
  return launch(P, nlev, false, all_defined != 0, stream);
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
  if (!set_requests(&P, reqs, nreq, gate_planes, true, all_defined != 0)) {
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
  return launch(P, nlev, true, all_defined != 0, stream);
}

}  // extern "C"
