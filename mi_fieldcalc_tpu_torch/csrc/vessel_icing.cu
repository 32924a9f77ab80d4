// The MINCOG (B5) and Modified Stallabrass (B6) vessel-icing solvers, one
// CUDA kernel each, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels mi_fieldcalc_tpu/ops/icing_fused.py:
// _mincog_kernel (entry vessel_icing_mincog_fused, pallas_call at :166) and
// _modstall_kernel (entry vessel_icing_modstall_fused, pallas_call at :280).
// Both trace the JAX package's _mincog_core / _modstall_core
// (ops/icing.py:455-709, 1025-1207) on one tile.  Here each thread solves
// one grid point from the prologue planes the wrapper computes in PyTorch
// (ops/icing_fused.py); the port's plain versions (ops/icing.py
// _mincog_core, _modstall_core) run the same arithmetic over whole tensors
// and the kernels equal them bit for bit.
//
// Per point, all in registers:
// - the shallow-water wave-speed fixed point c = c0 tanh(a/c): 32 exact
//   map steps, then Newton, forced at step 96; a Newton-resolved point takes
//   the reference's cap decision from a 17-node quadrature of the
//   iteration count (and, for MINCOG, the float reference's stall test);
// - 50 Runge-Kutta steps of the droplet temperature;
// - the height sweep (number = 2 (zmax - zmin) + 1 heights, 19 at the
//   operational 2..11 m): MINCOG runs 8 safeguarded-Newton steps on the
//   brine-temperature heat balance plus 3 residual evaluations per height;
//   ModStall runs up to 128 freezing-fraction steps per height (32 exact,
//   then Newton where the map contracts inside [0, 1]) and the post-loop
//   resolution of the 1000-step cap.
// Finished points hold their state exactly in the plain version's
// whole-array loops, and the cap fires at the same per-point step, so a
// thread that stops when its own point is done gives the same bits.  A
// warp runs as long as its slowest lane: that is the GPU form of the TPU
// kernel's per-tile early exit.
//
// The decay table (number floats, computed on the host in float64 and
// rounded once) is read at one index across the warp, a broadcast.  The
// flags arrive as bool planes (gate, shallow, and for MINCOG skip0); the
// kernels write 0 where the gate is off or the point is skipped, and the
// wrapper returns the gate as the mask.
//
// What bounds them: float32 operations.  Traffic is 17 (B5) or 12 (B6)
// input planes, 2-3 flag planes and one output plane, ~50 MB at 719x929,
// ~0.02 ms at the copy rate; the work is tens of thousands of float32
// operations per point, many of them IEEE divisions and exp evaluations.
// This first version is simple and right: occupancy, register pressure and
// divergence are later work.
//
// Numerics: -fmad=false; every min/max/clip propagates NaN (max_nan,
// min_nan, clip_nan) as jnp's do; exp, tanh and log are common.cuh's
// deterministic _libm ports; constants are float32 hex literals (checked
// by tests/test_torch_icing.py).

#include "common.cuh"

namespace {

// float32 constants (ops/icing.py)
constexpr float kF1A = 0x1.38ef34p-1f;           // 0.6112
constexpr float kF1B = 0x1.1ab852p+4f;           // 17.67
constexpr float kSigma = 0x1.e70c9ep-25f;        // 5.67e-8
constexpr float kTol = 0x1.4f8b58p-17f;          // 1e-5
constexpr float kNewtonRel = 0x1.4f8b58p-16f;    // 2e-5
constexpr float kEpsStep = 0x1.ff19e2p-24f;      // 1.19e-7
constexpr float kStall = 0x1.f75104p-16f;        // 3e-5
constexpr float k1em7 = 0x1.ad7f2ap-24f;         // 1e-7
constexpr float kTiny = 0x1.79ca1p-67f;          // 1e-20
constexpr float kOneMinus1em7 = 0x1.fffffcp-1f;  // 1 - 1e-7
constexpr float kOneMinus1em6 = 0x1.ffffdep-1f;  // 1 - 1e-6
constexpr float k1em30 = 0x1.4484cp-100f;        // 1e-30
constexpr float kDecayRatio = 0x1.14fb8cp+4f;    // 89.5 / 5.17
constexpr float kSixth = 0x1.555556p-3f;         // 1 / 6
constexpr float kRw = 0x1.0ef3b8p-14f;           // 6.46e-5
constexpr float kC012 = 0x1.899c1p-7f;           // 0.012012012
constexpr float kDF1 = 0x1.0cea52p+12f;          // 17.67 * 243.5
constexpr float kFloor = 0x1.ad7f2ap-21f;        // 8e-7
constexpr float kPt2 = 0x1.99999ap-3f;           // 0.2
constexpr float kTdur0 = 0x1.f7cedap-4f;         // 0.1230
constexpr float kTdur1 = 0x1.66cf42p-1f;         // 0.7008
constexpr float kLwc1 = 0x1.0ac1fap-14f;         // 6.36e-5
constexpr float k4Pi = 0x1.921fb6p+3f;           // 4 pi
constexpr float kLwc2 = 0x1.f325fcp-11f;         // 9.5205e-4
constexpr float kPt7 = 0x1.666666p-1f;           // 0.7
constexpr float kLfs = 0x1.c746p+17f;            // 3.33e5 * 0.7
constexpr float kBrine = 0x1.b0e69ap+5f;         // 54.1126
constexpr float kInv07 = 0x1.6db6dcp+0f;         // 1 / 0.7
constexpr float kPt44 = 0x1.c28f5cp-2f;          // 0.44
constexpr float kDsb = -0x1.a6c134p+15f;         // -54112.6
constexpr float k4Sigma = 0x1.e70c9ep-23f;       // 4 * 5.67e-8
constexpr float kRateScale = 0x1.947e9p+8f;      // 3600 * 100 / 890
constexpr float k1em6 = 0x1.0c6f7ap-20f;         // 1e-6
constexpr float kBisectB = 0x1.4cccccp+0f;       // 1.3 (the bracket's N)
constexpr float kDenA = 0x1.59999ap+0f;          // 1 - 0.7 * (-0.5)
constexpr float kDenB = 0x1.70a3ep-4f;           // 1 - 0.7 * 1.3

constexpr int kWarmup = 32;
constexpr int kWaveCap = kWarmup + 64;
constexpr int kHeightCap = kWarmup + 96;
constexpr int kNodes = 16;
constexpr int kNewtonIters = 8;
constexpr int kBlock = 128;

struct MincogParams {
  // c0, a, wave, pw, depth, v, sst, sal, airtemp, rh, ha, he, ea, M, K,
  // tau, vd (icing_fused._PLANES)
  const float* p[17];
  const bool* gate;
  const bool* shallow;
  const bool* skip0;
  const float* decay;
  int number;
  float vsca;
  int alt;
  float* out;
  int n;
};

struct ModstallParams {
  // c0, a, wave, v, sst, airtemp, rh, tf, ha, tau, K, M
  // (icing_fused._MS_PLANES)
  const float* p[12];
  const bool* gate;
  const bool* shallow;
  const float* decay;
  int number;
  float vsca;
  float* out;
  int n;
};

__device__ __forceinline__ float icing_f1(float t) {
  return kF1A * exp_f32((kF1B * t) / (t + 243.5f));
}

__device__ __forceinline__ float kt4(float t_celsius) {
  const float tk = t_celsius + kT0;
  const float t2 = tk * tk;
  return kSigma * t2 * t2;
}

// g(r + du) - r for a signed amplitude du, cancellation-free
__device__ __forceinline__ float gdiff(float du, float rr, float a, float c0,
                                       float t_r) {
  const float x = rr + du;
  const float xs = max_nan(fabsf(x), kTiny) * (x < 0.0f ? -1.0f : 1.0f);
  const float tx = tanh_f32(a / xs);
  const float td = tanh_f32(-(a * du) / (xs * rr));
  return c0 * td * (1.0f - tx * t_r);
}

// icing._wave_cap_predict: the predicted float64 iteration count
__device__ float wave_cap_predict(float c0, float a, float r, float c_sw) {
  const float rr = max_nan(r, kTol);
  const float t_r = tanh_f32(a / rr);
  const float s = ((c0 * a) * (1.0f - t_r * t_r)) / (rr * rr);
  const float u_end = kTol / (1.0f + s);
  const float u_sw = max_nan(fabsf(c_sw - rr), u_end);
  const float side = c_sw >= rr ? 1.0f : -1.0f;
  const float ln_lo = log_f32(u_end);
  const float dln = (log_f32(u_sw) - ln_lo) / static_cast<float>(kNodes);
  float acc = 0.0f;
  for (int i = 0; i <= kNodes; ++i) {
    const float u = exp_f32(ln_lo + static_cast<float>(i) * dln);
    const float d1 = gdiff(side * u, rr, a, c0, t_r);
    const float d2 = gdiff(d1, rr, a, c0, t_r);
    const float q = fabsf(d2) / u;
    const float mln = max_nan(-log_f32(min_nan(q, kOneMinus1em7)), k1em7);
    const float w = (i == 0 || i == kNodes) ? 0.5f : 1.0f;
    acc = acc + w * (2.0f / mln);
  }
  const float jpred = static_cast<float>(kWarmup) + dln * acc;
  return s < 1.0f ? jpred : 1e9f;
}

// icing._wave_speed_fixed_point for one point
__device__ float wave_speed(float c0, float a, bool needs_iter,
                            float max_iter, bool ref_f32) {
  if (!needs_iter) return c0;
  float c = 1.0f;
  float c_sw = 1.0f;
  int di = 0;
  for (int j = 0; j < kWaveCap && di == 0; ++j) {
    const float t = tanh_f32(a / c);
    const float g = c0 * t;
    const float gp = ((c0 * a) * (1.0f - t * t)) / (c * c);
    const float err1 = fabsf(g - c);
    const int j1 = j + 1;
    const bool newton = j1 > kWarmup;
    if (j1 == kWarmup + 1) c_sw = c;
    const float thr = newton ? max_nan(kTol, kNewtonRel * fabsf(c)) : kTol;
    const bool conv = err1 <= thr;
    const bool forced = j1 >= kWaveCap;
    if (conv || forced) {
      // warmup stops at the map output g; Newton keeps its root c
      c = newton ? c : (conv ? g : 0.0f);
      di = newton ? 2 : 1;
    } else {
      c = newton ? min_nan(max_nan(c - (c - g) / (1.0f + gp), kTol), c0) : g;
    }
  }
  if (di != 2) return c;
  bool ok = wave_cap_predict(c0, a, c, c_sw) <= max_iter;
  if (ref_f32) {
    const float rr = max_nan(c, kTol);
    const float t_r = tanh_f32(a / rr);
    const float s = ((c0 * a) * (1.0f - t_r * t_r)) / (rr * rr);
    const float floor_step =
        ((1.0f + s) * kEpsStep * rr) / max_nan(1.0f - s, k1em7);
    ok = ok && floor_step < kStall;
  }
  return ok ? c : 0.0f;
}

// ---------------------------------------------------------------- MINCOG

struct Heat {
  float sw, ta, ha, he, ea, rh, tsp, lwdown;
};

// icing._freeze_frac_ts: residual, its derivative and N at brine
// temperature ts (swdown = 0)
__device__ __forceinline__ void freeze_frac_ts(float ts, float rw,
                                               const Heat& H, float* res,
                                               float* dres, float* n) {
  const float den = ts - kBrine;
  const float sb = (1000.0f * ts) / den;
  const float sb_safe = sb == 0.0f ? 1.0f : sb;
  *n = (1.0f - H.sw / sb_safe) * kInv07;
  const float es = 10.0f * icing_f1(ts);
  const float swdown = 0.0f;
  const float qsum = H.ha * (ts - H.ta) + H.he * (es - H.rh * H.ea) +
                     rw * 4000.0f * (ts - H.tsp) + kt4(ts) - H.lwdown -
                     kPt44 * swdown;
  const float lrw = kLfs * rw;
  *res = qsum / lrw - *n;
  const float dsb_dts = kDsb / (den * den);
  const float dn_dts = (H.sw / (sb_safe * sb_safe)) * kInv07 * dsb_dts;
  const float tp = ts + 243.5f;
  const float des_dts = (es * kDF1) / (tp * tp);
  const float tk = ts + kT0;
  const float dq_dts = H.ha + H.he * des_dts + rw * 4000.0f +
                       k4Sigma * tk * tk * tk;
  *dres = dq_dts / lrw - dn_dts;
}

__device__ __forceinline__ float residual(float ts, float rw, const Heat& H,
                                          float* dres) {
  float r, n;
  freeze_frac_ts(ts, rw, H, &r, dres, &n);
  return r;
}

// _mincog_core's solve_n: the freezing fraction at spray flux rw
__device__ float mincog_solve_n(float rw, const Heat& H, float ts_lo,
                                float ts_hi, bool sw0) {
  if (sw0) {
    // sal == 0: the residual is linear in N, closed-form root
    float d;
    const float k_lin = residual(0.0f, rw, H, &d) + kInv07;
    const bool sl = (k_lin - kBisectB) > 0.0f;
    const bool lin_root = (k_lin - (-0.5f)) > 0.0f ? !sl : sl;
    return lin_root ? k_lin : 0.0f;
  }
  // icing._rtsafe_lanes over the bracket [ts_lo, ts_hi]
  float a = ts_lo;
  float b = ts_hi;
  float d;
  const float fa = residual(a, rw, H, &d);
  const float fb = residual(b, rw, H, &d);
  const bool sa = fa > 0.0f;
  const bool no_root = fb > 0.0f ? sa : !sa;
  if (no_root) return 0.0f;                    // NaN root -> N = 0
  const float eps = k1em6 * (b - a);
  const float denom = fb == fa ? 1.0f : fb - fa;
  const float x0 = a - (fa * (b - a)) / denom;
  float x = min_nan(max_nan(x0, a + eps), b - eps);
  for (int it = 0; it < kNewtonIters; ++it) {
    float df;
    const float f = residual(x, rw, H, &df);
    const bool same = f > 0.0f ? sa : !sa;
    a = same ? x : a;
    b = same ? b : x;
    const float step = f / (df == 0.0f ? 1.0f : df);
    const float xn = x - step;
    const bool ok = (xn > a && xn < b && fabsf(xn) < __int_as_float(0x7f800000)
                     && df != 0.0f) || xn == x;
    x = f == 0.0f ? x : (ok ? xn : (a + b) * 0.5f);
  }
  float r, dr, n_ts;
  freeze_frac_ts(x, rw, H, &r, &dr, &n_ts);
  return n_ts != n_ts ? 0.0f : n_ts;
}

__global__ void __launch_bounds__(kBlock)
mincog_kernel(const MincogParams P) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P.n) return;
  if (!P.gate[i] || P.skip0[i]) {
    P.out[i] = 0.0f;
    return;
  }
  const float c0 = P.p[0][i], a = P.p[1][i], wave = P.p[2][i];
  const float pw = P.p[3][i], depth = P.p[4][i], v = P.p[5][i];
  const float sst = P.p[6][i], sal = P.p[7][i], airtemp = P.p[8][i];
  const float rh = P.p[9][i], ha = P.p[10][i], he = P.p[11][i];
  const float ea = P.p[12][i], M = P.p[13][i], K = P.p[14][i];
  const float tau = P.p[15][i], vd = P.p[16][i];

  const float c = wave_speed(c0, a, P.shallow[i], 1000.0f, true);
  const float vr = c - P.vsca;
  const float tper = fabsf((c * pw) / vr);
  if (tper <= 0.0f) {
    P.out[i] = 0.0f;
    return;
  }
  const float tdur = kTdur0 + (kTdur1 * fabsf(vr * wave)) / max_nan(v, 5.0f);
  const float nf = 1.0f / (4.0f * tper);

  // droplet cooling, the reference runge_kutta template (VI:450-463)
  const float h = tau / 50.0f;
  const float h2 = h / 2.0f;
  const float K10 = K * 10.0f;
  float td = sst;
  for (int s = 0; s < 50; ++s) {
    const float k1 = h2 * ((M - kPt2 * td) - K10 * icing_f1(td));
    const float y2 = td + k1;
    const float k2 = h * ((M - kPt2 * y2) - K10 * icing_f1(y2));
    const float y3 = td + k2 / 2.0f;
    const float k3 = h * ((M - kPt2 * y3) - K10 * icing_f1(y3));
    const float y4 = td + k3;
    const float k4 = h2 * ((M - kPt2 * y4) - K10 * icing_f1(y4));
    td = td + (k1 + k2 + k3 + k4) / 3.0f;
  }

  float lwc0;
  if (P.alt == 1) {
    lwc0 = kLwc1 * wave * (vr * vr);
  } else {
    const float lam = c * pw;
    const float dl = (k4Pi * depth) / lam;
    const float sh = (exp_f32(dl) - exp_f32(-dl)) * 0.5f;
    const float cg = (c / 2.0f) * (1.0f + dl / sh);
    const float vgr = cg - P.vsca;
    lwc0 = kLwc2 * (wave * wave) * sqrtf(wave / lam) * vgr;
  }
  lwc0 = fabsf(lwc0);

  Heat H;
  H.sw = sal;
  H.ta = airtemp;
  H.ha = ha;
  H.he = he;
  H.ea = ea;
  H.rh = rh;
  H.tsp = 0.5f * (td + sst);
  H.lwdown = kPt7 * kt4(airtemp);
  const float sb_hi = sal / kDenA;
  const float ts_hi = (-kBrine * sb_hi) / (1000.0f - sb_hi);
  const float sb_lo = sal / kDenB;
  const float ts_lo = (-kBrine * sb_lo) / (1000.0f - sb_lo);
  const bool sw0 = sal <= 0.0f;
  const float rw_base = lwc0 * vd * nf * tdur;

  float icing = 0.0f;
  for (int k = 0; k < P.number; ++k) {
    const float rw = rw_base * __ldg(P.decay + k);
    const float n = mincog_solve_n(rw, H, ts_lo, ts_hi, sw0);
    icing = icing + rw * clip_nan(n, 0.0f, 1.0f);
  }
  P.out[i] = fabsf(icing / static_cast<float>(P.number)) * kRateScale;
}

// -------------------------------------------------------------- ModStall

struct FpConst {
  float tf, td, at, rh, f1_air, hk;
};

// one application of the freezing-fraction map: n1, slope B, residual floor
__device__ __forceinline__ void modstall_map(float n, float rw,
                                             const FpConst& F, float* n1,
                                             float* B, float* floor_) {
  const float ts = (1.0f + n) * F.tf;
  const float f1ts = icing_f1(ts);
  const float ri =
      kC012 * rw * (ts - F.td) +
      F.hk * ((ts - F.at) + kDecayRatio * (f1ts - F.rh * F.f1_air));
  *n1 = ri / rw;
  const float tsq = ts + 243.5f;
  const float f1p = (f1ts * kDF1) / (tsq * tsq);
  *B = (F.tf * (kC012 * rw + F.hk * (1.0f + kDecayRatio * f1p))) / rw;
  const float ri_mag =
      kC012 * rw * fabsf(ts - F.td) +
      F.hk * (fabsf(ts - F.at) + kDecayRatio * (f1ts + F.rh * F.f1_air));
  *floor_ = (kFloor * ri_mag) / rw;
}

// icing._modstall_fp for one point: clip(n, 0, 1)
__device__ float modstall_fp(float rw, const FpConst& F) {
  float n = 0.0f;
  float err_sw = 1.0f;
  int di = 0;
  for (int j = 0; j < kHeightCap && di == 0; ++j) {
    float n1, B, floor_;
    modstall_map(n, rw, F, &n1, &B, &floor_);
    const float err1 = fabsf(n1 - n);
    const int j1 = j + 1;
    const bool newton = j1 > kWarmup;
    const float absB = fabsf(B);
    const bool contracting = absB < kOneMinus1em6;
    if (j1 == kWarmup + 1) err_sw = err1;
    const float thr = newton ? max_nan(kTol, floor_) : kTol;
    const bool conv = err1 <= thr;
    const float root = (n1 - B * n) / (1.0f - B);
    const float amp_env = (absB * absB * err1) / (1.0f + absB);
    const bool inside = n1 >= 0.0f && n1 <= 1.0f;
    const bool env_ok = inside && root + amp_env <= 1.0f &&
                        root - amp_env >= 0.0f;
    const bool use_newton = env_ok && contracting && newton;
    const float n_next = use_newton ? root : n1;
    const bool forced = j1 >= kHeightCap;
    const bool stop = conv || forced;
    n = stop ? n1 : n_next;
    di = (stop && newton) ? 2
                          : ((conv || n1 < 0.0f || n1 > 1.0f) ? 1 : 0);
  }
  if (di == 2) {
    // the reference's 1000-step cap, predicted for post-warmup stops
    float n1f, Bf, floor_;
    modstall_map(n, rw, F, &n1f, &Bf, &floor_);
    const float absB = fabsf(Bf);
    const float lB = log_f32(max_nan(absB, k1em30));
    const float rem = log_f32(kTol / max_nan(err_sw, kTol)) /
                      (lB < 0.0f ? lB : -k1em30);
    const bool capped_c =
        absB < 1.0f && static_cast<float>(kWarmup) + rem > 1000.0f;
    const float errf = fabsf(n1f - n);
    const float amp = errf / (1.0f + absB);
    const float esc_rem = log_f32(2.0f / max_nan(amp, k1em30)) /
                          (lB > 0.0f ? lB : k1em30);
    const bool capped_d = absB >= 1.0f && errf > kTol &&
                          static_cast<float>(kHeightCap) + esc_rem > 1000.0f;
    if (capped_c || capped_d) n = 0.0f;
  }
  return clip_nan(n, 0.0f, 1.0f);
}

__global__ void __launch_bounds__(kBlock)
modstall_kernel(const ModstallParams P) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P.n) return;
  if (!P.gate[i]) {
    P.out[i] = 0.0f;
    return;
  }
  const float c0 = P.p[0][i], a = P.p[1][i], wave = P.p[2][i];
  const float v = P.p[3][i], sst = P.p[4][i], airtemp = P.p[5][i];
  const float rh = P.p[6][i], tf = P.p[7][i], ha = P.p[8][i];
  const float tau = P.p[9][i], K = P.p[10][i], M = P.p[11][i];

  const float c = wave_speed(c0, a, P.shallow[i], 10000.0f, false);
  const float vr = c - P.vsca;

  // droplet temperature, 50 fixed RK steps (VI:262-281)
  const float h = tau > 0.0f ? tau / 50.0f : 0.0f;
  float td = sst;
  for (int s = 0; s < 50; ++s) {
    const float k1 = (M - kPt2 * td) - K * icing_f1(td);
    const float y2 = td + 0.5f * h * k1;
    const float k2 = (M - kPt2 * y2) - K * icing_f1(y2);
    const float y3 = td + 0.5f * h * k2;
    const float k3 = (M - kPt2 * y3) - K * icing_f1(y3);
    const float y4 = td + h * k3;
    const float k4 = (M - kPt2 * y4) - K * icing_f1(y4);
    td = td + h * (kSixth * (((k1 + 2.0f * k2) + 2.0f * k3) + k4));
  }
  td = tau > 0.0f ? td : sst;

  FpConst F;
  F.tf = tf;
  F.td = td;
  F.at = airtemp;
  F.rh = rh;
  F.f1_air = icing_f1(airtemp);
  F.hk = ha / 333000.0f;
  const float rw_base = kRw * wave * (vr * vr);
  float ice = 0.0f;
  for (int k = 0; k < P.number; ++k) {
    const float rw = rw_base * __ldg(P.decay + k) * v;
    const float n = modstall_fp(rw, F);
    ice = ice + n * (rw / 890.0f) * 3600.0f * 100.0f;
  }
  P.out[i] = fabsf(ice / static_cast<float>(P.number));
}

int launch_grid(int n, dim3* g) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  *g = dim3(static_cast<unsigned>((n + kBlock - 1) / kBlock));
  return 0;
}

}  // namespace

extern "C" {

// B5.  planes: host array of 17 device pointers (icing_fused._PLANES);
// gate / shallow / skip0: bool planes; decay: `number` floats on the
// device; out: n floats.  Launches on `stream`; returns cudaGetLastError()
// as an int.
int mf_vessel_icing_mincog(const float* const* planes, const bool* gate,
                           const bool* shallow, const bool* skip0,
                           const float* decay, int number, float vsca,
                           int alt, float* out, int n, void* stream) {
  MincogParams P{};
  dim3 g;
  if (number < 1 || launch_grid(n, &g) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int k = 0; k < 17; ++k) P.p[k] = planes[k];
  P.gate = gate;
  P.shallow = shallow;
  P.skip0 = skip0;
  P.decay = decay;
  P.number = number;
  P.vsca = vsca;
  P.alt = alt;
  P.out = out;
  P.n = n;
  mincog_kernel<<<g, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

// B6.  planes: host array of 12 device pointers (icing_fused._MS_PLANES);
// otherwise as mf_vessel_icing_mincog.
int mf_vessel_icing_modstall(const float* const* planes, const bool* gate,
                             const bool* shallow, const float* decay,
                             int number, float vsca, float* out, int n,
                             void* stream) {
  ModstallParams P{};
  dim3 g;
  if (number < 1 || launch_grid(n, &g) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int k = 0; k < 12; ++k) P.p[k] = planes[k];
  P.gate = gate;
  P.shallow = shallow;
  P.decay = decay;
  P.number = number;
  P.vsca = vsca;
  P.out = out;
  P.n = n;
  modstall_kernel<<<g, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
