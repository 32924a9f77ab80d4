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
// What bounds it: device-memory bytes, and the rate at which this card
// takes 21 output planes written at once.  Per point the work is a few
// dozen flops, a table lookup and a 41-step compare count, against 4 f32 +
// 4 mask bytes read and 12 f32 + 9 mask bytes written (1.655 GB masked,
// 1.419 GB all-defined at 32x719x929: 0.4939 / 0.4235 ms at the published
// 3.35 TB/s).  The first design (32x8 tiles, one thread a point, |grad T|
// recomputed at the 4 neighbours for TFP) ran at the time of a copy with
// its own access pattern (the probe P1, csrc/probes.cu), ~48% of 3.35
// TB/s; the TPU lab's x + 1 into 12 buffers (P2) also moves ~1.75 TB/s.
//
// Design:
// - one thread a point, 256-thread blocks over 64x4 tiles of a level
//   (gridDim.z = nlev): a warp still writes 128 bytes of a value plane or
//   32 bytes of a mask plane a store, but a block's part of each plane is 4
//   rows of 256 (64) bytes instead of 8 rows of 128 (32), and the tile's
//   halo rows stay few;
// - |grad T| and its gate (tk defined at the 4 neighbours) are computed
//   once per clamped point of the tile's window (the tile and a one-point
//   ring, 396 points for 256) into shared memory, and TFP reads its 4
//   neighbours there: 44 loads a point instead of 80, 949 SASS
//   instructions instead of 1108 (masked; 742 instead of 896 all-defined);
// - every phase is a block-stride loop, so the source also runs on the
//   host with one thread per block (tests/test_torch_fused_host.py).
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py
// --pipeline-times, the launch alone, 3 pairs against the first design):
// masked 1.0059-1.0155 ms against 1.0387-1.0399, all-defined 0.8003-0.8030
// against 0.9394-0.9406, the isobaric 11 surfaces 0.3639-0.3705 against
// 0.3841-0.3854: ~1.63 / ~1.77 TB/s, the 12-buffer rate of P2.  Staging
// the planes in shared memory and writing them in 16-byte bursts (per flat
// chunk of a plane or per tile row), smaller or larger tiles, and capping
// or raising the blocks an SM holds were measured and were slower on the
// masked route (PERF.md section 6).
//
// fillEdges (copy column 1 -> 0 and nx-2 -> nx-1, then row 1 -> 0 and
// ny-2 -> ny-1) equals evaluating the raw stencil at the clamped point
// (clamp(y, 1, ny-2), clamp(x, 1, nx-2)), whose neighbours always lie in
// range.  TFP reads the *filled* |grad T| at its 4 neighbours; each is
// the raw value at its own clamped point, taken from the tile's window.
//
// A shard of a domain-decomposed grid (parallel/fused.py) is the block
// whose local (0, 0) sits at global (row0, col0), negative on halo rows,
// in a global (nyg, nxg) grid.  fillEdges then fires only at the global
// edges: the clamp keeps to global rows [1, nyg-2] and columns
// [1, nxg-2], and also to the local [1, ny-2] x [1, nx-2], so that a
// point on a halo row never reads outside the block (the halo rows of the
// output are cropped).  The host turns the offsets into the clamp bounds
// [ylo, yhi] x [xlo, xhi]; the unsharded grid is row0 = col0 = 0 and
// (nyg, nxg) = (ny, nx), the bounds [1, ny-2] x [1, nx-2].
//
// Numerics: built with -fmad=false and without --use_fast_math (see
// common.cuh, which holds the constants, the EWT table, the deterministic
// pow and the table lookups this kernel shares with the others).  Every
// output is the plain version's sequence of float32 operations
// (ops/fused.derived_fields_plain); the kernel equals it bit for bit.

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileX = 64;              // a block's tile: kTileX x kTileY
constexpr int kTileY = 4;               // points of one level
constexpr int kPoints = kTileX * kTileY;
// |grad T| and its gate on the tile and a one-point halo (clamped points)
constexpr int kHaloX = kTileX + 2;
constexpr int kHalo = kHaloX * (kTileY + 2);

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
  int ny, nx;
  int ylo, yhi, xlo, xhi;   // the clamp: rows [ylo, yhi], columns [xlo, xhi]
  int64_t plane_stride;   // elements from one output plane to the next
};

// Raw |grad T| at an interior point r of the level plane t.
__device__ __forceinline__ float grad_abs(const float* t, const float* xmapr,
                                          const float* ymapr, int r, int nx) {
  const float dfdx = 0.5f * __ldg(xmapr + r) *
                     (__ldg(t + r + 1) - __ldg(t + r - 1));
  const float dfdy = 0.5f * __ldg(ymapr + r) *
                     (__ldg(t + r + nx) - __ldg(t + r - nx));
  return sqrtf(dfdx * dfdx + dfdy * dfdy);
}

// tk defined at the 4 neighbours of interior point r (gradient's mask).
__device__ __forceinline__ bool ring4(const uint8_t* m, int r, int nx) {
  return __ldg(m + r - 1) && __ldg(m + r + 1) && __ldg(m + r - nx) &&
         __ldg(m + r + nx);
}

// kSharded: the clamp bounds come from P (a shard); without it they are
// the constants [1, ny-2] x [1, nx-2], which keep the unsharded kernel's
// registers (48 masked, against 61 with the bounds read from P).
template <bool kAllDefined, bool kSharded>
__global__ void __launch_bounds__(kThreads)
derived_fields_kernel(const Params P) {
  __shared__ float s_grad[kHalo];
  __shared__ uint8_t s_gate[kHalo];
  const int nx = P.nx, ny = P.ny;
  const int x0 = blockIdx.x * kTileX;
  const int y0 = blockIdx.y * kTileY;
  const int lev = blockIdx.z;
  const int64_t lev0 = static_cast<int64_t>(lev) * ny * nx;
  const float* tk = P.tk + lev0;
  const float* qf = P.q + lev0;
  const float* uf = P.u + lev0;
  const float* vf = P.v + lev0;
  // the mask pointers are null on the all-defined route
  const uint8_t* tkm = kAllDefined ? nullptr : P.tkm + lev0;
  const uint8_t* qm = kAllDefined ? nullptr : P.qm + lev0;
  const uint8_t* um = kAllDefined ? nullptr : P.um + lev0;
  const uint8_t* vm = kAllDefined ? nullptr : P.vm + lev0;
  float* ov = P.out_values + lev0;
  uint8_t* om = P.out_masks + lev0;
  const float a_l = __ldg(P.alevel + lev);
  const float b_l = __ldg(P.blevel + lev);
  const int ylo = kSharded ? P.ylo : 1, yhi = kSharded ? P.yhi : ny - 2;
  const int xlo = kSharded ? P.xlo : 1, xhi = kSharded ? P.xhi : nx - 2;
  // The clamped points the tile's TFP reads (its points' clamped points
  // and their clamped neighbours) lie in rows wy .. wy + kTileY + 1 and
  // columns wx .. wx + kTileX + 1: entry (iy, ix) holds the raw |grad T|
  // and gate at (min(wy + iy, yhi), min(wx + ix, xhi)).
  const int wy = max(min(max(y0, ylo), yhi) - 1, ylo);
  const int wx = max(min(max(x0, xlo), xhi) - 1, xlo);
  for (int h = threadIdx.x; h < kHalo; h += blockDim.x) {
    const int yy = min(wy + h / kHaloX, yhi);
    const int xx = min(wx + h % kHaloX, xhi);
    const int r = yy * nx + xx;
    s_grad[h] = grad_abs(tk, P.xmapr, P.ymapr, r, nx);
    if (!kAllDefined) s_gate[h] = ring4(tkm, r, nx);
  }
  __syncthreads();

  for (int pt = threadIdx.x; pt < kPoints; pt += blockDim.x) {
    const int y = y0 + pt / kTileX;
    const int x = x0 + pt % kTileX;
    if (y >= ny || x >= nx) continue;
    const int i2 = y * nx + x;
    float* o = ov + i2;
    uint8_t* m = om + i2;
    // ---- elementwise family (levels.py formulas) -----------------------
    const float tkv = __ldg(tk + i2);
    const float qv = __ldg(qf + i2);
    const float uv = __ldg(uf + i2);
    const float vv = __ldg(vf + i2);
    const float p_raw = a_l + b_l * __ldg(P.ps + i2);
    const float pidcp = pow_kappa(p_raw * kP0inv);
    bool psm = true, tkd = true, qd = true, ud = true, vd = true;
    if (!kAllDefined) {
      psm = __ldg(P.psm + i2);
      tkd = __ldg(tkm + i2);
      qd = __ldg(qm + i2);
      ud = __ldg(um + i2);
      vd = __ldg(vm + i2);
    }
    // alevelhum quirk: an undefined ps lets the sentinel into qsat
    const float p_sent = psm ? p_raw : kUndef;
    bool ok;
    int l;
    const float et = esat(tkv, &ok, &l);
    const float qsat = kEps * et / p_sent;
    const float rhc = clip_nan(qv / qsat, kRhmin, kRhmax);

    o[0 * P.plane_stride] = p_raw;
    o[1 * P.plane_stride] = tkv / pidcp;
    o[2 * P.plane_stride] = 100.0f * qv / qsat;
    o[3 * P.plane_stride] = ewt_inverse(rhc * et, l) + kT0;
    o[4 * P.plane_stride] = (tkv * kCp + qv * kXlh) / (kCp * pidcp);
    o[5 * P.plane_stride] =
        kDuct1 * (p_raw / tkv) + kDuct2 * (qv * p_raw) / (kEps * tkv * tkv);
    o[6 * P.plane_stride] = sqrtf(uv * uv + vv * vv);

    // ---- radius-1 stencils at the clamped point (fillEdges) ------------
    const int cy = min(max(y, ylo), yhi);
    const int cx = min(max(x, xlo), xhi);
    const int r = cy * nx + cx;
    const float xm = __ldg(P.xmapr + r);
    const float ym = __ldg(P.ymapr + r);
    const float dtx = __ldg(tk + r + 1) - __ldg(tk + r - 1);
    const float dty = __ldg(tk + r + nx) - __ldg(tk + r - nx);

    o[7 * P.plane_stride] =
        0.5f * xm * (__ldg(vf + r + 1) - __ldg(vf + r - 1)) -
        0.5f * ym * (__ldg(uf + r + nx) - __ldg(uf + r - nx));
    o[8 * P.plane_stride] =
        0.5f * xm * (__ldg(uf + r + 1) - __ldg(uf + r - 1)) +
        0.5f * ym * (__ldg(vf + r + nx) - __ldg(vf + r - nx));
    o[9 * P.plane_stride] = (__ldg(uf + r) * 0.5f * xm * dtx +
                             __ldg(vf + r) * 0.5f * ym * dty) * kAdvScale;

    // ---- |grad T| (filled) and TFP --------------------------------------
    // filled |grad T| at the 4 neighbours = raw at their clamped points
    const int cxm = max(cx - 1, xlo), cxp = min(cx + 1, xhi);
    const int cym = max(cy - 1, ylo), cyp = min(cy + 1, yhi);
    const int hc = (cy - wy) * kHaloX + (cx - wx);
    const int hxm = hc + cxm - cx, hxp = hc + cxp - cx;
    const int hym = hc + (cym - cy) * kHaloX, hyp = hc + (cyp - cy) * kHaloX;
    const float a_c = s_grad[hc];
    bool g_c = true, g_ring = true;
    if (!kAllDefined) {
      g_c = s_gate[hc];
      g_ring = s_gate[hxm] && s_gate[hxp] && s_gate[hym] && s_gate[hyp];
    }
    o[10 * P.plane_stride] = a_c;
    const float dadx = 0.5f * xm * (s_grad[hxp] - s_grad[hxm]);
    const float dady = 0.5f * ym * (s_grad[hyp] - s_grad[hym]);
    const bool nonzero = a_c != 0.0f;
    const float ainv = 1.0f / (nonzero ? a_c : 1.0f);
    const float dtdxa = 0.5f * xm * dtx * ainv;
    const float dtdya = 0.5f * ym * dty * ainv;
    o[11 * P.plane_stride] = -(dadx * dtdxa + dady * dtdya);

    if (kAllDefined) {
      m[0] = ok;
      m[P.plane_stride] = nonzero;
    } else {
      const bool vort_m = __ldg(vm + r - 1) && __ldg(vm + r + 1) &&
                          __ldg(um + r - nx) && __ldg(um + r + nx);
      m[0 * P.plane_stride] = psm;
      m[1 * P.plane_stride] = tkd && psm;
      m[2 * P.plane_stride] = tkd && qd && ok;
      m[3 * P.plane_stride] = tkd && qd && psm;
      m[4 * P.plane_stride] = ud && vd;
      // also divergence's mask (reference quirk)
      m[5 * P.plane_stride] = vort_m;
      m[6 * P.plane_stride] = __ldg(um + r) && __ldg(vm + r) && g_c;
      m[7 * P.plane_stride] = g_c;
      m[8 * P.plane_stride] = g_c && nonzero && g_ring;
    }
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns cudaGetLastError() as an int.
// Mask pointers may be null when all_defined != 0 (they are not read).
// out_masks holds 2 planes when all_defined != 0, else 9.  (row0, col0) is
// the global position of the local (0, 0) in a global (nyg, nxg) grid;
// the unsharded call passes 0, 0, ny, nx.  A block that holds no point of
// the global interior's clamp window is refused.  out_plane_stride is the
// distance, in elements, from one output plane to the next, the same for
// the value planes (floats) and the mask planes (bytes): 0 is the dense
// nlev * ny * nx; a member's slot in a [planes, nmem, nlev, ny, nx] stack
// passes nmem * nlev * ny * nx.  A stride below nlev * ny * nx is refused.
int mf_derived_fields(const float* tk, const float* q, const float* u,
                      const float* v, const uint8_t* tkm, const uint8_t* qm,
                      const uint8_t* um, const uint8_t* vm, const float* ps,
                      const uint8_t* psm, const float* alevel,
                      const float* blevel, const float* xmapr,
                      const float* ymapr, float* out_values,
                      uint8_t* out_masks, int nlev, int ny, int nx,
                      int row0, int col0, int nyg, int nxg,
                      int all_defined, int64_t out_plane_stride,
                      void* stream) {
  const int64_t plane = static_cast<int64_t>(ny) * nx;
  if (nlev < 1 || nlev > 65535 || ny < 3 || nx < 3 ||
      (ny + kTileY - 1) / kTileY > 65535 || plane > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t dense = plane * nlev;
  if (out_plane_stride == 0) out_plane_stride = dense;
  if (out_plane_stride < dense) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ylo = std::max(1, 1 - row0);
  const int yhi = std::min(ny - 2, nyg - 2 - row0);
  const int xlo = std::max(1, 1 - col0);
  const int xhi = std::min(nx - 2, nxg - 2 - col0);
  if (ylo > yhi || xlo > xhi) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params P{tk, q, u, v, tkm, qm, um, vm, ps, psm, alevel, blevel,
                 xmapr, ymapr, out_values, out_masks, ny, nx,
                 ylo, yhi, xlo, xhi, out_plane_stride};
  const dim3 grid((nx + kTileX - 1) / kTileX, (ny + kTileY - 1) / kTileY,
                  nlev);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool sharded = row0 != 0 || col0 != 0 || nyg != ny || nxg != nx;
  if (all_defined && sharded) {
    derived_fields_kernel<true, true><<<grid, kThreads, 0, s>>>(P);
  } else if (all_defined) {
    derived_fields_kernel<true, false><<<grid, kThreads, 0, s>>>(P);
  } else if (sharded) {
    derived_fields_kernel<false, true><<<grid, kThreads, 0, s>>>(P);
  } else {
    derived_fields_kernel<false, false><<<grid, kThreads, 0, s>>>(P);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* mf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
