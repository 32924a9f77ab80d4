"""Vessel-icing operators: Overland, Mertins, Modified Stallabrass, MINCOG.

Port of :mod:`mi_fieldcalc_tpu.ops.icing` (``icing.py:54-127, 226-741,
870-1250``).  Reference: FieldCalculationsVesselIcing.cc (VI).

Overland and Mertins are elementwise.  ModStall and MINCOG are per-point
iterative solvers: a c-independent prologue (:func:`_modstall_static`,
:func:`_mincog_static`, which need ``pow``, ``arcsin``, ``sin`` and
``cos``) and a c-dependent core (:func:`_modstall_core`,
:func:`_mincog_core`: the shallow-water wave-speed fixed point, the 50-step
droplet Runge-Kutta and the per-height freezing-fraction solve).  The
cores are the plain versions of the CUDA kernels in
``csrc/vessel_icing.cu``, which run the same arithmetic per point.

The JAX package's whole-array ``lax.while_loop`` fixed points are Python
loops over tensors here: each ends when every lane is done or at its cap,
and a finished lane holds its state exactly, so a lane's result does not
depend on how long the other lanes run.  The JAX unroll factors, the
warm-start and stacked-height variants and the ``MF_*`` lab switches are
not ported: the port runs the shipped cold, exact solves and reads no
environment variable.

Numerics: every division divides a tensor by a tensor on the same device.
PyTorch turns ``tensor / number`` on CUDA and ``number / tensor`` on every
device into a multiply by a reciprocal, which is not the IEEE quotient the
kernels and the JAX package compute.  ``exp``, ``tanh`` and ``log`` are the
deterministic ``_libm`` functions; ``min``, ``max`` and ``clip`` propagate
NaN, as ``jnp`` does.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .._libm import exp_f32, log_f32, tanh_f32
from ..constants import t0
from ..field import Field, f32
from ._harness import and_masks, const as _c, div as _div, out_field, require

__all__ = [
    "vessel_icing_overland", "vessel_icing_mertins",
    "vessel_icing_modstall", "vessel_icing_mincog",
]

#: the reference's bisection bracket in N (VI:391)
_BISECT_A, _BISECT_B = -0.5, 1.3
#: safeguarded-Newton iterations per height (icing.py:910)
_NEWTON_ITERS = 8
_INF = float("inf")


def _max(a: torch.Tensor, b) -> torch.Tensor:
    """``jnp.maximum``: NaN in either operand gives NaN."""
    return torch.maximum(a, b if isinstance(b, torch.Tensor) else _c(b, a))


def _min(a: torch.Tensor, b) -> torch.Tensor:
    """``jnp.minimum``: NaN in either operand gives NaN."""
    return torch.minimum(a, b if isinstance(b, torch.Tensor) else _c(b, a))


def _icing_f1(t: torch.Tensor) -> torch.Tensor:
    """Magnus-type saturation vapour pressure (VI:53-57)."""
    return f32(0.6112) * exp_f32(_div(f32(17.67) * t, t + f32(243.5)))


def _kt4(t_celsius: torch.Tensor) -> torch.Tensor:
    """Stefan-Boltzmann T^4 (VI:65-70)."""
    tk = t_celsius + float(t0)
    t2 = tk * tk
    return f32(5.67e-8) * t2 * t2


def _stallabrass_tf(sal: torch.Tensor) -> torch.Tensor:
    """Freezing point of sea water, Stallabrass (1980) (VI:95)."""
    return (f32(-0.002) - f32(0.0524) * sal) - f32(6.0e-5) * sal * sal


def vessel_icing_overland(airtemp: Field, seatemp: Field, u: Field, v: Field,
                          sal: Field, aice: Field) -> Field:
    """Overland (1990) icing rate; cubic in the icing predictor
    (VI:77-112).  Undefined where ice cover >= 0.4 or SST below the brine
    freezing point."""
    mask = and_masks(airtemp, seatemp, u, v, sal, aice)
    gate = mask & (aice.values < f32(0.4))
    tf = _stallabrass_tf(sal.values)
    gate = gate & ~(seatemp.values < tf)
    ff = torch.sqrt(u.values ** 2 + v.values ** 2)
    ppr = _div(ff * (tf - airtemp.values),
               1 + f32(0.3) * (seatemp.values - tf))
    out = f32(2.73e-2) * ppr + f32(2.91e-4) * (ppr * ppr) \
        + f32(1.84e-6) * ppr * ppr * ppr
    return out_field(out, gate)


def vessel_icing_mertins(airtemp: Field, seatemp: Field, u: Field, v: Field,
                         sal: Field, aice: Field) -> Field:
    """Mertins (1968) discrete icing-rate lookup: 4 wind bands x SST-scaled
    temperature thresholds (VI:114-180)."""
    mask = and_masks(airtemp, seatemp, u, v, sal, aice)
    gate = mask & (aice.values < f32(0.4))
    tf = _stallabrass_tf(sal.values)
    gate = gate & ~(seatemp.values < tf)

    ff = torch.sqrt(u.values ** 2 + v.values ** 2)
    tt = airtemp.values
    sst = seatemp.values

    # wind bands (VI:136-154): thresholds temp1/temp2/temp3 per band
    b0 = (f32(-1.15) * sst - f32(4.3), f32(-1.5) * sst - f32(10),
          torch.full_like(sst, f32(-10000.0)))
    b1 = (f32(-0.6) * sst - f32(3.2), f32(-1.05) * sst - f32(5.6),
          f32(-1.75) * sst - f32(12.5))
    b2 = (f32(-0.3) * sst - f32(2.6), f32(-0.66) * sst - f32(3.32),
          f32(-1.325) * sst - f32(7.651))
    b3 = (f32(-0.14) * sst - f32(2.28), f32(-0.3) * sst - f32(2.6),
          f32(-1.16) * sst - f32(5.22))

    in1 = ff < f32(17.2)
    in2 = ff < f32(20.8)
    in3 = ff < f32(28.5)

    def pick(i):
        return torch.where(in1, b0[i], torch.where(in2, b1[i],
                           torch.where(in3, b2[i], b3[i])))

    temp1, temp2, temp3 = pick(0), pick(1), pick(2)
    # lowest band quirk (VI:163): "temperature <= temp3 || ff < 17.2" selects
    # 4.375 cm/h instead of 6.25 for the first wind band.
    low = torch.where((tt <= temp3) | in1, f32(4.375), f32(6.25))
    zero = torch.zeros_like(tt)
    rate = torch.where(tt > f32(-2), zero,
                       torch.where(tt > temp1, f32(0.8333),
                                   torch.where(tt > temp2, f32(2.0833), low)))
    out = torch.where(ff >= f32(10.8), rate, zero)
    return out_field(out, gate)


# ---------------------------------------------------------------------------
# shared solver building blocks
# ---------------------------------------------------------------------------

def _count(trips: Optional[dict], key: str, active: torch.Tensor,
           part=None) -> None:
    """Add the number of lanes that take this step to ``trips[key]`` (the
    operation count behind a kernel's bound): ``wave_warm`` /
    ``wave_newton`` and ``height_warm`` / ``height_newton`` fixed-point
    lane-steps before and after the warmup, ``cap`` / ``height_cap`` lanes
    through the post-loop cap prediction, ``tanh_poly`` / ``tanh_exp``
    tanh evaluations by branch, and MINCOG's lane-heights by branch
    (``h_root``, ``h_noroot``, ``h_sal0``).

    Where ``trips`` holds a dict under ``"lanes"``, each lane's own count
    is added there too, as an int32 tensor of the lanes' shape: under
    ``key``, or under ``(key, part)`` for the work of one part of the
    solve, a height index or ``"cap"`` for the wave cap prediction (the
    scheduling model of the kernels' warps)."""
    if trips is not None:
        trips[key] = trips.get(key, 0) + int(active.sum())
        lanes = trips.get("lanes")
        if lanes is not None:
            name = key if part is None else (key, part)
            lanes[name] = lanes.get(name, 0) + active.to(torch.int32)


def _tanh(x, trips: Optional[dict], active, part=None):
    """``tanh_f32``, counting the ``active`` lanes that need its polynomial
    (|x| < 0.625) and its exp form (0.625 <= |x| <= 9; beyond 9 it is a
    sign)."""
    if trips is not None:
        ax = x.abs()
        _count(trips, "tanh_poly", active & (ax < 0.625), part)
        _count(trips, "tanh_exp", active & (ax >= 0.625) & (ax <= 9.0), part)
    return tanh_f32(x)


def _wave_speed_fixed_point(c0, a, needs_iter, max_iter: int, tol: float,
                            warmup: int = 32, ref_f32: bool = False,
                            trips: Optional[dict] = None):
    """Shallow-water wave speed c = c0 * tanh(a / c), iterated from c = 1
    until |dc| <= tol with the reference's diverged => 0 semantics
    (``icing.py:226-374``; ModStall VI:221-237, Mincog VI:494-508).

    ``warmup`` exact map steps, then Newton on ``c - c0*tanh(a/c)`` with
    the residual exit widened to ``2e-5*|c|``; a lane still live at
    ``warmup + 64`` is forced.  Newton-resolved lanes take the
    reference's cap decision from :func:`_wave_cap_predict`, and with
    ``ref_f32`` (MINCOG's float reference) also its stall test.
    ``needs_iter`` marks the lanes in the shallow-water branch; the others
    return ``c0``."""
    c = torch.where(needs_iter, torch.ones_like(c0), c0)
    c_sw = c
    done_i = (~needs_iter).to(torch.int32)
    tolf = f32(tol)
    loop_cap = warmup + 64
    j = 0
    while j < loop_cap and not bool((done_i != 0).all()):
        done = done_i != 0
        j1 = j + 1
        newton_phase = j1 > warmup
        _count(trips, "wave_newton" if newton_phase else "wave_warm", ~done)
        t = _tanh(_div(a, c), trips, ~done)
        g = c0 * t
        gp = _div((c0 * a) * (1.0 - t * t), c * c)
        err1 = (g - c).abs()
        if j1 == warmup + 1:
            c_sw = torch.where(~done, c, c_sw)
        if newton_phase:
            thr = _max(_c(tolf, c), f32(2e-5) * c.abs())
        else:
            thr = tolf
        conv = (~done) & (err1 <= thr)
        if newton_phase:
            # root is in (0, c0]: clip for safety (jnp.clip order)
            c_next = _min(_max(c - _div(c - g, 1.0 + gp), tolf), c0)
        else:
            c_next = g
        forced = (~done) & (j1 >= loop_cap)
        # warmup freezes at the map output g, Newton at the root c; a lane
        # forced at the cap in the Newton phase keeps its iterate
        c_out = torch.where(
            done, c,
            torch.where(conv & (not newton_phase), g,
                        torch.where(forced & (not newton_phase),
                                    torch.zeros_like(c), c)))
        c_out = torch.where((~done) & ~(conv | forced), c_next, c_out)
        stop = conv | forced
        di = torch.where(done, done_i, torch.where(
            stop, torch.full_like(done_i, 2 if newton_phase else 1),
            torch.zeros_like(done_i)))
        c, done_i, j = c_out, di, j1
    _count(trips, "cap", done_i == 2)
    jpred = _wave_cap_predict(c0, a, c, c_sw, tol, warmup, trips=trips,
                              active=done_i == 2)
    conv_ok = jpred <= f32(max_iter)
    if ref_f32:
        # the float reference also stalls when its stationary noise step
        # eps*r*(1+s)/(1-s) stays above ~tol (calibrated 3e-5,
        # icing.py:356-371)
        rr = _max(c, tolf)
        t_r = tanh_f32(_div(a, rr))
        s = _div((c0 * a) * (1.0 - t_r * t_r), rr * rr)
        floor_step = _div((1.0 + s) * f32(1.19e-7) * rr,
                          _max(1.0 - s, f32(1e-7)))
        conv_ok = conv_ok & (floor_step < f32(3e-5))
    newton_val = torch.where(conv_ok, c, torch.zeros_like(c))
    out = torch.where(done_i == 2, newton_val, c)
    return torch.where(needs_iter, out, c0)


def _wave_cap_predict(c0, a, r, c_sw, tol: float, warmup: int,
                      nodes: int = 16, trips: Optional[dict] = None,
                      active=None):
    """Predicted f64 iteration count of the wave-speed map from the switch
    iterate ``c_sw`` to the |dc| <= tol exit, given the Newton root ``r``
    (``icing.py:377-433``): the log-amplitude ODE integral
    ``warmup + 2 * int d(ln u) / (-ln q(u))`` by the trapezoid rule on
    ``nodes`` log-spaced intervals, with the cancellation-free tanh
    difference.  ``s >= 1`` (the map diverges at the root) gives 1e9.
    ``trips`` counts the ``active`` lanes' tanh evaluations."""
    tolf = f32(tol)
    rr = _max(r, tolf)
    t_r = _tanh(_div(a, rr), trips, active, "cap")
    s = _div((c0 * a) * (1.0 - t_r * t_r), rr * rr)
    u_end = _div(tolf, 1.0 + s)
    u_sw = _max((c_sw - rr).abs(), u_end)
    side = torch.where(c_sw >= rr, f32(1.0), f32(-1.0))
    ln_lo = log_f32(u_end)
    dln = _div(log_f32(u_sw) - ln_lo, f32(nodes))

    def gdiff(du):
        # g(r + du) - r for a signed amplitude du, cancellation-free
        x = rr + du
        xs = _max(x.abs(), f32(1e-20)) * torch.where(x < 0, f32(-1.0),
                                                      f32(1.0))
        tx = _tanh(_div(a, xs), trips, active, "cap")
        td = _tanh(_div(-(a * du), xs * rr), trips, active, "cap")
        return c0 * td * (1.0 - tx * t_r)

    acc = torch.zeros_like(c0 + r)
    for i in range(nodes + 1):
        u = exp_f32(ln_lo + float(i) * dln)
        d1 = gdiff(side * u)
        d2 = gdiff(d1)
        q = _div(d2.abs(), u)
        mln = _max(-log_f32(_min(q, f32(1.0 - 1e-7))), f32(1e-7))
        w = 0.5 if i in (0, nodes) else 1.0
        acc = acc + w * _div(2.0, mln)
    jpred = f32(warmup) + dln * acc
    return torch.where(s < 1.0, jpred, torch.full_like(jpred, f32(1e9)))


def _runge_kutta_modstall(y, h, M, K):
    """The droplet-temperature RK step of ModStall (VI:262-281)."""
    def f10mk(t):
        return (M - f32(0.2) * t) - K * _icing_f1(t)

    k1 = f10mk(y)
    y2 = y + 0.5 * h * k1
    k2 = f10mk(y2)
    y3 = y + 0.5 * h * k2
    k3 = f10mk(y3)
    y4 = y + h * k3
    return y + h * (f32(1.0 / 6.0)
                    * (((k1 + 2.0 * k2) + 2.0 * k3) + f10mk(y4)))


def _modstall_static(sal, wave, x_wind, y_wind, airtemp, rh, p, pw, depth,
                     gate):
    """The c-independent ModStall prologue (``icing.py:436-452``); it
    needs ``pow`` and stays in PyTorch for both routes.  Returns
    ``(v, c0, shallow, a, tf, ha, tau, K, M)``."""
    del wave
    c0 = f32(9.81 / (2 * math.pi)) * pw
    shallow = (depth <= c0 * pw) & (c0 != 0) & gate
    a = _div(f32(2 * math.pi) * depth,
             torch.where(pw != 0, pw, torch.ones_like(pw))) \
        * torch.where(pw != 0, f32(1.0), _INF)
    v = torch.sqrt(x_wind ** 2 + y_wind ** 2)
    tf = _stallabrass_tf(sal)
    ha = f32(5.17) * torch.pow(v, f32(0.8))                 # VI:248
    tau = f32(11.25) - _div(v, 4.0)                          # VI:256
    K = _div(311000.0, _div(p, 10.0) * f32(1005.0))
    M = f32(0.2) * airtemp + K * rh * _icing_f1(airtemp)
    return v, c0, shallow, a, tf, ha, tau, K, M


def _modstall_fp(rw, gate, tf, td, at, rhv, f1_air, hk, ratio,
                 warmup: int = 32, trips: Optional[dict] = None,
                 height: Optional[int] = None):
    """The freezing-fraction fixed point for spray flux ``rw``
    (``icing.py:537-684``): ``warmup`` exact map steps, then
    Newton-accelerated steps where the map contracts and the oscillation
    envelope stays inside [0, 1]; exit on the reference's |n1 - n|
    criterion (widened to the float32 residual floor after the warmup),
    forced at ``warmup + 96``; the post-loop single-rate prediction
    applies the reference's 1000-iteration cap.  Returns clip(n, 0, 1).
    ``height`` labels the per-lane counts (:func:`_count`)."""
    tolf = f32(1e-5)
    loop_cap = warmup + 96
    d_f1 = f32(17.67 * 243.5)
    c012 = f32(0.012012012)

    def _map(n):
        ts = (1.0 + n) * tf
        f1ts = _icing_f1(ts)
        ri = (c012 * rw * (ts - td)
              + hk * ((ts - at) + ratio * (f1ts - rhv * f1_air)))
        n1 = _div(ri, rw)
        tsq = ts + f32(243.5)
        f1p = _div(f1ts * d_f1, tsq * tsq)
        B = _div(tf * (c012 * rw + hk * (1.0 + ratio * f1p)), rw)
        ri_mag = (c012 * rw * (ts - td).abs()
                  + hk * ((ts - at).abs() + ratio * (f1ts + rhv * f1_air)))
        return n1, B, _div(f32(8e-7) * ri_mag, rw)

    n = torch.zeros_like(rw)
    err_sw = torch.ones_like(rw)
    di = (~gate).to(torch.int32)
    j = 0
    while j < loop_cap and not bool((di != 0).all()):
        done = di != 0
        j1 = j + 1
        newton_phase = j1 > warmup
        _count(trips, "height_newton" if newton_phase else "height_warm",
               ~done, height)
        n1, B, floor = _map(n)
        err1 = (n1 - n).abs()
        absB = B.abs()
        contracting = absB < f32(1.0 - 1e-6)
        if j1 == warmup + 1:
            err_sw = torch.where(~done, err1, err_sw)
        thr = _max(_c(tolf, n), floor) if newton_phase else tolf
        conv = (~done) & (err1 <= thr)
        root = _div(n1 - B * n, 1.0 - B)
        amp_env = _div(absB * absB * err1, 1.0 + absB)
        inside = (n1 >= 0.0) & (n1 <= 1.0)
        env_ok = (inside & (root + amp_env <= 1.0)
                  & (root - amp_env >= 0.0))
        use_newton = env_ok & contracting & newton_phase
        n_next = torch.where(use_newton, root, n1)
        forced = (~done) & (j1 >= loop_cap)
        stop = conv | forced
        n = torch.where(done, n, torch.where(stop, n1, n_next))
        escaped = conv | (n1 < 0) | (n1 > 1)
        di = torch.where(done, di, torch.where(
            stop & newton_phase, torch.full_like(di, 2),
            torch.where(escaped, torch.ones_like(di), torch.zeros_like(di))))
        j = j1
    # cap resolution for the lanes stopped after the warmup (di == 2)
    _count(trips, "height_cap", di == 2, height)
    n1f, Bf, _ = _map(n)
    absB = Bf.abs()
    lB = log_f32(_max(absB, f32(1e-30)))
    rem = _div(log_f32(_div(tolf, _max(err_sw, tolf))),
               torch.where(lB < 0, lB, _c(-1e-30, lB)))
    capped_c = (absB < 1.0) & (f32(warmup) + rem > 1000.0)
    errf = (n1f - n).abs()
    amp = _div(errf, 1.0 + absB)
    esc_rem = _div(log_f32(_div(2.0, _max(amp, f32(1e-30)))),
                   torch.where(lB > 0, lB, _c(1e-30, lB)))
    capped_d = (absB >= 1.0) & (errf > tolf) \
        & (f32(loop_cap) + esc_rem > 1000.0)
    n = torch.where((di == 2) & (capped_c | capped_d), torch.zeros_like(n),
                    n)
    return n.clamp(0.0, 1.0)


def _modstall_core(c0, a, shallow, gate, wave, v, sst, airtemp, rh, tf,
                   ha, tau, K, M, vsca: float, decay,
                   trips: Optional[dict] = None):
    """The c-dependent ModStall solve (``icing.py:455-709``): wave fixed
    point, 50-step droplet RK, and the per-height freezing-fraction fixed
    point with a cold start and the exact 32-step warmup at every height.
    ``decay`` holds the float32 per-height factors.  The plain version of
    kernel B6."""
    number = len(decay)
    c = _wave_speed_fixed_point(c0, a, shallow, 10000, 1e-5, trips=trips)
    vr = c - f32(vsca)
    ratio = f32(89.5 / 5.17)                  # VI:251
    h = torch.where(tau > 0, _div(tau, 50.0), torch.zeros_like(tau))
    td = sst
    for _ in range(50):
        td = _runge_kutta_modstall(td, h, M, K)
    td = torch.where(tau > 0, td, sst)
    f1_air = _icing_f1(airtemp)
    hk = _div(ha, 333000.0)
    rw_base = f32(6.46e-5) * wave * (vr * vr)
    ice = torch.zeros_like(v)
    for k, d in enumerate(decay):
        rw = rw_base * f32(d) * v
        n = _modstall_fp(rw, gate, tf, td, airtemp, rh, f1_air, hk, ratio,
                         trips=trips, height=k)
        ice = ice + n * _div(rw, 890.0) * f32(3600.0) * f32(100.0)
    return _div(ice, f32(number)).abs()


def _mincog_decay(zmin: float, number: int):
    """Per-height LWC decay factors, evaluated in float64 on the host like
    the reference's ``exp`` and rounded once to float32."""
    return [f32(math.exp(-0.55 * (zmin + 0.5 * k))) for k in range(number)]


def _number(zmin: float, zmax: float) -> int:
    """Heights sampled at 0.5 m steps in [zmin, zmax]."""
    return int((zmax - zmin) * 2 + 1)


def _modstall_require(vs, alpha, zmin, zmax) -> None:
    require(zmax >= zmin and math.fmod(zmax - zmin, 1.0) == 0.0,
            "vesselIcingModStall: bad zmin/zmax")
    require(vs >= 0 and alpha >= 0 and zmin >= 0 and zmax >= 0,
            "vesselIcingModStall: negative parameter")


def _modstall_gate(sal, wave, x_wind, y_wind, airtemp, rh, sst, p, aice,
                   depth):
    mask = and_masks(sal, wave, x_wind, y_wind, airtemp, rh, sst, p,
                     aice, depth)
    return mask & (aice.values < f32(0.4))


def vessel_icing_modstall(sal: Field, wave: Field, x_wind: Field,
                          y_wind: Field, airtemp: Field, rh: Field,
                          sst: Field, p: Field, pw: Field, aice: Field,
                          depth: Field, vs: float, alpha: float,
                          zmin: float, zmax: float) -> Field:
    """Modified Stallabrass freezing sea-spray (Henry 1995, Samuelsen 2015;
    VI:182-337).  ``vs`` ship speed, ``alpha`` relative heading, heights
    sampled at 0.5 m steps in [zmin, zmax]."""
    _modstall_require(vs, alpha, zmin, zmax)
    gate = _modstall_gate(sal, wave, x_wind, y_wind, airtemp, rh, sst, p,
                          aice, depth)
    v, c0, shallow, a, tf, ha, tau, K, M = _modstall_static(
        sal.values, wave.values, x_wind.values, y_wind.values,
        airtemp.values, rh.values, p.values, pw.values, depth.values, gate)
    out = _modstall_core(c0, a, shallow, gate, wave.values, v, sst.values,
                         airtemp.values, rh.values, tf, ha, tau, K, M,
                         float(vs * math.cos(alpha)),
                         _mincog_decay(zmin, _number(zmin, zmax)))
    return out_field(out, gate)


# ---------------------------------------------------------------------------
# MINCOG (Samuelsen et al. 2017)
# ---------------------------------------------------------------------------

def _freeze_frac_ts(ts, sw, ta, ha, he, ea, rh, rw, tsp, lwdown, swdown):
    """MINCOG heat-balance residual in brine-temperature space
    (``icing.py:870-901``): ``qsum(ts)/(lfs*rw) - N(ts)`` with
    ``N(ts) = (1 - sw/sb)/0.7``, ``sb = 1000*ts/(ts - 54.1126)``.
    Returns ``(residual, d(residual)/dts, N(ts))``."""
    lfs = f32(3.33e5 * 0.7)
    den = ts - f32(54.1126)
    sb = _div(f32(1000.0) * ts, den)
    sb_safe = torch.where(sb == 0, torch.ones_like(sb), sb)
    n = (1.0 - _div(sw, sb_safe)) * f32(1.0 / 0.7)
    es = f32(10.0) * _icing_f1(ts)
    qsum = (ha * (ts - ta) + he * (es - rh * ea)
            + rw * f32(4000.0) * (ts - tsp)
            + _kt4(ts) - lwdown - f32(0.44) * swdown)
    lrw = lfs * rw
    res = _div(qsum, lrw) - n
    dsb_dts = _div(-54112.6, den * den)
    dn_dts = _div(sw, sb_safe * sb_safe) * f32(1.0 / 0.7) * dsb_dts
    tp = ts + f32(243.5)
    des_dts = _div(es * f32(17.67 * 243.5), tp * tp)
    tk = ts + float(t0)
    dq_dts = ha + he * des_dts + rw * f32(4000.0) \
        + f32(4.0 * 5.67e-8) * tk * tk * tk
    dres = _div(dq_dts, lrw) - dn_dts
    return res, dres, n


def _ts_of_n(n: float, sw):
    """The reference's N -> brine-temperature map (VI:344-346)."""
    den = float(np.float32(1.0) - np.float32(0.7) * np.float32(n))
    sb = _div(sw, den)
    return _div(f32(-54.1126) * sb, 1000.0 - sb)


def _rtsafe_lanes(fn_grad, a, b, iters: int = _NEWTON_ITERS):
    """Bracket-safeguarded Newton root find, vectorised over lanes
    (``icing.py:913-963``): the secant start clipped into the bracket,
    then ``iters`` steps that take the Newton update where it lands inside
    the sign-change bracket (or holds a converged lane) and the midpoint
    otherwise.  Lanes without a sign change return NaN."""
    fa, _ = fn_grad(a)
    fb, _ = fn_grad(b)
    sa = fa > 0
    no_root = torch.where(fb > 0, sa, ~sa)
    eps = f32(1e-6) * (b - a)
    denom = torch.where(fb == fa, torch.ones_like(fa), fb - fa)
    x0 = a - _div(fa * (b - a), denom)
    x = _min(_max(x0, a + eps), b - eps)
    for _ in range(iters):
        f, df = fn_grad(x)
        same = torch.where(f > 0, sa, ~sa)
        a = torch.where(same, x, a)
        b = torch.where(same, b, x)
        step = _div(f, torch.where(df == 0, torch.ones_like(df), df))
        xn = x - step
        ok = ((xn > a) & (xn < b) & (xn.abs() < _INF) & (df != 0)) \
            | (xn == x)
        x = torch.where(f == 0, x, torch.where(ok, xn, (a + b) * 0.5))
    return torch.where(no_root, torch.full_like(x, float("nan")), x)


def _mincog_static(sal, wave, x_wind, y_wind, airtemp, rh, p, pw, depth,
                   vs: float, alpha: float, gate):
    """The c-independent MINCOG prologue (``icing.py:966-1022``): spray
    geometry, heat-transfer and humidity coefficients.  It needs
    ``arcsin``, ``sin``, ``cos`` and ``pow``, and stays in PyTorch for both
    routes, so the kernel and its plain version see the same planes.
    Returns ``(v, skip0, c0, shallow, a, ha, tau, ea, K, M, vdcomp, he)``."""
    del sal
    v = torch.sqrt(x_wind ** 2 + y_wind ** 2)
    skip0 = (v < 1.0) | (wave < f32(0.1))         # VI:479-482 => icing 0

    c0 = f32(9.81 / (2 * math.pi)) * pw            # VI:489-508
    shallow = (depth <= c0 * pw) & (c0 != 0) & gate & ~skip0
    a = _div(f32(2 * math.pi) * depth,
             torch.where(pw != 0, pw, torch.ones_like(pw))) \
        * torch.where(pw != 0, f32(1.0), _INF)

    beta = alpha
    sin_beta = f32(math.sin(beta))
    wrx = (v * f32(math.cos(beta)) - f32(vs)).abs()
    wry = (v * sin_beta).abs()
    wr_inv = _div(1.0, torch.sqrt(wrx * wrx + wry * wry))

    hax = f32(6.0617) * torch.pow(wrx, f32(1.82))
    hay = f32(4.8496) * torch.pow(wry, f32(1.8))
    ha = _div(hax + hay, wrx + wry)

    # simplified droplet trajectory (VI:539-576)
    beta_r = f32(math.pi) - torch.arcsin(v * sin_beta * wr_inv)
    br = torch.where(beta_r <= f32(math.pi / 2), f32(91 * math.pi / 180),
                     torch.where(beta_r > f32(math.pi), f32(math.pi),
                                 beta_r))
    sin_br = torch.sin(br)
    sin_beta_r_2 = sin_br * sin_br
    cos_beta_r = torch.cos(br)
    cos_2_beta_r = torch.cos(2.0 * br)

    # KV Nordkapp perimeter ellipse (VI:561-567), constants in float32
    r0_, a0_, b0_ = np.float32(13.18), np.float32(32.88), np.float32(6.605)
    a0_2, b0_2, r0_2 = a0_ * a0_, b0_ * b0_, r0_ * r0_
    ell = (float(b0_2 - a0_2) * cos_2_beta_r + float(a0_2) + float(b0_2))
    c0_ell = float(np.float32(math.sqrt(2.0)) * a0_ * b0_) * torch.sqrt(
        ell - float(np.float32(2.0) * r0_2) * sin_beta_r_2)
    r_ = _div(float(r0_ * np.float32(2.0) * b0_2) * cos_beta_r + c0_ell, ell)

    tau_const = r_ * wr_inv
    beta_deg = np.float32(beta * (180.0 / math.pi))
    drag = np.float32(-0.0046) * beta_deg + np.float32(2.1912)
    tau = tau_const * float(drag)

    ea = f32(10.0) * _icing_f1(airtemp)
    K = _div(f32(0.2 * 0.622 * 2.5e6), p * f32(1005.0))
    M = f32(0.2) * airtemp + K * rh * ea

    vdcomp = wrx * f32(0.9962) + float(np.float32(6.67) * np.float32(0.0872))
    he = _div(ha * f32(1738.6), p)
    return (v, skip0, c0, shallow, a, ha, tau, ea, K, M, vdcomp, he)


def _mincog_core(c0, a, shallow, skip0, wave, pw, depth, v, sst, sal,
                 airtemp, rh, ha, he, ea, M, K, tau, vd, vsca: float,
                 alt: int, decay, trips: Optional[dict] = None):
    """The c-dependent MINCOG solve (``icing.py:1025-1207``): the wave
    fixed point (float reference stall semantics), the 50-step droplet RK,
    and per height the safeguarded Newton on the brine-temperature heat
    balance (cold start), with the closed form on ``sal == 0`` lanes.
    ``decay`` holds the float32 per-height factors.  The plain version of
    kernel B5."""
    number = len(decay)
    c = _wave_speed_fixed_point(c0, a, shallow, 1000, 1e-5, ref_f32=True,
                                trips=trips)
    vr = c - f32(vsca)
    tper = _div(c * pw, vr).abs()
    skip = skip0 | (tper <= 0)
    if trips is not None:
        # the lanes the kernel solves: gated on (``trips["gate"]``, where
        # the caller gives it) and not skipped
        gate = trips.pop("gate", True)
        solved = gate & ~skip
        trips["solved"] = int(solved.sum())
        if "lanes" in trips:
            trips["lanes"]["live"] = (gate & ~skip0).to(torch.int32)
            trips["lanes"]["solved"] = solved.to(torch.int32)

    tdur = f32(0.1230) + _div(f32(0.7008) * (vr * wave).abs(),
                              _max(v, f32(5.0)))
    nf = _div(1.0, f32(4.0) * tper)

    def f10mk(t):
        return (M - f32(0.2) * t) - K * f32(10.0) * _icing_f1(t)

    h = _div(tau, 50.0)
    h2 = _div(h, 2.0)
    td = sst
    for _ in range(50):      # reference runge_kutta template (VI:450-463)
        k1 = h2 * f10mk(td)
        k2 = h * f10mk(td + k1)
        k3 = h * f10mk(td + _div(k2, 2.0))
        k4 = h2 * f10mk(td + k3)
        td = td + _div(k1 + k2 + k3 + k4, 3.0)
    tsp = f32(0.5) * (td + sst)

    if alt == 1:
        lwc0 = f32(6.36e-5) * wave * (vr * vr)
    else:
        lam = c * pw
        dl = _div(f32(4.0 * math.pi) * depth, lam)
        sh = (exp_f32(dl) - exp_f32(-dl)) * 0.5
        cg = _div(c, 2.0) * (1.0 + _div(dl, sh))
        vgr = cg - f32(vsca)
        lwc0 = f32(9.5205e-4) * (wave * wave) * torch.sqrt(_div(wave, lam)) \
            * vgr
    lwc0 = lwc0.abs()

    lwdown = f32(0.7) * _kt4(airtemp)              # VI:612-614
    swdown = torch.zeros_like(airtemp)             # VI:611, 615
    ts_hi = _ts_of_n(_BISECT_A, sal)
    ts_lo = _ts_of_n(_BISECT_B, sal)
    sw0 = sal <= 0
    rw_base = lwc0 * vd * nf * tdur

    def ffz(ts, rw):
        return _freeze_frac_ts(ts, sal, airtemp, ha, he, ea, rh, rw, tsp,
                               lwdown, swdown)

    icing = torch.zeros_like(v)
    for k, d in enumerate(decay):
        rw = rw_base * f32(d)
        ts_root = _rtsafe_lanes(lambda ts: ffz(ts, rw)[:2], ts_lo, ts_hi)
        if trips is not None:
            # solved lanes by branch: the closed form, no sign change in
            # the bracket (a NaN root), the safeguarded Newton
            no_root = torch.isnan(ts_root)
            _count(trips, "h_sal0", solved & sw0, k)
            _count(trips, "h_noroot", solved & ~sw0 & no_root, k)
            _count(trips, "h_root", solved & ~sw0 & ~no_root, k)
        _, _, n_ts = ffz(ts_root, rw)
        # sal == 0: the residual is linear in N, closed-form root
        r0, _, _ = ffz(torch.zeros_like(rw), rw)
        k_lin = r0 + f32(1.0 / 0.7)
        sl = (k_lin - f32(_BISECT_B)) > 0
        lin_root = torch.where((k_lin - f32(_BISECT_A)) > 0, ~sl, sl)
        n_lin = torch.where(lin_root, k_lin, torch.zeros_like(k_lin))
        n = torch.where(sw0, n_lin,
                        torch.where(torch.isnan(n_ts),
                                    torch.zeros_like(n_ts), n_ts))
        icing = icing + rw * n.clamp(0.0, 1.0)
    out = _div(icing, f32(number)).abs() * f32(3600.0 * 100.0 / 890.0)
    return torch.where(skip, torch.zeros_like(out), out)


def _mincog_gate(sal, wave, x_wind, y_wind, airtemp, rh, sst, p, aice,
                 depth):
    mask = and_masks(sal, wave, x_wind, y_wind, airtemp, rh, sst, p,
                     aice, depth)
    brine_freeze = _div(f32(-54.1126) * sal.values, 1000.0 - sal.values)
    return mask & (aice.values < f32(0.4)) & (sst.values > brine_freeze)


def _mincog_require(vs, alpha, zmin, zmax) -> None:
    require(vs >= 0 and alpha >= 0 and zmin >= 0 and zmax >= 0
            and zmax >= zmin and math.fmod(zmax - zmin, 1.0) == 0.0,
            "vesselIcingMincog: bad parameters")


def vessel_icing_mincog(sal: Field, wave: Field, x_wind: Field,
                        y_wind: Field, airtemp: Field, rh: Field,
                        sst: Field, p: Field, pw: Field, aice: Field,
                        depth: Field, vs: float, alpha: float,
                        zmin: float, zmax: float, alt: int) -> Field:
    """MINCOG icing rate (Samuelsen et al. 2017), org (alt=1) or adjusted
    (alt=2) liquid-water content (VI:465-705)."""
    _mincog_require(vs, alpha, zmin, zmax)
    gate = _mincog_gate(sal, wave, x_wind, y_wind, airtemp, rh, sst, p,
                        aice, depth)
    (v, skip0, c0, shallow, a, ha, tau, ea, K, M, vd, he) = _mincog_static(
        sal.values, wave.values, x_wind.values, y_wind.values,
        airtemp.values, rh.values, p.values, pw.values, depth.values, vs,
        alpha, gate)
    out = _mincog_core(c0, a, shallow, skip0, wave.values, pw.values,
                       depth.values, v, sst.values, sal.values,
                       airtemp.values, rh.values, ha, he, ea, M, K, tau, vd,
                       float(vs * math.cos(alpha)), alt,
                       _mincog_decay(zmin, _number(zmin, zmax)))
    return out_field(out, gate)
