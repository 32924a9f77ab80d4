"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. environment: the card's name and power limit (nvidia-smi), torch, CUDA
   and nvcc versions, and whether triton imports;
2. build: the CUDA kernel library (nvcc) and the host codec (g++), timed;
3. the kernel against its plain PyTorch version on the card, masked and
   all-defined, at small and ragged shapes: masks bitwise, values within
   rtol 2e-5 on defined points;
4. the main path: 3 requests through ``staging.run_derived_fields_np`` at
   the 32-level 719x929 AROME size (undef lanes live, fully defined, undef
   lanes live), each compared with the plain version on the same CUDA
   tensors; the kernel must have been launched exactly 3 times;
5. times on this card: kernel and plain medians (CUDA events), effective
   GB/s, a device copy's GB/s for scale, and one request split into
   decode, H2D, kernel, D2H and encode;
6. the column-interpolation kernel and the two suite kernels against
   their plain versions on the card, at phase 3's shapes and a 137-level
   column (137, 9, 150): masked and all-defined, ln p and p, targets above
   the top and below the surface, a non-monotone column; every valid mode
   of every suite family in one request, with out-of-table temperatures,
   undefined p / ps points and p <= 0 on the a-level path.  Masks and
   values must be equal (NaN where NaN);
7. the isobaric path at BASELINE config 4's full size, 137x719x929 -> the
   11 standard surfaces: ``derived_fields_isobaric(fused=True,
   stacked=True)`` must launch the interpolation kernel and the pipeline
   kernel once each and equal the plain composition; then its times, split
   into the two kernels;
8. the suite entry: 3 requests through ``staging.run_hlevel_suite_np`` at
   32x719x929 with BASELINE config 2's request set (undef lanes live,
   fully defined, undef lanes live; 3 launches, the all-defined route as
   the decode counts say, outputs equal to the plain version's), and
   ``alevel_suite_fused`` once at config 2's own 10x719x929 with a
   pressure field; then the two kernels' times and one request split;
9. vessel icing: the MINCOG (alt 1 and 2) and ModStall kernels against
   their plain versions at (1, 1), (3, 37), (37, 61), (9, 131), (64, 256)
   and 719x929 on friendly inputs, adversarial ones with planted pw == 0
   and sal == 0 points, and vs = 0 (values equal, NaN where NaN); 3
   requests through ``staging.run_vessel_icing_np`` at 719x929 with the
   operational 19 heights (scattered undefs, fully defined, scattered
   undefs; each kernel launched exactly 3 times; outputs equal to the
   plain route's); the port's ModStall against the 719x929 oracle golden
   (rtol / atol 2e-3); then the kernels' and plain versions' times and
   one request split into decode, H2D, prologues, kernels, D2H and encode.

Every kernel's record carries its bound: the larger of the bytes it must
move over this run's device-copy rate and the float32 operations these
inputs need over the card's 67 TFLOP/s.

A line ``record: {...}`` holds every number measured.  The second-to-last
line is a JSON object with the kernels' records, the last
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.  Exits
non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
NLEV, NY, NX = 32, 719, 929
SHAPES = ((3, 37, 61), (2, 33, 135), (1, 3, 3), (2, 5, 929), (4, 64, 256))
RTOL = 2e-5
#: H100 SXM float32 peak outside the tensor cores, FLOP/s (NVIDIA's data
#: sheet); the operation side of every kernel's bound
PEAK_F32 = 67e12
#: float32 operations per unit of work of B1-B4, counted low from the CUDA
#: sources (adds, multiplies, divisions; compares and selects not
#: counted): the bytes side bounds these kernels by a wide margin
OPS_B1_POINT = 150          # per point and level, all 12 outputs
OPS_B2_PAIR = 2             # per column, target and level pair (p_k1)
OPS_B2_TARGET = 80          # per column and target: two logs, the weights
OPS_SUITE_OUTPUT = 20       # per output point of B3 / B4
NAMES = ("p", "th", "rh", "td", "thetae", "ducting", "wspeed", "vort", "div",
         "tadv", "gradt", "tfp")
#: phase 6's shapes: phase 3's and a 137-level column
KERNEL_SHAPES = SHAPES + ((137, 9, 150),)
#: BASELINE config 4 (tools/baseline_configs.py:209-249) and config 2
#: (:130-174) at full size; the suite entry's requests at phase 4's size
ISO_SHAPE = (137, 719, 929)
A_SUITE_SHAPE = (10, 719, 929)
SUITE_SHAPE = (32, 719, 929)
CONFIG2 = {"temps": (3, 4), "hums_q": (1, 5, 9), "hums_rh": (3, 7, 11)}
#: every valid mode of every suite family (ops/fused_suite.py _VALID)
ALL_MODES = {"temps": (1, 2, 3, 4, 5), "hums_q": (1, 2, 5, 6, 9, 10),
             "hums_rh": (3, 4, 7, 8, 11, 12), "thes": (1, 2),
             "ducts_q": (1, 2), "ducts_rh": (3, 4)}


def log(*args) -> None:
    print(*args, flush=True)


def hbm_bytes(nlev: int, ny: int, nx: int) -> int:
    """Each input read once and each output written once, values and
    masks (the byte count of bench.py:84-93)."""
    pts3, pts2 = nlev * ny * nx, ny * nx
    reads = 4 * pts3 * 5 + pts2 * 5 + 3 * pts2 * 4 + 2 * nlev * 4
    return reads + 12 * pts3 * 5


def layout_bytes(nlev: int, ny: int, nx: int, all_defined: bool) -> int:
    """Bytes the kernel's own layout moves at least once: 4 value stacks
    (+ 4 mask stacks), ps (+ mask), 2 map planes, 12 value planes and 9 (or
    2) mask planes."""
    pts3, pts2 = nlev * ny * nx, ny * nx
    if all_defined:
        return 4 * pts3 * 4 + pts2 * 4 + 2 * pts2 * 4 + 12 * pts3 * 4 + 2 * pts3
    return 4 * pts3 * 5 + pts2 * 5 + 2 * pts2 * 4 + 12 * pts3 * 4 + 9 * pts3


def make_inputs(nlev, ny, nx, seed, undefs, kind="scattered"):
    """Seeded sentinel numpy inputs (the 10 arguments of the pipeline).
    ``scattered``: the kernel tests' pattern (test_fused.py), undefs at
    ~1/37 of points, corners, a 500 K point and an undefined ps point;
    ``column``: the benchmark's pattern (__graft_entry__.py), one undefined
    temperature column."""
    rng = np.random.default_rng(seed)
    tk = rng.normal(275.0, 15.0, (nlev, ny, nx)).astype(np.float32)
    q = rng.uniform(1e-4, 1e-2, (nlev, ny, nx)).astype(np.float32)
    u = rng.normal(0.0, 12.0, (nlev, ny, nx)).astype(np.float32)
    v = rng.normal(0.0, 12.0, (nlev, ny, nx)).astype(np.float32)
    ps = rng.normal(1000.0, 15.0, (ny, nx)).astype(np.float32)
    if undefs and kind == "scattered":
        for arr in (tk, q, u, v):
            arr.reshape(-1)[rng.integers(0, arr.size, arr.size // 37)] = 1e35
        tk[0, 0, 0] = 1e35
        tk[-1, -1, -1] = 1e35
        tk[0, min(1, ny - 1), min(1, nx - 1)] = 500.0
        ps[ny // 2, nx // 2] = 1e35
    elif undefs:
        tk[:, ny // 3, nx // 3] = 1e35
    alevel = np.linspace(0.0, 50.0, nlev).astype(np.float32)
    blevel = np.linspace(1.0, 0.5, nlev).astype(np.float32)
    if kind == "scattered":
        xm = rng.uniform(3e-7, 5e-7, (ny, nx)).astype(np.float32)
        ym = rng.uniform(3e-7, 5e-7, (ny, nx)).astype(np.float32)
    else:
        xm = np.full((ny, nx), 4.0e-7, np.float32)
        ym = np.full((ny, nx), 3.6e-7, np.float32)
    fc = np.full((ny, nx), 1.2e-4, np.float32)
    return tk, q, u, v, ps, alevel, blevel, xm, ym, fc


def sentinel(rng, lo, hi, shape, undef_frac: float) -> np.ndarray:
    """Uniform float32 values with ``undef_frac`` of them set to 1e35."""
    a = rng.uniform(lo, hi, shape).astype(np.float32)
    if undef_frac:
        a[rng.random(shape) < undef_frac] = np.float32(1e35)
    return a


def make_column_inputs(nlev, ny, nx, seed, undef_frac, undef_ps=False):
    """BASELINE config 4's inputs (tools/baseline_configs.py:216-233):
    T 220-300 K, q, u, v with ``undef_frac`` undefined points, ps
    950-1030 hPa (one undefined point with ``undef_ps``), and the hybrid
    law ``a = linspace(50, 300)``, ``b = linspace(0, 0.7)**1.5``, whose
    model top is 50 hPa and whose lowest level lies near 900 hPa."""
    rng = np.random.default_rng(seed)
    shape = (nlev, ny, nx)
    tk = sentinel(rng, 220.0, 300.0, shape, undef_frac)
    q = sentinel(rng, 1e-4, 1e-2, shape, undef_frac)
    u = sentinel(rng, -40.0, 40.0, shape, undef_frac)
    v = sentinel(rng, -40.0, 40.0, shape, undef_frac)
    ps = rng.uniform(950.0, 1030.0, (ny, nx)).astype(np.float32)
    if undef_ps:
        ps[ny // 2, nx // 2] = np.float32(1e35)
    alevel = np.linspace(50.0, 300.0, nlev).astype(np.float32)
    blevel = (np.linspace(0.0, 0.7, nlev) ** 1.5).astype(np.float32)
    xm = np.full((ny, nx), 4.0e-7, np.float32)
    fc = np.full((ny, nx), 1.2e-4, np.float32)
    return tk, q, u, v, ps, alevel, blevel, xm, xm.copy(), fc


def make_suite_inputs(nlev, ny, nx, seed, undef_frac, plant=True):
    """BASELINE config 2's inputs (tools/baseline_configs.py:135-147): T
    250-300 K, q, RH 5-95 % with ``undef_frac`` undefined points and a
    pressure field p 300-1000 hPa; plus ps 950-1030 hPa and hybrid
    coefficients for the h-level suite.  ``plant`` adds temperatures
    beyond both ends of the saturation table, p = 0 and p < 0, and (with
    undefined points) an undefined p and ps point."""
    rng = np.random.default_rng(seed)
    shape = (nlev, ny, nx)
    tk = sentinel(rng, 250.0, 300.0, shape, undef_frac)
    q = sentinel(rng, 1e-4, 1e-2, shape, undef_frac)
    rh = sentinel(rng, 5.0, 95.0, shape, undef_frac)
    p = rng.uniform(300.0, 1000.0, shape).astype(np.float32)
    ps = rng.uniform(950.0, 1030.0, (ny, nx)).astype(np.float32)
    if plant:
        tk[0, 0, 0] = 520.0
        tk[-1, -1, -1] = 100.0
        p[0, min(1, ny - 1), min(1, nx - 1)] = 0.0
        p[-1, -1, 0] = -5.0
        if undef_frac:
            p[0, ny // 2, nx // 2] = np.float32(1e35)
            ps[ny // 2, nx // 2] = np.float32(1e35)
    alevel = np.linspace(30.0, 0.0, nlev).astype(np.float32)
    blevel = np.linspace(0.02, 1.0, nlev).astype(np.float32)
    return tk, q, rh, p, ps, alevel, blevel


def value_err(got, ref, label: str) -> float:
    """Max |kernel - plain| (NaN equal to NaN, equal infinities equal);
    raises where they differ by more than RTOL relative."""
    import torch
    same = (got == ref) | (torch.isnan(got) & torch.isnan(ref))
    err = torch.where(same, torch.zeros_like(got), (got - ref).abs())
    bad = ~same & ~(err <= RTOL * ref.abs())
    if bool(bad.any()):
        k = int(bad.reshape(-1).nonzero()[0, 0])
        raise AssertionError(
            f"{label}: {int(bad.sum())} values outside rtol {RTOL}, e.g. "
            f"kernel {float(got.reshape(-1)[k])!r} plain "
            f"{float(ref.reshape(-1)[k])!r}")
    return float(err.max()) if err.numel() else 0.0


def compare_fields(got, ref, label: str, defined_only: bool) -> float:
    """Kernel vs plain lists of Fields: masks bitwise, values by
    :func:`value_err` on every point or on the defined points; returns the
    max abs error."""
    import torch
    if len(got) != len(ref):
        raise AssertionError(f"{label}: {len(got)} outputs, plain "
                             f"{len(ref)}")
    worst = 0.0
    for k, (g, r) in enumerate(zip(got, ref)):
        if not torch.equal(g.mask, r.mask):
            raise AssertionError(f"{label} output {k}: masks differ at "
                                 f"{int((g.mask != r.mask).sum())} points")
        gv, rv = ((g.values[g.mask], r.values[r.mask]) if defined_only
                  else (g.values, r.values))
        worst = max(worst, value_err(gv, rv, f"{label} output {k}"))
    return worst


def time_ms(fn, reps: int, warmup: bool = True) -> list:
    """Per-run device times of ``fn`` in ms (CUDA events), after a warm-up
    run unless ``warmup`` is False."""
    import torch
    if warmup:
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return out


def compare_stacked(got, ref, label: str) -> dict:
    """Kernel vs plain on the card: masks bitwise, values within RTOL on
    defined points (NaN equal to NaN).  Returns per-output max relative
    and absolute errors."""
    import torch
    from mi_fieldcalc_tpu_torch.models.pipeline import DerivedFieldsStacked
    if got.masks.shape != ref.masks.shape or not torch.equal(got.masks,
                                                             ref.masks):
        diff = int((got.masks != ref.masks).sum()) \
            if got.masks.shape == ref.masks.shape else -1
        raise AssertionError(f"{label}: masks differ at {diff} points")
    rel, absd = {}, {}
    for i, name in enumerate(NAMES):
        m = DerivedFieldsStacked.mask_plane(got.masks, i, got.values[i])
        g, r = got.values[i][m], ref.values[i][m]
        both_nan = torch.isnan(g) & torch.isnan(r)
        err = torch.where(both_nan, torch.zeros_like(g), (g - r).abs())
        bad = ~(err <= RTOL * r.abs())
        if bool(bad.any()):
            k = int(bad.nonzero()[0, 0])
            raise AssertionError(
                f"{label} {name}: {int(bad.sum())} values outside rtol "
                f"{RTOL}, e.g. kernel {float(g[k])!r} plain {float(r[k])!r}")
        scale = torch.where(r == 0, torch.ones_like(r), r.abs())
        rel[name] = float((err / scale).max()) if err.numel() else 0.0
        absd[name] = float(err.max()) if err.numel() else 0.0
    return {"max_rel": rel, "max_abs": absd}


def compare_dicts(got: dict, ref: dict, label: str) -> None:
    """Sentinel dicts: identical undef positions, values within RTOL."""
    for name in NAMES:
        g, r = got[name], ref[name]
        if g.shape != r.shape:
            raise AssertionError(f"{label} {name}: shape {g.shape} != "
                                 f"{r.shape}")
        ug, ur = g == np.float32(1e35), r == np.float32(1e35)
        if not np.array_equal(ug, ur):
            raise AssertionError(f"{label} {name}: undef positions differ "
                                 f"at {int((ug != ur).sum())} points")
        d = ~ur
        with np.errstate(invalid="ignore"):
            ok = (np.abs(g[d] - r[d]) <= RTOL * np.abs(r[d])) | (
                np.isnan(g[d]) & np.isnan(r[d]))
        if not ok.all():
            raise AssertionError(f"{label} {name}: {int((~ok).sum())} "
                                 f"values outside rtol {RTOL}")


def check_physics(out: dict, nlev: int, ny: int, nx: int) -> None:
    """The repo's own sanity bounds on a request's outputs: the expected
    shape, finite defined values, and plausible magnitudes on the
    benchmark inputs (theta and dewpoint in Kelvin, wind speed >= 0)."""
    for name in NAMES:
        a = out[name]
        if a.shape != (nlev, ny, nx) or a.dtype != np.float32:
            raise AssertionError(f"{name}: {a.shape} {a.dtype}")
        d = a[a != np.float32(1e35)]
        if d.size < a.size // 2 or not np.isfinite(d).all():
            raise AssertionError(f"{name}: too few or non-finite values")
    th = out["th"][out["th"] != np.float32(1e35)]
    td = out["td"][out["td"] != np.float32(1e35)]
    if not (150.0 < np.median(th) < 600.0 and 150.0 < np.median(td) < 400.0
            and out["wspeed"].min() >= 0.0):
        raise AssertionError("outputs outside physical bounds")


def phase_env() -> tuple:
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    from mi_fieldcalc_tpu_torch._build import find_nvcc
    nvcc = find_nvcc()
    nvcc_v = "not found"
    if nvcc:
        nvcc_v = subprocess.run([nvcc, "--version"], capture_output=True,
                                text=True, timeout=60).stdout.strip()
        nvcc_v = nvcc_v.splitlines()[-1]
    try:
        import triton
        tri = f"imports ({triton.__version__})"
    except ImportError as e:
        tri = f"does not import ({e})"
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"torch CUDA {torch.version.cuda}  nvcc: {nvcc} ({nvcc_v})")
    log(f"device: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}  triton {tri}")
    return smi, {"nvcc": nvcc_v, "triton": tri, "torch": torch.__version__,
                 "torch_cuda": torch.version.cuda}


def phase_build() -> dict:
    from mi_fieldcalc_tpu_torch import _build, native
    t = time.perf_counter()
    lib = _build.build()
    _build.load_library()
    t_cuda = time.perf_counter() - t
    t = time.perf_counter()
    codec = native.codec()
    t_host = time.perf_counter() - t
    log(f"build: CUDA library {lib.name} in {t_cuda:.2f} s; host codec "
        f"'{codec}' in {t_host:.2f} s")
    report = Path(str(lib) + ".log")
    if report.is_file():
        for line in report.read_text().splitlines():
            if ("registers" in line or "spill" in line
                    or "entry function" in line):
                log("  ptxas: " + line.strip())
    if codec != "native":
        raise AssertionError("the native host codec did not build")
    return {"cuda_build_s": t_cuda, "host_codec_s": t_host, "codec": codec}


def phase_kernel(dev, shapes=SHAPES) -> dict:
    import torch
    from mi_fieldcalc_tpu_torch.field import from_sentinel
    from mi_fieldcalc_tpu_torch.ops import fused
    worst = {}
    for shape in shapes:
        for all_defined in (False, True):
            raw = make_inputs(*shape, seed=sum(shape),
                              undefs=not all_defined)
            args = tuple(from_sentinel(a, device=dev) for a in raw[:5]) + \
                tuple(torch.as_tensor(a, device=dev) for a in raw[5:])
            got = fused.derived_fields_fused(*args, all_defined=all_defined)
            ref = fused.derived_fields_plain(*args, all_defined=all_defined)
            label = f"{shape} {'all_defined' if all_defined else 'masked'}"
            errs = compare_stacked(got, ref, label)
            log(f"kernel == plain {label}: max rel err " + " ".join(
                f"{k}={v:.1e}" for k, v in errs["max_rel"].items()))
            for k, v in errs["max_rel"].items():
                worst[k] = max(worst.get(k, 0.0), v)
    return worst


def phase_main_path(dev, nlev=NLEV, ny=NY, nx=NX) -> dict:
    import torch
    from mi_fieldcalc_tpu_torch import staging
    from mi_fieldcalc_tpu_torch.ops import fused
    requests = [("undef lanes live", make_inputs(nlev, ny, nx, 1, True,
                                                 "column"), False),
                ("fully defined", make_inputs(nlev, ny, nx, 2, False,
                                              "column"), True),
                ("undef lanes live", make_inputs(nlev, ny, nx, 3, True,
                                                 "scattered"), False)]
    fused.derived_fields_fused.launches = 0
    outs, buffers = [], []
    for _, args, _ in requests:
        outs.append(staging.run_derived_fields_np(*args, device=dev))
        stager = staging._stager_cache(4, 1e35)
        buffers.append((id(stager), id(stager.values)))
    torch.cuda.synchronize(dev)
    launches = fused.derived_fields_fused.launches
    log(f"main path: 3 requests at {nlev}x{ny}x{nx}, kernel launches "
        f"{launches}")
    if launches != 3:
        raise AssertionError(f"expected 3 kernel launches, got {launches}")
    if len(set(buffers)) != 1:
        raise AssertionError("the host stager was not reused")

    max_abs = 0.0
    for k, ((label, args, want_ad), out) in enumerate(zip(requests, outs)):
        host, all_defined = staging._decode_step(
            args, staging.HostStager(4), 1e35)
        if all_defined != want_ad:
            raise AssertionError(f"request {k + 1}: all_defined routed "
                                 f"{all_defined}, expected {want_ad}")
        staged = staging._upload_step(host, dev)
        plain = fused.derived_fields_plain(*staged, all_defined=all_defined)
        if k == 0:
            kern = fused.derived_fields_fused(*staged)
            errs = compare_stacked(kern, plain, "full size masked")
            max_abs = max(errs["max_abs"].values())
            del kern
        ref = staging._encode_step(*staging._fetch(plain), 1e35)
        del plain, staged
        compare_dicts(out, ref, f"request {k + 1}")
        check_physics(out, nlev, ny, nx)
        log(f"request {k + 1} ({label}, all_defined={all_defined}): "
            f"12 outputs == plain version")
    return {"launches": launches, "max_abs_err": max_abs}


def phase_times(dev, smi: str, nlev=NLEV, ny=NY, nx=NX, reps=10,
                request_reps=5) -> dict:
    import torch
    from mi_fieldcalc_tpu_torch import staging
    from mi_fieldcalc_tpu_torch.ops import fused
    res = {"card": smi, "shape": [nlev, ny, nx]}
    for label, undefs in (("masked", True), ("all_defined", False)):
        args = make_inputs(nlev, ny, nx, 4, undefs, "column")
        host, ad = staging._decode_step(args, staging.HostStager(4), 1e35)
        staged = staging._upload_step(host, dev)
        k = time_ms(lambda: fused.derived_fields_fused(
            *staged, all_defined=ad), reps)
        p = time_ms(lambda: fused.derived_fields_plain(
            *staged, all_defined=ad), reps)
        km, pm = statistics.median(k), statistics.median(p)
        res[label] = {
            "kernel_ms": km, "kernel_ms_all": k, "plain_ms": pm,
            "plain_ms_all": p,
            "gbps_bench_bytes": hbm_bytes(nlev, ny, nx) / km / 1e6,
            "gbps_layout_bytes": layout_bytes(nlev, ny, nx, ad) / km / 1e6}
        log(f"[{smi}] {label}: kernel median {km:.4f} ms, plain "
            f"{pm:.4f} ms ({pm / km:.1f}x), "
            f"{res[label]['gbps_bench_bytes']:.1f} GB/s by bench.py's byte "
            f"count, {res[label]['gbps_layout_bytes']:.1f} GB/s by the "
            f"kernel layout's bytes")
        del staged
    # a device-to-device copy of the step's size, for scale
    n = hbm_bytes(nlev, ny, nx) // 8
    src = torch.empty(n, dtype=torch.float32, device=dev)
    dst = torch.empty_like(src)
    c = statistics.median(time_ms(lambda: dst.copy_(src), reps))
    res["copy_gbps"] = 2 * 4 * n / c / 1e6
    log(f"[{smi}] device copy of {2 * 4 * n / 1e9:.2f} GB moved: "
        f"{res['copy_gbps']:.1f} GB/s")
    del src, dst

    for label, undefs in (("masked", True), ("all_defined", False)):
        args = make_inputs(nlev, ny, nx, 5, undefs, "column")
        stager = staging.HostStager(4)
        parts = {k: [] for k in ("decode", "h2d", "kernel", "d2h",
                                 "encode", "total")}
        for _ in range(request_reps):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            host, ad = staging._decode_step(args, stager, 1e35)
            t1 = time.perf_counter()
            staged = staging._upload_step(host, dev)
            torch.cuda.synchronize(dev)
            t2 = time.perf_counter()
            out = staging._compute(staged, ad)
            torch.cuda.synchronize(dev)
            t3 = time.perf_counter()
            vals, masks = staging._fetch(out)
            t4 = time.perf_counter()
            staging._encode_step(vals, masks, 1e35)
            t5 = time.perf_counter()
            for key, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2, t4 - t3,
                                       t5 - t4, t5 - t0)):
                parts[key].append(dt * 1e3)
            del staged, out, vals, masks
        med = {k: statistics.median(v) for k, v in parts.items()}
        res[f"request_{label}_ms"] = med
        log(f"[{smi}] request ({label}) median of {request_reps}, ms: "
            + " ".join(
            f"{k}={v:.2f}" for k, v in med.items()))
    return res


def phase_new_kernels(dev) -> dict:
    """The column-interpolation kernel (B2) and the a- and h-level suite
    kernels (B3, B4) against their plain versions at KERNEL_SHAPES."""
    import torch
    from mi_fieldcalc_tpu_torch.field import Field, from_sentinel
    from mi_fieldcalc_tpu_torch.models import STANDARD_PLEVELS
    from mi_fieldcalc_tpu_torch.ops import fused_suite as fs
    from mi_fieldcalc_tpu_torch.ops import vertical_fused as vf

    def on(a):
        return torch.as_tensor(a, device=dev)

    # 20 hPa lies above the model top, 1100 hPa below every surface
    targets = STANDARD_PLEVELS + (20.0, 1100.0)
    worst = {"interp": 0.0, "alevel_suite": 0.0, "hlevel_suite": 0.0}
    for shape in KERNEL_SHAPES:
        for all_defined in (False, True):
            raw = make_column_inputs(*shape, seed=sum(shape),
                                     undef_frac=0.0 if all_defined else 0.03,
                                     undef_ps=not all_defined)
            fields = tuple(from_sentinel(a, device=dev) for a in raw[:4])
            ps = from_sentinel(raw[4], device=dev)
            a, b = on(raw[5]), on(raw[6])
            kind = "all_defined" if all_defined else "masked"
            for log_p in (True, False):
                label = f"interp {shape} {kind} log_p={log_p}"
                got = vf.hlevel_to_plevel_fused(fields, ps, a, b, targets,
                                                log_p=log_p,
                                                all_defined=all_defined)
                ref = vf.hlevel_to_plevel_plain(fields, ps, a, b, targets,
                                                log_p, all_defined)
                err = compare_fields(got, ref, label, defined_only=False)
                worst["interp"] = max(worst["interp"], err)
            del fields, ps
    log(f"interp == plain at {len(KERNEL_SHAPES)} shapes x masked/"
        f"all-defined x ln p/p: max abs err {worst['interp']!r}")

    # one column whose pressure is not monotone: 57 hPa is bracketed by
    # levels (0, 1) and (2, 3); the last bracket wins
    al = np.array([10, 60, 50, 60, 80, 100, 120, 100, 50], np.float32)
    bl = np.array([0, 0, .1, .2, .3, .45, .6, .8, 1.0], np.float32)
    rng = np.random.default_rng(3)
    psv = rng.uniform(980.0, 1030.0, (4, 5)).astype(np.float32)
    psv[1, 2] = 50.0
    col = al + bl * psv[1, 2]
    if [k for k in range(8) if col[k] <= 57.0 < col[k + 1]] != [0, 2]:
        raise AssertionError("the non-monotone column is not set up")
    fv = rng.normal(0.0, 1.0, (9, 4, 5)).astype(np.float32)
    f = Field(on(fv), torch.ones(fv.shape, dtype=torch.bool, device=dev))
    psf = Field(on(psv), torch.ones(psv.shape, dtype=torch.bool, device=dev))
    nm_targets = (57.0, 500.0, 850.0)
    got = vf.hlevel_to_plevel_fused((f,), psf, on(al), on(bl), nm_targets)
    ref = vf.hlevel_to_plevel_plain((f,), psf, on(al), on(bl), nm_targets)
    worst["interp"] = max(worst["interp"], compare_fields(
        got, ref, "interp non-monotone column", defined_only=False))
    x0, x1 = np.log(col[2]), np.log(col[3])
    want = fv[2, 1, 2] + (fv[3, 1, 2] - fv[2, 1, 2]) * (
        (np.log(57.0) - x0) / (x1 - x0))
    if not (bool(got[0].mask[0, 1, 2])
            and abs(float(got[0].values[0, 1, 2]) - want) < 1e-5):
        raise AssertionError("non-monotone column: not the last bracket")
    log("interp == plain on a non-monotone column (last bracket wins)")

    reqs = fs._build_reqs("chip_smoke", **ALL_MODES)
    for shape in KERNEL_SHAPES:
        for all_defined in (False, True):
            tk, q, rh, p, psv, al, bl = make_suite_inputs(
                *shape, seed=sum(shape) + 1,
                undef_frac=0.0 if all_defined else 0.03)
            t, q, rh, p, ps = (from_sentinel(x, device=dev)
                               for x in (tk, q, rh, p, psv))
            a, b = on(al), on(bl)
            kind = "all_defined" if all_defined else "masked"
            for name, got, ref in (
                    ("alevel_suite", fs.alevel_suite_stacked(
                        t, q, rh, p, reqs, all_defined),
                     fs.alevel_suite_plain(t, q, rh, p, reqs, all_defined)),
                    ("hlevel_suite", fs.hlevel_suite_stacked(
                        t, q, rh, ps, a, b, reqs, all_defined),
                     fs.hlevel_suite_plain(t, q, rh, ps, a, b, reqs,
                                           all_defined))):
                label = f"{name} {shape} {kind}"
                if got.mask_map != ref.mask_map or not torch.equal(
                        got.masks, ref.masks):
                    raise AssertionError(f"{label}: mask planes differ")
                worst[name] = max(worst[name], compare_fields(
                    got.as_fields(), ref.as_fields(), label,
                    defined_only=True))
    log(f"alevel / hlevel suite == plain, {len(reqs)} modes in one request, "
        f"at {len(KERNEL_SHAPES)} shapes x masked/all-defined: max abs err "
        f"{worst['alevel_suite']!r} / {worst['hlevel_suite']!r}")
    return worst


def interp_bytes(nvar, nlev, nt, ny, nx, all_defined: bool) -> dict:
    """B2's bytes moved once: the whole level stack (values and masks),
    ps, and the outputs; and the bracket-only reads (two levels per field
    and target) the kernel makes."""
    pts, m = ny * nx, 0 if all_defined else 1
    out = nvar * nt * pts * 4 + (1 if all_defined else nvar) * nt * pts
    return {"stack": nvar * nlev * pts * (4 + m) + pts * (4 + m) + out,
            "bracket": 2 * nvar * nt * pts * (4 + m) + pts * (4 + m) + out}


def suite_bytes(nin3, nout, nplanes, nlev, ny, nx, ps_plane: bool,
                all_defined: bool) -> int:
    """B3 / B4's bytes moved once: ``nin3`` input stacks (values and
    masks), ps (B4), ``nout`` value planes and ``nplanes`` mask planes."""
    pts3, pts2, m = nlev * ny * nx, ny * nx, 0 if all_defined else 1
    return (nin3 * pts3 * (4 + m) + (pts2 * (4 + m) if ps_plane else 0)
            + nout * pts3 * 4 + nplanes * pts3)


def phase_isobaric(dev, smi: str, copy_gbps: float, reps=10) -> dict:
    """BASELINE config 4 at full size through derived_fields_isobaric."""
    import torch
    from mi_fieldcalc_tpu_torch import staging
    from mi_fieldcalc_tpu_torch.field import Field, from_sentinel
    from mi_fieldcalc_tpu_torch.models import (STANDARD_PLEVELS,
                                               derived_fields_isobaric)
    from mi_fieldcalc_tpu_torch.ops import fused
    from mi_fieldcalc_tpu_torch.ops import vertical_fused as vf

    nlev, ny, nx = ISO_SHAPE
    nt = len(STANDARD_PLEVELS)
    raw = make_column_inputs(nlev, ny, nx, seed=3, undef_frac=0.005)
    torch.cuda.reset_peak_memory_stats(dev)
    args = tuple(from_sentinel(a, device=dev) for a in raw[:5]) + tuple(
        torch.as_tensor(a, device=dev) for a in raw[5:])
    del raw
    in_gb = sum(f.values.numel() * 5 for f in args[:4]) / 1e9
    fused.derived_fields_fused.launches = 0
    vf.hlevel_to_plevel_fused.launches = 0
    out = derived_fields_isobaric(*args, plevels=STANDARD_PLEVELS,
                                  fused=True, stacked=True)
    torch.cuda.synchronize(dev)
    launches = {"interp": vf.hlevel_to_plevel_fused.launches,
                "derived_fields": fused.derived_fields_fused.launches}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    log(f"isobaric path {nlev}x{ny}x{nx} -> {nt} levels: launches "
        f"{launches}, inputs {in_gb:.2f} GB on the card, peak device "
        f"memory {peak_gb:.2f} GB")
    if launches != {"interp": 1, "derived_fields": 1}:
        raise AssertionError(f"expected one launch of each kernel, got "
                             f"{launches}")
    # the plain composition on the same tensors
    tk, q, u, v, ps, a, b, xm, ym, fc = args
    ps1 = Field(torch.zeros((ny, nx), dtype=torch.float32, device=dev),
                torch.ones((ny, nx), dtype=torch.bool, device=dev))
    plv = torch.tensor(STANDARD_PLEVELS, dtype=torch.float32, device=dev)
    zeros = torch.zeros(nt, dtype=torch.float32, device=dev)
    interp = vf.hlevel_to_plevel_plain((tk, q, u, v), ps, a, b,
                                       STANDARD_PLEVELS)
    plain = fused.derived_fields_plain(*interp, ps1, plv, zeros, xm, ym, fc)
    errs = compare_stacked(out, plain, "isobaric full size")
    max_abs = max(errs["max_abs"].values())
    res = staging._encode_step(*staging._fetch(out), 1e35)
    check_physics(res, nt, ny, nx)
    log(f"isobaric path == plain composition (max abs err {max_abs!r}); "
        f"outputs within the physical bounds")
    del out, plain, res

    # times: the two kernels and their plain versions, on these tensors
    kern = vf.hlevel_to_plevel_fused((tk, q, u, v), ps, a, b,
                                     STANDARD_PLEVELS)
    t_b2 = time_ms(lambda: vf.hlevel_to_plevel_fused(
        (tk, q, u, v), ps, a, b, STANDARD_PLEVELS), reps)
    p_b2 = time_ms(lambda: vf.hlevel_to_plevel_plain(
        (tk, q, u, v), ps, a, b, STANDARD_PLEVELS), reps)
    t_b1 = time_ms(lambda: fused.derived_fields_fused(
        *kern, ps1, plv, zeros, xm, ym, fc), reps)
    p_b1 = time_ms(lambda: fused.derived_fields_plain(
        *kern, ps1, plv, zeros, xm, ym, fc), reps)
    med = {k: statistics.median(x) for k, x in
           (("interp_ms", t_b2), ("interp_plain_ms", p_b2),
            ("derived_fields_ms", t_b1), ("derived_fields_plain_ms", p_b1))}
    nb = interp_bytes(4, nlev, nt, ny, nx, False)
    gbps = {k: v / med["interp_ms"] / 1e6 for k, v in nb.items()}
    log(f"[{smi}] isobaric step: interp kernel {med['interp_ms']:.4f} ms "
        f"(plain {med['interp_plain_ms']:.3f} ms), pipeline kernel on the "
        f"{nt} surfaces {med['derived_fields_ms']:.4f} ms (plain "
        f"{med['derived_fields_plain_ms']:.3f} ms); interp "
        f"{gbps['stack']:.1f} GB/s by whole-stack bytes "
        f"({nb['stack'] / 1e9:.3f} GB), {gbps['bracket']:.1f} GB/s by "
        f"bracket-read bytes; device copy {copy_gbps:.1f} GB/s")
    return {"launches": launches, "max_abs_err": max_abs,
            "inputs_gb": in_gb, "peak_device_gb": peak_gb,
            "times": {**med, "interp_ms_all": t_b2,
                      "interp_plain_ms_all": p_b2,
                      "derived_fields_ms_all": t_b1,
                      "derived_fields_plain_ms_all": p_b1},
            "interp_gbps": gbps, "interp_bytes": nb}


def check_suite_physics(out: dict, nlev: int, ny: int, nx: int) -> None:
    """Shape, finite defined values, and theta / dewpoints (K) within
    plausible bounds on config 2's inputs."""
    for name, a in out.items():
        if a.shape != (nlev, ny, nx) or a.dtype != np.float32:
            raise AssertionError(f"{name}: {a.shape} {a.dtype}")
        d = a[a != np.float32(1e35)]
        if d.size < a.size // 2 or not np.isfinite(d).all():
            raise AssertionError(f"{name}: too few or non-finite values")
    for name, lo, hi in (("temp3", 200.0, 600.0), ("hum_q9", 150.0, 400.0),
                         ("hum_rh11", 150.0, 400.0)):
        a = out[name]
        if not lo < float(np.median(a[a != np.float32(1e35)])) < hi:
            raise AssertionError(f"{name}: outside physical bounds")


def phase_suites(dev, smi: str, copy_gbps: float, reps=10,
                 request_reps=3) -> dict:
    """The suite entry (B4) and the a-level suite (B3) at full size."""
    import torch
    from mi_fieldcalc_tpu_torch import staging
    from mi_fieldcalc_tpu_torch.field import from_sentinel
    from mi_fieldcalc_tpu_torch.ops import fused_suite as fs

    nlev, ny, nx = SUITE_SHAPE
    reqs = fs._build_reqs("chip_smoke", *(CONFIG2.get(k, ()) for k in (
        "temps", "hums_q", "hums_rh", "thes", "ducts_q", "ducts_rh")))
    requests = [("undef lanes live", 11, 0.02, False),
                ("fully defined", 12, 0.0, True),
                ("undef lanes live", 13, 0.005, False)]
    inputs = [make_suite_inputs(nlev, ny, nx, seed, frac, plant=False)
              for _, seed, frac, _ in requests]
    fs.hlevel_suite_fused.launches = 0
    outs = []
    for tk, q, rh, _, ps, al, bl in inputs:
        outs.append(staging.run_hlevel_suite_np(tk, q, rh, ps, al, bl,
                                                device=dev, **CONFIG2))
    torch.cuda.synchronize(dev)
    h_launches = fs.hlevel_suite_fused.launches
    log(f"suite entry: 3 requests at {nlev}x{ny}x{nx}, {len(reqs)} outputs "
        f"each, suite kernel launches {h_launches}")
    if h_launches != 3:
        raise AssertionError(f"expected 3 suite kernel launches, got "
                             f"{h_launches}")
    h_err = 0.0
    for k, ((label, _, _, want_ad), (tk, q, rh, _, ps, al, bl), out) in \
            enumerate(zip(requests, inputs, outs)):
        host, ad = staging._suite_decode_step(
            tk, q, rh, ps, al, bl, reqs, staging.HostStager(3), 1e35)
        if ad != want_ad:
            raise AssertionError(f"suite request {k + 1}: all_defined routed "
                                 f"{ad}, expected {want_ad}")
        staged = staging._suite_upload_step(host, reqs, dev)
        plain = fs.hlevel_suite_plain(*staged, reqs, ad)
        if k == 0:
            kern = fs.hlevel_suite_stacked(*staged, reqs, ad)
            h_err = compare_fields(kern.as_fields(), plain.as_fields(),
                                   "suite full size masked",
                                   defined_only=True)
            del kern
        ref = staging._suite_encode_step(*staging._fetch(plain),
                                         plain.mask_map, reqs, 1e35)
        del plain, staged
        if list(out) != list(ref):
            raise AssertionError(f"suite request {k + 1}: keys {list(out)}")
        for name in out:
            g, r = out[name], ref[name]
            if not np.array_equal(g == np.float32(1e35),
                                  r == np.float32(1e35)):
                raise AssertionError(f"suite request {k + 1} {name}: undef "
                                     f"positions differ")
            value_err(torch.from_numpy(g), torch.from_numpy(r),
                      f"suite request {k + 1} {name}")
        check_suite_physics(out, nlev, ny, nx)
        log(f"suite request {k + 1} ({label}, all_defined={ad}): "
            f"{len(out)} outputs == plain version")

    # the a-level suite once at config 2's own shape, with a p field
    an, ay, ax = A_SUITE_SHAPE
    tk, q, rh, p, _, _, _ = make_suite_inputs(an, ay, ax, 1, 0.02,
                                              plant=False)
    t, q, rh, p = (from_sentinel(x, device=dev) for x in (tk, q, rh, p))
    fs.alevel_suite_fused.launches = 0
    a_out = fs.alevel_suite_fused(t, q, rh, p, **CONFIG2)
    torch.cuda.synchronize(dev)
    a_launches = fs.alevel_suite_fused.launches
    if a_launches != 1:
        raise AssertionError(f"expected 1 a-level suite launch, got "
                             f"{a_launches}")
    a_err = compare_fields(a_out, fs.alevel_suite_plain(
        t, q, rh, p, reqs).as_fields(), "alevel suite full size",
        defined_only=True)
    del a_out
    log(f"alevel_suite_fused at {an}x{ay}x{ax}: 1 launch, == plain "
        f"(max abs err {a_err!r})")

    # times: B3 on these tensors, B4 on request 1's
    k3 = time_ms(lambda: fs.alevel_suite_stacked(t, q, rh, p, reqs), reps)
    p3 = time_ms(lambda: fs.alevel_suite_plain(t, q, rh, p, reqs), reps)
    del t, q, rh, p
    tk, q, rh, _, ps, al, bl = inputs[0]
    host, ad = staging._suite_decode_step(tk, q, rh, ps, al, bl, reqs,
                                          staging.HostStager(3), 1e35)
    staged = staging._suite_upload_step(host, reqs, dev)
    k4 = time_ms(lambda: fs.hlevel_suite_stacked(*staged, reqs, ad), reps)
    p4 = time_ms(lambda: fs.hlevel_suite_plain(*staged, reqs, ad), reps)
    del staged
    nout = len(reqs)
    b3 = suite_bytes(4, nout, nout, an, ay, ax, False, False)
    b4 = suite_bytes(3, nout, nout, nlev, ny, nx, True, False)
    med = {"alevel_ms": statistics.median(k3),
           "alevel_plain_ms": statistics.median(p3),
           "hlevel_ms": statistics.median(k4),
           "hlevel_plain_ms": statistics.median(p4)}
    gbps = {"alevel": b3 / med["alevel_ms"] / 1e6,
            "hlevel": b4 / med["hlevel_ms"] / 1e6}
    log(f"[{smi}] alevel suite {an}x{ay}x{ax} masked: kernel "
        f"{med['alevel_ms']:.4f} ms, plain {med['alevel_plain_ms']:.3f} ms, "
        f"{gbps['alevel']:.1f} GB/s ({b3 / 1e9:.3f} GB); hlevel suite "
        f"{nlev}x{ny}x{nx} masked: kernel {med['hlevel_ms']:.4f} ms, plain "
        f"{med['hlevel_plain_ms']:.3f} ms, {gbps['hlevel']:.1f} GB/s "
        f"({b4 / 1e9:.3f} GB); device copy {copy_gbps:.1f} GB/s")

    # one masked suite request, split
    stager = staging.HostStager(3)
    parts = {k: [] for k in ("decode", "h2d", "kernel", "d2h", "encode",
                             "total")}
    for _ in range(request_reps):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        host, ad = staging._suite_decode_step(tk, q, rh, ps, al, bl, reqs,
                                              stager, 1e35)
        t1 = time.perf_counter()
        staged = staging._suite_upload_step(host, reqs, dev)
        torch.cuda.synchronize(dev)
        t2 = time.perf_counter()
        out = staging._suite_compute(staged, reqs, ad)
        torch.cuda.synchronize(dev)
        t3 = time.perf_counter()
        vals, masks = staging._fetch(out)
        t4 = time.perf_counter()
        staging._suite_encode_step(vals, masks, out.mask_map, reqs, 1e35)
        t5 = time.perf_counter()
        for key, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2, t4 - t3,
                                   t5 - t4, t5 - t0)):
            parts[key].append(dt * 1e3)
        del staged, out, vals, masks
    split = {k: statistics.median(v) for k, v in parts.items()}
    log(f"[{smi}] suite request (masked) median of {request_reps}, ms: "
        + " ".join(f"{k}={v:.2f}" for k, v in split.items()))
    return {"hlevel_launches": h_launches, "alevel_launches": a_launches,
            "hlevel_max_abs_err": h_err, "alevel_max_abs_err": a_err,
            "times": {**med, "alevel_ms_all": k3, "alevel_plain_ms_all": p3,
                      "hlevel_ms_all": k4, "hlevel_plain_ms_all": p4},
            "gbps": gbps, "bytes": {"alevel": b3, "hlevel": b4},
            "request_ms": split}


# ---------------------------------------------------------------- phase 9

#: the operational vessel-icing request: 719x929 (tools/perf_lab_mincog.py:
#: 27), vs 5 m/s, alpha 0.52, heights 2..11 m in 0.5 m steps = 19
#: (tools/perf_lab_mincog_fused.py:54)
ICING_SHAPE = (719, 929)
ICING_SCAL = (5.0, 0.52, 2.0, 11.0)
#: the JAX package's adversarial scalars: vs = 0 makes vr = c
ICING_VS0 = (0.0, 0.0, 1.0, 4.0)
ICING_SHAPES = ((1, 1), (3, 37), (37, 61), (9, 131), (64, 256), ICING_SHAPE)
#: float32 operations per unit of B5 / B6 work, counted from
#: csrc/vessel_icing.cu and common.cuh: each add, subtract, multiply,
#: divide, sqrt and floor is one; compares, selects, fabs and negation are
#: not counted.  Only what the function needs is charged: loop-invariant
#: and shared subexpressions once, each lane's own branch (the lane counts
#: of the plain version, ops/icing.py _count), the cheaper branch where a
#: lane's branch is not recorded.  exp_f32 23, log_f32 28, icing_f1 27;
#: tanh_f32 per evaluation by its branch, the polynomial 12 or the exp
#: form 27 (0 beyond |x| = 9).
OPS_TANH_POLY = 12
OPS_TANH_EXP = 27
OPS_WAVE_WARM = 3           # per warmup lane-step of the wave fixed point
OPS_WAVE_NEWTON = 14        # per Newton lane-step (slope, threshold, step)
OPS_WAVE_CAP = 68 + 17 * 78 + 2    # the 17-node cap prediction, its 69
#                                    tanh evaluations counted apart
OPS_WAVE_STALL = 5          # MINCOG's stall test (shares the cap's slope)
OPS_MINCOG_LANE = 50 * 137 + 38    # 50 RK steps + the per-lane setup
OPS_MINCOG_ALT2 = 59        # alt 2's group-velocity liquid water content
OPS_MINCOG_HEIGHT = 5       # per solved lane-height, any branch
OPS_MINCOG_RES = 50         # the heat-balance residual, value only
OPS_MINCOG_RES_D = 70       # the residual with its derivative
#: per lane-height by branch: the safeguarded Newton (bracket ends, secant
#: start, 8 steps, N at the root; the midpoint fallback is not charged),
#: no sign change (the bracket ends only), sal == 0 (the closed form)
OPS_MINCOG_ROOT = 2 * OPS_MINCOG_RES + 8 + 8 * (OPS_MINCOG_RES_D + 2) + 6
OPS_MINCOG_NOROOT = 2 * OPS_MINCOG_RES
OPS_MINCOG_SAL0 = OPS_MINCOG_RES + 3
OPS_MS_LANE = 50 * 138 + 35     # 50 RK steps + the per-lane setup
OPS_MS_HEIGHT = 8           # per lane and height outside the loop
OPS_MS_WARM = 40            # per warmup freezing-fraction lane-step
OPS_MS_NEWTON = 68          # per lane-step after it (slope, root, floor)
OPS_MS_CAP = 108            # per lane-height through the cap resolution


def make_icing_inputs(ny, nx, seed, undef_frac=1 / 23, adversarial=False,
                      plant=False):
    """The 11 sentinel inputs (sal, wave, x_wind, y_wind, airtemp, rh, sst,
    p, pw, aice, depth) in the JAX package's kernel-test ranges
    (tests/test_icing_fused.py:20-43): ice cover up to 0.5 (gated-off
    points), waves from 0.1 m (from 0 when ``adversarial``: skip points),
    and with ``adversarial`` long periods over shallow water (the wave
    fixed point's Newton phase and cap).  ``plant`` sets pw == 0 on every
    7th point and sal == 0 on every 11th."""
    rng = np.random.default_rng(seed)

    def f(lo, hi):
        return sentinel(rng, lo, hi, (ny, nx), undef_frac)

    a = [f(0.0, 35.0), f(0.0 if adversarial else 0.1, 8.0),
         f(-25.0, 25.0), f(-25.0, 25.0), f(-25.0, 2.0), f(0.3, 1.0),
         f(-1.0, 8.0), f(960.0, 1040.0),
         f(6.0, 14.0) if adversarial else f(2.0, 12.0), f(0.0, 0.5),
         f(2.0, 40.0) if adversarial else f(5.0, 500.0)]
    if plant:
        a[8].reshape(-1)[::7] = 0.0
        a[0].reshape(-1)[3::11] = 0.0
    return a


def icing_equal(got, ref, label: str) -> float:
    """Kernel vs plain Fields: masks bitwise, values equal (NaN where NaN);
    returns the max abs error over the points that are not both NaN."""
    import torch
    if not torch.equal(got.mask, ref.mask):
        raise AssertionError(f"{label}: masks differ at "
                             f"{int((got.mask != ref.mask).sum())} points")
    g, r = got.values, ref.values
    same = (g == r) | (torch.isnan(g) & torch.isnan(r))
    if not bool(same.all()):
        k = int((~same).reshape(-1).nonzero()[0, 0])
        raise AssertionError(
            f"{label}: {int((~same).sum())} values differ, e.g. kernel "
            f"{float(g.reshape(-1)[k])!r} plain {float(r.reshape(-1)[k])!r}")
    both_nan = torch.isnan(g) & torch.isnan(r)
    return float(torch.where(both_nan, torch.zeros_like(g),
                             (g - r).abs()).max())


def phase_icing_kernels(dev) -> dict:
    """B5 and B6 against their plain versions at ICING_SHAPES, and on an
    empty grid (no launch); the worst error of each kernel."""
    from mi_fieldcalc_tpu_torch.field import from_sentinel
    from mi_fieldcalc_tpu_torch.ops import icing_fused as F
    cases, worst = 0, {"mincog": 0.0, "modstall": 0.0}
    for shape in ICING_SHAPES:
        for kind, adversarial, scal in (("friendly", False, ICING_SCAL),
                                        ("adversarial", True, ICING_SCAL),
                                        ("vs=0", True, ICING_VS0)):
            raw = make_icing_inputs(*shape, seed=sum(shape) + len(kind),
                                    adversarial=adversarial,
                                    plant=adversarial)
            fields = [from_sentinel(a, device=dev) for a in raw]
            for alt in (1, 2):
                worst["mincog"] = max(worst["mincog"], icing_equal(
                    F.vessel_icing_mincog_fused(*fields, *scal, alt),
                    F.vessel_icing_mincog_plain(*fields, *scal, alt),
                    f"mincog alt {alt} {shape} {kind}"))
                cases += 1
            worst["modstall"] = max(worst["modstall"], icing_equal(
                F.vessel_icing_modstall_fused(*fields, *scal),
                F.vessel_icing_modstall_plain(*fields, *scal),
                f"modstall {shape} {kind}"))
            cases += 1
            del fields
    empty = [from_sentinel(np.zeros((0, 7), np.float32), device=dev)] * 11
    before = (F.vessel_icing_mincog_fused.launches,
              F.vessel_icing_modstall_fused.launches)
    for out in (F.vessel_icing_mincog_fused(*empty, *ICING_SCAL, 1),
                F.vessel_icing_modstall_fused(*empty, *ICING_SCAL)):
        if tuple(out.values.shape) != (0, 7):
            raise AssertionError(f"empty grid: shape {out.values.shape}")
    if before != (F.vessel_icing_mincog_fused.launches,
                  F.vessel_icing_modstall_fused.launches):
        raise AssertionError("empty grid: a kernel was launched")
    log(f"mincog (alt 1, 2) and modstall kernels == plain versions in "
        f"{cases} cases at {len(ICING_SHAPES)} shapes x friendly / "
        f"adversarial with pw == 0 and sal == 0 / vs = 0: max abs err "
        f"{worst!r}; an empty grid launches nothing")
    return {"cases": cases, "max_abs_err": worst}


def icing_requests():
    """Phase 9's three requests at ICING_SHAPE: (label, inputs, alt)."""
    return [("scattered undefs", make_icing_inputs(*ICING_SHAPE, 41, 0.01), 1),
            ("fully defined", make_icing_inputs(*ICING_SHAPE, 42, 0.0), 2),
            ("scattered undefs", make_icing_inputs(*ICING_SHAPE, 43, 0.002),
             1)]


def icing_plain_request(args, dev, alt: int) -> dict:
    """One request through the plain route on the card: the same decode
    and upload, the plain versions in place of the two kernels."""
    from mi_fieldcalc_tpu_torch import staging
    from mi_fieldcalc_tpu_torch.ops import icing_fused as F
    fields = staging._icing_upload_step(
        staging.HostStager(11).decode(*args), dev)
    outs = dict(zip(("overland", "mertins"), staging._icing_products(
        fields, *ICING_SCAL, alt, ("overland", "mertins"))))
    outs["modstall"] = F.vessel_icing_modstall_plain(*fields, *ICING_SCAL)
    outs["mincog"] = F.vessel_icing_mincog_plain(*fields, *ICING_SCAL, alt)
    return {k: f.to_sentinel().cpu().numpy() for k, f in outs.items()}


def check_icing_physics(out: dict, ny: int, nx: int) -> None:
    """The repo's own bounds on phase 9's outputs: the shape, finite
    defined values, gated-off points present, Mertins on its discrete
    rates, and the two solvers' rates non-negative (|ice| / number) with
    icing present (Overland's cubic is signed)."""
    for name, a in out.items():
        if a.shape != (ny, nx) or a.dtype != np.float32:
            raise AssertionError(f"{name}: {a.shape} {a.dtype}")
        d = a[a != np.float32(1e35)]
        if not (0 < d.size < a.size and np.isfinite(d).all()):
            raise AssertionError(f"{name}: undefined or non-finite rates")
        rates = np.float32([0.0, 0.8333, 2.0833, 4.375, 6.25])
        if name == "mertins" and not np.isin(d, rates).all():
            raise AssertionError("mertins: a rate outside its table")
        if name in ("mincog", "modstall") and not (
                (d >= 0).all() and (d > 0).any()):
            raise AssertionError(f"{name}: rates outside the physical bounds")


def phase_icing_path(dev) -> dict:
    """3 requests through run_vessel_icing_np, each against the plain
    route; the launch counts of both kernels."""
    import torch
    from mi_fieldcalc_tpu_torch import staging
    from mi_fieldcalc_tpu_torch.ops import icing_fused as F
    requests = icing_requests()
    F.vessel_icing_mincog_fused.launches = 0
    F.vessel_icing_modstall_fused.launches = 0
    outs = [staging.run_vessel_icing_np(*args, *ICING_SCAL, alt=alt,
                                        device=dev)
            for _, args, alt in requests]
    torch.cuda.synchronize(dev)
    launches = {"mincog": F.vessel_icing_mincog_fused.launches,
                "modstall": F.vessel_icing_modstall_fused.launches}
    log(f"icing entry: 3 requests at {ICING_SHAPE[0]}x{ICING_SHAPE[1]}, "
        f"{int((ICING_SCAL[3] - ICING_SCAL[2]) * 2 + 1)} heights, launches "
        f"{launches}")
    if launches != {"mincog": 3, "modstall": 3}:
        raise AssertionError(f"expected 3 launches of each kernel, got "
                             f"{launches}")
    for k, ((label, args, alt), out) in enumerate(zip(requests, outs)):
        ref = icing_plain_request(args, dev, alt)
        if list(out) != list(staging.ICING_PRODUCTS):
            raise AssertionError(f"icing request {k + 1}: keys {list(out)}")
        for name in out:
            g, r = out[name], ref[name]
            same = (g.view(np.int32) == r.view(np.int32)) | (
                np.isnan(g) & np.isnan(r))
            if not same.all():
                raise AssertionError(
                    f"icing request {k + 1} {name}: {int((~same).sum())} "
                    f"points differ from the plain route")
        check_icing_physics(out, *ICING_SHAPE)
        undef = [int((o == np.float32(1e35)).sum()) for o in out.values()]
        log(f"icing request {k + 1} ({label}, alt {alt}): 4 products == "
            f"plain route, undefined points {undef}")
    return {"launches": launches}


def phase_icing_golden(dev) -> dict:
    """The port's ModStall at 719x929 against the compiled reference's
    golden (tests/conformance_cases.py:372-377, tests/goldens/
    goldens_large.npz), on the points both define."""
    from mi_fieldcalc_tpu_torch.field import from_sentinel
    from mi_fieldcalc_tpu_torch.ops import icing_fused as F
    sys.path.insert(0, str(ROOT / "tests"))
    from conformance_cases import LARGE_CASES, case_inputs
    case = next(c for c in LARGE_CASES
                if c.name == "large_vesselIcingModStall")
    fields = [from_sentinel(a, device=dev) for a in case_inputs(case)]
    s = case.scalars
    out = F.vessel_icing_modstall_fused(*fields, s["vs"], s["alpha"],
                                        s["zmin"], s["zmax"])
    with np.load(ROOT / "tests" / "goldens" / "goldens_large.npz") as g:
        ref = g[case.name + "__out"]
    mask = out.mask.cpu().numpy()
    vals = out.values.cpu().numpy()
    both = mask & (ref != np.float32(1e35)) & ~np.isnan(ref)
    err = np.abs(vals[both] - ref[both])
    bad = ~(err <= case.atol + case.rtol * np.abs(ref[both]))
    log(f"modstall at 719x929 vs the oracle golden: {int(both.sum())} "
        f"points both defined, max abs err {float(err.max())!r}, "
        f"{int(bad.sum())} outside rtol/atol {case.rtol}")
    if not both.any() or bad.any():
        raise AssertionError("modstall disagrees with the 719x929 golden")
    return {"points": int(both.sum()), "max_abs_err": float(err.max()),
            "rtol": case.rtol, "atol": case.atol}


def icing_bound(trips: dict, number: int, npts: int, nplanes: int,
                nflags: int, copy_gbps: float, alt) -> dict:
    """The least time for B5 (``alt`` 1 or 2) or B6 (``alt`` None) on
    these inputs: bytes (planes and flags read once, the output written
    once) over the copy rate, float32 operations (the lane counts the
    plain version recorded) over PEAK_F32."""
    def n(key):
        return trips.get(key, 0)

    nbytes = npts * (4 * nplanes + nflags + 4)
    ops = (n("wave_warm") * OPS_WAVE_WARM + n("wave_newton") * OPS_WAVE_NEWTON
           + n("cap") * OPS_WAVE_CAP + n("tanh_poly") * OPS_TANH_POLY
           + n("tanh_exp") * OPS_TANH_EXP)
    if alt is not None:
        ops += (n("cap") * OPS_WAVE_STALL
                + n("solved") * (OPS_MINCOG_LANE + number * OPS_MINCOG_HEIGHT
                                 + (OPS_MINCOG_ALT2 if alt == 2 else 0))
                + n("h_root") * OPS_MINCOG_ROOT
                + n("h_noroot") * OPS_MINCOG_NOROOT
                + n("h_sal0") * OPS_MINCOG_SAL0)
    else:
        ops += (n("solved") * (OPS_MS_LANE + number * OPS_MS_HEIGHT)
                + n("height_warm") * OPS_MS_WARM
                + n("height_newton") * OPS_MS_NEWTON
                + n("height_cap") * OPS_MS_CAP)
    b_ms = nbytes / copy_gbps / 1e6
    o_ms = ops / PEAK_F32 * 1e3
    return {"bytes": nbytes, "ops": ops, "bytes_ms": b_ms, "ops_ms": o_ms,
            "bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations"}


def phase_icing_times(dev, smi: str, copy_gbps: float, reps=10,
                      plain_reps=3, request_reps=3) -> dict:
    """Kernel and plain times on request 1's inputs, the bounds, and one
    request split."""
    import math
    import torch
    from mi_fieldcalc_tpu_torch import staging
    from mi_fieldcalc_tpu_torch.field import Field
    from mi_fieldcalc_tpu_torch.ops import icing_fused as F
    from mi_fieldcalc_tpu_torch.ops.icing import _mincog_decay, _number
    vs, alpha, zmin, zmax = ICING_SCAL
    vsca = float(vs * math.cos(alpha))
    number = _number(zmin, zmax)
    decay = _mincog_decay(zmin, number)
    _, args, _ = icing_requests()[0]
    fields = staging._icing_upload_step(
        staging.HostStager(11).decode(*args), dev)
    npts = fields[0].values.numel()
    res = {"card": smi, "shape": list(ICING_SHAPE), "heights": number}
    g5, p5, sh5, sk5 = F._mincog_prologue(*fields, vs, alpha)
    g6, p6, sh6 = F._modstall_prologue(*fields)
    for name, launch, plain, nplanes, nflags in (
            ("mincog", lambda: F._launch(
                F.vessel_icing_mincog_fused, F._PLANES, p5, (g5, sh5, sk5),
                decay, vsca, 1),
             lambda trips=None: F._mincog_plain(g5, p5, sh5, sk5, vsca, 1,
                                                decay, trips), 17, 3),
            ("modstall", lambda: F._launch(
                F.vessel_icing_modstall_fused, F._MS_PLANES, p6, (g6, sh6),
                decay, vsca, None),
             lambda trips=None: F._modstall_plain(g6, p6, sh6, vsca, decay,
                                                  trips), 12, 2)):
        k = time_ms(launch, reps)
        trips = {}
        plain(trips)                      # the plain version's warm-up
        p = time_ms(plain, plain_reps, warmup=False)
        bound = icing_bound(trips, number, npts, nplanes, nflags, copy_gbps,
                            1 if name == "mincog" else None)
        res[name] = {"kernel_ms": statistics.median(k), "kernel_ms_all": k,
                     "plain_ms": statistics.median(p), "plain_ms_all": p,
                     "trips": trips, **bound}
        log(f"[{smi}] {name} {ICING_SHAPE[0]}x{ICING_SHAPE[1]}, {number} "
            f"heights: kernel {res[name]['kernel_ms']:.4f} ms, plain "
            f"{res[name]['plain_ms']:.1f} ms; bound {bound['bound_ms']:.4f} "
            f"ms by {bound['bound_by']} ({bound['ops']:.3e} ops -> "
            f"{bound['ops_ms']:.4f} ms; {bound['bytes'] / 1e6:.1f} MB -> "
            f"{bound['bytes_ms']:.4f} ms); lane counts {trips}")
    del p5, p6, g5, g6, fields

    # one request, split (host clock around synchronised steps)
    stager = staging.HostStager(11)
    keys = ("decode", "h2d", "overland_mertins", "mincog_prologue",
            "mincog_kernel", "modstall_prologue", "modstall_kernel",
            "stack", "d2h", "encode", "total")
    parts = {k: [] for k in keys}
    for _ in range(request_reps):
        marks = []

        def mark():
            torch.cuda.synchronize(dev)
            marks.append(time.perf_counter())

        mark()
        host = stager.decode(*args)
        mark()
        fields = staging._icing_upload_step(host, dev)
        mark()
        outs = staging._icing_products(fields, *ICING_SCAL, 1,
                                       ("overland", "mertins"))
        mark()
        g5, p5, sh5, sk5 = F._mincog_prologue(*fields, vs, alpha)
        mark()
        mc = F._launch(F.vessel_icing_mincog_fused, F._PLANES, p5,
                       (g5, sh5, sk5), decay, vsca, 1)
        mark()
        g6, p6, sh6 = F._modstall_prologue(*fields)
        mark()
        ms = F._launch(F.vessel_icing_modstall_fused, F._MS_PLANES, p6,
                       (g6, sh6), decay, vsca, None)
        mark()
        buf = staging._icing_stack(outs + [Field(ms, g6), Field(mc, g5)])
        mark()
        host = staging._icing_fetch(buf, 4, ICING_SHAPE)
        mark()
        staging._icing_encode_step(*host, staging.ICING_PRODUCTS, 1e35)
        mark()
        for key, a, b in zip(keys, marks, marks[1:]):
            parts[key].append((b - a) * 1e3)
        parts["total"].append((marks[-1] - marks[0]) * 1e3)
        del fields, outs, p5, p6, buf
    split = {k: statistics.median(v) for k, v in parts.items()}
    res["request_ms"] = split
    log(f"[{smi}] icing request (scattered undefs, alt 1) median of "
        f"{request_reps}, ms: " + " ".join(f"{k}={v:.2f}"
                                          for k, v in split.items()))
    return res


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch does not import: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import mi_fieldcalc_tpu_torch  # noqa: F401  (fails outside the repo)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    t_start = time.perf_counter()
    log("== phase 1: environment")
    smi, env = phase_env()
    log("== phase 2: build")
    build = phase_build()
    log("== phase 3: kernel vs plain version on the card")
    worst = phase_kernel(dev)
    log("== phase 4: main path, 3 requests through run_derived_fields_np")
    main_path = phase_main_path(dev)
    log("== phase 5: times on this card")
    times = phase_times(dev, smi, request_reps=3)
    log("== phase 6: interpolation and suite kernels vs plain versions")
    new_worst = phase_new_kernels(dev)
    log("== phase 7: the isobaric path at 137x719x929 -> 11 surfaces")
    iso = phase_isobaric(dev, smi, times["copy_gbps"])
    log("== phase 8: the suite entry and the a-level suite at full size")
    suites = phase_suites(dev, smi, times["copy_gbps"])
    log("== phase 9: vessel icing")
    icing_kernels = phase_icing_kernels(dev)
    icing_path = phase_icing_path(dev)
    icing_golden = phase_icing_golden(dev)
    icing_times = phase_icing_times(dev, smi, times["copy_gbps"])
    wall = time.perf_counter() - t_start
    log(f"all phases passed in {wall:.1f} s")

    log("record: " + json.dumps({
        "env": env, "build": build, "kernel_max_rel_err": worst,
        "main_path": main_path, "times": times,
        "new_kernels_max_abs_err": new_worst, "isobaric": iso,
        "suites": suites, "icing": {
            "kernels": icing_kernels, "path": icing_path,
            "golden": icing_golden, "times": icing_times},
        "wall_s": wall}))
    src, ref = "mi_fieldcalc_tpu_torch/csrc/", "mi_fieldcalc_tpu/ops/"
    copy = times["copy_gbps"]

    def bound(nbytes, ops):
        b_ms, o_ms = nbytes / copy / 1e6, ops / PEAK_F32 * 1e3
        return {"bound_ms": max(b_ms, o_ms),
                "bound_by": "bytes" if b_ms >= o_ms else "operations",
                "library_ms": None}

    pts1 = NLEV * NY * NX
    nlev4, ny4, nx4 = ISO_SHAPE
    from mi_fieldcalc_tpu_torch.models import STANDARD_PLEVELS
    nt4 = len(STANDARD_PLEVELS)
    an, ay, ax = A_SUITE_SHAPE
    nout = len(CONFIG2["temps"] + CONFIG2["hums_q"] + CONFIG2["hums_rh"])
    bounds = {
        "derived_fields": bound(layout_bytes(NLEV, NY, NX, False),
                                OPS_B1_POINT * pts1),
        "vertical_interp": bound(
            iso["interp_bytes"]["bracket"],
            ny4 * nx4 * nt4 * ((nlev4 - 1) * OPS_B2_PAIR + OPS_B2_TARGET)),
        "alevel_suite": bound(suites["bytes"]["alevel"],
                              OPS_SUITE_OUTPUT * nout * an * ay * ax),
        "hlevel_suite": bound(suites["bytes"]["hlevel"],
                              OPS_SUITE_OUTPUT * nout * pts1)}
    kernels = [{
        "name": "derived_fields",
        "route": "cuda",
        "source": src + "derived_fields.cu",
        "replaces": ref + "fused.py:301",
        "launches": main_path["launches"],
        "max_abs_err": main_path["max_abs_err"],
        "ms": times["masked"]["kernel_ms"],
        "plain_ms": times["masked"]["plain_ms"],
        **bounds["derived_fields"],
    }, {
        "name": "vertical_interp",
        "route": "cuda",
        "source": src + "vertical_interp.cu",
        "replaces": ref + "vertical_fused.py:54",
        "launches": iso["launches"]["interp"],
        "max_abs_err": max(iso["max_abs_err"], new_worst["interp"]),
        "ms": iso["times"]["interp_ms"],
        "plain_ms": iso["times"]["interp_plain_ms"],
        **bounds["vertical_interp"],
    }, {
        "name": "alevel_suite",
        "route": "cuda",
        "source": src + "level_suite.cu",
        "replaces": ref + "fused_suite.py:230",
        "launches": suites["alevel_launches"],
        "max_abs_err": max(suites["alevel_max_abs_err"],
                           new_worst["alevel_suite"]),
        "ms": suites["times"]["alevel_ms"],
        "plain_ms": suites["times"]["alevel_plain_ms"],
        **bounds["alevel_suite"],
    }, {
        "name": "hlevel_suite",
        "route": "cuda",
        "source": src + "level_suite.cu",
        "replaces": ref + "fused_suite.py:377",
        "launches": suites["hlevel_launches"],
        "max_abs_err": max(suites["hlevel_max_abs_err"],
                           new_worst["hlevel_suite"]),
        "ms": suites["times"]["hlevel_ms"],
        "plain_ms": suites["times"]["hlevel_plain_ms"],
        **bounds["hlevel_suite"],
    }] + [{
        "name": f"vessel_icing_{name}",
        "route": "cuda",
        "source": src + "vessel_icing.cu",
        "replaces": ref + ("icing_fused.py:69" if name == "mincog"
                           else "icing_fused.py:186"),
        "launches": icing_path["launches"][name],
        "max_abs_err": icing_kernels["max_abs_err"][name],
        "ms": icing_times[name]["kernel_ms"],
        "plain_ms": icing_times[name]["plain_ms"],
        "bound_ms": icing_times[name]["bound_ms"],
        "bound_by": icing_times[name]["bound_by"],
        "library_ms": None,
    } for name in ("mincog", "modstall")]
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
