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
   decode, H2D, kernel, D2H and encode.

A line ``record: {...}`` holds every number measured.  The second-to-last
line is a JSON object with the kernel's record, the last
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
NAMES = ("p", "th", "rh", "td", "thetae", "ducting", "wspeed", "vort", "div",
         "tadv", "gradt", "tfp")


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


def time_ms(fn, reps: int) -> list:
    """Per-run device times of ``fn`` in ms (CUDA events), after a warm-up."""
    import torch
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
            if "registers" in line or "spill" in line:
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


def phase_times(dev, smi: str, nlev=NLEV, ny=NY, nx=NX, reps=10) -> dict:
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
        for _ in range(5):
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
        log(f"[{smi}] request ({label}) median of 5, ms: " + " ".join(
            f"{k}={v:.2f}" for k, v in med.items()))
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

    log("== phase 1: environment")
    smi, env = phase_env()
    log("== phase 2: build")
    build = phase_build()
    log("== phase 3: kernel vs plain version on the card")
    worst = phase_kernel(dev)
    log("== phase 4: main path, 3 requests through run_derived_fields_np")
    main_path = phase_main_path(dev)
    log("== phase 5: times on this card")
    times = phase_times(dev, smi)

    log("record: " + json.dumps({
        "env": env, "build": build, "kernel_max_rel_err": worst,
        "main_path": main_path, "times": times}))
    kernels = [{
        "name": "derived_fields",
        "route": "cuda",
        "source": "mi_fieldcalc_tpu_torch/csrc/derived_fields.cu",
        "replaces": "mi_fieldcalc_tpu/ops/fused.py:301",
        "launches": main_path["launches"],
        "max_abs_err": main_path["max_abs_err"],
        "ms": times["masked"]["kernel_ms"],
        "plain_ms": times["masked"]["plain_ms"],
    }]
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
