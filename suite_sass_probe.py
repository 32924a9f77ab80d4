"""SASS instructions per point of the level-suite kernel on BASELINE
config 2's request set, for one or more checkouts.

    python3 suite_sass_probe.py DIR [DIR ...]

The kernel as built runs every request family through one switch, so its
instruction count says little of one point's path.  This compiles a copy
of DIR's ``mi_fieldcalc_tpu_torch/csrc/level_suite.cu`` with config 2's
requests fixed at compile time (the request loop runs to a constant and is
unrolled, what request r computes comes from a switch on r, the shared-
quantity flags are literals), so that the compiler folds the request
switch and the main body of the h-level masked kernel is close to one
point's path; it prints that body's count over the points a thread takes
(``kPer`` where the source has it, else 1).  It reads the two forms the
kernel has had: the first, which decodes (family, mode) per point from
``P.fam[r]`` / ``P.comp[r]`` and per-request flags, and the one that reads
ops decoded on the host (``P.op[r]``, ``P.uses``).  For any other source
it fails: the decode below is a copy of the kernel's and must follow it.

Needs nvcc and cuobjdump (the CUDA toolkit), no card.  Imports nothing of
JAX.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

#: the first kernel's per-request flags for config 2, as its set_requests
#: derived them: temp 4 and the odd humidity modes read the T-form esat,
#: every request but the RH ones reads pidcp
_CONFIG2_FLAGS = {"need_t": "true", "need_th": "false",
                  "need_th5": "false", "need_pid": "true"}
_FAMILY_ARG = ("temps", "hums_q", "hums_rh", "thes", "ducts_q", "ducts_rh")


def probe_decode(fam: str, c: int) -> tuple:
    """``decode`` of csrc/level_suite.cu for the host-decoded form: the
    Op's name, the Use names and tdconv of request (fam, c)."""
    odd = c % 2 == 1
    esat = ["kUseEsatT"] if odd else ["kUsePid", "kUseEsatTH"]
    qsat = esat + ["kUseQsatT" if odd else "kUseQsatTH"]
    td = "kT0" if fam in ("hum_q", "hum_rh") and c >= 9 else "0.0f"
    form = "T" if odd else "TH"
    if fam == "temp":
        return (f"kOpTemp{c}", ["kUsePid"] + (["kUseEsatT", "kUseQsatT"]
                                             if c == 4 else [])
                + (["kUseEsat5"] if c == 5 else []), td)
    if fam in ("hum_q", "hum_rh"):
        if c <= 2:
            return f"kOpRh{form}", qsat, td
        if c <= 4:
            return f"kOpQ{form}", qsat, td
        if c in (5, 6, 9, 10):
            return f"kOpTdQ{form}", qsat + [f"kUseTdQ{form}"], td
        return f"kOpTdRh{form}", esat + [f"kUseTdRh{form}"], td
    if fam == "the":
        return f"kOpThe{c}", ["kUsePid"], td
    if fam == "duct_q":
        return f"kOpDuctQ{form}", [] if odd else ["kUsePid"], td
    return f"kOpDuctRh{form}", esat, td


def probe_source(src: str) -> str:
    """``level_suite.cu``'s text with config 2's requests fixed at compile
    time; raises ValueError where the source is not one of the two forms."""
    from mi_fieldcalc_tpu_torch.ops.fused_suite import _FAMILY_CODE
    reqs = [(f, c) for f, arg in zip(_FAMILY_CODE, _FAMILY_ARG)
            for c in chip_smoke.CONFIG2.get(arg, ())]

    def table(name, kind, values):
        cases = " ".join(f"case {r}: return {v};"
                         for r, v in enumerate(values))
        return (f"__device__ __forceinline__ {kind} {name}(int r) {{\n"
                f"  switch (r) {{ {cases} default: return 0; }}\n}}\n")

    if "P.op[r]" in src:
        dec = [probe_decode(f, c) for f, c in reqs]
        tables = (table("probe_op", "int", [d[0] for d in dec])
                  + table("probe_tdconv", "float", [d[2] for d in dec]))
        subs = {r"P\.op\[r\]": "probe_op(r)",
                r"P\.tdconv\[r\]": "probe_tdconv(r)",
                r"\bP\.uses\b": "(" + " | ".join(sorted(
                    {u for d in dec for u in d[1]})) + ")"}
    else:
        tables = (table("probe_fam", "int", [_FAMILY_CODE[f] for f, _ in reqs])
                  + table("probe_comp", "int", [c for _, c in reqs]))
        subs = {r"P\.fam\[r\]": "probe_fam(r)",
                r"P\.comp\[r\]": "probe_comp(r)"}
        subs.update({rf"\bP\.{k}\b": v for k, v in _CONFIG2_FLAGS.items()})
    head = "template <bool kHybrid, bool kAllDefined>\n__global__"
    if head not in src:
        raise ValueError("the kernel's template head was not found")
    out = src.replace(head, tables + head, 1)
    loop = re.compile(r"\n(\s*)for \(int r = 0; r < P\.nreq;")
    out, n = loop.subn(rf"\n\1#pragma unroll\n\1for (int r = 0; r < "
                       rf"{len(reqs)};", out)
    if n != 1:
        raise ValueError("the request loop was not found once")
    for pattern, text in subs.items():
        out, k = re.subn(pattern, text, out)
        if k < 1:
            raise ValueError(f"{pattern} was not found")
    return out


def probe(d) -> dict:
    """SASS counts (``chip_smoke.sass_summary``) of the four kernels of
    checkout ``d`` compiled from :func:`probe_source`, per point over the
    points a thread takes."""
    from mi_fieldcalc_tpu_torch._build import NVCC_FLAGS, find_nvcc
    csrc = Path(d) / "mi_fieldcalc_tpu_torch" / "csrc"
    src = (csrc / "level_suite.cu").read_text()
    m = re.search(r"constexpr int kPer = (\d+)", src)
    per = int(m.group(1)) if m else 1
    flags = [f for f in NVCC_FLAGS
             if f not in ("-Xcompiler", "-fPIC", "-Xptxas", "-v")]
    with tempfile.TemporaryDirectory() as tmp:
        cu, cubin = Path(tmp) / "probe.cu", Path(tmp) / "probe.cubin"
        cu.write_text(probe_source(src))
        subprocess.run([find_nvcc(), *flags, "-I", str(csrc), "-cubin",
                        "-o", str(cubin), str(cu)], check=True,
                       capture_output=True, text=True, timeout=600)
        funcs = chip_smoke.cuobjdump_sass(cubin)
    out = {"points_per_thread": per}
    for name, instrs in funcs.items():
        m = re.search(r"suite_kernelILb(\d)ELb(\d)E", name)
        if m:
            key = (("hlevel" if m.group(1) == "1" else "alevel") + " "
                   + ("all_defined" if m.group(2) == "1" else "masked"))
            out[key] = chip_smoke.sass_summary(instrs, per)
    return out


def main(dirs) -> int:
    if not dirs:
        print(__doc__, file=sys.stderr)
        return 1
    for d in dirs:
        chip_smoke.log(f"{d}: suite-sass-probe " + json.dumps(probe(d)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
