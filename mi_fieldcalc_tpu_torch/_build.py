"""Build the package's CUDA sources with ``nvcc`` at first use and load
them with ctypes.

Every ``csrc/*.cu`` file (they share ``csrc/common.cuh``) is compiled by
its own ``nvcc`` process, all started together, and the objects are linked
into one shared library with a plain C interface (no PyTorch headers, so a
build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -Xcompiler -fPIC -c <source>.cu        (one per source)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared <objects>

``-fmad=false`` keeps every multiply and add rounded on its own, which the
deterministic pow and the bitwise mask gates rely on.  The library lands in
``_build/`` (git-ignored) under a name keyed by a hash of the sources and
flags, so unchanged sources are not rebuilt.  A missing ``nvcc`` or a
failed compile raises with the compiler's message.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["NVCC_FLAGS", "find_nvcc", "build", "load_library"]

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
#: where the CUDA toolkit sits when neither CUDA_HOME nor PATH names it
CUDA_DEFAULT = Path("/usr/local/cuda")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str | None:
    """``nvcc`` from ``CUDA_HOME``, then ``PATH``, then the default
    toolkit location; None when there is none."""
    root = os.environ.get("CUDA_HOME")
    if root and (Path(root) / "bin" / "nvcc").is_file():
        return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = CUDA_DEFAULT / "bin" / "nvcc"
    return str(default) if default.is_file() else None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def build(out_dir: Path | None = None) -> Path:
    """Compile ``csrc/*.cu`` into ``out_dir`` (default ``_build/``) unless a
    library for these exact sources and flags is already there; returns
    its path.  The compiler's report (``-Xptxas -v``: registers, spills)
    is kept beside it as ``<library>.log``."""
    out_dir = Path(out_dir) if out_dir is not None else BUILD_DIR
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    lib = out_dir / f"libmf_kernels_{h.hexdigest()[:16]}.so"
    if lib.is_file():
        return lib
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (looked in CUDA_HOME, PATH and "
            f"{CUDA_DEFAULT}/bin): the CUDA kernels of "
            "mi_fieldcalc_tpu_torch are compiled with nvcc at first use")
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        cus = [s for s in srcs if s.suffix == ".cu"]
        objs = [str(Path(tmp) / (s.stem + ".o")) for s in cus]
        procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True))
                 for cmd in ([nvcc, *NVCC_FLAGS, "-c", str(s), "-o", o]
                             for s, o in zip(cus, objs))]
        report = []
        for cmd, proc in procs:
            out, _ = proc.communicate()
            report.append(out)
            if proc.returncode != 0:
                for _, other in procs:
                    other.kill()
                    other.wait()
                raise RuntimeError(
                    f"nvcc failed with exit code {proc.returncode}:\n"
                    f"{' '.join(cmd)}\n{out}")
        tmp_lib = str(Path(tmp) / lib.name)
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
               "-o", tmp_lib, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with exit code {proc.returncode}:\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        Path(str(lib) + ".log").write_text("".join(report))
        os.replace(tmp_lib, lib)
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare the C entry points."""
    lib = ctypes.CDLL(str(build()))
    p, i = ctypes.c_void_p, ctypes.c_int
    pp, ip = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
    lib.mf_derived_fields.argtypes = [p] * 16 + [i] * 8 + [p]
    lib.mf_vertical_interp.argtypes = ([pp, pp, i] + [p] * 5
                                       + [i, p, p] + [i] * 5 + [p, ip])
    lib.mf_alevel_suite.argtypes = [p] * 8 + [ip, i, ip, p, p] + [i] * 4 + [p]
    lib.mf_hlevel_suite.argtypes = ([p] * 10 + [ip, i, ip, p, p] + [i] * 4
                                    + [p])
    f = ctypes.c_float
    lib.mf_vessel_icing_mincog.argtypes = [pp] + [p] * 4 + [i, f, i, p, i, p]
    lib.mf_vessel_icing_modstall.argtypes = [pp] + [p] * 3 + [i, f, p, i, p]
    lib.mf_vessel_icing_attributes.argtypes = [i] + [ip] * 4
    lib.mf_probe_copy.argtypes = [p] * 14 + [i] * 5 + [p]
    lib.mf_probe_add1.argtypes = [p, pp] + [i] * 6 + [p]
    lib.mf_probe_window.argtypes = [p] * 4 + [i] * 4 + [p]
    lib.mf_probe_solver.argtypes = [p] * 4 + [i, p]
    for fn in (lib.mf_derived_fields, lib.mf_vertical_interp,
               lib.mf_alevel_suite, lib.mf_hlevel_suite,
               lib.mf_vessel_icing_mincog, lib.mf_vessel_icing_modstall,
               lib.mf_vessel_icing_attributes, lib.mf_probe_copy,
               lib.mf_probe_add1, lib.mf_probe_window, lib.mf_probe_solver):
        fn.restype = i
    lib.mf_error_string.argtypes = [i]
    lib.mf_error_string.restype = ctypes.c_char_p
    return lib
