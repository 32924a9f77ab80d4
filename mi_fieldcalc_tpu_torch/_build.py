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

:data:`_SIGNATURES` declares every C entry's arguments, and :func:`call`
is the one way the wrappers and labs launch one: on the device's current
stream, raising with the CUDA error where the entry refuses.
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

import torch

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


_P, _I, _F, _I64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                    ctypes.c_int64)
_PP, _IP = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)


class _Stream(ctypes.c_void_p):
    """An entry's ``void* stream`` parameter: where :func:`call` passes the
    current stream."""


_S = _Stream

#: every C entry of ``csrc/*.cu`` and its ctypes argument types, in the
#: only copy Python holds (``tests/test_torch_build.py`` holds it to the C
#: signatures); each returns an ``int`` error code but ``mf_error_string``
_SIGNATURES = {
    "mf_derived_fields": [_P] * 16 + [_I] * 8 + [_I64, _S],
    "mf_vertical_interp": ([_PP, _PP, _I] + [_P] * 5 + [_I, _P, _P]
                           + [_I] * 5 + [_P, _S, _IP]),
    "mf_alevel_suite": [_P] * 8 + [_IP, _I, _IP, _P, _P] + [_I] * 4 + [_S],
    "mf_hlevel_suite": [_P] * 10 + [_IP, _I, _IP, _P, _P] + [_I] * 4 + [_S],
    "mf_vessel_icing_mincog": [_PP] + [_P] * 4 + [_I, _F, _I, _P, _I, _S],
    "mf_vessel_icing_modstall": [_PP] + [_P] * 3 + [_I, _F, _P, _I, _S],
    "mf_vessel_icing_attributes": [_I] + [_IP] * 4,
    "mf_probe_copy": [_P] * 14 + [_I] * 5 + [_S],
    "mf_probe_add1": [_P, _PP] + [_I] * 6 + [_S],
    "mf_probe_window": [_P] * 4 + [_I] * 4 + [_S],
    "mf_probe_solver": [_P] * 5 + [_I, _S],
    "mf_ensemble_stats": [_P] * 7 + [_I, _I64, _I, _F, _S],
    "mf_ensemble_prob": [_P] * 3 + [_I, _I64, _S],
    "mf_error_string": [_I],
}


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with every entry of :data:`_SIGNATURES` that it exports
    declared; entries it lacks are skipped (a host build holds one
    source's)."""
    for name, argtypes in _SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = (ctypes.c_char_p if name == "mf_error_string"
                          else ctypes.c_int)
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare the C entry points."""
    return _declare(ctypes.CDLL(str(build())))


def _c_args(entry: str, args: tuple, stream=None) -> tuple:
    """``entry``'s C arguments: ``args`` in its order, each tensor as its
    data pointer, with ``stream`` put in its stream slot."""
    args = tuple(a.data_ptr() if isinstance(a, torch.Tensor) else a
                 for a in args)
    at = _SIGNATURES[entry].index(_Stream)
    return args[:at] + (stream,) + args[at:]


def call(fn: str, entry: str, dev: torch.device, *args) -> None:
    """Launch the library's ``entry`` on ``dev``'s current stream with
    ``args`` (:func:`_c_args`), and raise, naming ``fn``, with the CUDA error
    if the launch was refused."""
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, entry)(*_c_args(entry, args, stream))
    if err != 0:
        raise RuntimeError(f"{fn}: kernel launch failed: "
                           f"{lib.mf_error_string(err).decode()}")
