"""JAX-free ctypes binding of the native host codec ``native/fieldcodec.cc``.

The port's counterpart of :mod:`mi_fieldcalc_tpu.native`: the entries
the serving path uses, :func:`decode_pad_batch`, :func:`decode_pad`,
:func:`encode_trim_batch` (with ``mask_map``) and, for ``align=True``,
:func:`decode_resample_batch` (``native.py:278-345``), and the rest of its
public surface, :func:`available`, :func:`decode`, :func:`encode`,
:func:`encode_trim`, :func:`count_defined` and :func:`defined_state_host`
(``native.py:135-160, 528-590``).  The LEV-packed entries (levpack) are
not ported.  It binds the same library
(ABI 6), built by ``native/build.sh`` with ``g++`` on first use into the
port's git-ignored ``_build/`` directory.  Without a compiler every entry
falls back to numpy with the same results, as the JAX binding does; the
codec is host code either way.  :func:`codec` says which one runs.
Undefined points decode to 0.0.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .field import UNDEF, ValuesDefined

__all__ = ["available", "codec", "decode", "decode_pad", "decode_pad_batch",
           "decode_resample_batch", "encode", "encode_trim",
           "encode_trim_batch", "count_defined", "defined_state_host"]

_ABI = 6
_REPO = Path(__file__).resolve().parent.parent
_SCRIPT = _REPO / "native" / "build.sh"
_SO = Path(__file__).resolve().parent / "_build" / "libmifieldcalc_host.so"

_f32p = ctypes.POINTER(ctypes.c_float)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_i64 = ctypes.c_int64
_i64p = ctypes.POINTER(ctypes.c_int64)


def _build() -> None:
    """Run ``native/build.sh`` into a scratch directory and move the
    library into place in one rename, so a concurrent reader never sees a
    half-written file."""
    _SO.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_SO.parent) as tmp:
        subprocess.run(["sh", str(_SCRIPT)], env={**os.environ, "OUT": tmp},
                       capture_output=True, timeout=300, check=True)
        os.replace(Path(tmp) / _SO.name, _SO)


@functools.cache
def _load() -> Optional[ctypes.CDLL]:
    try:
        if not _SO.is_file():
            _build()
        lib = ctypes.CDLL(str(_SO))
        if lib.mf_native_abi_version() != _ABI:
            _build()
            lib = ctypes.CDLL(str(_SO))
            if lib.mf_native_abi_version() != _ABI:
                return None
    except (OSError, subprocess.SubprocessError):
        return None
    f32 = ctypes.c_float
    lib.mf_decode.restype = _i64
    lib.mf_decode.argtypes = [_f32p, _i64, f32, f32, _f32p, _u8p]
    lib.mf_encode.restype = None
    lib.mf_encode.argtypes = [_f32p, _u8p, _i64, f32, _f32p]
    lib.mf_count_defined.restype = _i64
    lib.mf_count_defined.argtypes = [_f32p, _i64, f32]
    lib.mf_decode_pad.restype = _i64
    lib.mf_decode_pad.argtypes = [_f32p, _i64, _i64, _i64, _i64, _i64,
                                  ctypes.c_float, ctypes.c_float, _f32p, _u8p]
    lib.mf_encode_trim.restype = None
    lib.mf_encode_trim.argtypes = [_f32p, _u8p, _i64, _i64, _i64, _i64, _i64,
                                   ctypes.c_float, _f32p]
    lib.mf_decode_pad_batch.restype = None
    lib.mf_decode_pad_batch.argtypes = [
        ctypes.POINTER(_f32p), _i64, _i64, _i64, _i64, _i64, _i64,
        ctypes.c_float, ctypes.c_float, _f32p, _u8p, _i64p]
    lib.mf_decode_resample_batch.restype = None
    lib.mf_decode_resample_batch.argtypes = [
        ctypes.POINTER(_f32p), _i64, _i64, _i64, _i64, _i64, _i64,
        _i64p, _i64p, _f32p, _i64p, _i64p, _f32p,
        ctypes.c_float, ctypes.c_float, _f32p, _u8p, _i64p]
    lib.mf_encode_trim_batch_map.restype = None
    lib.mf_encode_trim_batch_map.argtypes = [
        _f32p, _u8p, _i64p, _i64, _i64, _i64, _i64, _i64, _i64,
        ctypes.c_float, ctypes.POINTER(_f32p)]
    return lib


def codec() -> str:
    """``"native"`` or ``"numpy"``: which codec the entries run (builds
    the native one if needed)."""
    return "numpy" if _load() is None else "native"


def available() -> bool:
    """Whether the compiled codec is loadable (builds it if needed)."""
    return _load() is not None


def _f32c(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32)


def _mask_u8(mask, shape) -> np.ndarray:
    m = np.ascontiguousarray(mask)
    if m.shape != tuple(shape):
        m = np.ascontiguousarray(np.broadcast_to(m, shape))
    return m.astype(np.uint8, copy=False)


def decode(values, undef: float = UNDEF, fill: float = 0.0,
           ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Sentinel array -> ``(values with fill at undefined points, bool
    mask, n_defined)`` in one pass (``is_defined``,
    FieldCalculations.h:42-45)."""
    v = _f32c(values)
    lib = _load()
    if lib is None:
        mask = ~np.isnan(v) & (v != np.float32(undef))
        return np.where(mask, v, np.float32(fill)), mask, int(mask.sum())
    out = np.empty_like(v)
    mask = np.empty(v.shape, dtype=np.uint8)
    n_def = lib.mf_decode(v.ctypes.data_as(_f32p), v.size, undef, fill,
                          out.ctypes.data_as(_f32p),
                          mask.ctypes.data_as(_u8p))
    return out, mask.view(np.bool_), int(n_def)


def encode(values, mask, undef: float = UNDEF) -> np.ndarray:
    """``(values, mask)`` -> the sentinel array (``Field.to_sentinel`` on
    the host); ``mask`` broadcasts to the values."""
    v = _f32c(values)
    m = _mask_u8(mask, v.shape)
    lib = _load()
    if lib is None:
        return np.where(m != 0, v, np.float32(undef))
    out = np.empty_like(v)
    lib.mf_encode(v.ctypes.data_as(_f32p), m.ctypes.data_as(_u8p), v.size,
                  undef, out.ctypes.data_as(_f32p))
    return out


def count_defined(values, undef: float = UNDEF) -> int:
    """The defined points of a sentinel array."""
    v = _f32c(values)
    lib = _load()
    if lib is None:
        return int((~np.isnan(v) & (v != np.float32(undef))).sum())
    return int(lib.mf_count_defined(v.ctypes.data_as(_f32p), v.size, undef))


def defined_state_host(values, undef: float = UNDEF) -> ValuesDefined:
    """``checkDefined(const float*, n)`` (FieldDefined.cc:41-57) of a
    sentinel array on the host."""
    v = _f32c(values)
    n_def = count_defined(v, undef)
    if n_def == v.size:
        return ValuesDefined.ALL_DEFINED
    if n_def == 0:
        return ValuesDefined.NONE_DEFINED
    return ValuesDefined.SOME_DEFINED


def _check_pad(ny, nx, ny_p, nx_p) -> None:
    if ny_p < ny or nx_p < nx:
        raise ValueError(f"padded shape ({ny_p}, {nx_p}) smaller than "
                         f"logical ({ny}, {nx})")


def decode_pad(values, ny_p: int, nx_p: int, undef: float = UNDEF,
               ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Sentinel array ``[..., ny, nx]`` -> ``(values, bool mask,
    n_defined)`` on an ``(ny_p, nx_p)`` grid in one pass: undefined points
    and padding get 0, padding mask False."""
    v = _f32c(values)
    ny, nx = v.shape[-2:]
    _check_pad(ny, nx, ny_p, nx_p)
    lib = _load()
    if lib is None:
        mask = ~np.isnan(v) & (v != np.float32(undef))
        out = np.where(mask, v, np.float32(0.0))
        pad = [(0, 0)] * (v.ndim - 2) + [(0, ny_p - ny), (0, nx_p - nx)]
        return np.pad(out, pad), np.pad(mask, pad), int(mask.sum())
    lead = int(np.prod(v.shape[:-2], dtype=np.int64))
    out = np.empty(v.shape[:-2] + (ny_p, nx_p), np.float32)
    mask = np.empty(out.shape, np.uint8)
    n_def = lib.mf_decode_pad(v.ctypes.data_as(_f32p), lead, ny, nx, ny_p,
                              nx_p, undef, 0.0, out.ctypes.data_as(_f32p),
                              mask.ctypes.data_as(_u8p))
    return out, mask.view(np.bool_), int(n_def)


def decode_pad_batch(arrays, ny_p: int, nx_p: int, undef: float = UNDEF,
                     out: Optional[np.ndarray] = None,
                     mask: Optional[np.ndarray] = None,
                     ) -> Tuple[np.ndarray, np.ndarray, list]:
    """K same-shape sentinel arrays ``[..., ny, nx]`` -> one contiguous
    ``[K, ..., ny_p, nx_p]`` (values, mask) block in one parallel pass.
    ``out``/``mask`` take preallocated buffers (a stager reuses them);
    returns ``(values, bool mask, per-array defined counts)``."""
    vs = [_f32c(a) for a in arrays]
    shape = vs[0].shape
    if any(a.shape != shape for a in vs):
        raise ValueError("decode_pad_batch: arrays must share a shape")
    ny, nx = shape[-2:]
    _check_pad(ny, nx, ny_p, nx_p)
    k = len(vs)
    oshape = (k,) + shape[:-2] + (ny_p, nx_p)
    out = np.empty(oshape, np.float32) if out is None else out
    mask = np.empty(oshape, np.uint8) if mask is None else mask
    if out.shape != oshape or out.dtype != np.float32:
        raise ValueError("decode_pad_batch: bad `out` buffer")
    if mask.shape != oshape or mask.dtype not in (np.uint8, np.bool_):
        raise ValueError("decode_pad_batch: bad `mask` buffer")
    lib = _load()
    if lib is None:
        counts = []
        for i, a in enumerate(vs):
            o, m, n = decode_pad(a, ny_p, nx_p, undef)
            out[i] = o
            mask[i] = m
            counts.append(n)
        return out, mask.view(np.bool_), counts
    lead = int(np.prod(shape[:-2], dtype=np.int64))
    srcs = (_f32p * k)(*[a.ctypes.data_as(_f32p) for a in vs])
    counts = (ctypes.c_int64 * k)()
    lib.mf_decode_pad_batch(srcs, k, lead, ny, nx, ny_p, nx_p, undef, 0.0,
                            out.ctypes.data_as(_f32p),
                            mask.ctypes.data_as(_u8p), counts)
    return out, mask.view(np.bool_), list(counts)


def decode_resample_batch(arrays, ny_t: int, nx_t: int, undef: float = UNDEF,
                          fill: float = 0.0,
                          out: Optional[np.ndarray] = None,
                          mask: Optional[np.ndarray] = None,
                          ) -> Tuple[np.ndarray, np.ndarray, list]:
    """K same-shape sentinel stacks ``[..., ny, nx]`` decoded and
    re-gridded (mask-aware bilinear, :func:`.ingest.resample_align`) onto
    one ``[K, ..., ny_t, nx_t]`` (values, mask) block in one parallel pass;
    ``fill`` at undefined points.  ``out``/``mask`` take preallocated
    buffers; returns ``(values, bool mask, per-array defined counts of the
    target grid)``.  The codec samples :func:`.ingest._axis_coords`'s
    coordinates, as the numpy fallback does; its values may differ from
    the fallback's in the last ulp (FP contraction)."""
    from .ingest import _axis_coords
    vs = [_f32c(a) for a in arrays]
    shape = vs[0].shape
    if any(a.shape != shape for a in vs):
        raise ValueError("decode_resample_batch: arrays must share a shape")
    ny, nx = shape[-2:]
    k = len(vs)
    oshape = (k,) + shape[:-2] + (ny_t, nx_t)
    out = np.empty(oshape, np.float32) if out is None else out
    mask = np.empty(oshape, np.uint8) if mask is None else mask
    if out.shape != oshape or out.dtype != np.float32:
        raise ValueError("decode_resample_batch: bad `out` buffer")
    if mask.shape != oshape or mask.dtype not in (np.uint8, np.bool_):
        raise ValueError("decode_resample_batch: bad `mask` buffer")
    lib = _load()
    if lib is None:
        from .ingest import resample_align
        counts = []
        for i, a in enumerate(vs):
            o, m, n = decode(resample_align(a, undef, shape_to=(ny_t, nx_t)),
                             undef, fill)
            out[i] = o
            mask[i] = m
            counts.append(n)
        return out, mask.view(np.bool_), counts
    y0, y1, wy = _axis_coords(ny, ny_t)
    x0, x1, wx = _axis_coords(nx, nx_t)
    lead = int(np.prod(shape[:-2], dtype=np.int64))
    srcs = (_f32p * k)(*[a.ctypes.data_as(_f32p) for a in vs])
    counts = (ctypes.c_int64 * k)()
    lib.mf_decode_resample_batch(
        srcs, k, lead, ny, nx, ny_t, nx_t,
        y0.ctypes.data_as(_i64p), y1.ctypes.data_as(_i64p),
        wy.ctypes.data_as(_f32p), x0.ctypes.data_as(_i64p),
        x1.ctypes.data_as(_i64p), wx.ctypes.data_as(_f32p), undef, fill,
        out.ctypes.data_as(_f32p), mask.ctypes.data_as(_u8p), counts)
    return out, mask.view(np.bool_), list(counts)


def encode_trim(values, mask, ny: int, nx: int,
                undef: float = UNDEF) -> np.ndarray:
    """``(values, mask)`` on a padded ``[..., ny_p, nx_p]`` grid -> the
    logical ``[..., ny, nx]`` sentinel array in one pass
    (:func:`decode_pad`'s output-side dual)."""
    v = _f32c(values)
    ny_p, nx_p = v.shape[-2:]
    _check_pad(ny, nx, ny_p, nx_p)
    m = _mask_u8(mask, v.shape)
    lib = _load()
    if lib is None:
        return np.where(m[..., :ny, :nx] != 0, v[..., :ny, :nx],
                        np.float32(undef))
    lead = int(np.prod(v.shape[:-2], dtype=np.int64))
    out = np.empty(v.shape[:-2] + (ny, nx), np.float32)
    lib.mf_encode_trim(v.ctypes.data_as(_f32p), m.ctypes.data_as(_u8p), lead,
                       ny, nx, ny_p, nx_p, undef, out.ctypes.data_as(_f32p))
    return out


def encode_trim_batch(values, mask, ny: int, nx: int, mask_map,
                      undef: float = UNDEF) -> list:
    """K result planes ``[K, ..., ny_p, nx_p]`` plus a mask block ->
    K logical ``[..., ny, nx]`` sentinel arrays in one parallel pass.

    ``mask_map[f]`` is value plane f's plane in the mask block, ``-1``
    meaning constant defined.  It serves the kernel's 9-plane
    (``DerivedFieldsStacked.MASK9``) and 2-plane (``MASK2``) stacks
    without expanding masks."""
    v = _f32c(values)
    ny_p, nx_p = v.shape[-2:]
    _check_pad(ny, nx, ny_p, nx_p)
    k = v.shape[0]
    m = np.ascontiguousarray(mask)
    if m.dtype not in (np.uint8, np.bool_):
        raise ValueError("encode_trim_batch: masks must be bool or uint8")
    m = m.view(np.uint8)
    mmap = np.asarray(mask_map, np.int64)
    if mmap.shape != (k,):
        raise ValueError(f"mask_map must have length {k}")
    if m.shape[1:] != v.shape[1:] or mmap.max(initial=-1) >= m.shape[0]:
        raise ValueError("mask block does not cover mask_map")
    lib = _load()
    if lib is None:
        return [v[f, ..., :ny, :nx].copy() if mmap[f] < 0 else
                encode_trim(v[f], m[mmap[f]], ny, nx, undef)
                for f in range(k)]
    lead = int(np.prod(v.shape[1:-2], dtype=np.int64))
    outs = [np.empty(v.shape[1:-2] + (ny, nx), np.float32) for _ in range(k)]
    optrs = (_f32p * k)(*[o.ctypes.data_as(_f32p) for o in outs])
    lib.mf_encode_trim_batch_map(
        v.ctypes.data_as(_f32p), m.ctypes.data_as(_u8p),
        mmap.ctypes.data_as(_i64p), k, lead, ny, nx, ny_p, nx_p, undef,
        optrs)
    return outs
