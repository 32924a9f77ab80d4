"""The derived-field pipeline in one CUDA kernel, with its plain version.

Port of :func:`mi_fieldcalc_tpu.ops.fused.derived_fields_fused`
(``fused.py:669-1006``): ``stacked=True`` with the 9 deduplicated mask
planes, or the 2 gate planes under ``all_defined``, and the per-field
layout ``stacked=False`` on top of it.
Its TPU kernel ``fused.py:_kernel`` becomes the hand-written CUDA kernel
``csrc/derived_fields.cu``; the plain version is
:func:`derived_fields_plain`, the port's :func:`derived_fields` stacked
into the same layout.

Tensors on the CPU take the plain version.  CUDA tensors take the kernel,
or the wrapper raises: it never falls back.  The grid is the logical
``(ny, nx)``; the kernel bounds-masks its own edges, so none of the TPU's
padded layout, tiling or sharding offsets carry over.
"""

from __future__ import annotations

import ctypes

import torch

from ..field import Field
from ..models.pipeline import DerivedFieldsStacked, derived_fields
from ._harness import check_tensor

__all__ = ["derived_fields_fused", "derived_fields_plain", "fused_supported"]

#: the field whose mask each plane of the 9- and 2-plane stacks holds
_PLANE_FIELDS9 = tuple(DerivedFieldsStacked.MASK9.index(k) for k in range(9))
_PLANE_FIELDS2 = tuple(DerivedFieldsStacked.MASK2.index(k) for k in range(2))
#: the kernel's limits (csrc/derived_fields.cu): gridDim.y = ceil(ny/4)
#: tiles of 4 rows, 32-bit offsets inside a level plane, gridDim.z = nlev
_MAX_NY = 4 * 65535
_MAX_PLANE = 2**31 - 1
_MAX_NLEV = 65535


def fused_supported(ny: int, nx: int) -> bool:
    """Whether the kernel covers this grid: at least 3x3 as in the
    reference, ``ny`` within the CUDA grid's y limit and a plane within
    the kernel's 32-bit offsets."""
    return 3 <= ny <= _MAX_NY and nx >= 3 and ny * nx <= _MAX_PLANE


def derived_fields_plain(tk: Field, q: Field, u: Field, v: Field, ps: Field,
                         alevel, blevel, xmapr, ymapr, fcoriolis,
                         all_defined: bool = False) -> DerivedFieldsStacked:
    """The kernel's plain PyTorch version: :func:`derived_fields` stacked
    into the kernel's layout.  ``all_defined`` ignores the input masks
    (every one is taken as True, as the kernel never reads them) and
    keeps the 2 data-dependent gate planes."""
    if all_defined:
        tk, q, u, v, ps = (Field(f.values, torch.ones_like(f.mask))
                           for f in (tk, q, u, v, ps))
    out = derived_fields(tk, q, u, v, ps, alevel, blevel, xmapr, ymapr,
                         fcoriolis)
    planes = _PLANE_FIELDS2 if all_defined else _PLANE_FIELDS9
    return DerivedFieldsStacked(
        values=torch.stack([f.values for f in out]),
        masks=torch.stack([out[k].mask for k in planes]))


def derived_fields_fused(tk: Field, q: Field, u: Field, v: Field, ps: Field,
                         alevel, blevel, xmapr, ymapr, fcoriolis,
                         stacked: bool = True,
                         all_defined: bool = False):
    """All 12 pipeline outputs in one pass, as a
    :class:`DerivedFieldsStacked`: values ``f32[12, nlev, ny, nx]`` and
    masks ``bool[9, nlev, ny, nx]``, or ``bool[2, nlev, ny, nx]`` when
    ``all_defined`` (the caller asserts every input point is defined; input
    masks are then not read).  ``stacked=False`` returns the same result
    as :class:`DerivedFields` (``.as_fields()``: views of the stacked
    tensors; fields that share a mask plane share its tensor).

    On CUDA tensors this launches the kernel and counts the launch in
    ``derived_fields_fused.launches``; on CPU tensors it runs
    :func:`derived_fields_plain`."""
    dev = tk.values.device
    if dev.type == "cpu":
        out = derived_fields_plain(tk, q, u, v, ps, alevel, blevel, xmapr,
                                   ymapr, fcoriolis, all_defined)
    elif dev.type == "cuda":
        out = _launch(tk, q, u, v, ps, alevel, blevel, xmapr, ymapr,
                      all_defined)
    else:
        raise ValueError(f"derived_fields_fused: no kernel for {dev}")
    return out if stacked else out.as_fields()


derived_fields_fused.launches = 0


def _check(t, name: str, shape: tuple, dtype: torch.dtype,
           dev: torch.device) -> None:
    check_tensor("derived_fields_fused", t, name, shape, dtype, dev)


def _launch(tk, q, u, v, ps, alevel, blevel, xmapr, ymapr,
            all_defined: bool) -> DerivedFieldsStacked:
    from .._build import load_library

    dev = tk.values.device
    if tk.values.dim() != 3:
        raise ValueError("derived_fields_fused: tk must be [nlev, ny, nx]")
    nlev, ny, nx = tk.values.shape
    if not fused_supported(ny, nx) or nlev > _MAX_NLEV:
        raise ValueError(f"derived_fields_fused: unsupported grid "
                         f"({nlev}, {ny}, {nx}); need ny, nx >= 3")
    f32, b8 = torch.float32, torch.bool
    for name, f in (("tk", tk), ("q", q), ("u", u), ("v", v)):
        _check(f.values, name, (nlev, ny, nx), f32, dev)
        _check(f.mask, name + ".mask", (nlev, ny, nx), b8, dev)
    _check(ps.values, "ps", (ny, nx), f32, dev)
    _check(ps.mask, "ps.mask", (ny, nx), b8, dev)
    for name, a in (("alevel", alevel), ("blevel", blevel)):
        _check(a, name, (nlev,), f32, dev)
    for name, a in (("xmapr", xmapr), ("ymapr", ymapr)):
        _check(a, name, (ny, nx), f32, dev)

    values = torch.empty((12, nlev, ny, nx), dtype=f32, device=dev)
    masks = torch.empty((2 if all_defined else 9, nlev, ny, nx), dtype=b8,
                        device=dev)
    lib = load_library()

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr())

    def mptr(f):
        return None if all_defined else ptr(f.mask)

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        derived_fields_fused.launches += 1
        err = lib.mf_derived_fields(
            ptr(tk.values), ptr(q.values), ptr(u.values), ptr(v.values),
            mptr(tk), mptr(q), mptr(u), mptr(v), ptr(ps.values), mptr(ps),
            ptr(alevel), ptr(blevel), ptr(xmapr), ptr(ymapr),
            ptr(values), ptr(masks), nlev, ny, nx, int(all_defined),
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"derived_fields_fused: kernel launch failed: "
                           f"{lib.mf_error_string(err).decode()}")
    return DerivedFieldsStacked(values=values, masks=masks)
