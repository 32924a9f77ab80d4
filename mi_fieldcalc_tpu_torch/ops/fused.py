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
``(ny, nx)``; the kernel bounds-masks its own edges, so the TPU's padded
layout and tiling do not carry over.  The sharding offsets do
(``global_shape``, ``grid_offsets``): a shard of a domain-decomposed grid
(:mod:`..parallel.fused`) fills its edges only where they are the global
grid's.
"""

from __future__ import annotations

import operator

import torch

from .. import _build
from ..field import Field
from ..models.pipeline import DerivedFieldsStacked, derived_fields
from ..utils.profiling import span
from ._harness import check_tensor, not_ported
from .stencil import ShardCtx, fill_bounds, shard_context

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


def _placement(shape, global_shape, grid_offsets, halo_rows) -> tuple:
    """``(row0, col0, nyg, nxg)`` of a block of ``shape``: where its local
    (0, 0) sits in the global grid, checked, as Python ints."""
    ny, nx = shape[-2], shape[-1]
    if isinstance(halo_rows, torch.Tensor) or operator.index(halo_rows) < 0:
        raise ValueError("derived_fields_fused: halo_rows must be an int "
                         ">= 0")
    if grid_offsets is None:
        if global_shape is not None and tuple(global_shape) != (ny, nx):
            raise not_ported("mi_fieldcalc_tpu.ops.fused."
                             "derived_fields_fused",
                             "the padded layout (global_shape without "
                             "grid_offsets)")
        return 0, 0, ny, nx
    if global_shape is None:
        raise ValueError("derived_fields_fused: grid_offsets needs "
                         "global_shape")
    if any(isinstance(x, torch.Tensor) for x in (*grid_offsets,
                                                 *global_shape)):
        raise TypeError("derived_fields_fused: grid_offsets and "
                        "global_shape are Python ints, not tensors")
    row0, col0 = (operator.index(x) for x in grid_offsets)
    nyg, nxg = (operator.index(x) for x in global_shape)
    fill_bounds(ny, row0, nyg)
    fill_bounds(nx, col0, nxg)
    return row0, col0, nyg, nxg


def derived_fields_plain(tk: Field, q: Field, u: Field, v: Field, ps: Field,
                         alevel, blevel, xmapr, ymapr, fcoriolis,
                         all_defined: bool = False, global_shape=None,
                         grid_offsets=None,
                         halo_rows: int = 2) -> DerivedFieldsStacked:
    """The kernel's plain PyTorch version: :func:`derived_fields` stacked
    into the kernel's layout.  ``all_defined`` ignores the input masks
    (every one is taken as True, as the kernel never reads them) and
    keeps the 2 data-dependent gate planes.  With ``grid_offsets`` the
    operators run on the shard (``ops.stencil.ShardCtx``), as the kernel
    does."""
    row0, col0, nyg, nxg = _placement(tk.values.shape, global_shape,
                                      grid_offsets, halo_rows)
    if all_defined:
        tk, q, u, v, ps = (Field(f.values, torch.ones(
            f.values.shape, dtype=torch.bool, device=f.values.device))
            for f in (tk, q, u, v, ps))
    if grid_offsets is None:
        out = derived_fields(tk, q, u, v, ps, alevel, blevel, xmapr, ymapr,
                             fcoriolis)
    else:
        with shard_context(ShardCtx(row0, col0, nyg, nxg)):
            out = derived_fields(tk, q, u, v, ps, alevel, blevel, xmapr,
                                 ymapr, fcoriolis)
    planes = _PLANE_FIELDS2 if all_defined else _PLANE_FIELDS9
    return DerivedFieldsStacked(
        values=torch.stack([f.values for f in out]),
        masks=torch.stack([out[k].mask for k in planes]))


def derived_fields_fused(tk: Field, q: Field, u: Field, v: Field, ps: Field,
                         alevel, blevel, xmapr, ymapr, fcoriolis,
                         stacked: bool = True,
                         all_defined: bool = False, global_shape=None,
                         grid_offsets=None, halo_rows: int = 2,
                         out_values=None, out_masks=None):
    """All 12 pipeline outputs in one pass, as a
    :class:`DerivedFieldsStacked`: values ``f32[12, nlev, ny, nx]`` and
    masks ``bool[9, nlev, ny, nx]``, or ``bool[2, nlev, ny, nx]`` when
    ``all_defined`` (the caller asserts every input point is defined; input
    masks are then not read, and may be ``None``).  ``stacked=False``
    returns the same result as :class:`DerivedFields` (``.as_fields()``:
    views of the stacked tensors; fields that share a mask plane share its
    tensor).

    On one shard of a domain-decomposed grid, ``global_shape`` is the
    global ``(ny, nx)`` and ``grid_offsets`` the global ``(row, col)`` of
    the local ``(0, 0)``, negative on halo rows: a pair of Python ints that
    reach the kernel as launch arguments (no device tensor, no host sync).
    ``fillEdges`` then fires only at the global edges; output rows and
    columns outside the global grid, or on halo rows, are the caller's to
    crop.  ``halo_rows`` tells the kernel nothing that the offsets do not
    (the TPU kernel chose its tiles by it); it must be an int >= 0.
    ``global_shape`` without ``grid_offsets`` is the TPU's padded layout,
    not ported, unless it is the block's own shape.

    ``out_values`` and ``out_masks``, given together, are where the
    outputs land, and what is returned: ``f32[12, nlev, ny, nx]`` and the
    route's ``bool[9 | 2, nlev, ny, nx]``, each plane contiguous and the
    planes of both one stride apart, in elements, of at least ``nlev * ny
    * nx``, as member ``m``'s slot ``[:, m]`` of ``[12 | 9 | 2, nmem, nlev,
    ny, nx]`` stacks is.  Without them the outputs are new dense tensors.

    On CUDA tensors this launches the kernel and counts the launch in
    ``derived_fields_fused.launches``; on CPU tensors it runs
    :func:`derived_fields_plain` (and copies its outputs into
    ``out_values`` / ``out_masks``)."""
    dev = tk.values.device
    if dev.type == "cpu":
        dense = not _out_stride(out_values, out_masks, tk.values.shape,
                                all_defined, dev)
        with span("b1.kernel", dev):
            out = derived_fields_plain(tk, q, u, v, ps, alevel, blevel,
                                       xmapr, ymapr, fcoriolis, all_defined,
                                       global_shape, grid_offsets, halo_rows)
            if not dense:
                out_values.copy_(out.values)
                out_masks.copy_(out.masks)
                out = DerivedFieldsStacked(out_values, out_masks)
    elif dev.type == "cuda":
        out = _launch(tk, q, u, v, ps, alevel, blevel, xmapr, ymapr,
                      all_defined, _placement(tk.values.shape, global_shape,
                                              grid_offsets, halo_rows),
                      out_values, out_masks)
    else:
        raise ValueError(f"derived_fields_fused: no kernel for {dev}")
    return out if stacked else out.as_fields()


derived_fields_fused.launches = 0


def _check(t, name: str, shape: tuple, dtype: torch.dtype,
           dev: torch.device) -> None:
    check_tensor("derived_fields_fused", t, name, shape, dtype, dev)


def _out_stride(out_values, out_masks, shape: tuple, all_defined: bool,
                dev: torch.device) -> int:
    """The plane stride, in elements, of the caller's output tensors, or
    0 (new dense outputs) without them; raises on any layout other than
    the one the kernel writes (:func:`derived_fields_fused`)."""
    if out_values is None and out_masks is None:
        return 0
    name = "derived_fields_fused"
    if out_values is None or out_masks is None:
        raise ValueError(f"{name}: give out_values and out_masks together")
    nplanes = 2 if all_defined else 9
    for arg, t, planes, dtype in (
            ("out_values", out_values, 12, torch.float32),
            ("out_masks", out_masks, nplanes, torch.bool)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {arg} must be a tensor on {dev}, got "
                            f"{type(t).__name__}")
        if t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected "
                             f"{dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} is {t.dtype}, expected {dtype}")
        if tuple(t.shape) != (planes,) + tuple(shape):
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                             f"expected {(planes,) + tuple(shape)}")
        if not t[0].is_contiguous():
            raise ValueError(f"{name}: each plane of {arg} must be "
                             f"contiguous")
    stride = out_values.stride(0)
    if out_masks.stride(0) != stride or stride < out_values[0].numel():
        raise ValueError(f"{name}: out_values and out_masks need one plane "
                         f"stride of at least nlev * ny * nx elements, got "
                         f"{stride} and {out_masks.stride(0)}")
    return stride


def _launch_args(tk, q, u, v, ps, alevel, blevel, xmapr, ymapr,
                 all_defined: bool, placement: tuple = None,
                 out_values=None, out_masks=None) -> tuple:
    """One launch's checks, outputs and arguments, on any device:
    ``(outputs, args)``, ``args`` those of ``mf_derived_fields`` but the
    stream, tensors for pointers.  ``placement`` is :func:`_placement`'s
    ``(row0, col0, nyg, nxg)``, the whole grid when ``None``; the outputs
    land in ``out_values`` / ``out_masks`` where given
    (:func:`_out_stride`)."""
    dev = tk.values.device
    if tk.values.dim() != 3:
        raise ValueError("derived_fields_fused: tk must be [nlev, ny, nx]")
    nlev, ny, nx = tk.values.shape
    if not fused_supported(ny, nx) or nlev > _MAX_NLEV:
        raise ValueError(f"derived_fields_fused: unsupported grid "
                         f"({nlev}, {ny}, {nx}); need ny, nx >= 3")
    if placement is None:
        placement = (0, 0, ny, nx)
    f32, b8 = torch.float32, torch.bool
    for name, f, shape in (("tk", tk, (nlev, ny, nx)),
                           ("q", q, (nlev, ny, nx)),
                           ("u", u, (nlev, ny, nx)),
                           ("v", v, (nlev, ny, nx)), ("ps", ps, (ny, nx))):
        _check(f.values, name, shape, f32, dev)
        if not all_defined:     # the all-defined route reads no mask
            _check(f.mask, name + ".mask", shape, b8, dev)
    for name, a in (("alevel", alevel), ("blevel", blevel)):
        _check(a, name, (nlev,), f32, dev)
    for name, a in (("xmapr", xmapr), ("ymapr", ymapr)):
        _check(a, name, (ny, nx), f32, dev)

    stride = _out_stride(out_values, out_masks, (nlev, ny, nx), all_defined,
                         dev)
    if stride:
        values, masks = out_values, out_masks
    else:
        values = torch.empty((12, nlev, ny, nx), dtype=f32, device=dev)
        masks = torch.empty((2 if all_defined else 9, nlev, ny, nx),
                            dtype=b8, device=dev)

    def mask(f):
        return None if all_defined else f.mask

    return DerivedFieldsStacked(values=values, masks=masks), (
        tk.values, q.values, u.values, v.values, mask(tk), mask(q), mask(u),
        mask(v), ps.values, mask(ps), alevel, blevel, xmapr, ymapr, values,
        masks, nlev, ny, nx, *placement, int(all_defined), stride)


def _launch(tk, q, u, v, ps, alevel, blevel, xmapr, ymapr,
            all_defined: bool, placement: tuple = None, out_values=None,
            out_masks=None) -> DerivedFieldsStacked:
    """One launch, as :func:`_launch_args` sets it up."""
    dev = tk.values.device
    out, args = _launch_args(tk, q, u, v, ps, alevel, blevel, xmapr, ymapr,
                             all_defined, placement, out_values, out_masks)
    derived_fields_fused.launches += 1
    with span("b1.kernel", dev):
        _build.call("derived_fields_fused", "mf_derived_fields", dev, *args)
    return out
