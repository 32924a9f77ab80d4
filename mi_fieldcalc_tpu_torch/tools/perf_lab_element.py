"""P3, the halo-window lab: overlapping ``(ty + 8)``-row windows staged
through shared memory.

Port of ``tools/perf_lab_element.py``'s ``probe`` (:28; kernel :38,
``pallas_call`` :62), which asked what Mosaic fetches for overlapping
``pl.Element`` windows at the array edges.  Window j of a level holds rows
``[j*ty - 4, j*ty + ty + 4)`` of ``x``; the probe writes every window to
``ow`` (``[ceil(ny/ty) * (ty + 8), nx]`` a level) and the centre rows plus
``y`` to ``o``.  Rows outside ``[0, ny)`` read as 0.0: on the TPU they are
undefined, so the port pins them.  On the H100 (``csrc/probes.cu``
``window_kernel``) a block stages one window's rows of 256 columns into
shared memory: its time beside the one-buffer ``x + 1`` of
:mod:`.perf_lab_dma` prices a halo tile at B1's shape:

    python -m mi_fieldcalc_tpu_torch.tools.perf_lab_element [--device cpu]
"""

from __future__ import annotations

import torch

from .. import _build
from ..ops._harness import check_tensor
from . import _lab

__all__ = ["window", "window_plain", "window_bytes", "b1_inputs",
           "at_b1_shape", "main"]

#: the TPU probe's array and window (perf_lab_element.py:152-153)
TOOL_SHAPE = (32, 256)
TOOL_TY = 8
#: B1's stack, windowed along y level by level, and the window heights
B1_SHAPE = (32, 719, 929)
B1_TYS = (8, 32)
HALO = 4
_MAX_TY = 32


def _levels(x: torch.Tensor, y: torch.Tensor):
    """``x`` as ``[nlev, ny, nx]`` (a 2-D ``x`` is one level) and ``y``
    of the same shape (the TPU probe's ``y`` is ``[1, ny, nx]``)."""
    x3 = x.unsqueeze(0) if x.dim() == 2 else x
    if x3.dim() != 3 or tuple(y.shape) != tuple(x3.shape):
        raise ValueError(f"window: x {tuple(x.shape)} must be [ny, nx] "
                         f"with y [1, ny, nx], or [nlev, ny, nx] with y "
                         f"alike; y is {tuple(y.shape)}")
    return x3


def window_plain(x: torch.Tensor, y: torch.Tensor, ty: int = TOOL_TY):
    """The probe's plain PyTorch version: ``(o, ow)``."""
    x3 = _levels(x, y)
    nlev, ny, nx = x3.shape
    jy = -(-ny // ty)
    pad = torch.zeros((nlev, jy * ty + 2 * HALO, nx), dtype=x.dtype,
                      device=x.device)
    pad[:, HALO:HALO + ny] = x3
    ow = torch.cat([pad[:, j * ty:j * ty + ty + 2 * HALO]
                    for j in range(jy)], dim=1)
    o = x3 + y
    if x.dim() == 2:
        return o[0], ow[0]
    return o, ow


def window(x: torch.Tensor, y: torch.Tensor, ty: int = TOOL_TY):
    """``(o, ow)``: ``o = x + y`` read through the windows' centre rows,
    and ``ow`` every window of ``ty + 8`` rows (``ty <= 32``).  On CUDA
    tensors this launches ``window_kernel`` and counts the launch in
    ``window.launches``; on CPU tensors it runs :func:`window_plain`."""
    if not _lab.route("window", x):
        return window_plain(x, y, ty)
    x3 = _levels(x, y)
    nlev, ny, nx = x3.shape
    for name, t in (("x", x), ("y", y)):
        check_tensor("window", t, name, tuple(t.shape), torch.float32,
                     x.device)
    if not 1 <= ty <= _MAX_TY:
        raise ValueError(f"window: ty {ty} outside 1..{_MAX_TY}")
    jy = -(-ny // ty)
    o = torch.empty_like(x)
    ow = torch.empty(x.shape[:-2] + (jy * (ty + 2 * HALO), nx),
                     dtype=torch.float32, device=x.device)
    window.launches += 1
    _build.call("window", "mf_probe_window", x.device, x, y, o, ow, ty,
                nlev, ny, nx)
    return o, ow


window.launches = 0


def window_bytes(nlev: int, ny: int, nx: int, ty: int) -> int:
    """Bytes the probe must move: ``x`` and ``y`` read once, ``o`` and
    every window of ``ow`` written once."""
    jy = -(-ny // ty)
    return 4 * nlev * nx * (3 * ny + jy * (ty + 2 * HALO))


def b1_inputs(dev: torch.device) -> tuple:
    """``x`` and ``y`` at B1's shape, normal from seed 0."""
    gen = torch.Generator(device=dev).manual_seed(0)
    return (torch.randn(B1_SHAPE, generator=gen, device=dev),
            torch.randn(B1_SHAPE, generator=gen, device=dev))


def at_b1_shape(x: torch.Tensor, y: torch.Tensor, reps: int = 10) -> dict:
    """The probe on ``x``, ``y`` with each of :data:`B1_TYS`, beside the
    one-buffer ``x + 1`` of :mod:`.perf_lab_dma` on ``x``: ms and GB/s of
    the bytes each must move."""
    from .perf_lab_dma import add1
    dev = x.device
    add_ms = _lab.median_ms(lambda: add1(x), dev, reps)
    rows = {"add1": {"ms": add_ms, "gbps": 8 * x.numel() / add_ms / 1e6}}
    for ty in B1_TYS:
        ms = _lab.median_ms(lambda: window(x, y, ty), dev, reps)
        nbytes = window_bytes(*x.shape, ty)
        rows[f"ty{ty}"] = {"ms": ms, "bytes": nbytes,
                           "gbps": nbytes / ms / 1e6,
                           "over_add1": ms / add_ms}
    return rows


def main(argv=None) -> int:
    dev = _lab.device_from_args("perf_lab_element", argv)
    label = _lab.device_label(dev)
    x = torch.arange(TOOL_SHAPE[0] * TOOL_SHAPE[1], dtype=torch.float32,
                     device=dev).reshape(TOOL_SHAPE)
    y = torch.ones((1,) + TOOL_SHAPE, dtype=torch.float32, device=dev)
    o, ow = window(x, y, TOOL_TY)
    # the TPU probe's own printout (perf_lab_element.py:190-201)
    print(f"[{label}] center rows exact:", torch.equal(o, x + 1))
    w0, wl = ow[:TOOL_TY + 2 * HALO], ow[-(TOOL_TY + 2 * HALO):]
    print("first window rows 4..6 == x rows 0..2:",
          torch.equal(w0[4:7], x[0:3]))
    print("first window rows 0..3 (padded region):",
          w0[:4, :2].flatten().tolist())
    print("last window rows TY+4.. (padded region):",
          wl[-4:, :2].flatten().tolist())
    print("last window row TY+3 == x row ny-1:",
          torch.equal(wl[TOOL_TY + 3], x[-1]))
    if dev.type == "cuda":
        x, y = b1_inputs(dev)
        for ty in B1_TYS:
            _lab.assert_same(window(x, y, ty), window_plain(x, y, ty),
                             f"window ty={ty}")
        for name, r in at_b1_shape(x, y).items():
            print(f"[{label}] {B1_SHAPE} {name}: {r['ms']:.4f} ms "
                  f"({r['gbps']:.1f} GB/s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
