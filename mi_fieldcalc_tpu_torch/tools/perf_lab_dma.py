"""P2, the streaming lab: ``x + 1`` into ``nbuf`` outputs at varied block
shapes.

Port of ``tools/perf_lab_dma.py`` (``pallas_add1(ty, nbuf)`` :43,
``pallas_call`` :57; ``pallas_add1_flat`` :72, :80), which priced the
TPU's per-grid-step and per-buffer DMA cost.  A unit of work is ``ty``
rows of one level (``ty >= ny``: the flat variant, one unit a level), and
the input is read once for each output, as the TPU probe passes it
``nbuf`` times.  On the H100 (``csrc/probes.cu`` ``add1_kernel``) a block
of ``threads`` takes a span of 4 to 8 float4 a thread: a piece of a long
unit, or several short units whole, so that thousands of blocks fill
every SM whatever ``ty`` is; it moves the span in 16-byte accesses,
several loads in flight before their stores (4-byte ones when x and the
outputs lie at different 16-byte phases).  At one buffer the kernel is
held to ``torch.add(x, 1)``; the buffer rows ask what rate many
concurrent output streams reach on this card:

    python -m mi_fieldcalc_tpu_torch.tools.perf_lab_dma [--device cpu]
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..ops._harness import check_tensor
from . import _lab

__all__ = ["add1", "add1_plain", "cases", "sweep", "SWEEP", "main"]

#: the lab's array (perf_lab_dma.py:22)
SHAPE = (32, 719, 929)
#: (ty, nbuf) of the TPU lab (perf_lab_dma.py:98-99), then shorter units
#: the TPU lab had no reason to try
SWEEP = ((48, 1), (48, 6), (48, 12), (48, 24), (32, 1), (96, 1), (96, 12),
         (1, 1), (4, 1), (8, 1), (4, 12), (8, 12))
#: threads a block
THREADS = (256, 512)
_MAX_BUFFERS = 32


def add1_plain(x: torch.Tensor, nbuf: int = 1) -> list:
    """The probe's plain PyTorch version: ``nbuf`` tensors ``x + 1``."""
    return [x + 1.0 for _ in range(nbuf)]


def add1(x: torch.Tensor, nbuf: int = 1, ty: int = 48,
         threads: int = 256) -> list:
    """``x + 1`` (float32 ``[nlev, ny, nx]``) into ``nbuf`` new tensors,
    ``ty`` rows of a level a block (``ty >= ny``: the flat variant).  On a
    CUDA tensor this launches ``add1_kernel`` and counts the launch in
    ``add1.launches``; on a CPU tensor it runs :func:`add1_plain`."""
    if not _lab.route("add1", x):
        return add1_plain(x, nbuf)
    if x.dim() != 3:
        raise ValueError("add1: x must be [nlev, ny, nx]")
    check_tensor("add1", x, "x", tuple(x.shape), torch.float32, x.device)
    if not (1 <= nbuf <= _MAX_BUFFERS and ty >= 1
            and 32 <= threads <= 1024):
        raise ValueError(f"add1: nbuf {nbuf} (1..{_MAX_BUFFERS}), ty {ty} "
                         f"(>= 1), threads {threads} (32..1024)")
    outs = [torch.empty_like(x) for _ in range(nbuf)]
    ptrs = (ctypes.c_void_p * nbuf)(*(o.data_ptr() for o in outs))
    add1.launches += 1
    _build.call("add1", "mf_probe_add1", x.device, x, ptrs, nbuf, ty,
                threads, *x.shape)
    return outs


add1.launches = 0


def cases(ny: int) -> list:
    """``(ty, nbuf, threads)`` of the sweep: the flat variant (``ty =
    ny``), then every (ty, nbuf) of :data:`SWEEP`, each at every count of
    :data:`THREADS`."""
    return [(ty, nbuf, t) for ty, nbuf in ((ny, 1),) + SWEEP
            for t in THREADS]


def sweep(x: torch.Tensor, reps: int = 10) -> list:
    """The TPU lab's table on ``x``'s device: ``x + 1`` in PyTorch (the
    library yardstick), then each of :func:`cases`.  GB/s count the bytes
    the TPU lab counts, ``nbuf`` reads and ``nbuf`` writes of the array
    (``perf_lab_dma.py:106``)."""
    dev = x.device
    nbytes = 4 * x.numel()
    ms = _lab.median_ms(lambda: torch.add(x, 1.0), dev, reps)
    rows = [{"case": "torch.add(x, 1)", "ty": None, "nbuf": 1,
             "threads": None, "ms": ms, "gbps": 2 * nbytes / ms / 1e6}]
    for ty, nbuf, threads in cases(x.shape[1]):
        ms = _lab.median_ms(lambda: add1(x, nbuf, ty, threads), dev, reps)
        rows.append({"case": "flat" if ty == x.shape[1] else "tiled",
                     "ty": ty, "nbuf": nbuf, "threads": threads, "ms": ms,
                     "gbps": 2 * nbuf * nbytes / ms / 1e6})
    return rows


def main(argv=None) -> int:
    dev = _lab.device_from_args("perf_lab_dma", argv)
    shape = SHAPE if dev.type == "cuda" else (3, 37, 41)
    x = torch.randn(shape, generator=torch.Generator(device=dev)
                    .manual_seed(0), device=dev)
    label = _lab.device_label(dev)
    for ty, nbuf, threads in cases(shape[1]):
        _lab.assert_same(add1(x, nbuf, ty, threads), add1_plain(x, nbuf),
                         f"add1 ty={ty} nbuf={nbuf} threads={threads}")
    for r in sweep(x):
        what = (r["case"] if r["ty"] is None else
                f"{r['case']:5s} ty={r['ty']:3d} bufs={r['nbuf']:2d} "
                f"threads={r['threads']:3d}")
        print(f"[{label}] {shape} {what:38s}: {r['ms']:8.4f} ms "
              f"({r['gbps']:.1f} GB/s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
