"""P1: B1's bytes, moved at the best rate this card gives them.

Port of the copy probe ``_ck`` inside ``bench.main`` (``bench.py:212``,
``pallas_call`` :233), which gave the TPU benchmark its attainable rate:
the pipeline kernel's reads and writes with trivial compute.  What the
probe (``csrc/probes.cu`` ``copy_kernel``) keeps of B1
(``csrc/derived_fields.cu``) is its inputs and outputs in their layout,
and so its bytes (:func:`copy_bytes`):

* ``s`` = the centres of tk, q, u, v and ps, then the x-1, x+1, y-1, y+1
  neighbours of tk, u and v at the clamped point (``cy``, ``cx`` in [1,
  n-2], B1's ``fillEdges`` point), then xmapr and ymapr there, summed in
  that order (18 adds);
* values ``[12, nlev, ny, nx]``: plane k is ``s + k``;
* masks ``[9, nlev, ny, nx]``: every plane the AND of the masks of tk, q,
  u, v and ps; with ``all_defined`` 2 planes of True and no mask read, as
  B1's all-defined route.

What it drops is B1's per-point store order: a block stages a strip of
full-width rows of one level in shared memory with 16-byte copies (ps and
the map factors, which the L2 keeps, it reads at each point), computes
``s`` and the mask AND once a point, and writes plane by plane in 16-byte
stores.  Its time is the best this card gives B1's bytes, and B1's time
over it says how much B1 could still gain (above 1) or that the
yardstick is still wrong (below 1).  The TPU probe's per-tile halo
rows (``bench.py:215-216``) are an artefact of its padded tiling and are
not carried over.  ``blocks_per_sm`` reserves shared memory a block to
cap the blocks an SM holds, and the probe's attainable time is its
fastest cap's (:data:`CAPS`):

    python -m mi_fieldcalc_tpu_torch.tools.bench_copy [--device cpu]
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

from ..field import Field
from .. import _build
from ..ops._harness import check_tensor
from . import _lab

__all__ = ["copy_probe", "copy_probe_plain", "copy_bytes", "probe_inputs",
           "b1_against_copy", "main"]

#: the lab's shape: the headline 32-level AROME stack (bench.py:81)
SHAPE = (32, 719, 929)
#: the CUDA grid's limit: gridDim.y = nlev
_MAX_NLEV = 65535
#: blocks an SM may hold, timed in turn (None: as many as the kernel's
#: shared memory and registers let)
CAPS = (None, 4, 3, 2, 1)
#: a Hopper SM's shared memory, of which the runtime keeps 1 KB a block
_SMEM_PER_SM = 228 * 1024
_SMEM_RESERVED = 1024


def copy_bytes(nlev: int, ny: int, nx: int, all_defined: bool) -> int:
    """Bytes B1's layout (and so the probe) moves at least once: 4 value
    stacks (+ 4 mask stacks), ps (+ its mask), 2 map planes, 12 value
    planes and 9 (or 2) mask planes."""
    pts3, pts2 = nlev * ny * nx, ny * nx
    if all_defined:
        return 4 * pts3 * 4 + pts2 * 4 + 2 * pts2 * 4 + 12 * pts3 * 4 + 2 * pts3
    return 4 * pts3 * 5 + pts2 * 5 + 2 * pts2 * 4 + 12 * pts3 * 4 + 9 * pts3


def copy_probe_plain(tk: Field, q: Field, u: Field, v: Field, ps: Field,
                     xmapr: torch.Tensor, ymapr: torch.Tensor,
                     all_defined: bool = False):
    """The probe's plain PyTorch version: ``(values, masks)``."""
    nlev, ny, nx = tk.values.shape
    dev = tk.values.device
    cy = torch.arange(ny, device=dev).clamp(1, ny - 2)
    cx = torch.arange(nx, device=dev).clamp(1, nx - 2)

    def at(t, dy, dx):
        return t[..., cy + dy, :][..., cx + dx]

    s = tk.values + q.values
    s = s + u.values
    s = s + v.values
    s = s + ps.values
    for f in (tk, u, v):
        for dy, dx in ((0, -1), (0, 1), (-1, 0), (1, 0)):
            s = s + at(f.values, dy, dx)
    s = s + at(xmapr, 0, 0)
    s = s + at(ymapr, 0, 0)
    values = torch.stack([s + float(k) for k in range(12)])
    if all_defined:
        return values, torch.ones((2, nlev, ny, nx), dtype=torch.bool,
                                  device=dev)
    m = tk.mask & q.mask & u.mask & v.mask & ps.mask
    return values, m.expand(9, nlev, ny, nx).contiguous()


def copy_probe(tk: Field, q: Field, u: Field, v: Field, ps: Field,
               xmapr: torch.Tensor, ymapr: torch.Tensor,
               all_defined: bool = False, blocks_per_sm=None):
    """The copy probe: ``(values f32[12, nlev, ny, nx], masks bool[9 (2
    when all_defined), nlev, ny, nx])``.  On CUDA tensors this launches
    ``copy_kernel``, at most ``blocks_per_sm`` blocks an SM (None: as
    many as its shared memory and registers let), and counts the launch in
    ``copy_probe.launches``; on CPU tensors it runs
    :func:`copy_probe_plain`."""
    if not _lab.route("copy_probe", tk.values):
        return copy_probe_plain(tk, q, u, v, ps, xmapr, ymapr, all_defined)
    dev = tk.values.device
    if tk.values.dim() != 3:
        raise ValueError("copy_probe: tk must be [nlev, ny, nx]")
    nlev, ny, nx = tk.values.shape
    if not (ny >= 3 and nx >= 3 and nlev <= _MAX_NLEV):
        raise ValueError(f"copy_probe: unsupported grid ({nlev}, {ny}, "
                         f"{nx}); need ny, nx >= 3")
    f32, b8 = torch.float32, torch.bool
    for name, f in (("tk", tk), ("q", q), ("u", u), ("v", v)):
        check_tensor("copy_probe", f.values, name, (nlev, ny, nx), f32, dev)
        check_tensor("copy_probe", f.mask, name + ".mask", (nlev, ny, nx),
                     b8, dev)
    check_tensor("copy_probe", ps.values, "ps", (ny, nx), f32, dev)
    check_tensor("copy_probe", ps.mask, "ps.mask", (ny, nx), b8, dev)
    for name, a in (("xmapr", xmapr), ("ymapr", ymapr)):
        check_tensor("copy_probe", a, name, (ny, nx), f32, dev)
    smem = 0
    if blocks_per_sm is not None:
        if not 1 <= blocks_per_sm <= 8:
            raise ValueError(f"copy_probe: blocks_per_sm {blocks_per_sm} "
                             "outside 1..8")
        smem = _SMEM_PER_SM // blocks_per_sm - _SMEM_RESERVED
    values = torch.empty((12, nlev, ny, nx), dtype=f32, device=dev)
    masks = torch.empty((2 if all_defined else 9, nlev, ny, nx), dtype=b8,
                        device=dev)

    def mask(f):
        return None if all_defined else f.mask

    copy_probe.launches += 1
    _build.call("copy_probe", "mf_probe_copy", dev, tk.values, q.values,
                u.values, v.values, mask(tk), mask(q), mask(u), mask(v),
                ps.values, mask(ps), xmapr, ymapr, values, masks, nlev, ny,
                nx, int(all_defined), smem)
    return values, masks


copy_probe.launches = 0


def probe_inputs(nlev: int, ny: int, nx: int, seed: int, all_defined: bool,
                 device) -> tuple:
    """B1's 10 arguments on ``device`` from ``seed``: tk ~ N(275, 15) K,
    q in [1e-4, 1e-2], u, v ~ N(0, 12) m/s, ps ~ N(1000, 15) hPa, hybrid
    coefficients, map factors near 1 and a Coriolis plane; 1 point in 37
    undefined in each field unless ``all_defined``."""
    rng = np.random.default_rng(seed)
    f32 = np.float32

    def field(a):
        m = (np.ones(a.shape, bool) if all_defined
             else rng.random(a.shape) >= 1 / 37)
        return Field(torch.as_tensor(a.astype(f32), device=device),
                     torch.as_tensor(m, device=device))

    s3, s2 = (nlev, ny, nx), (ny, nx)
    fields = (field(rng.normal(275, 15, s3)),
              field(rng.uniform(1e-4, 1e-2, s3)),
              field(rng.normal(0, 12, s3)), field(rng.normal(0, 12, s3)),
              field(rng.normal(1000, 15, s2)))
    rest = (np.linspace(0, 50, nlev), np.linspace(1, 0.5, nlev),
            rng.uniform(0.9, 1.1, s2) / 2500.0,
            rng.uniform(0.9, 1.1, s2) / 2500.0, np.full(s2, 1.2e-4))
    return fields + tuple(torch.as_tensor(a.astype(f32), device=device)
                          for a in rest)


def b1_against_copy(args: tuple, all_defined: bool, rounds: int = 3,
                    reps: int = 10) -> dict:
    """B1 and the probe at each of :data:`CAPS` on the same inputs, timed
    in turns (probe, B1, then B1, probe, ...: ``rounds`` rounds, median of
    ``reps`` each, the launch alone).  Returns each one's median, every
    round, the probe's attainable time (its fastest cap's median) and B1's
    time over it."""
    from ..ops.fused import derived_fields_fused
    tk, q, u, v, ps, alevel, blevel, xmapr, ymapr, fcoriolis = args
    dev = tk.values.device
    runs = {f"probe_cap{c}": (lambda c=c: copy_probe(
        tk, q, u, v, ps, xmapr, ymapr, all_defined, c)) for c in CAPS}
    runs["b1"] = lambda: derived_fields_fused(*args, all_defined=all_defined)
    times = {k: [] for k in runs}
    for r in range(rounds):
        for name in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
            times[name].append(_lab.median_ms(runs[name], dev, reps))
    med = {k: statistics.median(v) for k, v in times.items()}
    best = min((k for k in med if k != "b1"), key=med.get)
    return {"probe_ms": med[best], "probe_cap": best, "b1_ms": med["b1"],
            "medians": med, "rounds": times,
            "b1_over_probe": med["b1"] / med[best]}


def main(argv=None) -> int:
    dev = _lab.device_from_args("bench_copy", argv)
    shape = SHAPE if dev.type == "cuda" else (2, 37, 61)
    label = _lab.device_label(dev)
    for all_defined in (False, True):
        args = probe_inputs(*shape, seed=0, all_defined=all_defined,
                            device=dev)
        sel = args[:5] + args[7:9]
        _lab.assert_same(copy_probe(*sel, all_defined),
                         copy_probe_plain(*sel, all_defined), "copy_probe")
        r = b1_against_copy(args, all_defined)
        nbytes = copy_bytes(*shape, all_defined)
        route = "all-defined" if all_defined else "masked"
        print(f"[{label}] {shape} {route}: copy probe {r['probe_ms']:.4f} "
              f"ms at {r['probe_cap']} ({nbytes / r['probe_ms'] / 1e6:.1f} "
              f"GB/s of {nbytes / 1e9:.3f} GB), B1 {r['b1_ms']:.4f} ms, B1 / "
              f"probe {r['b1_over_probe']:.3f}; medians {r['medians']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
