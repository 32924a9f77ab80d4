"""Inputs of one card's block of a grid that a cell cuts over its cards,
drawn from ``--seed`` so that the whole grid's fields are the same on any
cut and in one process.

Each global ``[levels, ny, nx]`` stack (``[ny, nx]`` for ps) is drawn in
turn, field by field, lead time by lead time, member by member, with the
distributions of :mod:`benchmark.inputs`, and this card keeps only its
block and the ring of :data:`RING` points around it that lies inside the
grid.  The program gets the block; the plain reference works on the block
widened by the ring (:meth:`BlockCase.window`), so that it gives the whole
grid's answer there.

``undef: ["column_by_seams", dy, dx]`` leaves one temperature column
undefined at every level, at the global point ``dy`` rows from the row
seam and ``dx`` columns from the column seam of a cut into 2 x 2 blocks
(the first blocks one point longer where a side is odd), so its masks
cross both legs of that cut's exchange.
"""

from __future__ import annotations

import itertools

import torch

from . import inputs

#: the ring's width: the radius of the pipeline's stencils
RING = 2

FIELDS = ("tk", "q", "u", "v", "ps")


def seam_point(ny: int, nx: int, dy: int, dx: int) -> tuple:
    """The global ``(row, col)`` ``dy`` rows from the row seam and ``dx``
    columns from the column seam of a 2 x 2 cut of ``ny`` x ``nx``."""
    return (ny + 1) // 2 + int(dy), (nx + 1) // 2 + int(dx)


def widened(span: tuple, n: int) -> tuple:
    """``(start, stop)`` widened by :data:`RING` on each side, clipped to
    ``[0, n)``."""
    return max(0, span[0] - RING), min(n, span[1] + RING)


class BlockCase:
    """One card's inputs: ``fields`` ``{name: (values, mask)}`` of the
    block, ``lead + (nlev, rows, cols)`` (ps ``lead + (rows, cols)``),
    the hybrid coefficients and the block's map planes; the ring's four
    strips are kept apart for :meth:`window`."""

    def __init__(self, seed: int, config: dict, spec: dict, lead: tuple,
                 block: tuple, device):
        nlev, ny, nx = config["levels"], config["ny"], config["nx"]
        (r0, r1), (c0, c1) = block
        (w0, w1), (v0, v1) = widened((r0, r1), ny), widened((c0, c1), nx)
        self.block = block
        #: the block's rows and columns within the window
        self.crop = (slice(r0 - w0, r1 - w0), slice(c0 - v0, c1 - v0))
        parts = {"block": (slice(r0, r1), slice(c0, c1)),
                 "top": (slice(w0, r0), slice(v0, v1)),
                 "bottom": (slice(r1, w1), slice(v0, v1)),
                 "left": (slice(r0, r1), slice(v0, c0)),
                 "right": (slice(r0, r1), slice(c1, v1))}
        undef = spec.get("undef")
        column = None
        if isinstance(undef, list) and undef[0] == "column_by_seams":
            column = seam_point(ny, nx, undef[1], undef[2])
        elif undef:
            raise ValueError(f"unknown undef {undef!r} for a sharded cell")
        g = inputs.generator(seed, device)
        self.parts = {}
        for name in FIELDS:
            shape = (ny, nx) if name == "ps" else (nlev, ny, nx)
            kept = {p: torch.empty(tuple(lead) + shape[:-2]
                                   + (rs.stop - rs.start, cs.stop - cs.start),
                                   device=device)
                    for p, (rs, cs) in parts.items()}
            for idx in itertools.product(*(range(n) for n in lead)):
                t = inputs.draw(g, spec["fields"][name], shape, device)
                for p, (rs, cs) in parts.items():
                    kept[p][idx] = t[..., rs, cs]
                del t
            masks = {}
            for p, (rs, cs) in parts.items():
                m = torch.ones(kept[p].shape, dtype=torch.bool, device=device)
                if name == "tk" and column is not None and \
                        rs.start <= column[0] < rs.stop and \
                        cs.start <= column[1] < cs.stop:
                    m[..., column[0] - rs.start, column[1] - cs.start] = False
                masks[p] = m
            self.parts[name] = {p: (kept[p], masks[p]) for p in parts}
        self.fields = {name: self.parts[name]["block"] for name in FIELDS}
        self.alevel = inputs.levels(config["alevel"], nlev, device)
        self.blevel = inputs.levels(config["blevel"], nlev, device)
        rows, cols = r1 - r0, c1 - c0
        wrows, wcols = w1 - w0, v1 - v0

        def plane(key, shape):
            return torch.full(shape, float(config[key]), device=device)

        self.xmapr, self.ymapr, self.fcoriolis = (
            plane(k, (rows, cols)) for k in ("xmapr", "ymapr", "fcoriolis"))
        self.win_xmapr, self.win_ymapr = (
            plane(k, (wrows, wcols)) for k in ("xmapr", "ymapr"))

    def window(self, k, levels: slice = slice(None)) -> dict:
        """Lead ``k``'s fields on the block widened by the ring, levels
        ``levels`` (ps whole): ``{name: (values, mask)}``, the block's
        leading axes after ``k`` kept."""
        out = {}
        for name in FIELDS:
            parts = self.parts[name]
            sel = (k,) if name == "ps" else (k, slice(None), levels)

            def part(p, i):
                return parts[p][i][sel]

            out[name] = tuple(
                torch.cat([part("top", i),
                           torch.cat([part("left", i), part("block", i),
                                      part("right", i)], dim=-1),
                           part("bottom", i)], dim=-2)
                for i in (0, 1))
        return out

