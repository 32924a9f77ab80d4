"""The bytes and float32 operations that the benchmark's work needs,
worked out from shapes.

A frozen copy of the program's own arithmetic (``chip_smoke.py``
``layout_bytes``), kept here so that a later change to the program does
not change the yardstick.  A byte is counted once for each input read and
each output written, whatever a kernel reads again; an operation is an add, subtract, multiply, divide,
sqrt or floor (compares and selects are not counted).
"""

from __future__ import annotations

#: float32 operations per point and level of the 12-output pipeline
OPS_B1_POINT = 150


def pipeline_bytes(nlev: int, ny: int, nx: int) -> int:
    """One masked call of the 12-output pipeline in its stacked layout:
    4 value and 4 mask stacks, ps and its mask, 2 map planes read; 12
    value planes and 9 mask planes written (td, ducting and div share the
    masks of rh, theta_e and vort)."""
    pts3, pts2 = nlev * ny * nx, ny * nx
    return 4 * pts3 * 5 + pts2 * 5 + 2 * pts2 * 4 + 12 * pts3 * 4 + 9 * pts3


def pipeline_ops(nlev: int, ny: int, nx: int) -> int:
    return OPS_B1_POINT * nlev * ny * nx


def reduce_bytes(nmem: int, nlev: int, ny: int, nx: int) -> int:
    """The ensemble summary's reductions: the 12 member-stacked fields
    (values and masks) read once; the 12 means, 12 spreads and 2
    probabilities (values and masks) written once."""
    pts3 = nlev * ny * nx
    return 12 * nmem * pts3 * 5 + (24 + 2) * pts3 * 5

