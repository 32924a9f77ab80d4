"""The bytes that the isobaric pipeline's interpolation kernel needs,
worked out from shapes; the pipeline kernel that follows it is counted by
:func:`benchmark.counts.pipeline_bytes` and :func:`benchmark.counts.
pipeline_ops` at the targets' count of levels.

A frozen copy of the program's own arithmetic (``chip_smoke.py``
``interp_bytes``, its ``"bracket"`` count), kept here so that a later
change to the program does not change the yardstick.
"""

from __future__ import annotations


def interp_bytes(nvar: int, nt: int, ny: int, nx: int,
                 all_defined: bool) -> int:
    """One call of the interpolation: the two bracket levels of each field
    and target (values, and masks unless all defined) and ps read once; the
    ``nvar * nt`` value planes and the mask planes (one shared plane when
    all defined) written once."""
    pts, m = ny * nx, 0 if all_defined else 1
    out = nvar * nt * pts * 4 + (1 if all_defined else nvar) * nt * pts
    return 2 * nvar * nt * pts * (4 + m) + pts * (4 + m) + out
