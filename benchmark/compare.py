"""How the program's outputs are held to the plain reference's.

:class:`Gap` reads, over every output field it is given (in blocks, if a
field is large), the widest gap between the program's value and the
reference's at the points both define, as a share of the largest magnitude
the reference gives that field: the normwise worst error, which does not
blow up where a field crosses zero.  A point that one side defines and the
other does not, or that is NaN on one side only, counts as a gap of 1 (the
whole scale of the field), and so does an answer that was due and never
came.  The number compared is the largest such share over the fields.
"""

from __future__ import annotations

import torch


class Gap:
    """The widest normwise gap over named fields, fed block by block."""

    def __init__(self):
        self._diff = {}
        self._scale = {}
        self._split = set()

    def add(self, name: str, got_v, got_m, ref_v, ref_m) -> None:
        got_m = got_m.to(torch.bool).broadcast_to(ref_v.shape)
        ref_m = ref_m.to(torch.bool).broadcast_to(ref_v.shape)
        got_v = got_v.to(torch.float32)
        ref_v = ref_v.to(torch.float32)
        if bool((got_m != ref_m).any()):
            self._split.add(name)
        both = got_m & ref_m
        gnan, rnan = torch.isnan(got_v), torch.isnan(ref_v)
        if bool((both & (gnan != rnan)).any()):
            self._split.add(name)
        ok = both & ~gnan & ~rnan
        zero = torch.zeros((), device=ref_v.device)
        diff = torch.where(ok, (got_v - ref_v).abs(), zero).max()
        scale = torch.where(ok, ref_v.abs(), zero).max()
        self._diff[name] = max(self._diff.get(name, 0.0), float(diff))
        self._scale[name] = max(self._scale.get(name, 0.0), float(scale))

    def missing(self, n: int) -> None:
        """``n`` answers that were due never came: each counts 1."""
        if n:
            self._diff["(missing)"], self._scale["(missing)"] = 1.0, 1.0

    def per_field(self) -> dict:
        out = {}
        for name, d in self._diff.items():
            s = self._scale[name]
            g = d / s if s > 0 else (0.0 if d == 0 else 1.0)
            out[name] = 1.0 if name in self._split else g
        return out

    def value(self) -> float:
        return max(self.per_field().values(), default=0.0)

