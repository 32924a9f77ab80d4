"""Post-processing steps on the card: ``ops.fused.derived_fields_fused``
(the 12-output pipeline kernel, masked, stacked layout) on one lead time a
step, the outputs staying on the card.

A ring of lead times stays resident and is used in turn.  The check holds
the last output of each lead time in the window to the plain reference
(:mod:`benchmark.reference.pipeline`): all 12 value planes and the 9
mask planes.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from .. import counts, inputs, peaks
from ..compare import Gap
from ..reference._base import Field as RefField
from ..reference.ensemble import rounded
from ..reference.pipeline import FIELDS, derived_fields

_FUSED = "mi_fieldcalc_tpu_torch.ops.fused"

#: the program's stacked layout: the mask plane of each of the 12 fields
#: (td, ducting and div share the planes of rh, theta_e and vort)
MASK_PLANE = (0, 1, 2, 2, 3, 3, 4, 5, 5, 6, 7, 8)
#: the field whose mask each of the 9 planes holds
PLANE_FIELD = tuple(MASK_PLANE.index(j) for j in range(9))


class Entry:
    spans = {"b1": f"{_FUSED}:derived_fields_fused"}

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from mi_fieldcalc_tpu_torch.field import Field
        from mi_fieldcalc_tpu_torch.ops import fused
        self._Field, self._fused = Field, fused
        self.config, self.traffic, self.device = config, traffic, device
        self.nlev, self.ny, self.nx = (config["levels"], config["ny"],
                                       config["nx"])
        self.leads = int(traffic["lead_times"])
        case = inputs.pipeline_case(inputs.generator(seed, device), config,
                                    traffic, (self.leads,), device)
        self.fields = case.fields
        self.alevel, self.blevel = case.alevel, case.blevel
        self.xmapr, self.ymapr = case.xmapr, case.ymapr
        self.fcoriolis = case.fcoriolis
        self.kept, self.due = {}, set()

    def lead(self, k: int) -> dict:
        return {n: (v[k], m[k]) for n, (v, m) in self.fields.items()}

    def step(self, i: int) -> None:
        k = i % self.leads
        self.due.add(k)
        f = self.lead(k)
        args = [self._Field(*f[n]) for n in ("tk", "q", "u", "v", "ps")]
        self.kept[k] = self._fused.derived_fields_fused(
            *args, self.alevel, self.blevel, self.xmapr, self.ymapr,
            self.fcoriolis, stacked=True)

    def reset(self) -> None:
        self.kept.clear()
        self.due.clear()

    def reference(self, k: int) -> dict:
        f = self.lead(k)
        args = [RefField(*f[n]) for n in ("tk", "q", "u", "v", "ps")]
        return derived_fields(*args, self.alevel, self.blevel, self.xmapr,
                              self.ymapr)

    def check(self) -> dict:
        gap = Gap()
        gap.missing(len(self.due - set(self.kept)))
        for k, got in sorted(self.kept.items()):
            ref = self.reference(k)
            for i, n in enumerate(FIELDS):
                gap.add(n, got.values[i], got.masks[MASK_PLANE[i]],
                        ref[n].values, ref[n].mask)
            del ref
        return {"step_gap": (gap.value(), self.traffic["limits"]["step_gap"])}

    def work(self, units: int) -> dict:
        if self.device.type != "cuda":
            return {}
        name = torch.cuda.get_device_name(self.device)
        shape = (self.nlev, self.ny, self.nx)
        bound = peaks.bound_s(name, counts.pipeline_bytes(*shape),
                              counts.pipeline_ops(*shape))
        return {"b1_bound_s": units * bound}

    def control(self):
        """The reference in the program's place, in the program's stacked
        layout, its value planes rounded to bfloat16 and its masks exact."""
        entry = self

        def stand_in(*args, **kwargs):
            k = next(k for k in range(entry.leads)
                     if entry.fields["tk"][0][k].data_ptr()
                     == args[0].values.data_ptr())
            ref = entry.reference(k)
            shape = ref["th"].values.shape
            return SimpleNamespace(
                values=torch.stack([rounded(ref[n].values.expand(shape),
                                            torch.bfloat16) for n in FIELDS]),
                masks=torch.stack([ref[FIELDS[j]].mask.expand(shape)
                                   for j in PLANE_FIELD]))

        return {f"{_FUSED}:derived_fields_fused": stand_in}
