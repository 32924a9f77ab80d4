"""The ensemble summary: ``models.ensemble.ensemble_derived_summary`` with
``fused=True`` on member stacks that stay on the card: the pipeline kernel
once per member and the member stack, most of a summary's time, then the
reductions' kernel (``csrc/ensemble_stats.cu``) once per field.

A unit of work is one summary of all members at one lead time; lead times
are used in turn.  The check holds the last summary of each lead time in
the window to the plain reference (:mod:`benchmark.reference.ensemble`):
every mean and spread, and both probabilities, as one widest gap.
"""

from __future__ import annotations

import torch

from .. import counts, inputs, peaks
from ..compare import Gap
from ..reference import ensemble as ref_ensemble
from ..reference.pipeline import FIELDS

_ENSEMBLE = "mi_fieldcalc_tpu_torch.models.ensemble"


class Entry:
    spans = {"member_fields": f"{_ENSEMBLE}:ensemble_member_fields",
             "reduce": f"{_ENSEMBLE}:ensemble_summary"}

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from mi_fieldcalc_tpu_torch.field import Field
        from mi_fieldcalc_tpu_torch.models import ensemble
        self._Field, self._ensemble = Field, ensemble
        self.config, self.traffic, self.device = config, traffic, device
        self.nmem, self.nlev = config["members"], config["levels"]
        self.ny, self.nx = config["ny"], config["nx"]
        self.leads = int(traffic["lead_times"])
        case = inputs.pipeline_case(inputs.generator(seed, device), config,
                                    traffic, (self.leads, self.nmem), device)
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
        self.kept[k] = self._ensemble.ensemble_derived_summary(
            *args, self.alevel, self.blevel, self.xmapr, self.ymapr,
            self.fcoriolis, wind_limit=float(self.traffic["wind_limit"]),
            fused=True)

    def reset(self) -> None:
        self.kept.clear()
        self.due.clear()

    def reference(self, k: int, round_to=None):
        return ref_ensemble.summary(
            self.lead(k), self.alevel, self.blevel, self.xmapr, self.ymapr,
            float(self.traffic["wind_limit"]),
            int(self.traffic["level_block"]), round_to)

    def check(self) -> dict:
        gap = Gap()
        gap.missing(len(self.due - set(self.kept)))
        for k, got in sorted(self.kept.items()):
            ref = self.reference(k)
            for i, n in enumerate(FIELDS):
                for kind in ("mean", "spread"):
                    g, r = getattr(got, kind)[i], getattr(ref, kind)[i]
                    gap.add(f"{kind}.{n}", g.values, g.mask, r.values,
                            r.mask)
            for kind in ("prob_wind", "prob_t_freeze"):
                g, r = getattr(got, kind), getattr(ref, kind)
                gap.add(kind, g.values, g.mask, r.values, r.mask)
            del ref
        return {"summary_gap": (gap.value(),
                                self.traffic["limits"]["summary_gap"])}

    def work(self, units: int) -> dict:
        if self.device.type != "cuda":
            return {}
        name = torch.cuda.get_device_name(self.device)
        nbytes = counts.reduce_bytes(self.nmem, self.nlev, self.ny, self.nx)
        return {"reduce_bound_s": units * peaks.bound_s(name, nbytes, 0)}

    def control(self):
        """The reference in the program's place, its output values rounded
        to bfloat16 (:func:`benchmark.reference.ensemble.summary`)."""
        entry = self

        def stand_in(*args, **kwargs):
            k = next(k for k in range(entry.leads)
                     if entry.fields["tk"][0][k].data_ptr()
                     == args[0].values.data_ptr())
            return entry.reference(k, torch.bfloat16)

        return {f"{_ENSEMBLE}:ensemble_derived_summary": stand_in}
