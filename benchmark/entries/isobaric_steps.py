"""Isobaric steps on the card: ``models.pipeline.derived_fields_isobaric``
with ``fused=True, stacked=True, all_defined=True`` on one lead time a
step, the outputs staying on the card: the interpolation kernel
(``csrc/vertical_interp.cu``) from the model levels to the
configuration's ``plevels``, then the 12-output pipeline kernel on those
surfaces.

The inputs lie on a global grid (:mod:`benchmark.inputs_global`): the
configuration's hybrid law, the sphere's map factors and a surface
pressure drawn apart in the rows south of ``ps_south``.  The ring of lead
times, the check and the control are the pipeline steps' (:mod:`.
pipeline_steps`): the last output of each lead time in the window held to
the plain reference (:mod:`benchmark.reference.isobaric`), all 12 value
planes and the 9 mask planes on every surface.
"""

from __future__ import annotations

import torch

from .. import counts, counts_isobaric, inputs, inputs_global, peaks
from ..reference import isobaric as ref_isobaric
from . import pipeline_steps


class Entry(pipeline_steps.Entry):
    #: none from outside: the cell's readers read the program's own spans
    spans = {}

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from mi_fieldcalc_tpu_torch.field import Field
        from mi_fieldcalc_tpu_torch.models import pipeline
        self._Field, self._pipeline = Field, pipeline
        self.config, self.traffic, self.device = config, traffic, device
        self.ny, self.nx = config["ny"], config["nx"]
        self.leads = int(traffic["lead_times"])
        case = inputs_global.isobaric_case(inputs.generator(seed, device),
                                           config, traffic, (self.leads,),
                                           device)
        self.fields = case.fields
        self.alevel, self.blevel = case.alevel, case.blevel
        self.xmapr, self.ymapr = case.xmapr, case.ymapr
        self.fcoriolis = case.fcoriolis
        self.plevels = case.plevels
        self.kept, self.due = {}, set()

    def step(self, i: int) -> None:
        k = i % self.leads
        self.due.add(k)
        f = self.lead(k)
        args = [self._Field(*f[n]) for n in ("tk", "q", "u", "v", "ps")]
        self.kept[k] = self._pipeline.derived_fields_isobaric(
            *args, self.alevel, self.blevel, self.xmapr, self.ymapr,
            self.fcoriolis, plevels=self.plevels, fused=True, stacked=True,
            all_defined=True)

    def reference(self, k: int) -> dict:
        return ref_isobaric.derived_fields_isobaric(
            self.lead(k), self.alevel, self.blevel, self.plevels,
            self.xmapr, self.ymapr)

    def work(self, units: int) -> dict:
        if self.device.type != "cuda":
            return {}
        name = torch.cuda.get_device_name(self.device)
        nt = len(self.plevels)
        b2 = counts_isobaric.interp_bytes(4, nt, self.ny, self.nx, True)
        shape = (nt, self.ny, self.nx)
        b1 = peaks.bound_s(name, counts.pipeline_bytes(*shape),
                           counts.pipeline_ops(*shape))
        return {"b2_bound_s": units * peaks.bound_s(name, b2, 0),
                "b1_bound_s": units * b1}

    def control(self):
        """The reference in the program's place, in the program's stacked
        layout, its value planes rounded to bfloat16 and its masks exact
        (the pipeline steps' stand-in, here for the isobaric call)."""
        (stand_in,) = super().control().values()
        return {"mi_fieldcalc_tpu_torch.models.pipeline:"
                "derived_fields_isobaric": stand_in}
