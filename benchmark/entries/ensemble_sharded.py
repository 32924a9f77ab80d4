"""The ensemble summary grid-sharded over the cell's cards:
``parallel.fused.ensemble_summary_sharded`` on each card's block of the
grid the port picks (``parallel.mesh.factor_devices_for_grid``), one
process a card in the process group of ``parallel.distributed.
initialize``.  Each summary exchanges the blocks' halo rings (over NCCL
between cards), runs the pipeline kernel once a member on the padded
block, crops each member into its slot of the member stack, then the
reductions' kernel once a field, the probabilities' member flags reduced
over the cards.  In one process (the CPU tests) the grid is one block.

A unit of work is one summary of all members at one lead time on every
card; lead times are used in turn.  Each card's check holds the last
summary of each lead time to the plain reference of its block
(:mod:`benchmark.reference.ensemble_block`): every mean and spread, and
both probabilities, as one widest gap, the reference's member flags
reduced over the cards as the program's are.
"""

from __future__ import annotations

import torch

from .. import counts, inputs_sharded, peaks
from ..compare import Gap
from ..reference import ensemble_block as ref_block
from ..reference.pipeline import FIELDS

_FUSED = "mi_fieldcalc_tpu_torch.parallel.fused"

#: the process grid of each (global shape, device, default group): a grid
#: makes its process group once
_GRIDS = {}


def _grid(ny: int, nx: int, device):
    import torch.distributed as dist

    from mi_fieldcalc_tpu_torch.parallel import grid_mesh
    world = dist.group.WORLD if dist.is_initialized() else None
    key = (ny, nx, device, id(world))
    if key not in _GRIDS:
        _GRIDS[key] = grid_mesh(grid_shape=(ny, nx), device=device)
    return _GRIDS[key]


def _max_over_cards(flags: torch.Tensor) -> torch.Tensor:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.all_reduce(flags, op=dist.ReduceOp.MAX)
    return flags


class Entry:
    spans = {}

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from mi_fieldcalc_tpu_torch.field import Field
        from mi_fieldcalc_tpu_torch.parallel import distributed, fused
        distributed.initialize(device=device.type)
        self._Field, self._fused = Field, fused
        self.config, self.traffic, self.device = config, traffic, device
        self.nmem, self.nlev = config["members"], config["levels"]
        self.ny, self.nx = config["ny"], config["nx"]
        self.leads = int(traffic["lead_times"])
        self.grid = _grid(self.ny, self.nx, device)
        block = (self.grid.block("gy", self.ny), self.grid.block("gx", self.nx))
        self.case = inputs_sharded.BlockCase(seed, config, traffic,
                                             (self.leads, self.nmem), block,
                                             device)
        self.fields = self.case.fields
        self.kept, self.due = {}, set()

    def lead(self, k: int) -> dict:
        return {n: (v[k], m[k]) for n, (v, m) in self.fields.items()}

    def step(self, i: int) -> None:
        k = i % self.leads
        self.due.add(k)
        f = self.lead(k)
        c = self.case
        args = [self._Field(*f[n]) for n in ("tk", "q", "u", "v", "ps")]
        self.kept[k] = self._fused.ensemble_summary_sharded(
            self.grid, *args, c.alevel, c.blevel, c.xmapr, c.ymapr,
            c.fcoriolis, wind_limit=float(self.traffic["wind_limit"]),
            global_shape=(self.ny, self.nx), all_defined=False)

    def reset(self) -> None:
        self.kept.clear()
        self.due.clear()

    def reference(self, k: int, round_to=None):
        c = self.case
        return ref_block.summary(
            lambda levels: c.window(k, levels), self.nmem, self.nlev,
            c.alevel, c.blevel, c.win_xmapr, c.win_ymapr, c.crop,
            float(self.traffic["wind_limit"]),
            int(self.traffic["level_block"]), round_to, _max_over_cards)

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
        """This card's bounds: B1 on its block padded with the ring, once a
        member, and the reductions on its block."""
        if self.device.type != "cuda":
            return {}
        name = torch.cuda.get_device_name(self.device)
        (r0, r1), (c0, c1) = self.case.block
        ny, nx = r1 - r0, c1 - c0
        pad = 2 * inputs_sharded.RING
        b1 = peaks.bound_s(name, counts.pipeline_bytes(self.nlev, ny + pad,
                                                       nx + pad),
                           counts.pipeline_ops(self.nlev, ny + pad, nx + pad))
        nbytes = counts.reduce_bytes(self.nmem, self.nlev, ny, nx)
        return {"b1_bound_s": units * self.nmem * b1,
                "reduce_bound_s": units * peaks.bound_s(name, nbytes, 0)}

    def control(self):
        """The block reference in the program's place, its output values
        rounded to bfloat16 (:func:`benchmark.reference.ensemble_block.
        summary`)."""
        entry = self

        def stand_in(grid, tk, *args, **kwargs):
            k = next(k for k in range(entry.leads)
                     if entry.fields["tk"][0][k].data_ptr()
                     == tk.values.data_ptr())
            return entry.reference(k, torch.bfloat16)

        return {f"{_FUSED}:ensemble_summary_sharded": stand_in}
