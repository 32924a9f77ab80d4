"""Domain decomposition over processes: process grids, halo exchange, the
sharded pipeline (port of :mod:`mi_fieldcalc_tpu.parallel`).

The reference's only parallelism is OpenMP threads over per-point loops
(openmp_tools.h:42-45); it has no distributed backend (SURVEY §2.7).  The
port decomposes the ``(ny, nx)`` grid over a 2-D grid of processes, one
device each, on ``torch.distributed`` (NCCL between cards, gloo on the
CPU), with radius-R halo rings exchanged point to point between grid
neighbours, and the reference's ``fillEdges`` applied only at *physical*
domain edges, never at shard seams.
"""

from .mesh import (grid_mesh, partition_spec,  # noqa: F401
                   factor_devices_for_grid)
from .halo import halo_exchange, run_sharded  # noqa: F401
from . import distributed  # noqa: F401
