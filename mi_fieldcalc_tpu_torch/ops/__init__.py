"""The derived-field pipeline's operators in plain PyTorch (port of the
pipeline's slice of :mod:`mi_fieldcalc_tpu.ops`).  The CUDA kernel's
wrapper lives in :mod:`.fused`; importing it builds nothing."""

from .levels import (  # noqa: F401
    aleveltemp, alevelthe, alevelhum, alevelducting,
)
from .stencil import (  # noqa: F401
    fill_edges, gradient, relvort, divergence, advection,
    thermal_front_parameter,
)
from .elementwise import vectorabs  # noqa: F401
