"""The port's operators in plain PyTorch (port of the ported slices of
:mod:`mi_fieldcalc_tpu.ops`).  The CUDA kernels' wrappers live in
:mod:`.fused`, :mod:`.vertical_fused`, :mod:`.fused_suite` and
:mod:`.icing_fused`; importing them builds nothing."""

from .levels import (  # noqa: F401
    aleveltemp, alevelthe, alevelhum, alevelducting, hleveltemp, hlevelthe,
    hlevelhum, hlevelducting, hlevelpressure,
)
from .stencil import (  # noqa: F401
    fill_edges, gradient, relvort, divergence, advection,
    thermal_front_parameter,
)
from .elementwise import vectorabs  # noqa: F401
from .vertical import plevel_interp, hlevel_to_plevel  # noqa: F401
from .vertical_fused import hlevel_to_plevel_fused  # noqa: F401
from .fused_suite import (  # noqa: F401
    alevel_suite_fused, hlevel_suite_fused, suite_inputs_from_numpy,
)
from .icing import (  # noqa: F401
    vessel_icing_overland, vessel_icing_mertins, vessel_icing_modstall,
    vessel_icing_mincog,
)
from .icing_fused import (  # noqa: F401
    vessel_icing_mincog_fused, vessel_icing_modstall_fused,
)
