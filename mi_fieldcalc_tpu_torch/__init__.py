"""mi_fieldcalc_tpu_torch — PyTorch/CUDA port of the derived-field engine.

A second package beside :mod:`mi_fieldcalc_tpu` (the JAX reference, which
stays as it is).  It holds the reference's operator surface in plain
PyTorch, and serves the 12-output derived-field pipeline, the
level-conversion suites, the ensemble summary and the vessel-icing
products through hand-written CUDA kernels on an NVIDIA H100
(``csrc/*.cu``).
Module names mirror the JAX package, so each counterpart is found by path:

* :mod:`.field` — :class:`Field` (float32 values + bool mask tensors) and
  the sentinel codecs,
* :mod:`.constants`, :mod:`._libm` — the constants, EWT table and the
  deterministic pow, log, exp and tanh,
* :mod:`.ops` — the ~70 operators in plain PyTorch (levels, thermo,
  elementwise, stencil, stability, window, ensemble, vertical, icing), and
  the CUDA kernels' wrappers with their plain versions (:mod:`.ops.fused`,
  :mod:`.ops.vertical_fused`, :mod:`.ops.fused_suite`,
  :mod:`.ops.icing_fused`),
* :mod:`.models` — ``derived_fields`` and its stacked layout,
  ``derived_fields_isobaric``, ``derived_fields_plevel`` and
  ``ensemble_derived_summary``,
* :mod:`.native`, :mod:`.staging` — the host codec binding and the
  serving entries (``run_derived_fields_np``, ``run_hlevel_suite_np``,
  :func:`.staging.run_vessel_icing_np`).

The package imports ``torch`` and numpy only, never ``jax``.  Importing it
builds and loads nothing: the CUDA library is compiled at first use
(:mod:`._build`).
"""

__version__ = "0.1.0"

from .field import (  # noqa: F401
    UNDEF, Field, ValuesDefined, combine_defined, defined_counts,
    defined_state, from_arrays, from_sentinel, from_values, full_undef,
)
from . import constants, models, ops, parallel  # noqa: F401,E402
from .ops import (  # noqa: F401,E402
    vessel_icing_mertins, vessel_icing_mincog, vessel_icing_mincog_fused,
    vessel_icing_modstall, vessel_icing_modstall_fused,
    vessel_icing_overland,
)
from .staging import run_vessel_icing_np  # noqa: F401,E402
