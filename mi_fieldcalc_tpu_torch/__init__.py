"""mi_fieldcalc_tpu_torch — PyTorch/CUDA port of the derived-field engine.

A second package beside :mod:`mi_fieldcalc_tpu` (the JAX reference, which
stays as it is).  It serves the 12-output derived-field pipeline from
sentinel-coded numpy in to sentinel-coded numpy out, through one
hand-written CUDA kernel on an NVIDIA H100 (``csrc/derived_fields.cu``).
Module names mirror the JAX package, so each counterpart is found by path:

* :mod:`.field` — :class:`Field` (float32 values + bool mask tensors) and
  the sentinel codecs,
* :mod:`.constants`, :mod:`._libm` — the constants, EWT table and the
  deterministic Exner pow the pipeline uses,
* :mod:`.ops` — the pipeline's operators in plain PyTorch, and
  :mod:`.ops.fused` — the CUDA kernel's wrapper with its plain version,
* :mod:`.models.pipeline` — ``derived_fields`` and the stacked layout,
* :mod:`.native`, :mod:`.staging` — the host codec binding and the
  production entry :func:`.staging.run_derived_fields_np`.

The package imports ``torch`` and numpy only, never ``jax``.  Importing it
builds and loads nothing: the CUDA library is compiled at first use
(:mod:`._build`).
"""

__version__ = "0.1.0"

from .field import (  # noqa: F401
    UNDEF, Field, ValuesDefined, defined_state, from_arrays, from_sentinel,
    from_values, full_undef,
)
