"""Multi-operator pipelines (port of :mod:`mi_fieldcalc_tpu.models`)."""

from .pipeline import (  # noqa: F401
    DerivedFields, DerivedFieldsStacked, derived_fields, inputs_from_numpy,
)
