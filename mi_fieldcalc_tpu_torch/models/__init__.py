"""Multi-operator pipelines (port of :mod:`mi_fieldcalc_tpu.models`)."""

from .pipeline import (  # noqa: F401
    STANDARD_PLEVELS, DerivedFields, DerivedFieldsStacked, derived_fields,
    derived_fields_isobaric, derived_fields_plevel, inputs_from_numpy,
)
from .ensemble import (  # noqa: F401
    EnsembleSummary, ensemble_derived_summary,
)
