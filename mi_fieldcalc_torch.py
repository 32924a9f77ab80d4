"""Drop-in compatibility shim for the reference's Python module, on the
PyTorch/CUDA port.

The counterpart of ``mi_fieldcalc.py`` (the JAX package's shim): code
written against the reference's pybind11 module ``mi_fieldcalc`` runs
unchanged against the port with one import changed::

    import mi_fieldcalc_torch as mi_fieldcalc
    out = mi_fieldcalc.abshum(t, rhum, undef)   # same signature/layout

Everything re-exports from :mod:`mi_fieldcalc_tpu_torch.api`, which keeps
the binding's exact call signatures — including its ``shape(0) -> nx``
convention (py_mi_fieldcalc.cc:88) — and the full ~70-function C++
surface, with a keyword-only ``device`` (``"cuda"`` by default), and the
call-storm batching (``batch``, ``fetch``, ``Deferred``, ...): on CUDA a
recorded storm runs as one CUDA graph.
"""

from mi_fieldcalc_tpu_torch.api import *            # noqa: F401,F403
from mi_fieldcalc_tpu_torch.api import __all__      # noqa: F401
from mi_fieldcalc_tpu_torch import __version__      # noqa: F401
