"""Model-level temperature / humidity / THE / ducting operators (port of
the pipeline's slice of :mod:`mi_fieldcalc_tpu.ops.levels`,
``levels.py:109-327``).

Only the compute modes the derived-field pipeline runs are ported:
``aleveltemp`` 3, ``alevelhum`` 1 and 9, ``alevelthe`` 1 and
``alevelducting`` 1.  Any other mode raises :class:`NotImplementedError`
naming the JAX function.
"""

from __future__ import annotations

from ..constants import cp, pidcp_from_p, t0, xlh
from ..field import Field
from . import thermo
from ._harness import and_masks, not_ported, out_field, require

__all__ = ["aleveltemp", "alevelhum", "alevelthe", "alevelducting"]


def aleveltemp(t: Field, p: Field, compute: int, unit: str = "") -> Field:
    """Model-level temperature conversion with a pressure field
    (FieldCalculations.cc:1310-1353); compute 3 is T(K) -> theta."""
    require(0 < compute < 6, f"aleveltemp: bad compute {compute}")
    if compute != 3:     # ``unit`` remaps only compute < 3
        raise not_ported("mi_fieldcalc_tpu.ops.aleveltemp",
                         f"aleveltemp compute={compute}")
    return out_field(t.values / pidcp_from_p(p.values), and_masks(t, p))


def alevelhum(t: Field, hum: Field, p: Field, compute: int,
              unit: str = "") -> Field:
    """Model-level humidity conversion with a pressure field
    (FieldCalculations.cc:1394-1458): compute 1 is (T(K), q) -> RH%,
    compute 9 is (T(K), q) -> Td(K).

    Reference quirk (cc:1438): for these pressure-using modes an undefined
    pressure does not gate the output; the sentinel itself flows into the
    formulas and gives defined garbage.  Reproduced by computing with
    ``p.to_sentinel()``."""
    require(0 < compute < 13, f"alevelhum: bad compute {compute}")
    if compute > 8 and unit == "celsius":
        compute -= 4
    elif 4 < compute <= 8 and unit == "kelvin":
        compute += 4
    if compute not in (1, 9):
        raise not_ported("mi_fieldcalc_tpu.ops.alevelhum",
                         f"alevelhum compute={compute}")
    p_sent = p.to_sentinel()
    if compute == 1:
        out, ok = thermo.tk_q_rh(t.values, hum.values, p_sent)
    else:
        out, ok = thermo.tk_q_td(t.values, hum.values, p_sent, t0)
    return out_field(out, and_masks(t, hum) & ok)


def alevelthe(t: Field, q: Field, p: Field, compute: int) -> Field:
    """Equivalent potential temperature on model levels, compute 1 is
    (T(K), q) (FieldCalculations.cc:1355-1392)."""
    require(compute in (1, 2), f"alevelthe: bad compute {compute}")
    if compute != 1:
        raise not_ported("mi_fieldcalc_tpu.ops.alevelthe",
                         f"alevelthe compute={compute}")
    pi = float(cp) * pidcp_from_p(p.values)
    out = (t.values * float(cp) + q.values * float(xlh)) / pi
    return out_field(out, and_masks(t, q, p))


def alevelducting(t: Field, h: Field, p: Field, compute: int) -> Field:
    """Ducting index with a pressure field, compute 1 is (T(K), q)
    (FieldCalculations.cc:1460-1505)."""
    require(compute in (1, 2, 3, 4), f"alevelducting: bad compute {compute}")
    if compute != 1:
        raise not_ported("mi_fieldcalc_tpu.ops.alevelducting",
                         f"alevelducting compute={compute}")
    return out_field(thermo.tk_q_duct(t.values, h.values, p.values),
                     and_masks(t, h, p))
