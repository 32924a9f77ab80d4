"""The reference goldens replayed through the PyTorch port.

:data:`PORT_OPS` maps every operator name of ``conformance_cases.CASES``
to a call of its port, in the shape of ``test_conformance._native``;
:func:`port_case` runs one case on a device and :func:`check` holds its
output to the golden under the case's own contract (``test_conformance.
_check``: the mask equal to the reference's sentinel pattern where
``mask_exact``, values within the case's rtol / atol where both sides are
defined).  Imports numpy, torch and the port only, so ``chip_smoke.py``
replays the goldens on the card through it.
"""

from __future__ import annotations

import numpy as np

from conformance_cases import UNDEF

from mi_fieldcalc_tpu_torch import from_sentinel, ops

#: op name -> port call on (Fields, scalars)
PORT_OPS = {
    "pleveltemp": lambda F, s: ops.pleveltemp(F[0], s["p"], s["compute"],
                                              s["unit"]),
    "plevelthe": lambda F, s: ops.plevelthe(F[0], F[1], s["p"],
                                            s["compute"]),
    "plevelhum": lambda F, s: ops.plevelhum(F[0], F[1], s["p"], s["compute"],
                                            s["unit"]),
    "pleveldz2tmean": lambda F, s: ops.pleveldz2tmean(
        F[0], F[1], s["p1"], s["p2"], s["compute"]),
    "plevelducting": lambda F, s: ops.plevelducting(F[0], F[1], s["p"],
                                                    s["compute"]),
    "hleveltemp": lambda F, s: ops.hleveltemp(
        F[0], F[1], s["alevel"], s["blevel"], s["compute"], s["unit"]),
    "hlevelthe": lambda F, s: ops.hlevelthe(
        F[0], F[1], F[2], s["alevel"], s["blevel"], s["compute"]),
    "hlevelhum": lambda F, s: ops.hlevelhum(
        F[0], F[1], F[2], s["alevel"], s["blevel"], s["compute"], s["unit"]),
    "hlevelducting": lambda F, s: ops.hlevelducting(
        F[0], F[1], F[2], s["alevel"], s["blevel"], s["compute"]),
    "hlevelpressure": lambda F, s: ops.hlevelpressure(F[0], s["alevel"],
                                                      s["blevel"]),
    "aleveltemp": lambda F, s: ops.aleveltemp(F[0], F[1], s["compute"],
                                              s["unit"]),
    "alevelthe": lambda F, s: ops.alevelthe(F[0], F[1], F[2], s["compute"]),
    "alevelhum": lambda F, s: ops.alevelhum(F[0], F[1], F[2], s["compute"],
                                            s["unit"]),
    "alevelducting": lambda F, s: ops.alevelducting(F[0], F[1], F[2],
                                                    s["compute"]),
    "ilevelgwind": lambda F, s: ops.ilevelgwind(F[0], F[1], F[2], F[3]),
    "seaSoundSpeed": lambda F, s: ops.sea_sound_speed(F[0], F[1], s["z"],
                                                      s["compute"]),
    "kIndex": lambda F, s: ops.k_index(
        F[0], F[1], F[2], F[3], F[4], s["p500"], s["p700"], s["p850"],
        s["compute"]),
    "ductingIndex": lambda F, s: ops.ducting_index(F[0], F[1], s["p850"],
                                                   s["compute"]),
    "showalterIndex": lambda F, s: ops.showalter_index(
        F[0], F[1], F[2], s["p500"], s["p850"], s["compute"]),
    "boydenIndex": lambda F, s: ops.boyden_index(
        F[0], F[1], F[2], s["p700"], s["p1000"], s["compute"]),
    "sweatIndex": lambda F, s: ops.sweat_index(*F),
    "cvtemp": lambda F, s: ops.cvtemp(F[0], s["compute"]),
    "cvhum": lambda F, s: ops.cvhum(F[0], F[1], s["compute"], s["unit"]),
    "abshum": lambda F, s: ops.abshum(F[0], F[1]),
    "vectorabs": lambda F, s: ops.vectorabs(F[0], F[1]),
    "windCooling": lambda F, s: ops.wind_cooling(F[0], F[1], F[2],
                                                 s["compute"]),
    "underCooledRain": lambda F, s: ops.under_cooled_rain(
        F[0], F[1], F[2], s["precipMin"], s["snowRateMax"], s["tcMax"]),
    "pressure2FlightLevel": lambda F, s: ops.pressure2flightlevel(F[0]),
    "snow_in_cm": lambda F, s: ops.snow_in_cm(F[0], F[1], F[2]),
    "values2classes": lambda F, s: ops.values2classes(F[0], s["values"]),
    "fieldOPERfield": lambda F, s: ops.field_oper_field(s["compute"], F[0],
                                                        F[1]),
    "fieldOPERconstant": lambda F, s: ops.field_oper_constant(
        s["compute"], F[0], s["value"]),
    "constantOPERfield": lambda F, s: ops.constant_oper_field(
        s["compute"], s["value"], F[0]),
    "minvalueFields": lambda F, s: ops.minvalue_fields(F[0], F[1]),
    "maxvalueFields": lambda F, s: ops.maxvalue_fields(F[0], F[1]),
    "minvalueFieldConst": lambda F, s: ops.minvalue_field_const(F[0],
                                                                s["value"]),
    "maxvalueFieldConst": lambda F, s: ops.maxvalue_field_const(F[0],
                                                                s["value"]),
    "absvalueField": lambda F, s: ops.absvalue_field(F[0]),
    "log10Field": lambda F, s: ops.log10_field(F[0]),
    "pow10Field": lambda F, s: ops.pow10_field(F[0]),
    "logField": lambda F, s: ops.log_field(F[0]),
    "expField": lambda F, s: ops.exp_field(F[0]),
    "powerField": lambda F, s: ops.power_field(F[0], s["value"]),
    "replaceUndefined": lambda F, s: ops.replace_undefined(F[0], s["value"]),
    "replaceDefined": lambda F, s: ops.replace_defined(F[0], s["value"]),
    "copy_field": lambda F, s: F[0],   # the reference's memcpy (cc:318-322)
    "plevelgwind_xcomp": lambda F, s: ops.plevelgwind_xcomp(*F),
    "plevelgwind_ycomp": lambda F, s: ops.plevelgwind_ycomp(*F),
    "plevelgvort": lambda F, s: ops.plevelgvort(*F),
    "plevelqvector": lambda F, s: ops.plevelqvector(*F, s["p"],
                                                    s["compute"]),
    "relvort": lambda F, s: ops.relvort(*F),
    "absvort": lambda F, s: ops.absvort(*F),
    "divergence": lambda F, s: ops.divergence(*F),
    "advection": lambda F, s: ops.advection(*F, s["hours"]),
    "gradient": lambda F, s: ops.gradient(*F, s["compute"]),
    "shapiro2_filter": lambda F, s: ops.shapiro2_filter(F[0]),
    "thermalFrontParameter": lambda F, s: ops.thermal_front_parameter(*F),
    "momentumXcoordinate": lambda F, s: ops.momentum_x_coordinate(
        *F, s["fcoriolisMin"]),
    "momentumYcoordinate": lambda F, s: ops.momentum_y_coordinate(
        *F, s["fcoriolisMin"]),
    "jacobian": lambda F, s: ops.jacobian(*F),
    "sumFields": lambda F, s: ops.sum_fields(F[0]),
    "meanValue": lambda F, s: ops.mean_value(F[0]),
    "stddevValue": lambda F, s: ops.stddev_value(F[0]),
    "extremeValue": lambda F, s: ops.extreme_value(s["compute"], F[0]),
    "probability": lambda F, s: ops.probability(s["compute"], F[0],
                                                s["limits"]),
    "neighbourProbFunctions": lambda F, s: ops.neighbour_prob_functions(
        F[0], s["constants"], s["compute"]),
    "neighbourFunctions": lambda F, s: ops.neighbour_functions(
        F[0], s["constants"], s["compute"]),
    "vesselIcingOverland": lambda F, s: ops.vessel_icing_overland(*F),
    "vesselIcingMertins": lambda F, s: ops.vessel_icing_mertins(*F),
    "vesselIcingModStall": lambda F, s: ops.vessel_icing_modstall(
        *F, s["vs"], s["alpha"], s["zmin"], s["zmax"]),
    "vesselIcingMincog": lambda F, s: ops.vessel_icing_mincog(
        *F, s["vs"], s["alpha"], s["zmin"], s["zmax"], s["alt"]),
}


def port_case(case, ins, device="cpu"):
    """One case's inputs through its port on ``device``: a Field, or the
    ``(ug, vg)`` pair of ``ilevelgwind``."""
    fields = [from_sentinel(a, device=device) for a in ins]
    return PORT_OPS[case.op](fields, case.scalars)


def outputs(case, out):
    """``(name, Field)`` of each output of a case, keyed as the goldens
    are (``<case>__out``, and ``__out2`` for ``ilevelgwind``'s vg)."""
    if case.op == "ilevelgwind":
        return [(case.name + "__out", out[0]), (case.name + "__out2", out[1])]
    return [(case.name + "__out", out)]


def check(case, field, ref) -> None:
    """``test_conformance._check`` for a Field on any device."""
    ref_mask = (ref != UNDEF) & ~np.isnan(ref)
    my_mask = field.mask.cpu().numpy()
    my_vals = field.values.cpu().numpy()
    if case.mask_exact:
        np.testing.assert_array_equal(
            my_mask, ref_mask,
            err_msg=f"{case.name}: mask != reference sentinel pattern")
    both = my_mask & ref_mask
    assert both.any() or not ref_mask.any(), \
        f"{case.name}: no commonly-defined points"
    np.testing.assert_allclose(
        my_vals[both], ref[both], rtol=case.rtol, atol=case.atol,
        err_msg=f"{case.name}: values diverge from reference")
