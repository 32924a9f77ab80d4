"""The plain reference and the frozen counts against the program's own
CPU path at a small size: the reference is an independent copy, so a
later change to the program cannot move it, but today it computes what
the program's plain versions compute."""

import pytest
import torch

import chip_smoke
from benchmark import counts
from benchmark.reference import ensemble as ref_ensemble
from benchmark.reference import pipeline as ref_pipeline
from benchmark.reference._base import Field as RField
from mi_fieldcalc_tpu_torch.field import Field, from_sentinel
from mi_fieldcalc_tpu_torch.models import ensemble
from mi_fieldcalc_tpu_torch.models.pipeline import DerivedFieldsStacked
from mi_fieldcalc_tpu_torch.ops import fused

torch.set_num_threads(2)


def _same(got: Field, ref: RField, label: str) -> None:
    gm = got.mask.broadcast_to(got.values.shape)
    rm = ref.mask.broadcast_to(got.values.shape)
    assert torch.equal(gm, rm), f"{label}: masks differ"
    rv = ref.values.broadcast_to(got.values.shape)
    g, r = got.values[gm], rv[gm]
    same = (g == r) | (torch.isnan(g) & torch.isnan(r))
    assert bool(same.all()), f"{label}: values differ"


def _pipeline_args(seed, kind="scattered", shape=(3, 17, 23)):
    raw = chip_smoke.make_inputs(*shape, seed, True, kind)
    fields = [from_sentinel(a) for a in raw[:5]]
    rest = [torch.as_tensor(a) for a in raw[5:]]
    return fields, rest


@pytest.mark.parametrize("kind", ["scattered", "column"])
def test_reference_pipeline_is_the_plain_version(kind):
    fields, rest = _pipeline_args(3, kind)
    st = fused.derived_fields_plain(*fields, *rest)
    ref = ref_pipeline.derived_fields(
        *[RField(f.values, f.mask) for f in fields], *rest[:4])
    for i, name in enumerate(ref_pipeline.FIELDS):
        got = Field(st.values[i], DerivedFieldsStacked.mask_plane(
            st.masks, i, st.values[i]))
        _same(got, ref[name], name)


def test_reference_summary_is_the_program_summary():
    nmem = 3
    per = [_pipeline_args(10 + m, "scattered", (2, 9, 13)) for m in range(nmem)]
    stacks = [Field(torch.stack([p[0][i].values for p in per]),
                    torch.stack([p[0][i].mask for p in per]))
              for i in range(5)]
    rest = per[0][1]
    got = ensemble.ensemble_derived_summary(*stacks, *rest, fused=True)
    ref = ref_ensemble.summary(
        {n: (s.values, s.mask) for n, s in zip(("tk", "q", "u", "v", "ps"),
                                               stacks)},
        rest[0], rest[1], rest[2], rest[3], 15.0, level_block=1)
    for i, name in enumerate(ref_pipeline.FIELDS):
        _same(got.mean[i], ref.mean[i], f"mean.{name}")
        _same(got.spread[i], ref.spread[i], f"spread.{name}")
    _same(got.prob_wind, ref.prob_wind, "prob_wind")
    _same(got.prob_t_freeze, ref.prob_t_freeze, "prob_t_freeze")


@pytest.mark.parametrize("shape", [(3, 17, 23), (65, 949, 739)])
def test_frozen_bytes_are_the_programs(shape):
    assert counts.pipeline_bytes(*shape) == chip_smoke.layout_bytes(
        *shape, all_defined=False)
    assert counts.OPS_B1_POINT == chip_smoke.OPS_B1_POINT

