"""The isobaric cell's check and yardstick: faults planted in the program
come out as not correct under whole CPU runs of ``era5_l137.iso``; the
frozen interpolation of :mod:`benchmark.reference.isobaric` computes what
the program's plain version computes; the frozen bytes of
:mod:`benchmark.counts_isobaric` are the program's own count."""

import pytest
import torch

import chip_smoke
from benchmark import counts_isobaric, harness, inputs, inputs_global
from benchmark.reference import isobaric as ref_isobaric
from benchmark.spans import replaced
from benchmark.tests._small import SPEC, small
from benchmark.tests.test_bench_check import _altered, _stale
from mi_fieldcalc_tpu_torch.field import Field
from mi_fieldcalc_tpu_torch.ops import vertical_fused

CELL = "era5_l137.iso"
ISOBARIC = "mi_fieldcalc_tpu_torch.models.pipeline:derived_fields_isobaric"
INTERP = "mi_fieldcalc_tpu_torch.ops.vertical_fused:hlevel_to_plevel_fused"

torch.set_num_threads(2)


def _linear_in_p(fn):
    """The interpolation linear in p instead of ln p: a lower-fidelity
    rule that brackets the same levels."""
    def interp(*args, **kwargs):
        return fn(*args, **dict(kwargs, log_p=False))
    return interp


FAULTS = {"stale": {ISOBARIC: _stale}, "altered": {ISOBARIC: _altered},
          "linear_in_p": {INTERP: _linear_in_p}}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_planted_fault_comes_out_not_correct(fault):
    with replaced(FAULTS[fault]):
        out = harness.run_cell(SPEC, CELL, 2 ** 31 + 5, 0.05, False, "cpu",
                               overrides=small(SPEC, CELL))
    assert not out["correct"], (fault, out["check"])
    assert out["check"]["step_gap"]["value"] > \
        out["check"]["step_gap"]["limit"]


def _era5_columns(seed: int):
    r = harness.resolve(SPEC, CELL)
    config = dict(r["config"], **small(SPEC, CELL))
    case = inputs_global.isobaric_case(
        inputs.generator(seed, torch.device("cpu")), config, r["traffic"],
        (), torch.device("cpu"))
    f = case.fields
    return ([f[n][0] for n in ("tk", "q", "u", "v")], f["ps"][0],
            case.alevel, case.blevel, case.plevels)


def _scrambled_columns(seed: int):
    """Levels in no order: columns whose p rises and falls, so a target
    has several brackets and the last one wins."""
    g = torch.Generator().manual_seed(seed)
    vals = [torch.randn((9, 5, 7), generator=g) * 10 + 270 for _ in range(4)]
    ps = 1000 + 15 * torch.randn((5, 7), generator=g)
    return (vals, ps, 300 * torch.rand(9, generator=g),
            torch.rand(9, generator=g), (1000.0, 850.0, 500.0, 300.0))


@pytest.mark.parametrize("columns", [_era5_columns, _scrambled_columns])
@pytest.mark.parametrize("seed", [4, 2 ** 33 + 1])
def test_frozen_interpolation_is_the_plain_version(columns, seed):
    vals, ps, alevel, blevel, targets = columns(seed)
    got, mask = ref_isobaric.interpolate(vals, ps, alevel, blevel, targets)
    ones = torch.ones(vals[0].shape, dtype=torch.bool)
    plain = vertical_fused.hlevel_to_plevel_plain(
        tuple(Field(v, ones) for v in vals), Field(ps, ones[0]), alevel,
        blevel, targets, all_defined=True)
    assert bool(mask.any()) and not bool(mask.all())
    for v, f in enumerate(plain):
        assert torch.equal(f.mask, mask)
        assert torch.equal(f.values.view(torch.int32),
                           got[v].view(torch.int32))


@pytest.mark.parametrize("shape", [(4, 37, 13, 24), (4, 37, 721, 1440),
                                   (4, 11, 719, 929)])
@pytest.mark.parametrize("all_defined", [True, False])
def test_frozen_interp_bytes_are_the_programs(shape, all_defined):
    nvar, nt, ny, nx = shape
    assert counts_isobaric.interp_bytes(nvar, nt, ny, nx, all_defined) == \
        chip_smoke.interp_bytes(nvar, 137, nt, ny, nx,
                                all_defined)["bracket"]
