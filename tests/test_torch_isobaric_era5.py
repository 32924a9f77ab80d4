"""ERA5's 137 model levels to its 37 pressure levels through the port's
isobaric path, ``models.pipeline.derived_fields_isobaric(fused=True,
stacked=True, all_defined=True)``, held bit for bit to the benchmark's
plain reference (``benchmark/reference/isobaric.py``) at the
configuration's ``cpu_test`` grid: the stand-in hybrid law shaped like
IFS's, both pole rows and the Antarctic rows, whose surface pressure puts
the lowest surfaces below ground.  Also the law's shape, and the spans a
profiled call records.  The ``cuda`` case runs the kernels on the card
(``python -m pytest tests/test_torch_isobaric_era5.py --noconftest``);
this file imports no JAX."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness, inputs, inputs_global
from benchmark.reference import isobaric as ref_isobaric
from benchmark.reference.pipeline import FIELDS
from mi_fieldcalc_tpu_torch.field import Field
from mi_fieldcalc_tpu_torch.models import pipeline
from mi_fieldcalc_tpu_torch.models.pipeline import DerivedFieldsStacked
from mi_fieldcalc_tpu_torch.ops import vertical_fused
from mi_fieldcalc_tpu_torch.utils import profiling as tprof

_CELL = harness.resolve(harness.benchmark_spec(), "era5_l137.iso")
CONFIG, TRAFFIC = _CELL["config"], _CELL["traffic"]
SMALL = dict(CONFIG, **CONFIG["cpu_test"])


def _case(seed: int, config=SMALL, device="cpu"):
    """One hour of the cell's inputs: the port's Fields and the rest."""
    dev = torch.device(device)
    case = inputs_global.isobaric_case(inputs.generator(seed, dev), config,
                                       TRAFFIC, (), dev)
    args = [Field(*case.fields[n]) for n in ("tk", "q", "u", "v", "ps")]
    return case, args + [case.alevel, case.blevel, case.xmapr, case.ymapr,
                         case.fcoriolis]


def _port(case, args):
    return pipeline.derived_fields_isobaric(
        *args, plevels=case.plevels, fused=True, stacked=True,
        all_defined=True)


def _reference(case):
    return ref_isobaric.derived_fields_isobaric(
        case.fields, case.alevel, case.blevel, case.plevels, case.xmapr,
        case.ymapr)


def _same_bits(got: DerivedFieldsStacked, ref: dict) -> None:
    for i, name in enumerate(FIELDS):
        v = got.values[i]
        m = DerivedFieldsStacked.mask_plane(got.masks, i, v)
        rm = ref[name].mask.broadcast_to(v.shape)
        assert torch.equal(m, rm), f"{name}: masks differ"
        g, r = v[m], ref[name].values.broadcast_to(v.shape)[m]
        same = (g == r) | (torch.isnan(g) & torch.isnan(r))
        assert bool(same.all()), f"{name}: values differ"


@pytest.mark.parametrize("seed", [2 ** 31 + 11, 2 ** 32 + 5, 977])
def test_the_port_is_the_reference_bit_for_bit(seed):
    case, args = _case(seed)
    got = _port(case, args)
    ref = _reference(case)
    _same_bits(got, ref)
    # the masks the case must exercise: 1 hPa lies inside every column;
    # 1000 hPa lies below ground in the Antarctic rows, and above ground
    # at some points elsewhere
    south = inputs_global.south_rows(SMALL["ny"], TRAFFIC["ps_south"][
        "south_of_deg"])
    assert south == slice(11, 13)
    th = DerivedFieldsStacked.mask_plane(got.masks, 1, got.values[1])
    top, bottom = case.plevels.index(1.0), case.plevels.index(1000.0)
    assert bool(th[top].all())
    assert not bool(th[bottom, south].any())
    assert bool(th[bottom, 1:south.start - 1].any())


def test_the_stand_in_law_has_the_shape_of_ifs_l137():
    """A >= 0 from 0.01 hPa at the top, up to about 179 hPa near level 79
    and back to 0 at the surface, so A is not monotone and the
    interpolation kernel's vote for its search route fails; B rises from
    0 to 1."""
    a, b = (c.cpu().numpy() for c in inputs_global.hybrid_levels(
        CONFIG, "cpu"))
    assert a.dtype == np.float32 and len(a) == CONFIG["levels"] == 137
    assert (a >= 0).all()
    assert a[0] == np.float32(0.01) and a[40] == np.float32(50.0)
    assert a[-1] == 0.0 and b[40] == 0.0 and b[-1] == 1.0
    assert int(np.argmax(a)) == 79 and 178.0 < a.max() < 180.0
    assert (np.diff(b) >= 0).all() and not (np.diff(a) >= 0).all()


@pytest.mark.parametrize("ps", [371.0, 680.0, 1050.0])
def test_pressure_rises_down_the_column(ps):
    """p_k = A_k + B_k ps, rounded as the kernel rounds it, increases
    from the top level to the surface."""
    a, b = inputs_global.hybrid_levels(CONFIG, "cpu")
    p = a + b * torch.full((), ps)
    assert bool((p[1:] > p[:-1]).all())
    assert float(p[-1]) == ps


def test_the_step_records_its_kernels_under_its_span():
    case, args = _case(3)
    off = _port(case, args)
    with profile(activities=[ProfilerActivity.CPU]):
        on = _port(case, args)
    rec = tprof.take()
    (top,) = [s for s in rec.spans if s.parent is None]
    assert top.name == "isobaric.step"
    assert [s.name for s in rec.spans if s.parent == top.id] == \
        ["b2.kernel", "b1.kernel"]
    assert len(rec.spans) == 3 and rec.counters == {}
    assert all(s.self_ms >= 0 for s in rec.spans)
    assert torch.equal(off.values.view(torch.int32),
                       on.values.view(torch.int32))
    assert torch.equal(off.masks, on.masks)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_the_card_takes_the_kernels_bit_for_bit(cuda_device):
    """137 x 64 x 256 -> 37 on the card: the interpolation kernel, which
    finds p rising down every column of this law and so searches each,
    equals its plain version, and a profiled call counts every column
    searched; the whole step equals the reference on the card."""
    config = dict(CONFIG, ny=64, nx=256)
    case, args = _case(2 ** 31 + 3, config, cuda_device)
    fields = tuple(args[:4])
    before = vertical_fused.hlevel_to_plevel_fused.launches
    got = vertical_fused.hlevel_to_plevel_fused(
        fields, args[4], case.alevel, case.blevel, case.plevels,
        all_defined=True)
    torch.cuda.synchronize()
    assert vertical_fused.hlevel_to_plevel_fused.launches == before + 1
    plain = vertical_fused.hlevel_to_plevel_plain(
        fields, args[4], case.alevel, case.blevel, case.plevels,
        all_defined=True)
    for g, r in zip(got, plain):
        assert torch.equal(g.mask, r.mask)
        assert torch.equal(g.values.view(torch.int32),
                           r.values.view(torch.int32))
    with profile(activities=[ProfilerActivity.CPU]):
        vertical_fused.hlevel_to_plevel_fused(
            fields, args[4], case.alevel, case.blevel, case.plevels,
            all_defined=True)
    counters = tprof.take().counters
    assert counters["b2.columns"] == 64 * 256
    assert counters["b2.searched_columns"] == 64 * 256
    _same_bits(_port(case, args), _reference(case))
