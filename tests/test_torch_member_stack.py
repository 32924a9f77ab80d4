"""The ensemble's member stack written in place by the pipeline kernel.

``ops.fused.derived_fields_fused`` takes ``out_values`` / ``out_masks``:
a member's slot ``[:, m]`` of ``[12 | 9 | 2, nmem, nlev, ny, nx]`` stacks,
the planes one stride apart.  On CUDA tensors the kernel writes there (B1's
``out_plane_stride``, held bit for bit on the host in
``test_torch_fused_host.py``); on CPU tensors the plain version's outputs
are copied in.  Any other layout is refused.

``models.ensemble.ensemble_member_fields(fused=True)`` hands each
member's call its slot: 12 value planes and B1's own 9 mask planes (2 and
one all-True plane under ``all_defined``), the fields that share a mask
plane sharing its tensor; on CUDA tensors it counts
``ensemble.members_in_place`` once a member.  On CPU tensors the wrapper
copies the plain version's outputs into each slot, and the unfused route
copies each member into ``[12, nmem, ...]`` stacks; neither counts.  On the
CPU the fused route's summary equals the copy route's bit for bit; the
``cuda`` tests hold the kernel's in-place summary to the copy route built
from dense launches, on the card."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mi_fieldcalc_tpu_torch.field import Field
from mi_fieldcalc_tpu_torch.models import ensemble
from mi_fieldcalc_tpu_torch.models.pipeline import (DerivedFields,
                                                    DerivedFieldsStacked)
from mi_fieldcalc_tpu_torch.ops import fused
from mi_fieldcalc_tpu_torch.utils import profiling as tprof
import test_torch_profiling as tp

torch.set_num_threads(1)

COUNTER = "ensemble.members_in_place"
#: what a stack holds before the launch, outside the member's slot
SENTINEL = -7.25


def _args(nmem: int, all_defined: bool, device="cpu", **shape):
    """:func:`test_torch_profiling._inputs`, every mask True under
    ``all_defined`` (the route asserts every point is defined)."""
    args = tp._inputs(nmem, device=device, **shape)
    if all_defined:
        args = tuple(Field(f.values, torch.ones_like(f.mask))
                     for f in args[:5]) + args[5:]
    return args


def _member(args, m: int) -> list:
    return [Field(f.values[m], f.mask[m]) for f in args[:5]] + list(args[5:])


def _same(a, b) -> bool:
    """Equal bit for bit (NaN where NaN), through NamedTuples of Fields."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.float32:
            return bool(((a.view(torch.int32) == b.view(torch.int32))
                         | (a.isnan() & b.isnan())).all())
        return torch.equal(a, b)
    if isinstance(a, Field):
        return _same(a.values, b.values) and _same(a.mask, b.mask)
    return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))


def _copy_route(args, all_defined: bool) -> DerivedFields:
    """The member stack as it was built before the kernel wrote in place:
    dense launches, each member's values and its 12 mask planes copied
    into ``[12, nmem, ...]`` stacks."""
    nmem = args[0].values.shape[0]
    shape = tuple(args[0].values.shape[1:])
    dev = args[0].values.device
    values = torch.empty((12, nmem) + shape, device=dev)
    masks = torch.empty((12, nmem) + shape, dtype=torch.bool, device=dev)
    for m in range(nmem):
        st = fused.derived_fields_fused(*_member(args, m),
                                        all_defined=all_defined)
        values[:, m] = st.values
        for i in range(12):
            masks[i, m] = DerivedFieldsStacked.mask_plane(st.masks, i,
                                                          st.values[i])
    return DerivedFields(*[Field(values[i], masks[i]) for i in range(12)])


def _check_layout(out: DerivedFields, nmem: int, all_defined: bool) -> None:
    """12 value planes in one ``[12, nmem, ...]`` stack; the masks in the
    kernel's own planes, each field on the plane ``MASK9`` / ``MASK2``
    gives it, fields that share a plane sharing its storage, the
    ``all_defined`` route's constant plane all True."""
    v0 = out[0].values
    n = v0.numel()
    assert v0.shape[0] == nmem and v0.is_contiguous()
    for i, f in enumerate(out):
        assert f.values.data_ptr() == v0.data_ptr() + i * n * 4, i
        assert f.values.untyped_storage().data_ptr() == \
            v0.untyped_storage().data_ptr()
        assert f.mask.is_contiguous() and f.mask.shape == v0.shape
    plane_of = (DerivedFieldsStacked.MASK2 if all_defined
                else DerivedFieldsStacked.MASK9)
    ptrs = [f.mask.data_ptr() for f in out]
    for i, j in enumerate(plane_of):
        for k, l in enumerate(plane_of):
            assert (ptrs[i] == ptrs[k]) == (j == l), (i, k)
    stacked = [f.mask for f, j in zip(out, plane_of) if j >= 0]
    base = min(t.data_ptr() for t in stacked)
    assert {t.data_ptr() - base for t in stacked} == {
        j * n for j in set(plane_of) if j >= 0}
    assert len(set(ptrs)) == (3 if all_defined else 9)
    for f, j in zip(out, plane_of):
        if j < 0:
            assert bool(f.mask.all())


# ------------------------------------------------------------- the wrapper
@pytest.mark.parametrize("all_defined", [False, True])
def test_the_wrapper_writes_into_a_member_slot_on_the_cpu(all_defined):
    args = _member(_args(1, all_defined), 0)
    dense = fused.derived_fields_fused(*args, all_defined=all_defined)
    nplanes = dense.masks.shape[0]
    shape = tuple(dense.values.shape[1:])
    values = torch.full((12, 3) + shape, SENTINEL)
    masks = torch.zeros((nplanes, 3) + shape, dtype=torch.bool)
    got = fused.derived_fields_fused(*args, all_defined=all_defined,
                                     out_values=values[:, 1],
                                     out_masks=masks[:, 1])
    assert got.values.data_ptr() == values[:, 1].data_ptr()
    assert got.masks.data_ptr() == masks[:, 1].data_ptr()
    assert _same(got, dense)
    assert bool((values[:, [0, 2]] == SENTINEL).all())
    assert not bool(masks[:, [0, 2]].any())
    fields = fused.derived_fields_fused(
        *args, stacked=False, all_defined=all_defined,
        out_values=values[:, 2], out_masks=masks[:, 2])
    assert _same(fields, dense.as_fields())
    assert fields.td.mask.data_ptr() == masks[2 if not all_defined else 0,
                                              2].data_ptr()


def _bad_layouts():
    """(label, out_values, out_masks, error) on a 2x7x9 grid, masked
    route: each departs from the kernel's layout in one way."""
    shape = (2, 7, 9)
    n = 2 * 7 * 9
    v = torch.empty((12, 3) + shape)
    m = torch.empty((9, 3) + shape, dtype=torch.bool)
    return [
        ("values alone", v[:, 1], None, ValueError),
        ("masks alone", None, m[:, 1], ValueError),
        ("12 mask planes", v[:, 1],
         torch.empty((12, 3) + shape, dtype=torch.bool)[:, 1], ValueError),
        ("2 mask planes", v[:, 1], m[:2, 1], ValueError),
        ("11 value planes", v[:11, 1], m[:, 1], ValueError),
        ("float64 values", v.double()[:, 1], m[:, 1], TypeError),
        ("uint8 masks", v[:, 1], m.to(torch.uint8)[:, 1], TypeError),
        ("a plane not contiguous",
         torch.empty((12, 2, 3, 7, 9))[:, :, 1], m[:, 1], ValueError),
        ("strides differ", v[:, 1],
         torch.empty((9, 2) + shape, dtype=torch.bool)[:, 1], ValueError),
        ("planes overlap", torch.empty(12 * n).as_strided(
            (12,) + shape, (n - 1, 63, 9, 1)),
         torch.empty(12 * n, dtype=torch.bool).as_strided(
            (9,) + shape, (n - 1, 63, 9, 1)), ValueError),
        ("values not a tensor", [0.0], m[:, 1], TypeError)]


@pytest.mark.parametrize("case", _bad_layouts(), ids=lambda c: c[0])
def test_the_wrapper_refuses_another_layout(case):
    _, values, masks, error = case
    args = _member(_args(1, False), 0)
    with pytest.raises(error, match="derived_fields_fused"):
        fused.derived_fields_fused(*args, out_values=values,
                                   out_masks=masks)


def test_the_wrapper_refuses_masked_planes_on_the_all_defined_route():
    args = _member(_args(1, True), 0)
    shape = tuple(args[0].values.shape)
    with pytest.raises(ValueError, match="out_masks has shape"):
        fused.derived_fields_fused(
            *args, all_defined=True, out_values=torch.empty((12,) + shape),
            out_masks=torch.empty((9,) + shape, dtype=torch.bool))


# ------------------------------------------------------------ the ensemble
@pytest.fixture
def counted(monkeypatch):
    """Every name the ensemble's counter is called with, in or out of a
    profiler session."""
    names = []

    def count(name, n=1):
        names.append(name)
        tprof.count(name, n)

    monkeypatch.setattr(ensemble, "count", count)
    return names


@pytest.mark.parametrize("session", [False, True])
@pytest.mark.parametrize("fused_", [True, False])
def test_the_cpu_and_unfused_routes_copy_and_count_nothing(counted, session,
                                                           fused_):
    nmem = 3
    args = _args(nmem, False)
    if session:
        with tp._cpu_session():
            out = ensemble.ensemble_derived_summary(*args, fused=fused_)
        rec = tprof.take()
        assert COUNTER not in rec.counters and rec.counters == {}
        (fields,) = [s for s in rec.spans
                     if s.name == "ensemble.member_fields"]
        kids = [s.name for s in rec.spans if s.parent == fields.id]
        per_member = ["ensemble.member_stack"]
        if fused_:
            per_member = ["b1.kernel"] + per_member
        assert kids == per_member * nmem
    else:
        out = ensemble.ensemble_derived_summary(*args, fused=fused_)
    assert counted == []
    member_fields = ensemble.ensemble_member_fields(*args, fused=fused_)
    if fused_:
        _check_layout(member_fields, nmem, False)
    else:
        assert len({f.mask.data_ptr() for f in member_fields}) == 12
    assert _same(out, ensemble.ensemble_summary(member_fields))


@pytest.mark.parametrize("all_defined", [False, True])
def test_the_in_place_route_rehearsed_on_the_cpu(counted, all_defined):
    """The fused route on CPU tensors: its stacks and their shared planes,
    equal to the copy route's bit for bit, and its summary too; under a
    profiler session the span tree is the copy route's and nothing is
    counted."""
    nmem = 3
    args = _args(nmem, all_defined)
    out = ensemble.ensemble_member_fields(*args, fused=True,
                                          all_defined=all_defined)
    _check_layout(out, nmem, all_defined)
    copy = _copy_route(args, all_defined)
    assert _same(out, copy)
    assert counted == []
    with tp._cpu_session():
        got = ensemble.ensemble_derived_summary(*args, fused=True,
                                                all_defined=all_defined)
    rec = tprof.take()
    assert rec.counters == {}
    (fields,) = [s for s in rec.spans if s.name == "ensemble.member_fields"]
    assert [s.name for s in rec.spans if s.parent == fields.id] == \
        ["b1.kernel", "ensemble.member_stack"] * nmem
    assert _same(got, ensemble.ensemble_summary(copy))


# ---------------------------------------------------------------- the card
def _cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("all_defined", [False, True])
def test_the_kernel_writes_the_member_stack_in_place_on_the_card(
        all_defined):
    """On the card at 3 members x 2 x 37x61: the stacks' layout and
    shared planes, one B1 launch a member into its slot, the counter at
    3 under a profiler session, and the summary bit for bit the copy
    route's (dense launches, the planes copied into the stacks)."""
    dev = _cuda()
    nmem = 3
    args = _args(nmem, all_defined, device="cuda", nlev=2, ny=37, nx=61)
    before = fused.derived_fields_fused.launches
    out = ensemble.ensemble_member_fields(*args, fused=True,
                                          all_defined=all_defined)
    torch.cuda.synchronize(dev)
    assert fused.derived_fields_fused.launches == before + nmem
    _check_layout(out, nmem, all_defined)
    copy = _copy_route(args, all_defined)
    assert _same(out, copy)
    ref = ensemble.ensemble_summary(copy)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        got = ensemble.ensemble_derived_summary(*args, fused=True,
                                                all_defined=all_defined)
    rec = tprof.take()
    torch.cuda.synchronize(dev)
    assert rec.counters.get(COUNTER) == nmem
    (fields,) = [s for s in rec.spans if s.name == "ensemble.member_fields"]
    assert [s.name for s in rec.spans if s.parent == fields.id] == \
        ["b1.kernel", "ensemble.member_stack"] * nmem
    for kind in ("mean", "spread"):
        for name, g, r in zip(DerivedFields._fields, getattr(got, kind),
                              getattr(ref, kind)):
            assert _same(g, r), (kind, name)
    assert _same(got.prob_wind, ref.prob_wind)
    assert _same(got.prob_t_freeze, ref.prob_t_freeze)
    assert bool(got.mean.tfp.mask.any())


@pytest.mark.cuda
def test_the_wrapper_refuses_a_slot_on_another_device():
    dev = _cuda()
    args = _member(_args(1, False, device="cuda"), 0)
    shape = tuple(args[0].values.shape)
    with pytest.raises(ValueError, match="out_values is on cpu"):
        fused.derived_fields_fused(
            *args, out_values=torch.empty((12,) + shape),
            out_masks=torch.empty((9,) + shape, dtype=torch.bool,
                                  device=dev))
