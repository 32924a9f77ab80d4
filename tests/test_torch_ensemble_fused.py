"""The ensemble reductions' kernel (``csrc/ensemble_stats.cu``) and its
wrapper ``ops.ensemble_fused.ensemble_stats_fused``.

On the CPU the wrapper runs its plain version, the composition of
``mean_value``, ``stddev_value`` and ``probability``, bit for bit.  The
kernel's source is compiled for the host through ``cuda_host.py``'s
stand-in ``cuda_runtime.h`` (each block one thread; both kernels are
block-stride loops) and held bit for bit to the plain version: it sums the
members in the same order and skips the undefined ones where the plain
version adds +0.  PyTorch's CPU ``sqrt`` is not correctly rounded (the
card's and the host's ``sqrtf`` are), so the plain version runs with a
correctly rounded one there.  The ``cuda`` tests hold the kernel on the card
to the plain version on the card."""

import re

import numpy as np
import pytest
import torch
import torch.distributed as dist

from cuda_host import CSRC, host_library, run
from mi_fieldcalc_tpu_torch.field import Field, f32
from mi_fieldcalc_tpu_torch.ops import ensemble_fused, probability
from mi_fieldcalc_tpu_torch.ops import mean_value, stddev_value
from mi_fieldcalc_tpu_torch.ops.ensemble_fused import (
    EnsembleStats, ensemble_stats_fused, ensemble_stats_plain)
from mi_fieldcalc_tpu_torch.ops.stencil import ShardCtx, shard_context

#: (nmem, member shape): one member; MEPS's 10 on a ragged odd-sized grid
#: (3 x 7 x 11 = 231 points); 10 on an even one; either side of each of the
#: kernel's register caps (10, 11; 31, 33) and GEFS / ECMWF ENS sizes
#: (31, 51)
CASES = [(1, (3, 7, 11)), (10, (3, 7, 11)), (10, (2, 4, 8)), (3, (5, 13)),
         (11, (2, 5, 9)), (31, (2, 5, 9)), (33, (2, 5, 9)), (51, (3, 7, 11))]
#: (limit, compute): no probability, above 15 (wind), below 0 (advection)
MODES = [(None, None), (15.0, 1), (0.0, 2)]


def _stack(nmem: int, shape: tuple, seed: int, device="cpu") -> Field:
    """Members around 10 +- 12 (both limits cut them) with ~1/7 of the
    points undefined (sentinel values there), one point undefined in
    every member, and, with more than one member, member 0 undefined
    everywhere: it drops out of the probability's divisor."""
    rng = np.random.default_rng(seed)
    v = (10.0 + 12.0 * rng.standard_normal((nmem,) + shape)).astype(
        np.float32)
    m = rng.random((nmem,) + shape) > 1 / 7
    m.reshape(nmem, -1)[:, 0] = False
    if nmem > 1:
        m[0] = False
    v[~m] = np.float32(1e35)
    return Field(torch.from_numpy(v).to(device), torch.from_numpy(m).to(device))


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal where both are numbers, NaN where both are NaN."""
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


def _same_stats(got, ref) -> None:
    for kind in ("mean", "spread", "prob"):
        g, r = getattr(got, kind), getattr(ref, kind)
        if r is None:
            assert g is None
            continue
        assert g.values.shape == r.values.shape, kind
        assert torch.equal(g.mask, r.mask), kind
        assert _same(g.values, r.values), kind


@pytest.mark.parametrize("limit,compute", MODES)
@pytest.mark.parametrize("nmem,shape", CASES)
def test_the_cpu_route_is_the_plain_composition(nmem, shape, limit, compute):
    f = _stack(nmem, shape, 7 + nmem)
    got = ensemble_stats_fused(f, limit, compute)
    assert torch.equal(got.mean.values, mean_value(f).values)
    assert torch.equal(got.mean.mask, mean_value(f).mask)
    assert torch.equal(got.spread.values, stddev_value(f).values)
    assert torch.equal(got.spread.mask, stddev_value(f).mask)
    if compute is None:
        assert got.prob is None
    else:
        ref = probability(compute, f, (limit,))
        assert torch.equal(got.prob.values, ref.values)
        assert torch.equal(got.prob.mask, ref.mask)
    assert not got.mean.mask.reshape(-1)[0]     # no member defined there


def test_a_member_undefined_everywhere_leaves_the_divisor():
    f = _stack(10, (3, 7, 11), 3)
    got = ensemble_stats_fused(f, 15.0, 1).prob
    count = (f.mask & (f.values > 15.0)).sum(dim=0).to(torch.float32)
    assert torch.equal(got.values, count * f32(100.0) / f32(9.0))
    assert bool(got.mask.all())


def test_the_modes_are_checked():
    f = _stack(3, (5, 13), 1)
    for limit, compute in ((15.0, None), (None, 1), (15.0, 3), (0.0, 4)):
        with pytest.raises(ValueError, match="limit and compute"):
            ensemble_stats_fused(f, limit, compute)


def test_launches_count_only_on_the_card():
    before = ensemble_stats_fused.launches, ensemble_stats_fused.prob_launches
    ensemble_stats_fused(_stack(3, (5, 13), 1), 15.0, 1)
    assert (ensemble_stats_fused.launches,
            ensemble_stats_fused.prob_launches) == before


@pytest.fixture
def one_rank_group():
    """A gloo process group of one rank, with no default group."""
    return dist.ProcessGroupGloo(dist.HashStore(), 0, 1)


@pytest.mark.parametrize("compute", [1, 2])
def test_one_rank_shard_context_gives_the_same_result(one_rank_group,
                                                      compute):
    f = _stack(10, (3, 7, 11), 5)
    ref = ensemble_stats_fused(f, 0.0, compute)
    with shard_context(ShardCtx(0, 0, 7, 11, one_rank_group)):
        got = ensemble_stats_fused(f, 0.0, compute)
    _same_stats(got, ref)


def test_every_launch_returns_cudaGetLastError():
    """Each ``<<<>>>`` launch of the source is followed by returning
    ``cudaGetLastError()``, which the wrapper raises on when not 0."""
    src = (CSRC / "ensemble_stats.cu").read_text()
    launches = re.findall(r"<<<[^;]*;\s*\n\s*([^\n]*)", src)
    assert len(launches) == 2
    assert all(nxt == "return static_cast<int>(cudaGetLastError());"
               for nxt in launches)


# ------------------------------------------------ the source, on the host
@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return host_library(tmp_path_factory, "ensemble_stats.cu", 2)


@pytest.fixture
def exact_sqrt(monkeypatch):
    """A correctly rounded float32 sqrt (through float64), as the card's."""
    sqrt = torch.sqrt
    monkeypatch.setattr(torch, "sqrt", lambda x: sqrt(x.double()).float())


def _host_stats(lib, f: Field, limit, compute):
    """The kernels' C entries on host memory, on the arguments the wrapper
    launches with (``ensemble_fused._launch_args``: one member-flag buffer,
    the epilogue after the stats), its outputs and flags first filled with
    sentinels."""
    _, stats, prob = ensemble_fused._launch_args(f, limit, compute)
    mean, spread, some, _, seen = stats[2:7]
    for t, v in ((mean, -7.0), (spread, -7.0), (some, False)):
        t.fill_(v)
    if prob is None:
        assert run(lib, "mf_ensemble_stats", stats) == 0
        return mean, spread, some, None, None
    prob[0].fill_(-7.0)
    prob[1].fill_(False)
    seen.fill_(5)
    assert run(lib, "mf_ensemble_stats", stats) == 0
    assert run(lib, "mf_ensemble_prob", prob) == 0
    return mean, spread, some, prob[0], prob[1]


def _in_member_order(f: Field):
    """The plain version's arithmetic with its member sums taken strictly
    in member order (PyTorch's CPU ``sum(dim=0)`` takes a few points of a
    plane's ragged tail in another order): where(mask, v, 0) added member
    after member, over the count or 1; the squared deviations the same."""
    zero = torch.zeros((), dtype=torch.float32)
    n = f.mask.sum(dim=0)
    nf = torch.where(n > 0, n, 1).to(torch.float32)
    total = torch.zeros(f.values.shape[1:])
    for v, m in zip(f.values, f.mask):
        total = total + torch.where(m, v, zero)
    mean = total / nf
    sq = torch.zeros(f.values.shape[1:])
    for v, m in zip(f.values, f.mask):
        d = v - mean
        sq = sq + torch.where(m, d * d, zero)
    return mean, torch.sqrt(sq / nf)


def _assert_close(got, ref, field: Field) -> None:
    """Masks and probabilities exact.  Means and spreads differ only by
    the order of the plain version's sums (PyTorch's reduction kernel
    against the kernel's member order): 4 float32 ulps of the point's
    largest member magnitude, and for the spread also of the mean, whose
    rounding ``x - mean`` carries (as ``test_torch_models._assert_summary``
    allows)."""
    big = torch.where(field.mask, field.values.abs(),
                      torch.zeros((), device=field.values.device)).amax(0)
    ulp = torch.finfo(torch.float32).eps
    for kind, scale in (("mean", big),
                        ("spread", big + ref.mean.values.abs())):
        g, r = getattr(got, kind), getattr(ref, kind)
        assert torch.equal(g.mask, r.mask), kind
        tol = 4 * ulp * scale
        ok = (g.values == r.values) | ((g.values - r.values).abs() <= tol)
        assert bool((ok | (g.values.isnan() & r.values.isnan())).all()), kind
    if ref.prob is not None:
        assert torch.equal(got.prob.values, ref.prob.values)
        assert torch.equal(got.prob.mask, ref.prob.mask)


@pytest.mark.parametrize("limit,compute", MODES)
@pytest.mark.parametrize("nmem,shape", CASES)
def test_the_kernel_source_equals_the_plain_version(host_lib, exact_sqrt,
                                                    nmem, shape, limit,
                                                    compute):
    """Masks and probabilities bit for bit; means and spreads bit for bit
    the plain arithmetic in member order, and within its summation-order
    tolerance of the plain version itself."""
    f = _stack(nmem, shape, 100 + nmem)
    if nmem > 1:        # a NaN member where defined: NaN out, as plain
        f.values.reshape(nmem, -1)[1, 3] = float("nan")
        f.mask.reshape(nmem, -1)[1, 3] = True
    ref = ensemble_stats_plain(f, limit, compute)
    mean, spread, some, prob, prob_some = _host_stats(host_lib, f, limit,
                                                      compute)
    order_mean, order_spread = _in_member_order(f)
    assert _same(mean, order_mean)
    assert _same(spread, order_spread)
    got = EnsembleStats(
        Field(mean, some), Field(spread, some),
        None if prob is None else Field(prob, prob_some.expand(prob.shape)))
    _assert_close(got, ref, f)


def test_the_kernel_source_with_no_member_defined(host_lib):
    """Nothing defined anywhere: means and spreads 0 and undefined, the
    probability 0 over a divisor of 1 and undefined, as the plain
    version gives."""
    f = _stack(10, (2, 3, 5), 9)
    f = Field(f.values, torch.zeros_like(f.mask))
    ref = ensemble_stats_plain(f, 0.0, 2)
    mean, spread, some, prob, prob_some = _host_stats(host_lib, f, 0.0, 2)
    assert not some.any() and not prob_some
    for got, r in ((mean, ref.mean), (spread, ref.spread), (prob, ref.prob)):
        assert torch.equal(got, r.values) and not r.mask.any()


def test_the_entries_refuse_what_the_kernel_does_not_take(host_lib):
    x = torch.zeros(4)
    for nmem, npts, compute, count in ((0, 4, 0, None), (1, -1, 0, None),
                                       (1, 4, 3, x), (1, 4, 1, None),
                                       (1025, 4, 1, x)):
        assert run(host_lib, "mf_ensemble_stats", (x,) * 5 + (
            count, count, nmem, npts, compute, 0.0)) != 0
    assert run(host_lib, "mf_ensemble_prob", (x, x, x, 0, 4)) != 0


# ------------------------------------------------------------- on the card
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", 0)


#: on the card at an odd point count (3 x 49 x 73 = 10731): one member and
#: MEPS's 10 (the cap of 10), GEFS's 31 (the cap of 32) and ECMWF ENS's 51
#: (above every register cap)
CARD_CASES = [(1, (3, 49, 73)), (10, (3, 49, 73)), (31, (3, 49, 73)),
              (51, (3, 49, 73))]


@pytest.mark.cuda
@pytest.mark.parametrize("limit,compute", MODES)
@pytest.mark.parametrize("nmem,shape", CARD_CASES)
def test_the_kernel_on_the_card_against_the_plain_version(nmem, shape, limit,
                                                          compute):
    dev = _cuda()
    f = _stack(nmem, shape, 200 + nmem, dev)
    before = ensemble_stats_fused.launches, ensemble_stats_fused.prob_launches
    got = ensemble_stats_fused(f, limit, compute)
    torch.cuda.synchronize(dev)
    assert (ensemble_stats_fused.launches,
            ensemble_stats_fused.prob_launches) == (
        before[0] + 1, before[1] + (compute is not None))
    _assert_close(got, ensemble_stats_plain(f, limit, compute), f)


@pytest.mark.cuda
def test_a_member_plane_off_every_alignment_on_the_card():
    """A stack cut from a larger buffer at an odd float offset: no member
    plane starts on a 16-byte boundary."""
    dev = _cuda()
    f = _stack(10, (1, 37, 41), 8, dev)
    n = f.values.numel()
    vals = torch.empty(n + 1, device=dev)[1:].view(f.values.shape)
    mask = torch.empty(n + 3, dtype=torch.bool, device=dev)[3:].view(
        f.mask.shape)
    vals.copy_(f.values)
    mask.copy_(f.mask)
    g = Field(vals, mask)
    _assert_close(ensemble_stats_fused(g, 15.0, 1),
                          ensemble_stats_plain(f, 15.0, 1), f)


@pytest.mark.cuda
def test_one_rank_shard_context_on_the_card(one_rank_group):
    dev = _cuda()
    f = _stack(10, (3, 49, 73), 6, dev)
    ref = ensemble_stats_fused(f, 0.0, 2)
    with shard_context(ShardCtx(0, 0, 49, 73, one_rank_group)):
        got = ensemble_stats_fused(f, 0.0, 2)
    _same_stats(got, ref)


@pytest.mark.cuda
def test_a_summary_launches_the_kernel_twelve_times():
    from mi_fieldcalc_tpu_torch.models import ensemble
    import test_torch_profiling as tp
    dev = _cuda()
    args = tp._inputs(3, device="cuda")
    assert args[0].values.device.type == dev.type
    before = ensemble_stats_fused.launches, ensemble_stats_fused.prob_launches
    ensemble.ensemble_derived_summary(*args, fused=True)
    ensemble.ensemble_derived_summary(*args, fused=False)
    torch.cuda.synchronize(dev)
    # 12 stats launches a summary, 2 of them (wspeed, tadv) with an epilogue
    assert (ensemble_stats_fused.launches,
            ensemble_stats_fused.prob_launches) == (before[0] + 24,
                                                    before[1] + 4)


@pytest.mark.cuda
def test_a_refused_launch_raises(monkeypatch):
    """The C entry's refusal (here of no members) reaches the wrapper as
    an error, never as outputs left unwritten."""
    from mi_fieldcalc_tpu_torch import _build
    dev = _cuda()
    lib = _build.load_library()
    x = torch.zeros(4, device=dev)
    assert run(lib, "mf_ensemble_stats",
               (x,) * 5 + (None, None, 0, 4, 0, 0.0)) != 0

    class Refusing:
        mf_error_string = lib.mf_error_string

        @staticmethod
        def mf_ensemble_stats(*args):
            return 1                    # cudaErrorInvalidValue

    monkeypatch.setattr(_build, "load_library", lambda: Refusing)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        ensemble_stats_fused(_stack(3, (5, 13), 1, dev))

