"""The MEPS-30 cell's path on four gloo ranks: ``parallel.fused.
ensemble_summary_sharded`` at 30 members, 3 levels and a ragged 21x19 grid
cut (1, 2, 2), held to the benchmark's plain reference of the whole grid;
the block reference that the cell's check runs on each card, assembled,
equal to that whole-grid reference; and the spans and the counter of the
sharded path.

The inputs are the cell's own (``benchmark/inputs_sharded.py`` at the
configuration's ``cpu_test`` size): one temperature column undefined 2
rows above the row seam and 1 column right of the column seam, so its
masks ride both legs of the exchange.  Four ranks run the cases of
``torch_parallel_cases.CASES["meps"]`` once per module
(``tests/torch_parallel_worker.py``); B1 and the reductions are their
plain versions here.
"""

import pytest
import torch

import torch_parallel_cases as C
from benchmark.compare import Gap
from benchmark.reference import ensemble as ref_ensemble
from benchmark.reference.pipeline import FIELDS
from mi_fieldcalc_tpu_torch.parallel.mesh import factor_devices_for_grid

#: the widest normwise gap (:class:`benchmark.compare.Gap`) allowed between
#: the sharded port and the whole-grid reference, and between the assembled
#: block references and the whole-grid one.  The derived fields are the
#: same float32 operations on both sides (B1's plain version is the
#: reference's arithmetic), but PyTorch's CPU sum over the member axis
#: orders its adds by the stack's shape, so a block's mean can differ from
#: the whole grid's by an ulp or two: both gaps read 2.73e-7 (mean.th).
#: 1e-5 leaves that room; a seam filled as an edge, a lost mask or a member
#: flag off by one reads 1e-2 or more
TOLERANCE = 1e-5


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return C.run_ranks("meps", tmp_path_factory.mktemp("meps_ranks"))


@pytest.fixture(scope="module")
def whole():
    """The whole-grid reference of the cell's inputs."""
    config, traffic = C.meps_config()
    case = C.meps_case(((0, config["ny"]), (0, config["nx"])))
    lead = {n: (v[0], m[0]) for n, (v, m) in case.fields.items()}
    return ref_ensemble.summary(lead, case.alevel, case.blevel, case.xmapr,
                                case.ymapr, float(traffic["wind_limit"]),
                                C.MEPS_LEVEL_BLOCK)


def _pairs(got, ref):
    """``(name, got, ref)`` for every mean, spread and probability."""
    for kind in ("mean", "spread"):
        for i, n in enumerate(FIELDS):
            yield f"{kind}.{n}", getattr(got, kind)[i], getattr(ref, kind)[i]
    for kind in ("prob_wind", "prob_t_freeze"):
        yield kind, getattr(got, kind), getattr(ref, kind)


def test_the_port_cuts_the_cell_into_2x2_blocks():
    """The cut the cell runs, at its size and at the CPU's."""
    assert factor_devices_for_grid(1069, 949, 4) == (1, 2, 2)
    assert factor_devices_for_grid(21, 19, 4) == (1, 2, 2)


def test_sharded_summary_matches_the_whole_grid_reference(ranks, whole):
    """Every mean, spread and probability of the gathered sharded summary:
    masks equal to the reference's, values within :data:`TOLERANCE`."""
    got = ranks["summary"]
    th = FIELDS.index("th")
    assert not bool(whole.mean[th].mask.all()), "no undefined column"
    gap = Gap()
    for name, g, r in _pairs(got, whole):
        assert torch.equal(g.mask.expand(r.values.shape),
                           r.mask.expand(r.values.shape)), name
        gap.add(name, g.values, g.mask, r.values, r.mask)
    assert gap.value() <= TOLERANCE, gap.per_field()


def test_block_reference_assembles_to_the_whole_grid(ranks, whole):
    """The four blocks' answers of ``reference/ensemble_block.py`` (each on
    its block widened by the ring, the member flags reduced over the
    ranks), put in place, are the whole-grid reference: masks and
    probabilities (counts of members) exactly, means and spreads within
    :data:`TOLERANCE`, since PyTorch's CPU sum over the member axis orders
    its adds by the stack's shape (an ulp at a few points)."""
    blocks = ranks["blocks"]
    assert len(blocks) == 4
    cover = torch.zeros(whole.mean[0].values.shape[-2:], dtype=torch.int32)
    gap = Gap()
    for ((r0, r1), (c0, c1)), ref in blocks:
        cover[r0:r1, c0:c1] += 1
        for name, b, w in _pairs(ref, whole):
            wv = w.values[..., r0:r1, c0:c1]
            wm = w.mask.expand(w.values.shape)[..., r0:r1, c0:c1]
            assert torch.equal(b.mask.expand(b.values.shape), wm), name
            if name.startswith("prob"):
                assert torch.equal(b.values, wv), name
            gap.add(name, b.values, b.mask, wv, wm)
    assert bool((cover == 1).all())
    assert gap.value() <= TOLERANCE, gap.per_field()


def test_sharded_summary_records_its_spans(ranks):
    """Under a profiler session one sharded summary records on every rank
    ``ensemble.summary`` around ``halo.exchange`` (its two legs'
    ``halo.wire``), ``ensemble.member_fields`` holding 30
    ``ensemble.member_stack`` spans, and ``ensemble.flags_reduce`` once a
    probability; ``halo.bytes`` is the strips' bytes reckoned from the
    shapes; a summary without a session records nothing."""
    config, _ = C.meps_config()
    nmem, nlev = config["members"], config["levels"]
    radius = 2
    for info in ranks["spans"]:
        spans = info["spans"]

        def named(name, parent=None):
            return [s for s in spans if s[0] == name
                    and (parent is None or s[1] == parent)]

        assert len(named("ensemble.summary", None)) == 1
        assert len(named("halo.exchange", "ensemble.summary")) == 1
        assert len(named("halo.wire", "halo.exchange")) == 2
        assert len(named("ensemble.member_fields", "ensemble.summary")) == 1
        assert len(named("ensemble.member_stack",
                         "ensemble.member_fields")) == nmem
        assert len(named("ensemble.member_stack")) == nmem
        assert len(named("ensemble.flags_reduce")) == 2
        (r0, r1), (c0, c1) = info["block"]
        # one neighbour on each leg: RADIUS rows of the block, then RADIUS
        # columns of the row-padded block, of tk, q, u, v (values and
        # masks), ps (values and mask) and the two map factors
        per_point = 4 * nmem * nlev * (4 + 1) + nmem * (4 + 1) + 2 * 4
        rows = radius * (c1 - c0) * per_point
        cols = radius * (r1 - r0 + 2 * radius) * per_point
        assert info["counters"]["halo.bytes"] == rows + cols
        assert info["after"] == (0, {})
