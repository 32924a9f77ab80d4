"""The pipeline kernel's source, compiled for the host CPU, against its plain
version, bit for bit.

``csrc/derived_fields.cu`` (B1 ``mf_derived_fields``, with
``csrc/common.cuh``) is compiled by g++ through the stand-in
``cuda_runtime.h`` of ``cuda_host.py``, which runs each block of the grid
(a 64x4 tile of a level) as one thread: the kernel's phases are
block-stride loops (|grad T| and its gate on the tile's window of clamped
points into shared memory, then the tile's points), so one thread covers
its block's tile point after point.  With ``-ffp-contract=off`` every
float operation rounds on its own, as the card's ``-fmad=false`` build
does, so the outputs can be held to ``derived_fields_plain``: masks equal
and values equal bit for bit at every point, NaN where NaN.  PyTorch's CPU
``sqrt`` is not correctly rounded (the card's is, and so is the host
``sqrtf``), so the plain version runs with a correctly rounded one.  The
card checks the same equality (``chip_smoke.py`` phases 3-5, 7 and 10)."""

import numpy as np
import pytest
import torch

import chip_smoke
from cuda_host import host_library, run
from mi_fieldcalc_tpu_torch.field import from_sentinel
from mi_fieldcalc_tpu_torch.models.pipeline import DerivedFieldsStacked
from mi_fieldcalc_tpu_torch.ops import fused

torch.set_num_threads(1)

#: the 3x3 minimum; ragged planes: 5x929 (15 tiles a row, the last 33
#: columns wide; a second tile row of one grid row, whose clamped point
#: lies in the tile above) and 37x61 (tiles narrower than 64 and a last
#: tile row of one grid row); a plane under one tile; and 33x135
SHAPES = [(1, 3, 3), (3, 37, 61), (2, 5, 929), (2, 33, 135), (1, 4, 5)]


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return host_library(tmp_path_factory, "derived_fields.cu", 4)


@pytest.fixture
def exact_sqrt(monkeypatch):
    """A correctly rounded float32 sqrt (through float64), as the card's."""
    sqrt = torch.sqrt
    monkeypatch.setattr(torch, "sqrt", lambda x: sqrt(x.double()).float())


def _inputs(nlev, ny, nx, seed, undefs):
    """``chip_smoke.make_inputs``'s scattered pattern (undefined points at
    ~1/37 of each stack, two corners, a 500 K point, an undefined ps
    point), and with ``undefs`` more at the edges: every corner of every
    level in u, v and q, the first and last row of tk on level 0, the
    first and last column of v, a point next to three corners (a clamped
    neighbour of the edge points) in tk, and ps at a corner and an edge."""
    raw = list(chip_smoke.make_inputs(nlev, ny, nx, seed, undefs))
    if undefs:
        tk, q, u, v, ps = raw[:5]
        for a in (u, v, q):
            a[:, [0, 0, -1, -1], [0, -1, 0, -1]] = 1e35
        tk[0, [0, -1], :] = 1e35
        v[:, :, [0, -1]] = 1e35
        tk[:, [1, -2, -2], [-2, 1, -2]] = 1e35
        ps[0, -1] = 1e35
        ps[-1, nx // 2] = 1e35
    return raw


def _args(raw, all_defined):
    fields = tuple(from_sentinel(a) for a in raw[:5])
    if all_defined:
        fields = tuple(type(f)(f.values, torch.ones_like(f.mask))
                       for f in fields)
    return fields + tuple(torch.from_numpy(a) for a in raw[5:])


#: where a launch writes: dense new planes, or member 1's slot of
#: 3-member stacks ``[planes, 3, nlev, ny, nx]`` (``out_plane_stride`` 3
#: planes)
INTO = ["dense", "member 1 of 3"]
#: what the stacks hold before the launch, outside the member's slot
SENTINEL_VALUE, SENTINEL_MASK = -7.25, 3


class _MemberStack:
    """3-member value and mask stacks filled with sentinels, and the slot
    ``[:, 1]`` a launch writes; the mask stack is bytes, so that the
    sentinel 3 is neither of the 0 / 1 the kernel writes (the launch takes
    it as bool, which it only writes)."""

    def __init__(self, nplanes: int, shape: tuple):
        self.values = torch.full((12, 3) + shape, SENTINEL_VALUE)
        self.masks = torch.full((nplanes, 3) + shape, SENTINEL_MASK,
                                dtype=torch.uint8)

    def slot(self) -> tuple:
        """``(values, masks)`` of member 1."""
        return self.values[:, 1], self.masks.view(torch.bool)[:, 1]

    def written(self) -> DerivedFieldsStacked:
        """Member 1's planes, after checking that members 0 and 2 still
        hold the sentinels."""
        for m in (0, 2):
            assert bool((self.values[:, m] == SENTINEL_VALUE).all()), m
            assert bool((self.masks[:, m] == SENTINEL_MASK).all()), m
        assert bool((self.masks[:, 1] <= 1).all())
        return DerivedFieldsStacked(self.values[:, 1].contiguous(),
                                    self.masks[:, 1].bool())


def _call(lib, f, al, bl, xm, ym, offsets, global_shape, all_defined,
          values=None, masks=None, stride=None) -> tuple:
    """``mf_derived_fields`` on the arguments the wrapper launches with
    (``fused._launch_args``), into ``values`` / ``masks`` where given, and
    with ``stride`` in place of their plane stride where given:
    ``(error code, outputs)``."""
    out, args = fused._launch_args(*f, al, bl, xm, ym, all_defined,
                                   (*offsets, *global_shape), values, masks)
    if stride is not None:
        args = args[:-1] + (stride,)
    return run(lib, "mf_derived_fields", args), out


def _launch_into(lib, f, al, bl, xm, ym, offsets, global_shape,
                 all_defined, into="dense") -> DerivedFieldsStacked:
    """One host launch of B1, into new dense planes or into member 1 of 3
    (``into``)."""
    stack = None
    if into != "dense":
        stack = _MemberStack(2 if all_defined else 9,
                             tuple(f[0].values.shape))
    err, out = _call(lib, f, al, bl, xm, ym, offsets, global_shape,
                     all_defined, *(stack.slot() if stack else ()))
    assert err == 0
    return stack.written() if stack else out


def _host_fused(lib, args, all_defined, into="dense") -> DerivedFieldsStacked:
    """One host launch of B1 on the whole grid."""
    ny, nx = args[0].values.shape[1:]
    return _launch_into(lib, args[:5], *args[5:9], (0, 0), (ny, nx),
                        all_defined, into)


def _assert_same(got, ref, label):
    """Masks equal; values equal bit for bit at every point, NaN where
    NaN."""
    assert torch.equal(got.masks, ref.masks), (
        label, int((got.masks != ref.masks).sum()))
    g, r = got.values, ref.values
    same = (g.view(torch.int32) == r.view(torch.int32)) | (
        torch.isnan(g) & torch.isnan(r))
    bad = [int((~same[k]).sum()) for k in range(12)]
    assert not any(bad), (label, bad)


@pytest.mark.parametrize("into", INTO)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("all_defined", [False, True])
def test_host_fused_matches_plain(host_lib, exact_sqrt, shape, all_defined,
                                  into):
    """Dense, or into member 1 of 3-member stacks (``out_plane_stride`` 3
    planes), where the planes equal the dense launch's bit for bit and
    members 0 and 2 keep their sentinels."""
    raw = _inputs(*shape, seed=sum(shape), undefs=not all_defined)
    args = _args(raw, all_defined)
    got = _host_fused(host_lib, args, all_defined, into)
    ref = fused.derived_fields_plain(*args, all_defined=all_defined)
    _assert_same(got, ref, (shape, all_defined, into))
    if into != "dense":
        _assert_same(got, _host_fused(host_lib, args, all_defined),
                     (shape, all_defined, "dense"))


def test_host_fused_writes_only_its_planes(host_lib, exact_sqrt):
    """Output planes that are views into larger buffers at odd offsets:
    the values land where the plain version puts them, and nothing before
    or after the 12 value and 9 mask planes is written."""
    shape = (3, 7, 41)
    raw = _inputs(*shape, seed=7, undefs=True)
    args = _args(raw, False)
    ref = fused.derived_fields_plain(*args)
    n = int(np.prod(shape))
    vbuf = torch.full((12 * n + 8,), 7.0)
    mbuf = torch.full((9 * n + 8,), 3, dtype=torch.uint8)
    err, got = _call(host_lib, args[:5], *args[5:9], (0, 0), shape[1:],
                     False, vbuf[3:3 + 12 * n].view(12, *shape),
                     mbuf[5:5 + 9 * n].view(torch.bool).view(9, *shape))
    assert err == 0
    _assert_same(got, ref, "views")
    assert bool((vbuf[:3] == 7.0).all()) and bool((vbuf[-5:] == 7.0).all())
    assert bool((mbuf[:5] == 3).all()) and bool((mbuf[-3:] == 3).all())


def test_host_fused_planted_points_reach_every_branch(host_lib, exact_sqrt):
    """The planted points do what the test above relies on: masked-out
    edges and corners, an undefined ps, a 500 K point off the table, and
    on the all-defined route a zero |grad T| gate."""
    shape = (2, 37, 61)
    raw = _inputs(*shape, seed=3, undefs=True)
    out = _host_fused(host_lib, _args(raw, False), False)
    m = out.masks
    assert not bool(m[4, 0, 0, 0])              # wind speed: u, v corner
    assert not bool(m[1, :, 0, -1].any())       # theta: ps undefined
    assert not bool(m[2, 0, 1, 1])              # 500 K is off the table
    assert not bool(m[7, 0, 0, :].any())        # |grad T| on an undef row
    assert bool(m[8].any()) and not bool(m[8].all())
    flat = list(raw)
    flat[0] = np.full(shape, 280.0, np.float32)  # a flat T: |grad T| == 0
    out = _host_fused(host_lib, _args(flat, True), True)
    assert not bool(out.masks[1].any())
    assert bool(out.masks[0].all())


#: process grids (gy, gx) cut from SHARD_SHAPE: 37 rows over 4 are 10, 9,
#: 9, 9 and 61 columns over 4 are 16, 15, 15, 15
SHARD_GRIDS = [(2, 2), (4, 1), (1, 4), (3, 2)]
SHARD_SHAPE = (2, 37, 61)


def _host_launcher(lib, all_defined, nyg, nxg, into="dense"):
    """``chip_smoke.run_plan``'s launch through the host library, with a
    launch's offsets in the global ``(nyg, nxg)`` grid."""
    def launch(f, al, bl, xm, ym, offsets, halo_rows):
        return _launch_into(lib, f, al, bl, xm, ym, offsets, (nyg, nxg),
                            all_defined, into)

    return launch


@pytest.mark.parametrize("into", INTO)
@pytest.mark.parametrize("grid", SHARD_GRIDS)
@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("all_defined", [False, True])
def test_host_fused_shards_match_unsharded(host_lib, exact_sqrt, grid,
                                           overlap, all_defined, into):
    """B1 on every shard of a (gy, gx) cut, with the shard's offsets: on
    its block and a radius-2 halo ring (zeros, mask False, beyond the
    physical edges), or, with overlap, on its block alone and on the seam
    strips patched in; cropped and stitched, equal to the unsharded launch
    bit for bit at every point.  Each launch also equals the plain version
    under the same offsets on the part of its output that is kept (beyond
    the physical edges ps is 0 there, and the kernel's pow takes only
    positive pressures, as in the unsharded kernel's masked lanes).  With
    ``into`` member 1 of 3, every shard's launch writes into its slot of
    3-member stacks and leaves the other members' sentinels."""
    ny, nx = SHARD_SHAPE[1:]
    raw = _inputs(*SHARD_SHAPE, seed=5, undefs=not all_defined)
    args = _args(raw, all_defined)[:9]
    launch = _host_launcher(host_lib, all_defined, ny, nx, into)
    whole = _host_fused(host_lib, _args(raw, all_defined), all_defined)
    plan = chip_smoke.shard_plan(ny, nx, *grid, overlap)
    got = chip_smoke.run_plan(launch, args, plan, all_defined)
    _assert_same(got, whole, (grid, overlap, all_defined))
    for p in plan:
        a = chip_smoke.piece_args(args, p["win"])
        offsets = (p["win"][0], p["win"][2])
        ref = fused.derived_fields_plain(
            *a, None, all_defined, global_shape=(ny, nx),
            grid_offsets=offsets, halo_rows=p["halo_rows"])
        out = launch(a[:5], *a[5:], offsets, p["halo_rows"])
        _assert_same(chip_smoke.kept(out, p["take"]),
                     chip_smoke.kept(ref, p["take"]),
                     (grid, overlap, all_defined, into, p["shard"],
                      p["kind"]))


def test_host_fused_refuses_a_block_off_the_grid(host_lib):
    """A block that holds no point of the global clamp window is refused
    by the C entry, and the wrapper's plain route names it."""
    raw = _inputs(1, 5, 6, seed=1, undefs=False)
    args = _args(raw, False)
    launch = _host_launcher(host_lib, False, 5, 6)
    with pytest.raises(AssertionError):
        launch(args[:5], *args[5:9], (10, 0), 0)
    with pytest.raises(ValueError, match="holds no interior point"):
        fused.derived_fields_plain(*args, global_shape=(5, 6),
                                   grid_offsets=(10, 0))
    with pytest.raises(ValueError, match="halo_rows"):
        fused.derived_fields_plain(*args, global_shape=(5, 6),
                                   grid_offsets=(0, 0), halo_rows=-1)
    with pytest.raises(TypeError, match="Python ints"):
        fused.derived_fields_plain(*args, global_shape=(5, 6),
                                   grid_offsets=(torch.tensor(0), 0))
    with pytest.raises(NotImplementedError, match="padded layout"):
        fused.derived_fields_plain(*args, global_shape=(8, 8))


@pytest.mark.parametrize("all_defined", [False, True])
@pytest.mark.parametrize("short", [1, "plane", "all", "negative"])
def test_host_fused_refuses_a_plane_stride_below_the_planes(
        host_lib, all_defined, short):
    """An ``out_plane_stride`` below ``nlev * ny * nx`` (one element short,
    one level plane, 1, or negative) is refused by the C entry, and
    nothing is written; ``nlev * ny * nx`` itself is the dense launch."""
    shape = (2, 5, 6)
    n3 = int(np.prod(shape))
    stride = {1: n3 - 1, "plane": n3 // shape[0], "all": 1,
              "negative": -n3}[short]
    args = _args(_inputs(*shape, seed=2, undefs=False), all_defined)
    stack = _MemberStack(2 if all_defined else 9, shape)
    err, _ = _call(host_lib, args[:5], *args[5:9], (0, 0), shape[1:],
                   all_defined, *stack.slot(), stride)
    assert err != 0
    assert bool((stack.values == SENTINEL_VALUE).all())
    assert bool((stack.masks == SENTINEL_MASK).all())
    dense = _host_fused(host_lib, args, all_defined)
    err, out = _call(host_lib, args[:5], *args[5:9], (0, 0), shape[1:],
                     all_defined, *map(torch.empty_like, dense), n3)
    assert err == 0
    _assert_same(out, dense, short)
