"""The port's domain decomposition (``mi_fieldcalc_tpu_torch.parallel``)
against the unsharded port, case by case as ``tests/test_parallel.py``
holds the JAX package's.

Four gloo ranks (``tests/torch_parallel_worker.py``) run every case of
``torch_parallel_cases.CASES["ops"]`` once per module on their own blocks
of (1, 2, 2), (1, 4, 1), (1, 1, 4) and (2, 2, 1) process grids, uneven
cuts among them; each test holds its case's gathered result to the same
operator on the whole grid: masks bitwise, values bit for bit where
defined.
"""

import numpy as np
import pytest
import torch

import torch_parallel_cases as C
from mi_fieldcalc_tpu_torch.parallel import distributed
from torch_parallel_cases import assert_same
from mi_fieldcalc_tpu_torch.parallel.mesh import (
    block, factor_devices, factor_devices_for_grid, partition_spec)

CASES = C.CASES["ops"]()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return C.run_ranks("ops", tmp_path_factory.mktemp("ops_ranks"))


def _check(ranks, name):
    assert_same(CASES[name].unsharded(), ranks[name], name)


@pytest.mark.parametrize("name", [o[0] for o in C.OPS])
def test_sharded_equivalence(ranks, name):
    _check(ranks, f"op_{name}")


@pytest.mark.parametrize("mesh_shape", C.MESHES)
def test_sharded_equivalence_mesh_shapes(ranks, mesh_shape):
    """plevelqvector (radius 2) on every grid shape, on 30x46: 30 rows
    over 4 shards are 8, 8, 7, 7."""
    _check(ranks, f"qvector_{mesh_shape}")


def test_sharded_tuple_output(ranks):
    _check(ranks, "tuple_output")


def test_sharded_batched(ranks):
    """Leading level axis cut over lev, spatial over (gy, gx)."""
    _check(ranks, "batched")


def test_elementwise_sharded(ranks):
    """A pointwise operator through run_sharded with radius 0 (the JAX
    test partitions it with GSPMD)."""
    _check(ranks, "elementwise")


@pytest.mark.parametrize("mesh_shape", [(1, 2, 2), (1, 4, 1), (1, 1, 4)])
@pytest.mark.parametrize("which", ["x", "y"])
def test_sharded_momentum_coordinates(ranks, mesh_shape, which):
    """m / n use the global grid index: each shard adds its offset."""
    _check(ranks, f"momentum_{which}_{mesh_shape}")


@pytest.mark.parametrize("mesh_shape", [(1, 2, 2), (1, 4, 1)])
@pytest.mark.parametrize("holes", [False, True])
def test_sharded_shapiro(ranks, mesh_shape, holes):
    """Boundary copies at physical edges only, and the all-defined choice
    a global minimum over the shards."""
    _check(ranks, f"shapiro_{mesh_shape}_{holes}")


@pytest.mark.parametrize("name", ["exchange_gy", "exchange_gx",
                                  "exchange_gy_2d", "exchange_gx_2d"])
def test_packed_strip_exchange_matches_per_array(ranks, name):
    """The packed legs deliver what the per-array exchange does, on both
    trailing axes, for mixed 2-D / 3-D float32 and bool arrays, and both
    equal the global array's halo (zeros beyond the physical edges)."""
    ok = ranks[name]
    assert len(ok) == 4 and all(all(r) for r in ok), ok


def test_packed_sendrecv_roundtrip(ranks):
    """Pre-sliced strips reach the right neighbours, dtypes restored,
    zeros at physical edges."""
    _, (f3, f2, b3) = C._sendrecv_case()
    got = ranks["sendrecv"]
    for i, (prev3, next2, prevb) in enumerate(got):
        assert prevb.dtype == torch.bool
        if i == 0:
            assert not prev3.any() and not prevb.any()
        else:
            assert torch.equal(prev3, f3 - (i - 1))
            assert torch.equal(prevb, ~b3)
        if i == 3:
            assert not next2.any()
        else:
            assert torch.equal(next2, f2 + (i + 1))


def test_factor_devices():
    assert factor_devices(8) == (1, 2, 4)
    assert factor_devices(4) == (1, 2, 2)
    assert factor_devices(7) == (1, 1, 7)


def test_factor_devices_for_grid():
    """The split whose largest shard with its halo ring holds the fewest
    points; splits the seam strips cannot take only as a last resort;
    ties toward fewer gx shards."""
    # global 0.25-degree grid at 128 devices: a 2-D split, and the best
    lev, gy, gx = factor_devices_for_grid(721, 1440, 128)
    assert (lev, gy * gx) == (1, 128) and gx > 1

    def score(gy, gx):
        return (-(-721 // gy) + 4) * (-(-1440 // gx) + 4)

    assert score(gy, gx) == min(score(128 // g, g) for g in range(1, 129)
                                if 128 % g == 0)
    # 32x48 over 8: (1, 2, 4) streams 20x16 a shard, against 12x28 (4, 2)
    assert factor_devices_for_grid(32, 48, 8) == (1, 2, 4)
    # a tie: 8x8 over 2 is 8x4 either way; fewer gx shards win
    assert factor_devices_for_grid(8, 8, 2) == (1, 2, 1)
    # 12 rows over 4 leave 3 a shard, too few for a seam strip (4): the
    # column split wins although the row split scores the same
    assert factor_devices_for_grid(12, 64, 4) == (1, 1, 4)
    # ...and where every split is too thin, the best of them still comes
    assert factor_devices_for_grid(6, 6, 4) == (1, 2, 2)
    with pytest.raises(ValueError):
        factor_devices_for_grid(2, 2, 64)


def test_grid_mesh_grid_shape_kwarg(ranks):
    """Coordinates in rank order, neighbours, shorter shapes dropping axes
    from the front, ``grid_shape`` and the default square-ish split."""
    got = ranks["grid_mesh"]
    assert [g["coords"] for g in got] == [(0, 0, 0), (0, 0, 1), (0, 1, 0),
                                          (0, 1, 1)]
    assert [g["rank"] for g in got] == [0, 1, 2, 3]
    assert got[0]["gy"] == (None, 2) and got[0]["gx"] == (None, 1)
    assert got[3]["gy"] == (1, None) and got[3]["gx"] == (2, None)
    assert got[0]["shapes"] == [(1, 2, 2), (1, 1, 4),
                                factor_devices_for_grid(30, 46, 4),
                                (1, 2, 2)]
    assert [g["g1_gx"] for g in got] == [(None, 1), (0, 2), (1, 3),
                                         (2, None)]


def test_grid_mesh_single_process():
    """Without torch.distributed, one process is the whole grid; a shape
    for more processes, or both arguments, raise."""
    from mi_fieldcalc_tpu_torch.parallel import grid_mesh

    g = grid_mesh(device="cpu")
    assert g.shape == (1, 1, 1) and g.coords == (0, 0, 0)
    assert g.group is None and g.neighbours("gy") == (None, None)
    with pytest.raises(ValueError, match="processes"):
        grid_mesh((1, 2, 2), device="cpu")
    with pytest.raises(ValueError, match="not both"):
        grid_mesh((1, 1, 1), grid_shape=(8, 8), device="cpu")


def test_block_cut_and_partition_spec():
    """The first ny % gy blocks hold one row more; specs as the JAX
    package's PartitionSpec."""
    assert [block(30, 4, i) for i in range(4)] == [(0, 8), (8, 16),
                                                   (16, 23), (23, 30)]
    assert [block(8, 2, i) for i in range(2)] == [(0, 4), (4, 8)]
    assert partition_spec(0) == ()
    assert partition_spec(1) == ("lev",)
    assert partition_spec(2) == ("gy", "gx")
    assert partition_spec(4) == ("lev", None, "gy", "gx")


def test_local_shard_array_single_process():
    """On a one-process grid the local block is the whole array, and
    ``gather`` gives it back as it is."""
    from mi_fieldcalc_tpu_torch.parallel import grid_mesh

    g = grid_mesh(device="cpu")
    a = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    t = distributed.local_shard_array(a, g)
    assert t.device.type == "cpu" and np.array_equal(t.numpy(), a)
    assert distributed.gather(t, g) is t


def test_initialize_without_cluster_is_a_noop(monkeypatch):
    """No torchrun environment and no arguments: the single-process no-op,
    as the JAX function records it; explicit arguments must come
    together, and the card's backend never falls back to gloo."""
    import torch.distributed as dist

    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setitem(distributed._state, "initialized", False)
    monkeypatch.setitem(distributed._state, "device", None)
    distributed.initialize()
    assert distributed.is_initialized() and distributed.device() is None
    assert not dist.is_initialized()
    monkeypatch.setitem(distributed._state, "initialized", False)
    with pytest.raises(ValueError, match="together"):
        distributed.initialize("127.0.0.1:1")
    monkeypatch.setattr(dist, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="NCCL"):
        distributed.initialize("127.0.0.1:1", 1, 0, device="cuda")
    assert not dist.is_initialized()


@pytest.mark.parametrize("mesh_shape", [(1, 2, 2), (1, 4, 1), (1, 1, 4)])
@pytest.mark.parametrize("compute,consts", C.NEIGHBOUR_CONSTS)
def test_sharded_neighbour_functions(ranks, mesh_shape, compute, consts):
    """The border ring and the strided sample grid in global coordinates
    (composed halo radius = range + step - 1)."""
    _check(ranks, f"neighbour_{mesh_shape}_{compute}_{consts}")


@pytest.mark.parametrize("mesh_shape", [(1, 2, 2), (1, 4, 1)])
def test_sharded_neighbour_prob_functions(ranks, mesh_shape):
    _check(ranks, f"neighbour_prob_{mesh_shape}")


@pytest.mark.parametrize("mesh_shape", [(1, 2, 2), (1, 4, 1)])
@pytest.mark.parametrize("compute", [3, 4])
def test_sharded_cvtemp_autodetect_global_mean(ranks, mesh_shape, compute):
    """cvtemp modes 3 / 4 decide on the global defined-value mean: a
    Celsius-looking top half and a Kelvin-looking bottom half make the
    same choice on every shard (a sum over the shards)."""
    _check(ranks, f"cvtemp_{mesh_shape}_{compute}")


def test_sharded_probability_global_member_flags(ranks):
    """Member 1 is defined only in the top-left shard; every shard still
    counts it in the denominator (a maximum over the shards)."""
    _check(ranks, "probability")


def test_failing_ranks_are_reported_and_stopped(tmp_path):
    """A rank that fails ends the run with the ranks' output, and no rank
    outlives it (a hang would cost one module, not the suite)."""
    with pytest.raises(RuntimeError, match="KeyError"):
        C.run_ranks("no such group", tmp_path, world=2, timeout=60,
                    attempts=1)
