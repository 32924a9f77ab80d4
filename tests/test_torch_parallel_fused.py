"""The sharded pipeline of the port (``mi_fieldcalc_tpu_torch.parallel.
fused``) against the unsharded port, case by case as
``tests/test_parallel_fused.py`` holds the JAX package's, and the slice
as a whole against the JAX package.

Four gloo ranks (``tests/torch_parallel_worker.py``) run every case of
``torch_parallel_cases.CASES["fused"]`` once per module; B1 is its plain
version here, run on each shard under the shard's offsets.  Each gathered
result equals the whole-grid port's: masks bitwise, values bit for bit
where defined.  The uneven cuts (45 rows over 4, 41 over 2, 141 columns
over 2) stand in for the JAX padded-layout cases, which the port does not
have.
"""

import numpy as np
import pytest

import torch_parallel_cases as C
from torch_parallel_cases import assert_same

CASES = C.CASES["fused"]()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return C.run_ranks("fused", tmp_path_factory.mktemp("fused_ranks"))


def _fields(out):
    """A pipeline result as its 12 Fields (the stacked layout expanded)."""
    return out.as_fields() if hasattr(out, "as_fields") else out


def _check(ranks, name):
    assert_same(_fields(CASES[name].unsharded()), _fields(ranks[name]),
                name)


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("mesh_shape,nlev,ny,nx", C.FUSED_SHAPES)
def test_sharded_fused_matches_unsharded(ranks, mesh_shape, nlev, ny, nx,
                                         overlap):
    _check(ranks, f"fused_{mesh_shape}_{ny}x{nx}_{overlap}")


@pytest.mark.parametrize("mesh_shape,nlev,ny,nx", C.ISOBARIC_SHAPES)
@pytest.mark.parametrize("overlap", [False, True])
def test_sharded_isobaric_matches_unsharded(ranks, mesh_shape, nlev, ny,
                                            nx, overlap):
    """Per-shard column interpolation, the halo ring on the interpolated
    stacks, per-shard B1: equal to the whole-grid fused isobaric path."""
    _check(ranks, f"isobaric_{mesh_shape}_{overlap}")


def test_sharded_isobaric_rejects_lev_mesh(ranks):
    assert "lev == 1" in ranks["isobaric_rejects_lev"]


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("mesh_shape,nlev,ny,nx", C.UNEVEN_SHAPES)
def test_sharded_uneven_cut_matches(ranks, mesh_shape, nlev, ny, nx,
                                    overlap):
    """Blocks of unequal extents (the first ny % gy blocks one row more),
    where the JAX tests pad the global grid instead."""
    _check(ranks, f"uneven_{mesh_shape}_{ny}x{nx}_{overlap}")


@pytest.mark.parametrize("mesh_shape", [(1, 2, 2), (1, 4, 1)])
def test_sharded_ensemble_matches_unsharded(ranks, mesh_shape):
    """Mean, spread and probabilities equal the whole-grid ensemble's,
    the denominators' whole-field member flags included: member 2's tk is
    defined only in the top-left corner, inside one shard."""
    _check(ranks, f"ensemble_{mesh_shape}")


@pytest.mark.parametrize("overlap", [False, True])
def test_sharded_stacked_matches_per_field(ranks, overlap):
    """``stacked=True`` gives the 2-tensor layout of the same fields."""
    got = ranks[f"stacked_{overlap}"]
    assert got.values.shape == (12, 2, 32, 64)
    assert got.masks.shape == (9, 2, 32, 64)
    _check(ranks, f"stacked_{overlap}")


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("mesh_shape", [(1, 2, 2), (1, 4, 1), (1, 1, 4)])
def test_sharded_all_defined_matches(ranks, mesh_shape, overlap):
    """The all-defined route (no mask on the wire, the 2 gate planes)
    equals the masked whole-grid route on fully defined inputs, per field
    and stacked."""
    _check(ranks, f"all_defined_{mesh_shape}_{overlap}")
    st = ranks[f"all_defined_stacked_{mesh_shape}_{overlap}"]
    assert st.masks.shape[0] == 2
    _check(ranks, f"all_defined_stacked_{mesh_shape}_{overlap}")


@pytest.mark.parametrize("overlap", [False, True])
def test_sharded_isobaric_all_defined_matches(ranks, overlap):
    """B2's all-defined route per shard, its one shared mask plane on the
    wire once: equal to the whole-grid masked isobaric path."""
    _check(ranks, f"isobaric_all_defined_{overlap}")


@pytest.mark.parametrize("overlap", [False, True])
def test_sharded_uneven_all_defined_matches(ranks, overlap):
    """All-defined on an uneven cut (43 rows, 117 columns over 2 x 2)."""
    _check(ranks, f"uneven_all_defined_{overlap}")


@pytest.mark.parametrize("overlap", [False, True])
def test_sharded_pipeline_matches_jax(ranks, overlap):
    """The slice as a whole: the JAX package's sharded pipeline (its Pallas
    kernel in interpret mode on the 8-device CPU mesh) against the port's
    gathered result on the same (1, 2, 2) grid, 2x24x32: masks bitwise,
    values within rtol 2e-5 (CONFORMANCE.md:112-114)."""
    import jax
    import jax.numpy as jnp

    from mi_fieldcalc_tpu.field import from_sentinel
    from mi_fieldcalc_tpu.parallel import grid_mesh
    from mi_fieldcalc_tpu.parallel.fused import derived_fields_fused_sharded

    arrays = C.pipeline_inputs(*C.JAX_SHAPE, seed=C.JAX_SEED)
    args = ([from_sentinel(a) for a in arrays[:5]]
            + [jnp.asarray(a) for a in arrays[5:]])
    mesh = grid_mesh((1, 2, 2), devices=jax.devices()[:4])
    ref = derived_fields_fused_sharded(mesh, *args, interpret=True,
                                       overlap=overlap)
    got = ranks[f"jax_{overlap}"]
    for name in ref._fields:
        rm = np.asarray(getattr(ref, name).mask)
        gm = getattr(got, name).mask.numpy()
        assert np.array_equal(rm, gm), f"{name}: mask"
        rv = np.asarray(getattr(ref, name).values)[rm]
        gv = getattr(got, name).values.numpy()[rm]
        with np.errstate(all="ignore"):
            assert np.allclose(rv, gv, rtol=2e-5, atol=1e-30,
                               equal_nan=True), f"{name}: values"


def test_sharded_rejects_a_block_off_the_cut():
    """A block that is not this rank's cut of the global grid raises, and
    the overlap path names the rows its seam strips need."""
    from mi_fieldcalc_tpu_torch.parallel import grid_mesh
    from mi_fieldcalc_tpu_torch.parallel.fused import (
        _overlap_core, derived_fields_fused_sharded)

    g = grid_mesh(device="cpu")
    args = C._port(C.pipeline_inputs(1, 8, 9))
    with pytest.raises(ValueError, match="not this rank's cut"):
        derived_fields_fused_sharded(g, *args, global_shape=(9, 9))

    class Tall:       # a grid of 2 gy shards, seen from shard 0
        shape, coords = (1, 2, 1), (0, 0, 0)

    small = C._port(C.pipeline_inputs(1, 3, 9))
    with pytest.raises(ValueError, match=r"needs >= 4 local rows"):
        _overlap_core(Tall, small[:5], *small[5:9], False, (0, 0, 6, 9))


@pytest.mark.parametrize("overlap", [False, True])
def test_single_process_grid_matches_unsharded(overlap):
    """Without torch.distributed the grid is one process: the sharded
    entries and run_sharded run on the whole grid (zeros beyond its edges,
    no collective) and equal the unsharded calls."""
    from mi_fieldcalc_tpu_torch import ops
    from mi_fieldcalc_tpu_torch.parallel import grid_mesh, run_sharded
    from mi_fieldcalc_tpu_torch.parallel.fused import (
        derived_fields_fused_sharded)

    g = grid_mesh(device="cpu")
    args = C._port(C.pipeline_inputs(2, 13, 17, seed=3))
    assert_same(C.derived_fields_fused(*args, stacked=False),
                derived_fields_fused_sharded(g, *args, overlap=overlap))
    assert_same(ops.shapiro2_filter(args[0]),
                run_sharded(ops.shapiro2_filter, g, 2, args[0]))
