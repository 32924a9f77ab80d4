"""The port's pipeline kernel wrapper (``ops/fused.py``) and its stacked
layout against the JAX package.

On the CPU the wrapper runs the kernel's plain version; the CUDA kernel
itself is compared with that plain version by the ``cuda``-marked test
(skipped where there is no card) and by ``chip_smoke.py``.

Tolerances.  Masks are bitwise equal everywhere.  Against the JAX
functions evaluated op by op, values agree within rtol 2e-5.  Against JAX
``derived_fields_fused(interpret=True)``, which XLA:CPU compiles with
multiply-adds contracted into FMAs, the 7 elementwise planes keep rtol
2e-5 and the 5 stencil planes (vort, div, tadv, gradt, tfp) get
``|got - ref| <= 2e-5*|ref| + 2e-6*max|ref|``: a centred difference near
cancellation moves by a few ulps of the plane's scale under contraction
(measured ~1e-7 of max|ref|), which no relative bound can hold.
"""

import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mi_fieldcalc_tpu.field import UNDEF
from mi_fieldcalc_tpu.field import from_sentinel as j_from_sentinel
from mi_fieldcalc_tpu.models.pipeline import derived_fields as j_derived
from mi_fieldcalc_tpu.ops.fused import derived_fields_fused as j_fused
from mi_fieldcalc_tpu_torch import constants as tc
from mi_fieldcalc_tpu_torch.models.pipeline import (
    DerivedFields, DerivedFieldsStacked, derived_fields, inputs_from_numpy,
)
from mi_fieldcalc_tpu_torch.ops import fused as tfused

torch.set_num_threads(1)

STENCIL_PLANES = (7, 8, 9, 10, 11)


def _inputs(nlev, ny, nx, seed=0, undefs=True):
    """The JAX package's fused-kernel test inputs (test_fused.py): seeded
    numpy, scattered undefs incl. corners, a 500 K point and an undefined
    ps point.  Returns the JAX arguments and their numpy form."""
    rng = np.random.default_rng(seed)
    tk = rng.normal(275, 15, (nlev, ny, nx)).astype(np.float32)
    q = rng.uniform(1e-4, 1e-2, (nlev, ny, nx)).astype(np.float32)
    u = rng.normal(0, 12, (nlev, ny, nx)).astype(np.float32)
    v = rng.normal(0, 12, (nlev, ny, nx)).astype(np.float32)
    ps = rng.normal(1000, 15, (ny, nx)).astype(np.float32)
    if undefs:
        for arr in (tk, q, u, v):
            idx = rng.integers(0, arr.size, arr.size // 37)
            arr.reshape(-1)[idx] = UNDEF
        tk[0, 0, 0] = UNDEF
        tk[-1, -1, -1] = UNDEF
        tk[0, 1, 1] = 500.0
        ps[ny // 2, nx // 2] = UNDEF
    alevel = np.linspace(0, 50, nlev).astype(np.float32)
    blevel = np.linspace(1, 0.5, nlev).astype(np.float32)
    xm = rng.uniform(3e-7, 5e-7, (ny, nx)).astype(np.float32)
    ym = rng.uniform(3e-7, 5e-7, (ny, nx)).astype(np.float32)
    fc = np.full((ny, nx), 1.2e-4, np.float32)
    jargs = tuple(j_from_sentinel(a) for a in (tk, q, u, v, ps)) + tuple(
        jnp.asarray(a) for a in (alevel, blevel, xm, ym, fc))
    nargs = [(np.asarray(f.values), np.asarray(f.mask)) for f in jargs[:5]]
    nargs += [alevel, blevel, xm, ym, fc]
    return jargs, nargs


def _assert_values(got, ref, mask, name, stencil=False):
    g, r = got[mask], ref[mask]
    atol = 2e-6 * float(np.max(np.abs(r))) if stencil and r.size else 0.0
    np.testing.assert_allclose(g, r, rtol=2e-5, atol=atol, err_msg=name)


@pytest.mark.parametrize("all_defined", [False, True])
def test_fused_matches_jax_fused_kernel(all_defined):
    jargs, nargs = _inputs(2, 33, 135, seed=168, undefs=not all_defined)
    ref = j_fused(*jargs, interpret=True, stacked=True,
                  all_defined=all_defined)
    got = tfused.derived_fields_fused(*inputs_from_numpy(nargs),
                                      stacked=True, all_defined=all_defined)
    assert got.values.shape == (12, 2, 33, 135)
    assert got.masks.dtype == torch.bool
    assert got.masks.shape == ((2 if all_defined else 9), 2, 33, 135)
    np.testing.assert_array_equal(got.masks.numpy(),
                                  np.asarray(ref.masks) != 0)
    rv = np.asarray(ref.values)
    for i in range(12):
        m = DerivedFieldsStacked.mask_plane(got.masks, i,
                                            got.values[i]).numpy()
        _assert_values(got.values[i].numpy(), rv[i], m, f"plane {i}",
                       stencil=i in STENCIL_PLANES)


@pytest.mark.parametrize("undefs", [True, False])
def test_fused_matches_jax_pipeline(undefs):
    jargs, nargs = _inputs(3, 37, 61, seed=98, undefs=undefs)
    ref = j_derived(*jargs)                       # op by op
    got = tfused.derived_fields_fused(*inputs_from_numpy(nargs),
                                      stacked=True).as_fields()
    for name in ref._fields:
        rm = np.asarray(getattr(ref, name).mask)
        np.testing.assert_array_equal(getattr(got, name).mask.numpy(), rm,
                                      err_msg=name)
        _assert_values(getattr(got, name).values.numpy(),
                       np.asarray(getattr(ref, name).values), rm, name)


@pytest.mark.parametrize("nplanes", [12, 9, 2])
def test_mask_plane_layouts(nplanes):
    """Field i's mask through each stacked layout equals the per-field
    mask of the plain pipeline (the 2-plane layout on fully defined
    input, where the other 10 masks are constant True)."""
    _, nargs = _inputs(2, 11, 17, seed=nplanes, undefs=nplanes != 2)
    args = inputs_from_numpy(nargs)
    fields = derived_fields(*args)
    if nplanes == 12:
        masks = torch.stack([f.mask for f in fields])
    else:
        masks = tfused.derived_fields_fused(
            *args, all_defined=nplanes == 2).masks
    assert masks.shape[0] == nplanes
    for i, f in enumerate(fields):
        m = DerivedFieldsStacked.mask_plane(masks, i, f.values)
        assert torch.equal(m, f.mask), i
    st = DerivedFieldsStacked(torch.stack([f.values for f in fields]), masks)
    assert torch.equal(st.field(3).mask, fields.td.mask)
    with pytest.raises(NotImplementedError, match="mask_plane"):
        DerivedFieldsStacked.mask_plane(
            torch.zeros((2, 11, 17), dtype=torch.int32), 0, fields.p.values)


def test_unported_layout_and_grid_checks():
    """The per-field layout (``stacked=False``, once unported) is the
    stacked result's ``.as_fields()``; the grid and argument checks."""
    _, nargs = _inputs(1, 5, 6, seed=1)
    args = inputs_from_numpy(nargs)
    per_field = tfused.derived_fields_fused(*args, stacked=False)
    stacked = tfused.derived_fields_fused(*args)
    assert isinstance(per_field, DerivedFields)
    for got, want in zip(per_field, stacked.as_fields()):
        assert torch.equal(got.mask, want.mask)
        assert torch.equal(got.values, want.values)
    assert tfused.fused_supported(719, 929)
    assert not tfused.fused_supported(2, 64)
    assert not tfused.fused_supported(64, 2)
    # the wrapper's argument checks (device-independent)
    dev = torch.device("cpu")
    with pytest.raises(ValueError, match="contiguous"):
        tfused._check(torch.zeros(3, 4).t(), "x", (4, 3), torch.float32, dev)
    with pytest.raises(TypeError, match="float32"):
        tfused._check(torch.zeros(4, 3, dtype=torch.float64), "x", (4, 3),
                      torch.float32, dev)
    with pytest.raises(ValueError, match="shape"):
        tfused._check(torch.zeros(4, 4), "x", (4, 3), torch.float32, dev)


def _hex_consts(src: str) -> dict:
    return {m.group(1): float.fromhex(m.group(2)) for m in re.finditer(
        r"constexpr float (k\w+) = (-?0x[0-9a-fA-F.]+p[-+]?\d+)f;", src)}


def test_kernel_constants_match_the_port():
    """The CUDA sources' float literals (in the header every kernel
    includes) equal the port's float32 constants bit for bit (the kernels
    cannot be compiled here, their constants can be read)."""
    csrc = Path(tfused.__file__).parent.parent / "csrc"
    src = (csrc / "common.cuh").read_text()
    assert '#include "common.cuh"' in (csrc / "derived_fields.cu").read_text()
    consts = _hex_consts(src)
    c_d = float(tc.kappa)
    c_hi = float(np.float32(round(c_d * 4096.0) / 4096.0))
    want = {"kT0": tc.t0, "kEps": tc.eps, "kP0inv": tc.p0inv,
            "kRhmin": tc.rhmin, "kEwtScale": np.float32(0.2),
            "kDuct1": np.float32(77.6), "kUndef": np.float32(UNDEF),
            "kMinNormal": np.float32(1.1754944e-38),
            "kSqrtHalf": np.float32(0.70710678118654752440),
            "kLn2": np.float32(0.693147180559945309),
            "kKappaHi": np.float32(c_hi),
            "kKappaLo": np.float32(c_d) - np.float32(c_hi),
            "kKappaL2e": np.float32(c_d * 1.44269504088896341)}
    for name, value in want.items():
        assert np.float32(consts[name]) == np.float32(value), name
    body = re.search(r"c_ewt\[kNEwt\] = \{([^}]*)\}", src).group(1)
    table = np.array([float.fromhex(t.strip().rstrip("f"))
                      for t in body.split(",") if t.strip()], np.float32)
    np.testing.assert_array_equal(table.view(np.int32),
                                  tc.EWT.view(np.int32))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 37, 61), (2, 33, 135), (1, 3, 3),
                                   (2, 5, 929), (4, 64, 256)])
@pytest.mark.parametrize("all_defined", [False, True])
def test_cuda_kernel_matches_plain(cuda_device, shape, all_defined):
    _, nargs = _inputs(*shape, seed=sum(shape), undefs=not all_defined)
    args = inputs_from_numpy(nargs, device=cuda_device)
    before = tfused.derived_fields_fused.launches
    got = tfused.derived_fields_fused(*args, all_defined=all_defined)
    torch.cuda.synchronize()
    assert tfused.derived_fields_fused.launches == before + 1
    ref = tfused.derived_fields_plain(*args, all_defined=all_defined)
    assert torch.equal(got.masks, ref.masks)
    for i in range(12):
        m = DerivedFieldsStacked.mask_plane(got.masks, i, got.values[i])
        _assert_values(got.values[i][m].cpu().numpy(),
                       ref.values[i][m].cpu().numpy(),
                       np.ones(int(m.sum()), bool), f"plane {i}")
