"""The PyTorch port's foundation against the JAX package: the sentinel
codec, the constants and EWT table, the deterministic Exner pow and the
table coordinate.

The JAX side is evaluated op by op (no ``jax.jit``): XLA:CPU's jit
contracts multiply-adds into FMAs, which moves ``pow_posc_f32`` by an ulp
on some inputs, while the op-by-op evaluation rounds every operation on
its own, as the port (and the CUDA kernel, built with ``-fmad=false``)
does.  Against it the port is held bit for bit.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mi_fieldcalc_tpu import _libm as jlibm
from mi_fieldcalc_tpu import constants as jc
from mi_fieldcalc_tpu import field as jfield
from mi_fieldcalc_tpu_torch import _libm as tlibm
from mi_fieldcalc_tpu_torch import constants as tc
from mi_fieldcalc_tpu_torch import field as tfield

torch.set_num_threads(1)


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def test_sentinel_round_trip_with_nan():
    rng = np.random.default_rng(0)
    a = rng.normal(0.0, 100.0, (3, 7, 11)).astype(np.float32)
    a.reshape(-1)[rng.integers(0, a.size, 20)] = jfield.UNDEF
    a[0, 0, :4] = [np.nan, np.inf, -np.inf, -jfield.UNDEF]
    got = tfield.from_sentinel(a)
    ref = jfield.from_sentinel(a)
    assert got.values.dtype == torch.float32 and got.mask.dtype == torch.bool
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    assert not got.mask[0, 0, 0] and got.mask[0, 0, 1] and got.mask[0, 0, 3]
    back = got.to_sentinel().numpy()
    np.testing.assert_array_equal(_bits(back), _bits(ref.to_sentinel()))
    assert back[0, 0, 0] == np.float32(jfield.UNDEF)     # NaN -> undef
    # a second round trip is the identity
    np.testing.assert_array_equal(
        _bits(tfield.from_sentinel(back).to_sentinel()), _bits(back))
    # from_arrays carries the JAX Field state (values, mask) unchanged
    fa = tfield.from_arrays(np.asarray(ref.values), np.asarray(ref.mask))
    np.testing.assert_array_equal(fa.mask.numpy(), np.asarray(ref.mask))
    m = np.asarray(ref.mask)
    np.testing.assert_array_equal(_bits(fa.values.numpy()[m]),
                                  _bits(np.asarray(ref.values)[m]))
    with pytest.raises(ValueError):
        tfield.from_arrays(np.zeros((2, 3)), np.zeros((3, 2), bool))


@pytest.mark.parametrize("mask, state", [
    (np.ones((4, 5), bool), tfield.ValuesDefined.ALL_DEFINED),
    (np.zeros((4, 5), bool), tfield.ValuesDefined.NONE_DEFINED),
    (np.eye(4, 5, dtype=bool), tfield.ValuesDefined.SOME_DEFINED),
])
def test_defined_state(mask, state):
    assert tfield.defined_state(torch.from_numpy(mask)) == state
    assert tfield.defined_state(torch.from_numpy(mask)) == \
        jfield.defined_state(jnp.asarray(mask))
    assert tfield.full_undef((2, 3)).mask.sum() == 0
    assert bool(tfield.from_values(np.ones((2, 3))).mask.all())


def test_ewt_table_and_constants_match():
    np.testing.assert_array_equal(_bits(tc.EWT), _bits(jc.EWT))
    assert tc.N_EWT == jc.N_EWT == 41
    for name in ("cp", "eps", "kappa", "p0inv", "rhmin", "rhmax", "t0",
                 "xlh"):
        assert _bits(getattr(tc, name)) == _bits(getattr(jc, name)), name


def test_pow_posc_f32_bitwise():
    """~1e5 Exner-domain samples (p/p0 for p in 1..1100 hPa) and the
    sentinel pressure 1e35 through the deterministic pow."""
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.uniform(1e-3, 1.1, 100_000),
                        np.geomspace(1e-6, 1e3, 997),
                        [1e35, 1e35 * 1e-3, 1.0]]).astype(np.float32)
    got = tlibm.pow_posc_f32(torch.from_numpy(x), tc.kappa).numpy()
    ref = np.asarray(jlibm.pow_posc_f32(jnp.asarray(x), jc.kappa))
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    # and it is the pow it claims to be (<= ~2.5 ulp on the domain)
    exact = np.power(x[:100_000].astype(np.float64), float(jc.kappa))
    assert np.max(np.abs(got[:100_000] - exact) / exact) < 4e-7


def test_pidcp_from_p_edges_bitwise():
    rng = np.random.default_rng(2)
    p = np.concatenate([rng.uniform(1.0, 1100.0, 1000),
                        [0.0, -0.0, -5.0, -1e35, np.nan, 1e35]]
                       ).astype(np.float32)
    got = tc.pidcp_from_p(torch.from_numpy(p)).numpy()
    ref = np.asarray(jc.pidcp_from_p(jnp.asarray(p)))
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    assert got[-6] == 0.0 and got[-5] == 0.0
    assert np.isnan(got[-4]) and np.isnan(got[-3]) and np.isnan(got[-2])


def test_table_coordinate_saturates_like_xla():
    """The table gate and clipped index for defined temperatures outside
    the table (500 K), huge values, infinities and NaN: XLA truncates,
    saturates and maps NaN to 0; the port clamps in float first."""
    t = np.array([np.nan, np.inf, -np.inf, 1e30, -1e30, 500.0 - 273.15,
                  -100.0, -100.5, -101.0, -105.0, 99.99, 100.0, 100.01,
                  3.7, -37.2], np.float32)
    x_t, l_t = tc.ewt_index(torch.from_numpy(t))
    x_j, l_j = jc.ewt_index(jnp.asarray(t))
    np.testing.assert_array_equal(_bits(x_t.numpy()), _bits(x_j))
    np.testing.assert_array_equal(tc.ewt_defined(l_t).numpy(),
                                  np.asarray(jc.ewt_defined(l_j)))
    np.testing.assert_array_equal(l_t.clamp(0, 39).numpy(),
                                  np.clip(np.asarray(l_j), 0, 39))
    # NaN maps to l = 0 on both sides, so the gate alone does not drop it
    assert l_t[0] == 0 and np.asarray(l_j)[0] == 0


def test_ewt_value_and_inverse_bitwise():
    rng = np.random.default_rng(3)
    tc_ = np.concatenate([rng.uniform(-110.0, 110.0, 5000),
                          [np.nan, -100.0, 100.0]]).astype(np.float32)
    x_t, l_t = tc.ewt_index(torch.from_numpy(tc_))
    x_j, l_j = jc.ewt_index(jnp.asarray(tc_))
    et_t = tc.ewt_value(x_t, l_t)
    et_j = jc.ewt_value(x_j, l_j)
    np.testing.assert_array_equal(_bits(et_t.numpy()), _bits(et_j))
    rh = rng.uniform(0.02, 1.0, tc_.size).astype(np.float32)
    inv_t = tc.ewt_inverse(et_t * torch.from_numpy(rh), l_t).numpy()
    inv_j = np.asarray(jc.ewt_inverse(et_j * jnp.asarray(rh), l_j))
    np.testing.assert_array_equal(_bits(inv_t), _bits(inv_j))
    clamped = tc.clamp_rh(torch.tensor([0.0, 0.5, 2.0, np.nan])).numpy()
    np.testing.assert_array_equal(clamped[:3], np.float32([0.02, 0.5, 1.0]))
    assert np.isnan(clamped[3])
