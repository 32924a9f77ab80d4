"""The rest of the port's public surface against the JAX package's: the
ICAO atmosphere, the flight-level and Exner helpers of ``constants``,
``field.defined_counts`` / ``combine_defined`` and the host codec entries
of ``native``, with the cases of ``tests/test_constants.py``,
``test_field.py`` and ``test_native.py``."""

import numpy as np
import pytest
import torch

from mi_fieldcalc_tpu import constants as JC
from mi_fieldcalc_tpu import field as JF
from mi_fieldcalc_tpu import native as JN
from mi_fieldcalc_tpu_torch import constants as TC
from mi_fieldcalc_tpu_torch import field as TF
from mi_fieldcalc_tpu_torch import native as TN

UNDEF = TF.UNDEF

# from ICAO doc 7488 (MetConstantsTest.cc:39-58)
P_H_DOC7488 = [
    (8.7, 31985), (10.0, 31055), (11.1, 30360), (19.4, 26680),
    (97.3, 16353), (139.5, 14069), (244.1, 10517), (354.2, 8035),
    (459.7, 6189), (590.8, 4324), (739.7, 2576), (840.7, 1547),
    (936.8, 657), (1010.0, 27), (1020.0, -56), (1050.0, -302),
    (1130.0, -929),
]
P_FL_EXAMPLES = [
    (600, 140), (500, 185), (400, 235), (300, 300), (250, 340),
    (200, 385), (150, 445),
]


@pytest.mark.parametrize("name", JC.__all__)
def test_constants_public_names_match_jax(name):
    """Every public name of the JAX module is in the port's ``__all__``,
    and the numpy constants and tables are the same values."""
    assert name in TC.__all__
    j = getattr(JC, name)
    if isinstance(j, (np.ndarray, np.floating, float, int)):
        t = getattr(TC, name)
        assert np.array_equal(np.asarray(t), np.asarray(j))
        assert np.asarray(t).dtype == np.asarray(j).dtype


def test_icao_geo_altitude_from_pressure():
    for p, h in P_H_DOC7488:
        got = TC.icao_geo_altitude_from_pressure(p)
        assert abs(got - h) < 1.55, p
        assert got == JC.icao_geo_altitude_from_pressure(p)


def test_icao_fl_examples():
    for p, fl in P_FL_EXAMPLES:
        got = TC.fl_from_geo_altitude(TC.icao_geo_altitude_from_pressure(p))
        assert got == fl, p


def test_icao_flight_level_table_roundtrip():
    for p, fl in zip(TC.P_LEVEL_TABLE, TC.F_LEVEL_TABLE):
        got = TC.fl_from_geo_altitude(
            TC.icao_geo_altitude_from_pressure(float(p)))
        assert got == fl, p


def test_icao_pressure_from_geo_altitude():
    for p, h in P_H_DOC7488:
        got = TC.icao_pressure_from_geo_altitude(h)
        assert abs(got - p) < 0.01 * p, h
        assert got == JC.icao_pressure_from_geo_altitude(h)


def test_icao_vectorized_matches_jax():
    """Arrays in, arrays out, equal to the JAX package's float64 numpy,
    beyond the table's top included."""
    ps = np.array([x[0] for x in P_H_DOC7488] + [0.001, 2000.0])
    hs = np.array([x[1] for x in P_H_DOC7488] + [95000.0, -2000.0])
    for fn in ("icao_geo_altitude_from_pressure",
               "icao_pressure_from_geo_altitude"):
        arg = ps if "pressure" == fn.split("_")[-1] else hs
        np.testing.assert_array_equal(getattr(TC, fn)(arg),
                                      getattr(JC, fn)(arg))
    fls = np.array([0, 55, 100, 185, 450])
    np.testing.assert_array_equal(TC.geo_altitude_from_fl(fls),
                                  JC.geo_altitude_from_fl(fls))
    np.testing.assert_array_equal(TC.fl_from_geo_altitude(hs),
                                  JC.fl_from_geo_altitude(hs))
    assert TC.geo_altitude_from_fl(100) == JC.geo_altitude_from_fl(100)


def test_pi_from_p_matches_jax():
    """``cp * (p/p0)**kappa``, the p == 0 and p < 0 edges included, bit
    for bit (the JAX function op by op: XLA:CPU flushes subnormals)."""
    import jax

    p = np.array([1000.0, 850.0, 500.0, 10.0, 0.0, -5.0, np.nan],
                 np.float32)
    got = TC.pi_from_p(torch.from_numpy(p)).numpy()
    with jax.disable_jit():
        want = np.asarray(JC.pi_from_p(p))
    np.testing.assert_array_equal(got.view(np.int32)[:-1],
                                  want.view(np.int32)[:-1])
    assert np.isnan(got[-1]) and np.isnan(want[-1])


ALL = TF.ValuesDefined.ALL_DEFINED
NONE = TF.ValuesDefined.NONE_DEFINED
SOME = TF.ValuesDefined.SOME_DEFINED


@pytest.mark.parametrize("a", [ALL, NONE, SOME])
@pytest.mark.parametrize("b", [ALL, NONE, SOME])
def test_combine_defined_matches_reference_table(a, b):
    """FieldDefined.cc:72-83, against the JAX function."""
    got = TF.combine_defined(a, b)
    assert int(got) == int(JF.combine_defined(JF.ValuesDefined(int(a)),
                                              JF.ValuesDefined(int(b))))


def test_defined_counts():
    """``(n_defined, n_total)`` as tensors on the mask's device, and summed
    over blocks they give the whole field's count."""
    mask = torch.tensor([[True, False], [True, True]])
    n_def, n_tot = TF.defined_counts(mask)
    assert int(n_def) == 3 and int(n_tot) == 4
    j_def, j_tot = JF.defined_counts(mask.numpy())
    assert (int(n_def), int(n_tot)) == (int(j_def), int(j_tot))
    big = torch.from_numpy(np.arange(64).reshape(8, 8) % 5 != 0)
    parts = [TF.defined_counts(big[r:r + 4, c:c + 4])[0]
             for r in (0, 4) for c in (0, 4)]
    assert int(sum(parts)) == int(np.sum(np.arange(64) % 5 != 0))


def _sentinel_grid(rng, shape, frac_undef=0.3, with_nan=True):
    v = rng.normal(size=shape).astype(np.float32)
    u = rng.uniform(size=shape)
    v[u < frac_undef] = np.float32(UNDEF)
    if with_nan:
        v[u > 1.0 - frac_undef / 4] = np.nan
    return v


def test_native_builds():
    assert TN.available(), "native codec failed to build/load"
    assert TN.codec() == "native"


@pytest.mark.parametrize("shape", [(1,), (7, 13), (719, 929), (3, 64, 64)])
def test_decode_matches_jax(shape):
    rng = np.random.default_rng(0)
    v = _sentinel_grid(rng, shape)
    out, mask, n_def = TN.decode(v, UNDEF, fill=-1.5)
    j_out, j_mask, j_def = JN.decode(v, UNDEF, fill=-1.5)
    np.testing.assert_array_equal(mask, j_mask)
    np.testing.assert_array_equal(out, j_out)
    assert n_def == j_def == int(mask.sum())
    assert mask.dtype == np.bool_


def test_decode_matches_device_codec():
    v = _sentinel_grid(np.random.default_rng(1), (33, 41))
    _, mask, _ = TN.decode(v)
    np.testing.assert_array_equal(mask, TF.from_sentinel(v).mask.numpy())


def test_encode_roundtrip():
    v = _sentinel_grid(np.random.default_rng(2), (50, 60), with_nan=False)
    out, mask, _ = TN.decode(v, UNDEF, fill=0.0)
    back = TN.encode(out, mask, UNDEF)
    np.testing.assert_array_equal(back, v)
    np.testing.assert_array_equal(back, JN.encode(out, mask, UNDEF))


def test_encode_broadcast_mask():
    v = np.arange(12, dtype=np.float32).reshape(3, 4)
    m = np.array([True, False, True, False])
    enc = TN.encode(v, m, UNDEF)
    assert (enc[:, 1] == np.float32(UNDEF)).all()
    np.testing.assert_array_equal(enc, JN.encode(v, m, UNDEF))


@pytest.mark.parametrize("frac,expect", [(0.0, ALL), (1.0, NONE),
                                         (0.5, SOME)])
def test_defined_state_host(frac, expect):
    rng = np.random.default_rng(3)
    v = rng.normal(size=(40, 40)).astype(np.float32)
    v[rng.uniform(size=v.shape) < frac] = np.float32(UNDEF)
    if frac == 1.0:
        v[:] = np.float32(UNDEF)
    assert TN.defined_state_host(v, UNDEF) == expect
    assert int(JN.defined_state_host(v, UNDEF)) == int(expect)
    assert TN.count_defined(v, UNDEF) == JN.count_defined(v, UNDEF)


def test_large_threaded_consistency():
    """Every thread-count threshold of the codec (1e3 / 1e4 / 1e5)."""
    rng = np.random.default_rng(4)
    for n in (999, 1001, 10001, 100001, 500000):
        v = _sentinel_grid(rng, (n,))
        out, mask, n_def = TN.decode(v)
        assert n_def == int((~np.isnan(v) & (v != np.float32(UNDEF))).sum())
        assert (out[~mask] == 0.0).all()
        nan_free = np.nan_to_num(v, nan=np.float32(UNDEF))
        np.testing.assert_array_equal(out[mask], nan_free[mask])


@pytest.mark.parametrize("shape,padded", [((45, 130), (48, 256)),
                                          ((3, 45, 130), (48, 256)),
                                          ((8, 128), (8, 128))])
def test_encode_trim_matches_jax(shape, padded):
    """``encode_trim``: the padded grid's logical part as sentinels, as
    the JAX function gives it (and ``decode_pad``'s dual)."""
    v = _sentinel_grid(np.random.default_rng(7), shape)
    vals, mask, _ = TN.decode_pad(v, *padded)
    got = TN.encode_trim(vals, mask, *shape[-2:])
    np.testing.assert_array_equal(got, JN.encode_trim(vals, mask,
                                                      *shape[-2:]))
    np.testing.assert_array_equal(got, np.where(np.isnan(v), UNDEF, v))
    with pytest.raises(ValueError):
        TN.encode_trim(vals, mask, shape[-2] + 9, shape[-1])
