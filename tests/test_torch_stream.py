"""The port's streaming executor ``staging.stream_derived_fields_np`` and
the reused, chunked host blocks under every serving entry, on the CPU.

The stream must give, step by step and in order, the bytes the serial
entry ``run_derived_fields_np`` gives; the chunked fetch must give the
same bytes whatever the chunk size; no returned array may share memory
with a reused block, and a block is never rewritten before the upload
that reads it has finished.  Against the JAX package's stream the
tolerances are those of ``tests/test_torch_staging.py`` (its XLA:CPU jit
contracts multiply-adds): rtol 2e-5, and ``2e-6*max|ref|`` more on the 5
stencil outputs; sentinels identical.
"""

import numpy as np
import pytest
import torch

from mi_fieldcalc_tpu.field import UNDEF
from mi_fieldcalc_tpu.staging import (
    stream_derived_fields_np as j_stream)
from mi_fieldcalc_tpu_torch import staging
from test_torch_staging import STENCIL, _inputs

torch.set_num_threads(1)

CPU = dict(device="cpu")


def _steps(n=3, shape=(3, 24, 40)):
    """``n`` requests from different seeds, masked and all-defined in
    turn, so the route switches mid-stream."""
    return [_inputs(*shape, seed=10 + i, undefs=i % 2 == 0)
            for i in range(n)]


def _same_bytes(got: dict, ref: dict, label: str) -> None:
    assert list(got) == list(ref), label
    for name, r in ref.items():
        g = got[name]
        assert g.dtype == r.dtype and g.shape == r.shape, (label, name)
        assert g.tobytes() == r.tobytes(), (label, name)


def test_stream_equals_serial_in_order():
    steps = _steps()
    routes = [staging._decode_step(s, staging.HostStager(4), UNDEF)[1]
              for s in steps]
    assert routes == [False, True, False]      # the route switches
    serial = [staging.run_derived_fields_np(*s, **CPU) for s in steps]
    got = list(staging.stream_derived_fields_np(iter(steps), **CPU))
    assert len(got) == len(steps)
    for i, (g, r) in enumerate(zip(got, serial)):
        _same_bytes(g, r, f"step {i}")


@pytest.mark.parametrize("n", [0, 1])
def test_stream_empty_and_single_step(n):
    steps = _steps(n)
    got = list(staging.stream_derived_fields_np(steps, **CPU))
    assert len(got) == n
    if n:
        _same_bytes(got[0], staging.run_derived_fields_np(*steps[0], **CPU),
                    "single step")


def test_stream_shape_change_mid_stream():
    steps = [_inputs(3, 24, 40, seed=1), _inputs(2, 17, 33, seed=2),
             _inputs(2, 17, 33, seed=3, undefs=False),
             _inputs(3, 24, 40, seed=4)]
    got = list(staging.stream_derived_fields_np(steps, **CPU))
    for i, (g, s) in enumerate(zip(got, steps)):
        assert g["th"].shape == np.shape(s[0])
        _same_bytes(g, staging.run_derived_fields_np(*s, **CPU), f"step {i}")


def test_stream_outputs_outlive_the_blocks():
    """Step 1's dict is unchanged after steps 2 and 3 reuse both blocks,
    and no returned array shares memory with a stager's block."""
    steps = _steps(4)
    stream = staging.stream_derived_fields_np(steps, **CPU)
    first = next(stream)
    kept = {k: a.copy() for k, a in first.items()}
    rest = list(stream)
    assert len(rest) == 3
    _same_bytes(first, kept, "step 1 after step 3")
    stager = staging._stager_cache(4, UNDEF)
    out = staging.run_derived_fields_np(*steps[0], **CPU)
    blocks = [stager._vin.numpy(), stager._min.numpy(), stager._out.numpy()]
    for a in list(out.values()) + list(first.values()):
        assert not any(np.shares_memory(a, b) for b in blocks)


@pytest.mark.parametrize("chunk", [1, 5, 12])
def test_chunked_fetch_same_bytes(chunk):
    """Chunks of 1, 5 (not a divisor of the 12 planes) and 12 value
    planes give the entries' bytes (their own chunks), masked and
    all-defined, for the pipeline, the suite and the icing products."""
    from test_torch_icing import SCAL, _entry_inputs
    from test_torch_suite import _suite_np
    cpu = torch.device("cpu")
    for k, args in enumerate([_inputs(seed=7), _inputs(seed=8,
                                                       undefs=False)]):
        stager = staging.HostStager(4)
        host, ad = staging._decode_step(args, stager, UNDEF)
        out = staging._compute(staging._upload_step(host, cpu), ad)
        _same_bytes(staging._encode_step(
            staging._fetch(out, stager, chunk), UNDEF),
            staging.run_derived_fields_np(*args, **CPU), f"pipeline {k}")
    suite = _suite_np(seed=4, undefs=True)
    modes = dict(temps=(3, 5), hums_q=(1, 2), hums_rh=(3,), thes=(1,),
                 ducts_q=(1,))
    reqs = staging._build_reqs("test", *modes.values(), ())
    stager = staging.HostStager(3)
    host, ad = staging._suite_decode_step(*suite, reqs, stager, UNDEF)
    out = staging._suite_compute(staging._suite_upload_step(host, reqs, cpu),
                                 reqs, ad)
    _same_bytes(staging._suite_encode_step(
        staging._suite_fetch(out, stager, chunk), reqs, UNDEF),
        staging.run_hlevel_suite_np(*suite, **modes, **CPU), "suite")
    icing = _entry_inputs(seed=3)
    stager = staging.HostStager(11)
    stager.decode(*icing)
    outs = staging._icing_products(staging._icing_upload_step(stager, cpu),
                                   *SCAL, 1, staging.ICING_PRODUCTS)
    _same_bytes(staging._encode_planes(
        staging._icing_fetch(outs, stager, chunk), staging.ICING_PRODUCTS,
        UNDEF), staging.run_vessel_icing_np(*icing, *SCAL, **CPU), "icing")


def test_chunks_keep_the_codec_team():
    """The default chunk leaves every encode call above the codec's
    whole-team row count: 2 chunks of 6 planes at the headline
    32x719x929, 6 of 2 at 137 levels, one chunk for the suite's 8 planes
    at 32 levels and for small grids."""
    assert staging._chunk_size(12, (32, 719, 929)) == 6
    assert staging._chunk_size(8, (32, 719, 929)) == 8
    assert staging._chunk_size(12, (137, 719, 929)) == 2
    assert staging._chunk_size(4, (719, 929)) == 4
    assert staging._chunk_size(12, (3, 24, 40)) == 12
    for k, plane in ((12, (32, 719, 929)), (12, (137, 719, 929))):
        chunk = staging._chunk_size(k, plane)
        assert chunk * plane[0] * plane[1] > staging.CODEC_TEAM_ROWS


@pytest.mark.parametrize("k, chunk, want", [
    (9, 5, [[0, 1, 2, 3], [4, 5, 6], [7, 8]]),
    (2, 5, [[0], [], [1]]),
    (9, 1, [[0], [1], [2], [], [3], [], [4], [5], [], [6], [7], [8]])])
def test_fetch_chunks_carry_their_mask_planes(k, chunk, want):
    """Each chunk copies the mask planes it is the first to read (the
    9-plane map shares rh/the/vo's planes with td/duc/dv; the 2-plane map
    holds only RH's and TFP's gates), so its encode never waits on a later
    chunk."""
    mmap = {9: staging.DerivedFieldsStacked.MASK9,
            2: staging.DerivedFieldsStacked.MASK2}[k]
    plan = staging._chunk_plan(mmap, 12, chunk)
    assert [m for _, _, m in plan] == want
    assert [(lo, hi) for lo, hi, _ in plan] == [
        (lo, min(12, lo + chunk)) for lo in range(0, 12, chunk)]
    copied = set()
    for lo, hi, masks in plan:
        copied |= set(masks)
        assert set(mmap[lo:hi]) - {-1} <= copied


def test_decode_waits_for_the_upload_that_reads_the_block():
    """A decode into a block first waits on the event of the last upload
    from it (on CUDA the copy is non_blocking), and only then writes."""
    stager = staging.HostStager(4)
    a, b = _inputs(seed=1), _inputs(seed=2)
    staging._decode_step(a, stager, UNDEF)
    before = stager.values.copy()
    order = []

    class Event:
        def synchronize(self):
            # the block still holds request a when the wait returns
            order.append(np.array_equal(stager.values, before))

    stager.uploaded = Event()
    staging._decode_step(b, stager, UNDEF)
    assert order == [True] and stager.uploaded is None
    assert not np.array_equal(stager.values, before)


def test_stream_rejects_unported_options_and_missing_cuda(monkeypatch):
    steps = _steps(1)
    for kw in (dict(levpack=True), dict(align=True)):
        with pytest.raises(NotImplementedError, match="not ported"):
            staging.stream_derived_fields_np(steps, **kw, **CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        staging.stream_derived_fields_np(steps)      # raises before a step


def test_stream_matches_jax_stream():
    steps = _steps()
    got = list(staging.stream_derived_fields_np(steps, **CPU))
    ref = list(j_stream(steps))
    assert len(got) == len(ref) == len(steps)
    for g_step, r_step in zip(got, ref):
        assert list(g_step) == list(r_step)
        for name, r in r_step.items():
            g = g_step[name]
            undef = r == np.float32(UNDEF)
            np.testing.assert_array_equal(g == np.float32(UNDEF), undef,
                                          err_msg=name)
            d = ~undef
            atol = (2e-6 * float(np.abs(r[d]).max())
                    if name in STENCIL else 0.0)
            np.testing.assert_allclose(g[d], r[d], rtol=2e-5, atol=atol,
                                       err_msg=name)


@pytest.mark.cuda
def test_stream_on_the_card_equals_serial():
    """On the card: page-locked blocks, the copy streams and the B1
    launches, the stream byte for byte the serial entry's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    from mi_fieldcalc_tpu_torch.ops import fused
    steps = _steps(4)
    serial = [staging.run_derived_fields_np(*s) for s in steps]
    fused.derived_fields_fused.launches = 0
    got = list(staging.stream_derived_fields_np(steps))
    assert fused.derived_fields_fused.launches == len(steps)
    for i, (g, r) in enumerate(zip(got, serial)):
        _same_bytes(g, r, f"step {i}")
