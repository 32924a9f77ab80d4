"""The port's profiling module (``mi_fieldcalc_tpu_torch/utils/profiling``)
against the JAX package's ``utils/profiling``.

``roofline_for_op`` keeps JAX's arithmetic: at the same rate (the port's
H100 figure handed to JAX's function) the two give the same bytes,
seconds, points per second and fraction.  The
published rates are NVIDIA's only: ``device_hbm_gbps`` raises for the CPU
and for any card it has no rate for (JAX's 819e9 default is a TPU v5e
figure and does not carry over).  ``trace`` writes a Chrome trace on the
CPU too; the device's busy time is the union of the trace's kernel, copy
and fill intervals.  The CUDA-event timer is checked on the card only.
"""

import json
from types import SimpleNamespace

import pytest
import torch

from mi_fieldcalc_tpu.utils import profiling as jprof
from mi_fieldcalc_tpu_torch.utils import profiling as tprof

torch.set_num_threads(1)


def _card(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: SimpleNamespace(name=name))


@pytest.mark.parametrize("n_in,n_out,points,bv,bm", [
    (2, 1, 719 * 929, 4, 1), (4, 12, 32 * 719 * 929, 4, 1),
    (1, 1, 7, 8, 0)])
def test_roofline_for_op_matches_jax(monkeypatch, n_in, n_out, points, bv,
                                     bm):
    # the same rate on both sides: the port's H100 figure handed to JAX's
    _card(monkeypatch, "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(jprof, "device_hbm_gbps", lambda device=None:
                        tprof.device_hbm_gbps("cuda"))
    ref = jprof.roofline_for_op(n_in, n_out, points, bv, bm)
    got = tprof.roofline_for_op(n_in, n_out, points, bv, bm, device="cuda")
    assert got.hbm_bytes_per_sec == ref.hbm_bytes_per_sec == 3.35e12
    assert got.bytes_accessed == ref.bytes_accessed
    assert got.seconds == ref.seconds
    assert got.points_per_sec == ref.points_per_sec
    assert got.fraction(1e-3) == ref.fraction(1e-3)


@pytest.mark.parametrize("name,rate,flops", [
    ("NVIDIA H100 80GB HBM3", 3.35e12, 67e12),
    ("NVIDIA H200", 4.8e12, 67e12)])
def test_published_rates_of_known_cards(monkeypatch, name, rate, flops):
    _card(monkeypatch, name)
    assert tprof.device_hbm_gbps(torch.device("cuda", 0)) == rate
    assert tprof.device_hbm_gbps() == rate
    assert tprof.device_f32_flops("cuda") == flops
    rl = tprof.roofline_for_op(4, 12, 1000, device="cuda")
    assert rl.hbm_bytes_per_sec == rate


@pytest.mark.parametrize("name", ["TPU v5 lite", "NVIDIA H100 PCIe",
                                  "NVIDIA A100-SXM4-80GB"])
def test_unknown_cards_raise(monkeypatch, name):
    _card(monkeypatch, name)
    with pytest.raises(ValueError, match="no published memory rate"):
        tprof.device_hbm_gbps(torch.device("cuda", 0))
    with pytest.raises(ValueError, match="no published float32 rate"):
        tprof.device_f32_flops(torch.device("cuda", 0))


def test_the_cpu_has_no_published_rate():
    with pytest.raises(ValueError, match="cpu"):
        tprof.device_hbm_gbps(torch.device("cpu"))
    with pytest.raises(ValueError, match="cpu"):
        tprof.roofline_for_op(1, 1, 10, device="cpu")


def test_trace_on_the_cpu_writes_a_trace(tmp_path):
    with tprof.trace(str(tmp_path / "t")) as prof:
        torch.ones(1000).add_(1.0)
    path = tmp_path / "t" / "trace.json"
    assert prof.trace_path == str(path) and path.is_file()
    events = json.loads(path.read_text())["traceEvents"]
    assert any("add_" in e.get("name", "") for e in events)
    assert tprof.device_events(path) == []
    assert tprof.device_busy_ms(path) == 0.0


def test_device_busy_is_the_union_of_device_intervals(tmp_path):
    ev = [{"name": "k1", "cat": "kernel", "ts": 100.0, "dur": 50.0},
          {"name": "c1", "cat": "gpu_memcpy", "ts": 120.0, "dur": 100.0},
          {"name": "s1", "cat": "gpu_memset", "ts": 300.0, "dur": 10.0},
          {"name": "k2", "cat": "kernel", "ts": 305.0, "dur": 1.0},
          {"name": "aten::add", "cat": "cpu_op", "ts": 0.0, "dur": 1e6},
          {"name": "flow", "cat": "kernel", "ts": 400.0}]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev[::-1]}))
    assert [e[0] for e in tprof.device_events(path)] == ["k1", "c1", "s1",
                                                         "k2"]
    # [100, 220) and [300, 310): 130 us
    assert tprof.device_busy_ms(path) == pytest.approx(0.130)


@pytest.mark.cuda
def test_event_times_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    x = torch.ones(1 << 20, device="cuda")
    for queued in (False, True):
        t = tprof.event_times_ms(lambda: x.add_(1.0), 3, queued=queued)
        assert len(t) == 3 and all(v > 0 for v in t)
