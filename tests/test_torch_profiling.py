"""The port's profiling module (``mi_fieldcalc_tpu_torch/utils/profiling``).

The published rates are NVIDIA's only: ``device_hbm_gbps`` raises for the
CPU and for any card it has no rate for (the JAX package's 819e9 default
is a TPU v5e figure and does not carry over).  ``trace`` writes a Chrome
trace on the CPU too; the device's busy time is the union of the trace's
kernel, copy and fill intervals.

The program's spans and counters record only inside a ``torch.profiler``
session, on the clock of the profiler's host events; with none on, a span
allocates nothing, reads no clock and makes no CUDA call.  The ensemble
summary and the pipeline kernel's wrapper record their layers' spans, and
their outputs are the same bit for bit with tracing on and off.  The
CUDA-event timer and the clock of a launch are checked on the card only.
"""

import itertools
import json
import sys
import threading
import time
import tracemalloc
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mi_fieldcalc_tpu_torch.field import Field
from mi_fieldcalc_tpu_torch.models import ensemble
from mi_fieldcalc_tpu_torch.ops import fused
from mi_fieldcalc_tpu_torch.utils import profiling as tprof

torch.set_num_threads(1)


def _card(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: SimpleNamespace(name=name))


@pytest.mark.parametrize("name,rate,flops", [
    ("NVIDIA H100 80GB HBM3", 3.35e12, 67e12),
    ("NVIDIA H200", 4.8e12, 67e12)])
def test_published_rates_of_known_cards(monkeypatch, name, rate, flops):
    _card(monkeypatch, name)
    assert tprof.device_hbm_gbps(torch.device("cuda", 0)) == rate
    assert tprof.device_hbm_gbps() == rate
    assert tprof.device_f32_flops("cuda") == flops


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


# -- the program's spans and counters ---------------------------------------

def _cpu_session():
    """A host-only ``torch.profiler`` session."""
    return profile(activities=[ProfilerActivity.CPU])


def _inputs(nmem: int, nlev: int = 2, ny: int = 7, nx: int = 9,
            device="cpu"):
    """Member-stacked inputs of :func:`ensemble_derived_summary`, a few
    points of each field undefined."""
    g = torch.Generator().manual_seed(5 + nmem)

    def field(shape, lo, hi):
        v = lo + (hi - lo) * torch.rand(shape, generator=g)
        m = torch.rand(shape, generator=g) > 0.05
        return Field(v.to(device), m.to(device))

    shape = (nmem, nlev, ny, nx)
    fields = (field(shape, 255.0, 295.0), field(shape, 1e-4, 1e-2),
              field(shape, -12.0, 12.0), field(shape, -12.0, 12.0),
              field((nmem, ny, nx), 985.0, 1015.0))
    consts = (torch.linspace(0.0, 50.0, nlev, device=device),
              torch.linspace(1.0, 0.5, nlev, device=device),
              torch.full((ny, nx), 4.0e-7, device=device),
              torch.full((ny, nx), 3.6e-7, device=device), 1.2e-4)
    return fields + consts


def _member(args, m: int = 0):
    """The inputs of one member, as :func:`derived_fields_fused` takes
    them."""
    return tuple(Field(f.values[m], f.mask[m]) for f in args[:5]) + args[5:]


def test_no_session_records_nothing():
    tprof.take()
    with tprof.span("a"):
        with tprof.span("b"):
            tprof.count("c", 3)
    tprof.count("c")
    assert tprof.recorded() == tprof.Recording([], {})


def test_a_span_off_allocates_nothing_and_calls_no_clock_or_card(
        monkeypatch):
    def forbidden(*args, **kwargs):
        raise AssertionError("called with no profiler session on")

    assert tprof.span("off") is tprof.span("off")     # one shared object
    monkeypatch.setattr(tprof, "_clock", forbidden)
    monkeypatch.setattr(time, "time_ns", forbidden)
    monkeypatch.setattr(time, "perf_counter", forbidden)
    monkeypatch.setattr(torch.cuda, "Event", forbidden)
    monkeypatch.setattr(torch.cuda, "is_initialized", forbidden)
    monkeypatch.setattr(tprof, "_device_allocs", forbidden)

    @tprof.span("off.decorated")
    def work(x):
        return x + 1

    tracemalloc.start()
    try:
        work(1)
        before = tracemalloc.get_traced_memory()[0]
        for _ in itertools.repeat(None, 10000):
            with tprof.span("off"):
                pass
            work(1)
            tprof.count("off")
        after = tracemalloc.get_traced_memory()[0]
    finally:
        tracemalloc.stop()
    assert after - before == 0
    assert tprof.recorded().spans == []


def test_a_device_count_off_is_none_and_allocates_nothing(monkeypatch):
    """With no session on, a kernel's counter slot is None (a launch passes
    a null pointer), made without a tensor, a clock or a CUDA call."""
    def forbidden(*args, **kwargs):
        raise AssertionError("called with no profiler session on")

    monkeypatch.setattr(torch, "zeros", forbidden)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        forbidden)
    monkeypatch.setattr(tprof, "_clock", forbidden)
    tprof.take()
    assert tprof.device_count("off", "cpu") is None
    tracemalloc.start()
    try:
        tprof.device_count("off", "cpu")
        before = tracemalloc.get_traced_memory()[0]
        for _ in itertools.repeat(None, 10000):
            tprof.device_count("off", "cpu")
        after = tracemalloc.get_traced_memory()[0]
    finally:
        tracemalloc.stop()
    assert after - before == 0
    assert tprof.recorded() == tprof.Recording([], {})


def test_a_device_count_is_read_with_its_session():
    """Inside a session a kernel's counter is one slot a name and device,
    the same tensor on every call, zeroed once a session and made once a
    process; what the kernel added joins the session's counters when they
    are read, beside the host's counts, and reading twice adds nothing."""
    tprof.take()
    with _cpu_session():
        slot = tprof.device_count("kernel.n", "cpu")
        assert slot.shape == () and slot.dtype == torch.int64
        assert int(slot) == 0
        slot += 5
        assert tprof.device_count("kernel.n", torch.device("cpu")) is slot
        tprof.device_count("kernel.n", "cpu").add_(2)
        tprof.count("host.n", 3)
    assert tprof.recorded().counters == {"kernel.n": 7, "host.n": 3}
    assert tprof.recorded().counters == {"kernel.n": 7, "host.n": 3}
    with _cpu_session():
        again = tprof.device_count("kernel.n", "cpu")
        assert again is slot and int(again) == 0
        again += 4
    assert tprof.take().counters == {"kernel.n": 4}
    assert tprof.recorded().counters == {}
    with _cpu_session():
        with tprof.span("none counted"):
            pass
    assert tprof.take().counters == {}


def test_nesting_sets_parent_root_and_self_time():
    with _cpu_session():
        with tprof.span("outer"):
            with tprof.span("mid"):
                with tprof.span("inner"):
                    time.sleep(0.002)
            with tprof.span("mid"):
                time.sleep(0.001)
        with tprof.span("second"):
            pass
    rec = tprof.recorded()
    assert [s.name for s in rec.spans] == ["outer", "mid", "inner", "mid",
                                           "second"]
    outer, mid1, inner, mid2, second = rec.spans
    assert outer.parent is None and outer.root == outer.id
    assert mid1.parent == mid2.parent == outer.id and inner.parent == mid1.id
    assert {s.root for s in rec.spans[:4]} == {outer.id}
    assert second.parent is None and second.root == second.id != outer.id
    for s in rec.spans:
        assert s.start_ns <= s.end_ns
        assert s.ms == (s.end_ns - s.start_ns) / 1e6    # host clock
    assert outer.self_ms == pytest.approx(outer.ms - mid1.ms - mid2.ms,
                                          abs=1e-9)
    assert mid1.self_ms == pytest.approx(mid1.ms - inner.ms, abs=1e-9)
    assert inner.self_ms == inner.ms and inner.ms >= 2.0
    assert all(s.self_ms >= 0 for s in rec.spans)


def test_a_span_brackets_the_profiler_event_it_ran():
    """The clock test: the span's host window holds the ``aten::add_``
    that ran inside it, on the profiler's own timestamps."""
    x = torch.ones(4096)
    with _cpu_session() as prof:
        with tprof.span("add"):
            x.add_(1.0)
    (s,) = tprof.recorded().spans
    adds = [e for e in prof.profiler.kineto_results.events()
            if e.name() == "aten::add_"]
    assert len(adds) == 1
    start = adds[0].start_ns()
    assert s.start_ns <= start <= start + adds[0].duration_ns() <= s.end_ns


def test_two_sessions_each_read_their_own():
    with _cpu_session():
        with tprof.span("first"):
            tprof.count("n", 2)
    first = tprof.recorded()
    with _cpu_session():
        with tprof.span("second"):
            tprof.count("n", 5)
        with tprof.span("second"):
            pass
    second = tprof.recorded()
    assert [s.name for s in first.spans] == ["first"]
    assert first.counters == {"n": 2}
    assert [s.name for s in second.spans] == ["second", "second"]
    assert second.counters == {"n": 5}
    assert tprof.take() == second and tprof.recorded().spans == []


def test_a_decorated_function_is_spanned_on_every_call():
    @tprof.span("twice")
    def twice(x):
        """Twice x."""
        return 2 * x

    assert twice.__name__ == "twice" and twice.__doc__ == "Twice x."
    assert twice(3) == 6
    with _cpu_session():
        assert twice(4) == 8 and twice(5) == 10
    assert [s.name for s in tprof.take().spans] == ["twice", "twice"]


def test_threads_keep_their_own_stacks_and_counts_add_up():
    """Spans opened in several threads at once nest within their own
    thread, and no count is lost."""
    n_threads, reps = 8, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _cpu_session():
            def work(k):
                for _ in range(reps):
                    with tprof.span(f"t{k}"):
                        with tprof.span(f"t{k}.child"):
                            tprof.count("n")

            threads = [threading.Thread(target=work, args=(k,))
                       for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    rec = tprof.take()
    assert rec.counters == {"n": n_threads * reps}
    by_id = {s.id: s for s in rec.spans}
    assert len(by_id) == 2 * n_threads * reps
    for s in rec.spans:
        if s.name.endswith(".child"):
            assert by_id[s.parent].name == s.name[:-len(".child")]
            assert s.root == s.parent
        else:
            assert s.parent is None and s.root == s.id


@pytest.mark.parametrize("nmem", [1, 3])
def test_the_ensemble_summary_records_each_layer(nmem):
    args = _inputs(nmem)
    with _cpu_session():
        ensemble.ensemble_derived_summary(*args, fused=True)
    rec = tprof.take()
    by_id = {s.id: s for s in rec.spans}

    def children(s):
        return [c.name for c in rec.spans if c.parent == s.id]

    (top,) = [s for s in rec.spans if s.parent is None]
    assert top.name == "ensemble.summary"
    assert all(s.root == top.id for s in rec.spans)
    assert children(top) == ["ensemble.member_fields", "ensemble.reduce"]
    fields, reduce = (by_id[i] for i in sorted(
        s.id for s in rec.spans if s.parent == top.id))
    assert children(fields) == ["b1.kernel", "ensemble.member_stack"] * nmem
    stats = [s for s in rec.spans if s.parent == reduce.id]
    assert [s.name for s in stats] == ["ensemble.stats"] * 12
    assert not any(children(s) for s in stats)
    assert len(rec.spans) == 3 + 2 * nmem + 12
    assert rec.counters == {}           # no allocator counter off CUDA
    assert all(s.self_ms >= 0 for s in rec.spans)


def _same(a, b) -> bool:
    """Equal bit for bit, through NamedTuples of Fields."""
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, Field):
        return _same(a.values, b.values) and _same(a.mask, b.mask)
    return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("entry", ["ensemble_derived_summary",
                                   "derived_fields_fused"])
def test_outputs_are_the_same_with_tracing_on_and_off(entry):
    args = _inputs(3)
    if entry == "ensemble_derived_summary":
        def run():
            return ensemble.ensemble_derived_summary(*args, fused=True)
    else:
        def run():
            return fused.derived_fields_fused(*_member(args, 1))
    off = run()
    with _cpu_session():
        on = run()
    assert tprof.take().spans
    assert _same(off, on)


_META = torch.empty(2, device="meta")


@pytest.mark.parametrize("args,kwargs,device", [
    ((_META,), {}, "meta"),
    ((1.0, Field(_META, _META)), {}, "meta"),
    ((ensemble.EnsembleSummary(*[Field(_META, _META)] * len(
        ensemble.EnsembleSummary._fields)),), {}, "meta"),
    (([Field(_META, _META)],), {}, "meta"),
    ((3,), {"x": _META}, "meta"),
    ((torch.ones(1), _META), {}, "cpu"),
    ((1, "a", None), {}, None)], ids=[
        "tensor", "field", "named_tuple", "list", "keyword", "first",
        "none"])
def test_a_decorated_span_takes_the_device_of_its_arguments(args, kwargs,
                                                            device):
    got = tprof._device_of(args) or tprof._device_of(kwargs)
    assert got == (None if device is None else torch.device(device))


def _forbid(monkeypatch, *names):
    def forbidden(*args, **kwargs):
        raise AssertionError("a CUDA call for work on the host")

    for name in names:
        monkeypatch.setattr(torch.cuda, name, forbidden)


def test_work_on_the_host_keeps_the_host_clock_once_cuda_is_up(
        monkeypatch):
    """CUDA being up in the process (as after any test on the card) does
    not make a span over host work time an idle stream or read the
    allocator: the timer follows the work's device."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    _forbid(monkeypatch, "Event", "current_stream",
            "memory_stats_as_nested_dict", "is_current_stream_capturing")
    args = _inputs(2)
    with _cpu_session():
        with tprof.span("outer"):
            with tprof.span("inner"):
                time.sleep(0.002)
        ensemble.ensemble_derived_summary(*args, fused=True)
    rec = tprof.take()
    assert rec.counters == {}
    assert len(rec.spans) == 2 + 3 + 2 * 2 + 12
    for s in rec.spans:
        assert s.ms == (s.end_ns - s.start_ns) / 1e6
    assert rec.spans[1].ms >= 2.0


def test_spans_on_a_card_time_by_events_and_count_allocations(
        monkeypatch):
    """A span on a card is timed by a pair of events (here stand-ins that
    tick once a record), a block inside it takes its card, a block on the
    host keeps the host clock, and only a span asked to count
    allocations adds to ``allocator.device_allocs``, through
    :func:`count`."""
    ticks = itertools.count()

    class Event:
        def __init__(self, enable_timing=False):
            self.t = None

        def record(self, stream=None):
            self.t = next(ticks)

        def synchronize(self):
            pass

        def elapsed_time(self, end):
            return float(end.t - self.t)

    allocs = iter([10, 12, 99])
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: None)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(torch.cuda, "memory_stats_as_nested_dict",
                        lambda device: {"num_device_alloc": next(allocs)})
    added = []
    real_count = tprof.count
    monkeypatch.setattr(tprof, "count",
                        lambda name, n=1: (added.append((name, n)),
                                           real_count(name, n)))
    with _cpu_session():
        with tprof.span("root", torch.device("cuda", 0), count_allocs=True):
            with tprof.span("inner"):
                pass
            with tprof.span("host", "cpu"):
                time.sleep(0.001)
        with tprof.span("plain", "cuda"):
            pass
    rec = tprof.take()
    root, inner, host, plain = rec.spans
    assert (root.ms, inner.ms, plain.ms) == (3.0, 1.0, 1.0)
    assert host.ms == (host.end_ns - host.start_ns) / 1e6 >= 1.0
    assert root.self_ms == pytest.approx(3.0 - 1.0 - host.ms)
    assert rec.counters == {"allocator.device_allocs": 2}
    assert added == [("allocator.device_allocs", 2)]


@pytest.mark.cuda
def test_the_summary_on_the_card_and_then_on_the_host():
    """On the card the summary's spans are timed by events, its root
    counts the allocator's calls and its member loop the members written
    in place; after that, in the same process, the same summary on host
    tensors records host-clock spans and no counter."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    on_card = _inputs(2, device="cuda")
    ensemble.ensemble_derived_summary(*on_card, fused=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]):
        ensemble.ensemble_derived_summary(*on_card, fused=True)
        torch.cuda.synchronize()
    card = tprof.take()
    # the reductions' kernel: one ensemble.stats a field, nothing under it
    assert len(card.spans) == 3 + 2 * 2 + 12
    assert set(card.counters) == {"allocator.device_allocs",
                                  "ensemble.members_in_place"}
    assert card.counters["ensemble.members_in_place"] == 2
    assert all(s.ms > 0 for s in card.spans)
    # events, not the host clock: every span found its card
    assert all(s.ms != (s.end_ns - s.start_ns) / 1e6 for s in card.spans)
    with _cpu_session():
        ensemble.ensemble_derived_summary(*_inputs(2), fused=True)
        with tprof.span("sleep"):
            time.sleep(0.002)
    host = tprof.take()
    assert host.counters == {}
    assert len(host.spans) == 3 + 2 * 2 + 12 + 1
    for s in host.spans:
        assert s.ms == (s.end_ns - s.start_ns) / 1e6
    assert host.spans[-1].ms >= 2.0


@pytest.mark.cuda
def test_a_span_holds_its_launch_on_the_card():
    """In a CUDA-only session, as the benchmark's traced runs make, the
    host window of ``b1.kernel`` holds the start of its kernel's launch
    (the runtime call that shares the kernel's correlation id)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    from torch.autograd import DeviceType
    args = _member(_inputs(1, 4, 64, 96, device="cuda"))
    fused.derived_fields_fused(*args)
    torch.cuda.synchronize()
    clocks = {"time_ns": time.time_ns, "monotonic_ns": time.monotonic_ns,
              "perf_counter_ns": time.perf_counter_ns}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        before = {k: c() for k, c in clocks.items()}
        fused.derived_fields_fused(*args)
        after = {k: c() for k, c in clocks.items()}
        torch.cuda.synchronize()
    rec = tprof.take()
    (kernel,) = rec.spans
    assert kernel.name == "b1.kernel" and kernel.parent is None
    assert 0 < kernel.ms
    assert rec.counters == {}       # only the summary counts allocations
    events = list(prof.profiler.kineto_results.events())
    (b1,) = [e for e in events if e.device_type() == DeviceType.CUDA
             and "derived_fields_kernel" in e.name()]
    (launch,) = [e for e in events if e.device_type() == DeviceType.CPU
                 and e.correlation_id() == b1.correlation_id()]
    start = launch.start_ns()
    matched = [k for k in clocks if before[k] <= start <= after[k]]
    print(f"{launch.name()} at {start}: inside the {matched} windows")
    assert "time_ns" in matched
    assert kernel.start_ns <= start <= kernel.end_ns
