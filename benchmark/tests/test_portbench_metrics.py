"""The metric arithmetic on a recorded window: the profiler's events
reduced to the device's busy time, idle gaps and named-range time, the
program's spans to self time, and each reader's number."""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from benchmark import harness
from benchmark import profile_events as pe

FIX = json.loads((Path(__file__).parent / "fixtures"
                  / "window_small.json").read_text())


class FakeEvent:
    """The accessors of a profiler event (`_KinetoEvent`) the reduction
    reads."""

    def __init__(self, d):
        self.d = d

    def name(self):
        return self.d["name"]

    def device_type(self):
        return DeviceType.CPU if self.d["device"] == "cpu" else DeviceType.CUDA

    def is_user_annotation(self):
        return self.d["kind"] in ("user_annotation", "gpu_user_annotation")

    def start_ns(self):
        return self.d["start"]

    def duration_ns(self):
        return self.d["dur"]


@pytest.fixture
def trace():
    return pe.from_kineto([FakeEvent(e) for e in FIX["events"]],
                          FIX["offset_ns"], FIX["t0"], FIX["t1"])


def test_reduction(trace):
    want = FIX["expect"]
    assert len(trace.ops) == want["ops"]  # host events and the twin are no work
    assert pe.busy_ns(trace) == want["busy_ns"]
    assert [list(g) for g in pe.idle_gaps(trace)] == want["gaps"]
    names = dict(pe.time_by_name(trace))
    assert names["k_add"] == pytest.approx(350e-9)


def _window(trace, n=4, **kw):
    stmts = [{"shape": "q", "t_send": 0.0, "t_done": 0.1 * (i + 1), "ok": 1,
              "rows_read": 1000, "bytes_least": 335.0} for i in range(n)]
    return harness.Window(seconds=2.0, setup_s=12.5, stmts=stmts,
                          in_window=stmts[:3],
                          trace=trace, **kw)


def _read(name, w):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py").read(w)


def test_device_readers(trace):
    w = _window(trace, peaks={"hbm_bytes_per_s": 3.35e12})
    assert _read("device_idle_pct", w) == pytest.approx(50.0)
    assert _read("launches_per_stmt", w) == pytest.approx(1.0)
    # 4 statements x 335 B at 3.35e12 B/s = 4e-10 s against 500 ns busy
    assert _read("hbm_roofline_pct", w) == pytest.approx(100 * 4e-10 / 5e-7)


def test_readers_without_a_trace_return_nothing():
    w = _window(None)
    for name in ("device_idle_pct", "launches_per_stmt", "hbm_roofline_pct",
                 "frontend_ms", "plan_cache_hit_pct"):
        assert _read(name, w) is None


def test_end_to_end_readers():
    w = _window(None)
    assert _read("rows_per_s", w) == pytest.approx(3 * 1000 / 2.0)
    assert _read("stmt_p95_ms", w) == pytest.approx(400.0)  # nearest rank
    assert _read("setup_s", w) == 12.5


def _span(name, start, dur, children=()):
    return SimpleNamespace(name=name, start_ns=start, dur_ns=dur,
                           children=list(children))


def test_front_end_readers():
    root = _span("session.execute", 0, 1000, [
        _span("parse", 0, 100),
        _span("plan", 100, 300, [_span("copr.compile", 150, 100)]),
        _span("executor.next", 400, 600)])
    spans = pe.flatten(root)
    assert {s.name: s.self_ns for s in spans} == {
        "session.execute": 0, "parse": 100, "plan": 200,
        "copr.compile": 100, "executor.next": 600}
    w = _window(None, spans=spans, n_traces=2,
                counters={"plan_cache_hits_total": 3.0,
                          "plan_cache_misses_total": 1.0})
    assert _read("frontend_ms", w) == pytest.approx(300 / 1e6 / 2)
    assert _read("plan_cache_hit_pct", w) == pytest.approx(75.0)


def test_idle_gaps_are_labelled_by_the_open_span(trace):
    spans = pe.flatten(_span("session.execute", 0, 1000, [
        _span("parse", 0, 100), _span("copr.readback", 650, 300)]))
    got = pe.label_gaps(pe.idle_gaps(trace), spans)
    assert got == [("session.execute", 200e-9), ("copr.readback", 200e-9),
                   ("parse", 100e-9)]
