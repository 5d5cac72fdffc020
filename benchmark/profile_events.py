"""Reduction of a torch.profiler trace and of the program's finished
statement traces to what the per-layer readers read.

The arithmetic of the port's smoke run (`chip_smoke.py --profile`: the
device's own operations, the idle share, kernels by name), changed to
the union of the device's operation intervals over the whole traced
window, so work that overlaps counts once and the gaps between
statements count as idle.

All times are nanoseconds on the host's monotonic clock
(`time.perf_counter_ns`), the clock of the program's spans; the
profiler's own stamps are moved onto it by one offset taken when the
trace starts."""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

@dataclass
class DeviceTrace:
    """The device's operations in a traced window."""

    t0: int
    t1: int
    #: (name, start, end) of each operation, by start
    ops: list = field(default_factory=list)


def from_kineto(events, offset_ns: int, t0: int, t1: int) -> DeviceTrace:
    """`prof.profiler.kineto_results.events()` as a DeviceTrace over
    [t0, t1]; `offset_ns` is profiler clock minus host monotonic clock.
    The device's work is its kernels, copies and fills: every device
    event but the device-side twin of a host range, which only marks
    the range."""
    from torch.autograd import DeviceType

    trace = DeviceTrace(t0, t1)
    for e in events:
        if e.device_type() != DeviceType.CPU and not e.is_user_annotation():
            start = e.start_ns() - offset_ns
            trace.ops.append((e.name(), start, start + e.duration_ns()))
    trace.ops.sort(key=lambda o: o[1])
    return trace


def merged(trace: DeviceTrace) -> list:
    """The union of the operations' intervals, clipped to the window."""
    out = []
    for _n, s, t in trace.ops:
        s, t = max(s, trace.t0), min(t, trace.t1)
        if t <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def busy_ns(trace: DeviceTrace) -> int:
    """Nanoseconds of the window in which some operation ran."""
    return sum(t - s for s, t in merged(trace))


def idle_gaps(trace: DeviceTrace) -> list:
    """(start, end) of each stretch of the window with nothing running."""
    gaps, at = [], trace.t0
    for s, t in merged(trace):
        if s > at:
            gaps.append((at, s))
        at = t
    if trace.t1 > at:
        gaps.append((at, trace.t1))
    return gaps


def ops_in_window(trace: DeviceTrace) -> list:
    return [o for o in trace.ops if o[1] < trace.t1 and o[2] > trace.t0]


def time_by_name(trace: DeviceTrace) -> list:
    """[(name, seconds)] of the device's operations, most time first."""
    acc = {}
    for name, s, t in ops_in_window(trace):
        acc[name] = acc.get(name, 0) + (t - s)
    return sorted(((n, v / 1e9) for n, v in acc.items()),
                  key=lambda x: -x[1])


@dataclass
class Span:
    name: str
    start: int
    end: int
    self_ns: int
    depth: int


def flatten(root) -> list:
    """A finished statement trace's span tree (objects with `name`,
    `start_ns`, `dur_ns`, `children`) as Spans with self time: the
    span's duration less what its children cover."""
    out = []

    def walk(sp, depth):
        end = sp.start_ns + sp.dur_ns
        cover, at = 0, sp.start_ns
        for c in sorted(sp.children, key=lambda c: c.start_ns):
            s, t = max(c.start_ns, at), min(c.start_ns + c.dur_ns, end)
            if t > s:
                cover += t - s
                at = t
        out.append(Span(sp.name, sp.start_ns, end,
                        max(sp.dur_ns - cover, 0), depth))
        for c in sp.children:
            walk(c, depth + 1)

    walk(root, 0)
    return out


def label_gaps(gaps: list, spans: list, top: int = 10) -> list:
    """[(label, seconds)] of the `top` longest idle gaps, each labelled
    with the innermost program span open at its midpoint (the latest
    started among the deepest), or 'no statement' where none was."""
    spans = sorted(spans, key=lambda s: s.start)
    starts = [s.start for s in spans]
    out = []
    for s, t in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = (s + t) // 2
        best = None
        for sp in spans[:bisect.bisect_right(starts, mid)]:
            if sp.end >= mid and (best is None or (sp.depth, sp.start)
                                  > (best.depth, best.start)):
                best = sp
        out.append((best.name if best else "no statement", (t - s) / 1e9))
    return out
