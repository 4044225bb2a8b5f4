"""Interval arithmetic over a traced run's host events, for the readers of
the program's own spans (`mbots.*`, recorded by the port under the
profiler).

Intervals are (start, end) pairs in the trace's nanoseconds; a set of them
is kept as a sorted list of disjoint intervals. The program's spans share
the clock of the device operations in the same trace, so host spans and
device idle time intersect directly.
"""

from __future__ import annotations

import bisect

PROGRAM = "mbots."
"""The prefix of the program's span names."""


def union(intervals) -> list:
    """The sorted disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        elif e > s:
            out.append((s, e))
    return out


def length(disjoint) -> int:
    return sum(e - s for s, e in disjoint)


def intersect(a, b) -> list:
    """The intersection of two disjoint sorted sets."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(a, b) -> list:
    """The part of disjoint sorted set `a` outside disjoint sorted set `b`."""
    return intersect(a, complement(b, a[0][0], a[-1][1])) if a else []


def complement(disjoint, start: int, end: int) -> list:
    """[start, end) less a disjoint sorted set."""
    out, t = [], start
    for s, e in disjoint:
        if s > t:
            out.append((t, min(s, end)))
        t = max(t, e)
        if t >= end:
            break
    if t < end:
        out.append((t, end))
    return [(s, e) for s, e in out if s < e]


def named(trace, prefix: str) -> list:
    """The union of the window thread's host events whose names start with
    `prefix` (the program records its spans as profiler events, not as
    annotations, so they are read from `Trace.host`)."""
    return union((s, e) for s, e, name in trace.host if name.startswith(prefix))


def device_idle(trace) -> list:
    """The traced window less the device's busy time."""
    return complement(trace.busy_intervals(), trace.start_ns, trace.end_ns)


LAUNCHES = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cuMemcpy", "cudaMemset", "cuMemset")
"""Name prefixes of the runtime and driver calls that put an operation on
the device: kernel launches, copies and fills."""


def launched_inside(trace, disjoint) -> int:
    """The window thread's launch calls (`LAUNCHES`) that start inside a
    disjoint sorted set: one a device operation. Counted on the host, not
    through `Trace.launch`, whose map by correlation id holds the CPU
    operator that shares an id with a runtime call for about a third of
    the device operations."""
    starts = [s for s, _ in disjoint]
    n = 0
    for t, _, name in trace.host:
        if name.startswith(LAUNCHES):
            i = bisect.bisect_right(starts, t) - 1
            n += i >= 0 and t <= disjoint[i][1]
    return n


def ms_per_call(run, disjoint) -> float:
    return length(disjoint) / 1e6 / run.traced_calls


def program_spans(run, prefix: str = PROGRAM) -> list | None:
    """The union of the program's spans under `prefix` in a traced run;
    None where the run has no trace or the program no such span."""
    if run.trace is None or not run.traced_calls:
        return None
    return named(run.trace, prefix) or None
