"""The device trace of a traced run, read from `torch.profiler`'s own
events: device operations with their times, the benchmark's spans (CPU
user annotations named `portbench.*`) and the launch time of each device
operation (its runtime call, matched by correlation id)."""

from __future__ import annotations

import bisect
from collections import defaultdict

SPAN_PREFIX = "portbench."


class Trace:
    """`start_ns` / `end_ns`: the traced window on the host's wall clock, the
    clock the profiler's events are stamped in."""

    def __init__(self, prof, start_ns: int, end_ns: int):
        import torch

        cpu = torch.autograd.DeviceType.CPU
        self.start_ns, self.end_ns = start_ns, end_ns
        self.window_s = (end_ns - start_ns) / 1e9
        self.ops = []                      # device operations: (start, end, name, corr)
        self.spans = defaultdict(list)     # span name -> [(start, end)] on the host
        self.launch = {}                   # correlation id -> host time of the call
        host = defaultdict(list)           # thread -> [(start, end, name)]
        for e in prof.profiler.kineto_results.events():
            name, s = e.name(), e.start_ns()
            end = s + e.duration_ns()
            annotation = e.is_user_annotation() or name.startswith(SPAN_PREFIX)
            if e.device_type() == cpu:
                if annotation:
                    self.spans[name].append((s, end))
                elif e.correlation_id():
                    self.launch[e.correlation_id()] = s
                host[e.start_thread_id()].append((s, end, name))
            elif not annotation:
                self.ops.append((s, end, name, e.correlation_id()))
        self.ops.sort()
        # The thread that ran the window holds the benchmark's spans.
        main = max(host, key=lambda t: sum(n.startswith(SPAN_PREFIX) for _, _, n in host[t]),
                   default=None)
        self.host = sorted(host.get(main, []))
        for v in self.spans.values():
            v.sort()

    # ---- device time ----

    def busy_intervals(self):
        """The device's busy time as disjoint [start, end) intervals."""
        merged = []
        for s, e, _, _ in self.ops:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def durations(self, needle: str) -> list[float]:
        """Seconds of each device operation whose name contains `needle`."""
        return [(e - s) / 1e9 for s, e, n, _ in self.ops if needle in n]

    def span_device_s(self, span: str) -> float | None:
        """Device seconds of the operations launched inside the spans named
        `span`; None where the trace has no such span."""
        iv = self.spans.get(span)
        if not iv:
            return None
        starts = [s for s, _ in iv]
        total = 0
        for s, e, _, corr in self.ops:
            t = self.launch.get(corr)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= iv[i][1]:
                total += e - s
        return total / 1e9

    # ---- breakdown ----

    def top_ops(self, n: int = 10) -> list:
        per = defaultdict(int)
        for s, e, name, _ in self.ops:
            per[name[:120]] += e - s
        return [[k, v / 1e9] for k, v in sorted(per.items(), key=lambda kv: -kv[1])[:n]]

    def doing(self, t: int) -> str:
        """What the window's host thread was doing at time t: its innermost
        benchmark span and its innermost other operation."""
        span = op = None
        for s, e, name in self.host:
            if s > t:
                break
            if e >= t:
                if name.startswith(SPAN_PREFIX):
                    span = name
                else:
                    op = name
        return f"{span or 'window'}: {op or 'python'}"

    def idle_gaps(self, n: int = 10) -> list:
        """The n longest stretches of the window with no device operation,
        each named by what the host was doing at its middle."""
        gaps, t = [], self.start_ns
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((s - t, t))
            t = max(t, e)
        if self.end_ns > t:
            gaps.append((self.end_ns - t, t))
        gaps.sort(reverse=True)
        return [[self.doing(t0 + d // 2), d / 1e9] for d, t0 in gaps[:n]]
