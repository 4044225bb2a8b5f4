"""Arithmetic shared by the metric readers in `metrics/`. Each returns None
where the run has nothing to read, and the reader then reports nothing."""

from __future__ import annotations


def device_idle(run) -> float | None:
    """% of the traced window in which no operation ran on the device."""
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def roofline(run, kernel: str, bound_attr: str) -> float | None:
    """% of the kernel's traced device time that its bound (counted from
    the traced steps' data) takes."""
    bound = getattr(run.driver, bound_attr, None)
    times = run.trace.durations(kernel) if run.trace is not None else []
    if not bound or not times:
        return None
    return 100.0 * bound / (sum(times) / len(times))
