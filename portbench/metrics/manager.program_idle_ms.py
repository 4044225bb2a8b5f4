"""Ms a traced call in which the device is idle while the host is inside
one of the port's spans (`mbots.*`): the idle the port's own host work
leaves. The rest of `manager.device_idle` is the caller's, the benchmark's
and the profiler's."""

from portbench import spans


def read(run):
    program = spans.program_spans(run)
    if program is None or run.trace.busy_s <= 0:
        return None
    return spans.ms_per_call(run, spans.intersect(spans.device_idle(run.trace), program))
