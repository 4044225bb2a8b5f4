"""Device operations a traced tick launched inside one of the port's spans
(`mbots.*`). The backward runs on autograd's device thread, whose host
events the trace does not keep, so the count is every device operation of
the trace less those the window's thread launched outside the port's
spans."""

from portbench import spans


def read(run):
    program = spans.program_spans(run)
    if program is None or not run.trace.ops:
        return None
    outside = spans.complement(program, -1, 1 << 62)
    return (len(run.trace.ops) - spans.launched_inside(run.trace, outside)) / run.traced_calls
