"""Device operations a traced call launched from inside one of the port's
spans (`mbots.*`): the kernel launches, copies and fills the window's
thread calls there."""

from portbench import spans


def read(run):
    program = spans.program_spans(run)
    if program is None or not run.trace.ops:
        return None
    return spans.launched_inside(run.trace, program) / run.traced_calls
