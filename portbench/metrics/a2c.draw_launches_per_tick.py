"""Device operations a traced tick launched inside the port's action-draw
spans (`mbots.learn.draw`: the species' categorical draws, threefry in
int64 torch ops), counted by the window thread's launch calls."""

from portbench import spans


def read(run):
    draw = spans.program_spans(run, "mbots.learn.draw")
    if draw is None or not run.trace.ops:
        return None
    return spans.launched_inside(run.trace, draw) / run.traced_calls
