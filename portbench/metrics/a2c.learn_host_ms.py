"""Host ms a traced tick inside the port's learner spans (`mbots.learn.*`:
learner rows, forward, draw, gradient, Adam, write-back), less the env
wrappers (`mbots.env.*`) and the waits on the device (`mbots.sync.*`)
inside them."""

from portbench import spans


def read(run):
    learn = spans.program_spans(run, "mbots.learn.")
    if learn is None:
        return None
    other = spans.union(spans.named(run.trace, "mbots.env.")
                        + spans.named(run.trace, "mbots.sync."))
    return spans.ms_per_call(run, spans.subtract(learn, other))
