"""Host ms a traced call inside the port's env wrappers (`mbots.env.*`: the
systems and raycast wrappers' checks and launches), less the host's waits
on the device inside them (`mbots.sync.*`)."""

from portbench import spans


def read(run):
    env = spans.program_spans(run, "mbots.env.")
    if env is None:
        return None
    return spans.ms_per_call(run, spans.subtract(env, spans.named(run.trace, "mbots.sync.")))
