"""Host ms a traced call inside the SimManager's own spans
(`mbots.manager.*`: step, write-back, order, refresh, each export built,
shift), less the time the env wrappers (`mbots.env.*`) and the waits on the
device (`mbots.sync.*`) cover."""

from portbench import spans


def read(run):
    mgr = spans.program_spans(run, "mbots.manager.")
    if mgr is None:
        return None
    other = spans.union(spans.named(run.trace, "mbots.env.")
                        + spans.named(run.trace, "mbots.sync."))
    return spans.ms_per_call(run, spans.subtract(mgr, other))
