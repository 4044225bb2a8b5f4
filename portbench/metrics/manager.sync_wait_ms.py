"""Host ms a traced call inside the port's blocking device-to-host reads
(`mbots.sync.*`): the host waiting on the device."""

from portbench import spans


def read(run):
    sync = spans.program_spans(run, "mbots.sync.")
    return None if sync is None else spans.ms_per_call(run, sync)
