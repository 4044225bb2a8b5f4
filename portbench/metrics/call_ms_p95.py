"""95th percentile of the host ms of each synchronised call in the window."""

from portbench.core import percentile


def read(run):
    return 1e3 * percentile(run.call_s, 95)
