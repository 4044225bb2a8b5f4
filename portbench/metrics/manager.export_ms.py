"""Device ms a step of the operations launched under the benchmark's export
spans: the export order and refresh inside `step()` and the 12 getters."""


def read(run):
    if run.trace is None:
        return None
    s = run.trace.span_device_s("portbench.export")
    return None if s is None else 1e3 * s / run.traced_calls
