"""The port's blocking device-to-host reads an A2C tick, from its always-on
counters over the run (`host_syncs` over `learn_ticks`, as the driver
keeps them)."""


def read(run):
    counts = getattr(run.driver, "counts", None)
    if not run.traced_calls or not counts or not counts.get("learn_ticks"):
        return None
    return counts.get("host_syncs", 0) / counts["learn_ticks"]
