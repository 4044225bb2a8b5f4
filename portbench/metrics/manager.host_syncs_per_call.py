"""The port's blocking device-to-host reads a SimManager step, from its
always-on counters over the whole process (`host_syncs` over `steps`; the
constructor's one read counts too)."""


def read(run):
    if not run.traced_calls:
        return None
    from madrona_bots_tpu_torch.utils import profiling
    counts = getattr(profiling, "counts", None)
    if counts is None:
        return None
    c = counts()
    return c.get("host_syncs", 0) / c["steps"] if c.get("steps") else None
