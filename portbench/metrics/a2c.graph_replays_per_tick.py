"""CUDA graph replays of the CLI's loop body an A2C tick, from the port's
always-on counters over the run (`tick_graph_replays` over `learn_ticks`,
as the cell's `Driver` keeps them): 1 where every tick past the eager
warm-up is a replay, 0 from a program that replays none or has no such
counter."""


def read(run):
    counts = getattr(run.driver, "counts", None)
    if not run.traced_calls or not counts or not counts.get("learn_ticks"):
        return None
    return counts.get("tick_graph_replays", 0) / counts["learn_ticks"]
