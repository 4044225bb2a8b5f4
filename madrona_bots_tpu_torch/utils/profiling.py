"""Profiling: spans and counters inside the port, and a trace for TensorBoard.

Counterpart of `madrona_bots_tpu/utils/profiling.py`. The reference's only
tracing is wall-clock step timing streamed to wandb (SURVEY §5). Here:

- `span(name)`: an event of the recording profiler's own (`RecordFunction`,
  as `torch.compile`'s generated code annotates its calls), else one shared
  no-op context. The events carry the profiler's timestamps, so they line
  up with the device operations of the same trace, and the runtime calls
  made inside them carry the correlation ids of the operations they launch.
  Parents come from nesting on one thread. The port's spans are named
  `mbots.<layer>.<part>`.
- `count(name, n)`: always-on integer counters in one process-wide table,
  read with `counts()` without a profiler. The SimManager counts `steps`
  and `host_syncs` (each blocking device-to-host read, `host_sync`), the
  export-row kernel's wrapper `export_launches`, the A2C tick
  `learn_ticks` and `learner_rows`, the CLI's loop graph
  (`learn/tick_graph.py`) `tick_graph_captures` and `tick_graph_replays`,
  the counter RNG (`rng.py`) `rng_kernel_calls` and `rng_plain_calls`.
- `device_trace(logdir)`: a profiler over a block, written for TensorBoard,
  so an operator sees the spans beside the host and card timelines.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

_OFF = contextlib.nullcontext()
_event = torch._C._profiler._RecordFunctionFast
_counts: Dict[str, int] = {}


def span(name: str):
    """A context that records its block as the event `name` in a recording
    profiler, else a shared no-op. The check reads the flag that torch's
    profilers set on start and clear on stop (a module attribute: the C
    query costs twice the whole no-op span). Under the profiler the C++
    event costs about a tenth of `torch.profiler.record_function`, whose
    enter and exit are two profiled operator calls."""
    return _event(name) if _autograd_profiler._is_profiler_enabled else _OFF


def recording() -> bool:
    """Whether a torch profiler records: the flag `span` reads."""
    return _autograd_profiler._is_profiler_enabled


def count(name: str, n: int = 1) -> None:
    _counts[name] = _counts.get(name, 0) + n


def counts() -> Dict[str, int]:
    """A copy of the counters since the process started or `reset_counts`."""
    return dict(_counts)


def reset_counts() -> None:
    _counts.clear()


def host_sync(site: str):
    """A blocking device-to-host read at `site`: counted in `host_syncs` on
    every device (on the CPU the read does not block, but the site is the
    same) and spanned as `mbots.sync.<site>`, so a trace shows the host's
    wait on the device."""
    count("host_syncs")
    return span("mbots.sync." + site)


@contextlib.contextmanager
def device_trace(logdir: Optional[str]):
    """A torch.profiler trace of the host and, where there is one, the card,
    written to `logdir` for TensorBoard, with the port's `mbots.*` spans.
    Does nothing if logdir is falsy, so call sites can be unconditional."""
    if not logdir:
        yield
        return
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
