"""Profiling helpers.

Counterpart of `madrona_bots_tpu/utils/profiling.py`. The reference's only
tracing is wall-clock step timing streamed to wandb (SURVEY §5); here the
same light timer, and a `torch.profiler` trace of the host and the card,
written for TensorBoard, when asked for.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import torch
from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler


def _cuda_devices(out) -> set:
    """The CUDA devices of the tensors in `out` (nested tuples, lists and
    dicts)."""
    if isinstance(out, torch.Tensor):
        return {out.device} if out.is_cuda else set()
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        return set().union(*(_cuda_devices(o) for o in out)) if out else set()
    if hasattr(out, "__dataclass_fields__"):
        return _cuda_devices([getattr(out, f) for f in out.__dataclass_fields__])
    return set()


class StepTimer:
    """Wall-clock timing of calls.

    `timed(fn, *args)` runs fn, waits for the devices of its result's CUDA
    tensors, records the elapsed time and returns the result. (A context
    manager cannot see the body's output: with asynchronous launches it
    would record the enqueue, not the execution.)"""

    def __init__(self):
        self.times: List[float] = []

    def timed(self, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        for dev in _cuda_devices(out):
            torch.cuda.synchronize(dev)
        self.times.append(time.perf_counter() - t0)
        return out

    def fps(self, num_worlds: int, skip_first: int = 1) -> float:
        ts = self.times[skip_first:] or self.times
        return num_worlds / (sum(ts) / len(ts))

    def summary(self) -> Dict[str, float]:
        ts = self.times[1:] or self.times
        return {"mean_s": sum(ts) / len(ts), "min_s": min(ts),
                "max_s": max(ts), "n": len(ts)}


@contextlib.contextmanager
def device_trace(logdir: Optional[str]):
    """A torch.profiler trace of the host and, where there is one, the card,
    written to `logdir` for TensorBoard. Does nothing if logdir is falsy, so
    call sites can be unconditional."""
    if not logdir:
        yield
        return
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
