"""The CLI's A2C loop body replayed as one CUDA graph.

`training_loop.run_tick` runs an epoch as: split the carried key, run the
tick under the second half, stack its metrics into one vector, and copy
that vector to the host, the loop's one blocking read. Eagerly, everything
before the copy is ~2,500 small launches, and the host's enqueue of them,
not the card, paces the loop. A `TickGraph` (one per tick that
`a2c.make_train_tick` builds without a mesh) records those launches once
as a CUDA graph and replays it on every later call with a CUDA state:

- The first `WARMUP_CALLS` calls of a signature (the shapes, dtypes and
  devices of the state, the train states and the key) run the body eagerly
  on a side stream. They are real ticks. They also make what a capture
  cannot make: the kernels' builds, the device constants, the cuBLAS
  handles of the calling thread and of autograd's device thread.
- The next call copies the caller's inputs into the graph's own buffers
  (the state's fields, and one flat buffer that holds the train states and
  the key), captures the body over them on that stream, and replays the
  graph once: a capture runs nothing. At the graph's end the new state is
  copied into the state buffers, and the new train states and key into the
  flat buffer.
- Each later call copies into those buffers what the caller passes that is
  not already there (nothing of the state the last call returned; one copy
  of the flat buffer for its train states and key), replays the graph, and
  returns the state buffers and a clone of the flat buffer.

So train states and keys are never written in place, as on the eager
path, and the state is written in place, as the eager tick writes it: a
state that a call returned is written by the next call of the same tick.
The graph runs the eager launches in their order, on the same inputs, so
its results equal the eager ones.

Counters count real ticks. The capture counts the tick's counters
(`learn_ticks`, `learner_rows`, `rng_kernel_calls`) once, as the eager
tick would, and each later replay adds what the capture counted.
`tick_graph_captures` counts captures, `tick_graph_replays` replays (the
capturing call's included).
The kernels' own launch tallies (`ops/*_cuda.launches`) count wrapper
calls, so they leave replays out. Nothing is captured while a profiler
records, and the spans inside the graph are not recorded on a replay: the
replay and its copies are the span `mbots.learn.tick`.
"""

from __future__ import annotations

from typing import Callable

import torch

from madrona_bots_tpu_torch.env.state import FIELDS, WorldState
from madrona_bots_tpu_torch.utils import profiling

WARMUP_CALLS = 2
"""Eager calls of a signature before its capture."""

_ALIGN = 16
"""Byte alignment of each leaf in the flat buffer."""


def leaves(tree) -> list:
    """The tensors of a train state, a tuple of them, or a tensor, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for x in tree for t in leaves(x)]


def rebuild(like, tensors):
    """`like`'s structure (tuples and named tuples of tensors) holding the
    tensors of the iterator `tensors`, in `leaves` order."""
    if isinstance(like, torch.Tensor):
        return next(tensors)
    parts = [rebuild(x, tensors) for x in like]
    return tuple(parts) if type(like) is tuple else type(like)(*parts)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _padded(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def flat_bytes(like: list) -> int:
    """The size of a flat buffer that holds the tensors of `like`."""
    return sum(_padded(_nbytes(t)) for t in like)


def flat_views(flat: torch.Tensor, like: list) -> list:
    """Views of the uint8 buffer `flat`, one a tensor of `like` with its
    dtype and shape, each at a multiple of `_ALIGN` bytes."""
    out, at = [], 0
    for t in like:
        out.append(flat[at:at + _nbytes(t)].view(t.dtype).view(t.shape))
        at += _padded(_nbytes(t))
    return out


def _write_back(outs: list, bufs: list) -> None:
    """Copy each output into its buffer; an output that shares memory with
    any buffer but is not its own is cloned first, so no copy reads what
    another has written."""
    held = {b.untyped_storage().data_ptr() for b in bufs}
    srcs = [o if o is b or o.untyped_storage().data_ptr() not in held else o.clone()
            for o, b in zip(outs, bufs)]
    for s, b in zip(srcs, bufs):
        if s is not b:
            b.copy_(s)


class TickGraph:
    """The captured loop body of one tick; see the module's docstring.
    `body(state, train_states, key)` returns (state, train states, carried
    key, metric names, stacked metrics)."""

    def __init__(self):
        self._sig = None
        self._graph = None
        self._stream = None

    def __call__(self, body: Callable, state: WorldState, train_states, key: torch.Tensor):
        ins = leaves(train_states) + [key]
        sig = tuple((t.shape, t.dtype, t.device)
                    for t in [getattr(state, f) for f in FIELDS] + ins)
        if sig != self._sig:
            self._sig, self._graph, self._eager_left = sig, None, WARMUP_CALLS
        if self._graph is not None:
            return self._replay(state, ins)
        if self._eager_left > 0 or profiling.recording():
            self._eager_left -= 1
            return self._eager(body, state, train_states, key)
        return self._capture(body, state, train_states, ins)

    def _eager(self, body, state, train_states, key):
        dev = state.device
        if self._stream is None or self._stream.device != dev:
            self._stream = torch.cuda.Stream(dev)
        cur = torch.cuda.current_stream(dev)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            out = body(state, train_states, key)
        cur.wait_stream(self._stream)
        return out

    def _capture(self, body, state, train_states, ins):
        self._fields = [getattr(state, f).clone() for f in FIELDS]
        self._flat = torch.empty(flat_bytes(ins), dtype=torch.uint8, device=state.device)
        self._views = flat_views(self._flat, ins)
        for v, t in zip(self._views, ins):
            v.copy_(t)
        self._like = rebuild(train_states, iter(self._views[:-1]))
        before = profiling.counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=self._stream):
            new_state, new_ts, key, names, stacked = body(
                WorldState(**dict(zip(FIELDS, self._fields))), self._like, self._views[-1])
            _write_back([getattr(new_state, f) for f in FIELDS], self._fields)
            _write_back(leaves(new_ts) + [key], self._views)
        self._counted = {k: n - before.get(k, 0) for k, n in profiling.counts().items()
                         if n != before.get(k, 0)}
        self._graph, self._names, self._stacked = graph, names, stacked
        profiling.count("tick_graph_captures")
        return self._launch()

    def _replay(self, state, ins):
        with profiling.span("mbots.learn.tick"):
            for f, buf in zip(FIELDS, self._fields):
                t = getattr(state, f)
                if t is not buf:
                    buf.copy_(t)
            if all(a is b for a, b in zip(ins, self._returned)):
                self._flat.copy_(self._returned_flat)
            else:
                for v, t in zip(self._views, ins):
                    v.copy_(t)
            for k, n in self._counted.items():
                profiling.count(k, n)
            return self._launch()

    def _launch(self):
        self._graph.replay()
        profiling.count("tick_graph_replays")
        self._returned_flat = self._flat.clone()
        self._returned = flat_views(self._returned_flat, self._views)
        return (WorldState(**dict(zip(FIELDS, self._fields))),
                rebuild(self._like, iter(self._returned[:-1])), self._returned[-1],
                self._names, self._stacked)
