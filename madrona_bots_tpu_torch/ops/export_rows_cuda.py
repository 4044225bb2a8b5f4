"""The SimManager's export-row kernel: its wrapper and plain versions.

`gather` and `scatter` launch `csrc/export_rows.cu` on CUDA tensors and run
`gather_reference` / `scatter_reference` on CPU tensors. They move the rows
of the SimManager's exports (`api/manager.py`), several fields a launch,
each in its own dtype: the exports of a tick in one launch, the refresh of
the action and hidden buffers in one, their write-back into the state in
one. The JAX package moves the same rows on the host, in its C++ library,
so the kernel replaces no Pallas kernel.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from madrona_bots_tpu_torch.ops import _build
from madrona_bots_tpu_torch.utils import native, profiling

launches = 0
"""Launches of the export-row kernel since the count was last set to 0."""

MAX_FIELDS = 16
_ARGS = ([ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2)
_RECORD = 5
"""int64 a field in the launch: src, dst, row bytes, access bytes, convert."""

Pair = Tuple[torch.Tensor, torch.Tensor]
"""(src, dst): 2-D contiguous row tensors of one width."""


def access_bytes(row_bytes: int, *addrs: int) -> int:
    """Bytes a memory access of one field in the kernel: the largest of 16,
    8, 4, 2 and 1 that divides the row's bytes and every pointer, so that
    every row of the field is aligned to it (the lowest set bit of them
    all, at most 16)."""
    bits = row_bytes
    for a in addrs:
        bits |= a
    return min(16, bits & -bits) if bits else 16


def gather_reference(perm: torch.Tensor, pairs: Sequence[Pair]) -> None:
    """dst[r] = src[perm[r]] for r < len(perm), field by field
    (`native.gather_rows`), converted to dst's dtype."""
    for src, dst in pairs:
        dst[: perm.numel()] = native.gather_rows(src, perm)


def scatter_reference(order: torch.Tensor, valid: int, pairs: Sequence[Pair]) -> None:
    """dst[order[i]] = src[i] for i < valid and a zero row for valid <= i <
    len(order), field by field (`native.scatter_rows`)."""
    for src, dst in pairs:
        rows = torch.cat((src[:valid], src.new_zeros((order.numel() - valid, src.shape[1]))))
        native.scatter_rows(rows.to(dst.dtype), order, dst)


def _records(kind: str, order: torch.Tensor, pairs: Sequence[Pair], src_rows: int,
             dst_rows: int, exact: bool) -> List[int]:
    """Raise unless the kernel takes these arguments; else the launch's
    field records, _RECORD ints a field with rows of bytes to move."""
    if order.dtype != torch.int64 or order.dim() != 1 or not order.is_contiguous():
        raise ValueError(f"export_rows {kind}: the order must be a contiguous 1-D int64 "
                         f"tensor, got {order.dtype} {tuple(order.shape)}")
    if not 1 <= len(pairs) <= MAX_FIELDS:
        raise ValueError(f"export_rows {kind}: 1 to {MAX_FIELDS} fields, got {len(pairs)}")
    dev = order.get_device()
    records = []
    for i, (src, dst) in enumerate(pairs):
        ss, ds = src.shape, dst.shape
        if not (len(ss) == 2 and len(ds) == 2 and ss[1] == ds[1] and ss[0] >= src_rows
                and (ds[0] == dst_rows if exact else ds[0] >= dst_rows)
                and src.is_contiguous() and dst.is_contiguous()
                and src.get_device() == dev and dst.get_device() == dev):
            raise ValueError(
                f"export_rows {kind}: field {i} needs contiguous [rows, d] src (>= {src_rows} "
                f"rows) and dst ({'' if exact else '>= '}{dst_rows} rows) of one width on "
                f"{order.device}, got {tuple(ss)} on {src.device} and {tuple(ds)} on "
                f"{dst.device}")
        if src.dtype == dst.dtype:
            convert = 0
        elif src.dtype == torch.int32 and dst.dtype == torch.float32:
            convert = 1
        else:
            raise ValueError(f"export_rows {kind}: field {i} from {src.dtype} into {dst.dtype}; "
                             f"the kernel copies a dtype or converts int32 into float32")
        rb = ss[1] * src.element_size()
        if rb:
            sp, dp = src.data_ptr(), dst.data_ptr()
            records += (sp, dp, rb, access_bytes(rb, sp, dp), convert)
    return records


def _launch(order: torch.Tensor, rows: int, valid: int, scatter: bool,
            records: List[int]) -> None:
    global launches
    if order.device.type != "cuda":
        raise ValueError(f"export_rows kernel: tensors on {order.device}")
    if not rows or not records:
        return
    fn = _build.function("export_rows", "mbots_export_rows", _ARGS)
    err = fn(order.data_ptr(), rows, valid, int(scatter), len(records) // _RECORD,
             (ctypes.c_int64 * len(records))(*records),
             torch._C._cuda_getCurrentRawStream(order.get_device()))
    if err != 0:
        raise RuntimeError(f"export_rows kernel launch failed: CUDA error {err}")
    launches += 1
    profiling.count("export_launches")


def gather(perm: torch.Tensor, pairs: Sequence[Pair]) -> None:
    """dst[r] = src[perm[r]] for r < len(perm), for every (src, dst) pair,
    in one launch.

    perm  : [n] int64 row numbers of the sources.
    pairs : src [R, d] and dst [>= n, d], contiguous, of one dtype or int32
            into float32 (rounded to nearest, as `.to(torch.float32)`).
    dst's rows from n on are left as they are."""
    records = _records("gather", perm, pairs, 0, perm.numel(), exact=False)
    if perm.device.type == "cpu":
        gather_reference(perm, pairs)
        return
    _launch(perm, perm.numel(), perm.numel(), False, records)


def scatter(order: torch.Tensor, valid: int, pairs: Sequence[Pair]) -> None:
    """dst[order[i]] = src[i] for i < valid and a zero row for valid <= i <
    len(order), for every (src, dst) pair, in one launch. With `order` a
    permutation of dst's rows every row of dst is written once, so dst may
    come from `torch.empty`.

    order : [R] int64, R = dst's rows.
    pairs : src [>= valid, d] and dst [R, d], as `gather`'s."""
    if not 0 <= valid <= order.numel():
        raise ValueError(f"export_rows scatter: {valid} valid rows of {order.numel()}")
    records = _records("scatter", order, pairs, valid, order.numel(), exact=True)
    if order.device.type == "cpu":
        scatter_reference(order, valid, pairs)
        return
    _launch(order, order.numel(), valid, True, records)
