"""The learner-row gather kernel's wrapper and its plain version.

`compact_fields` launches `csrc/row_gather.cu` on CUDA tensors and runs
`compact_fields_reference` on CPU tensors. It replaces the JAX package's
`ops/row_gather.py::compact_fields`: one launch gathers every field of the
bf16 compacting A2C tick.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch

from madrona_bots_tpu_torch.ops import _build

launches = 0
"""Launches of the row-gather kernel since the count was last set to 0."""

MAX_FIELDS = 8
BLOCK_BYTES = 8192
"""Output bytes a block of the kernel writes at least (whole worlds)."""
_DTYPES = {torch.uint8: 0, torch.int8: 1, torch.int32: 2, torch.bfloat16: 3}
_ARGS = ([ctypes.c_void_p] + [ctypes.c_int] * 4
         + [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p])


def vector_width(width: int, elem_bytes: int, src_addr: int, dst_addr: int) -> int:
    """Elements per memory access of one field in the kernel: 8 (an
    8-element load, one 16-byte bf16 store) where the row width is a
    multiple of 8, the source is aligned to its load (at most 16 bytes) and
    the destination to 16 bytes; else 1 (2-byte stores)."""
    if width % 8 == 0 and src_addr % min(16, 8 * elem_bytes) == 0 and dst_addr % 16 == 0:
        return 8
    return 1


def worlds_per_block(K: int, widths: Sequence[int]) -> int:
    """Worlds a block covers: the fewest that write BLOCK_BYTES of bf16."""
    per_world = 2 * K * sum(widths)
    return max(1, -(-BLOCK_BYTES // per_world)) if per_world else 1


def compact_fields_reference(kslot: torch.Tensor,
                             fields: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """out[w, k] = bf16(field[w, kslot[w, k]]), a zero row where kslot is -1."""
    idx = kslot.clamp(min=0).long()[:, :, None]
    ok = (kslot >= 0)[:, :, None]
    zero = torch.zeros((), dtype=torch.bfloat16, device=kslot.device)
    return [torch.where(ok, torch.take_along_dim(f, idx, dim=1).to(torch.bfloat16), zero)
            for f in fields]


def _check(kslot: torch.Tensor, fields: Sequence[torch.Tensor]) -> None:
    if kslot.dtype != torch.int32 or kslot.dim() != 2 or not kslot.is_contiguous():
        raise ValueError(f"row_gather kernel: kslot must be a contiguous int32 "
                         f"[W, K] tensor, got {kslot.dtype} {tuple(kslot.shape)}")
    if not 1 <= len(fields) <= MAX_FIELDS:
        raise ValueError(f"row_gather kernel: 1 to {MAX_FIELDS} fields, got {len(fields)}")
    W = kslot.shape[0]
    A = fields[0].shape[1]
    for i, f in enumerate(fields):
        if (f.dim() != 3 or f.shape[:2] != (W, A) or f.dtype not in _DTYPES
                or not f.is_contiguous() or f.device != kslot.device):
            raise ValueError(
                f"row_gather kernel: field {i} must be a contiguous [W={W}, A={A}, d] "
                f"u8/i8/i32/bf16 tensor on {kslot.device}, got {f.dtype} "
                f"{tuple(f.shape)} on {f.device}")


def compact_fields(kslot: torch.Tensor,
                   fields: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Gather learner rows from per-field sources in one launch.

    kslot  : [W, K] int32, source slot in [0, A) per (world, learner row),
             -1 for rows that come out zero.
    fields : [W, A, d] tensors, u8/i8/i32 (integer values; exact in bf16 for
             |v| <= 256) or bf16.
    Returns one [W, K, d] bf16 tensor per field."""
    global launches
    _check(kslot, fields)
    if kslot.device.type == "cpu":
        return compact_fields_reference(kslot, fields)
    if kslot.device.type != "cuda":
        raise ValueError(f"row_gather kernel: tensors on {kslot.device}")
    W, K = kslot.shape
    A = fields[0].shape[1]
    outs = [torch.empty((W, K, f.shape[2]), dtype=torch.bfloat16, device=kslot.device)
            for f in fields]
    n = len(fields)
    widths = [f.shape[2] for f in fields]
    src = (ctypes.c_void_p * n)(*[f.data_ptr() for f in fields])
    dst = (ctypes.c_void_p * n)(*[o.data_ptr() for o in outs])
    dtype = (ctypes.c_int * n)(*[_DTYPES[f.dtype] for f in fields])
    width = (ctypes.c_int * n)(*widths)
    vec = (ctypes.c_int * n)(*[vector_width(d, f.element_size(), f.data_ptr(), o.data_ptr())
                               for d, f, o in zip(widths, fields, outs)])
    fn = _build.function("row_gather", "mbots_row_gather", _ARGS)
    err = fn(kslot.data_ptr(), W, A, K, n, src, dst, dtype, width, vec,
             worlds_per_block(K, widths), torch.cuda.current_stream(kslot.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"row_gather kernel launch failed: CUDA error {err}")
    launches += 1
    return outs
