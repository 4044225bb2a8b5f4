"""The numbers that decide `correct`, each from the program's outputs and
the plain reference's, and their limits."""

from __future__ import annotations

import math

import torch


def mismatched(got: torch.Tensor, want: torch.Tensor) -> int:
    """Elements that differ in bits; every element where dtype or shape
    differ."""
    if got.dtype != want.dtype or got.shape != want.shape:
        return max(got.numel(), want.numel(), 1)
    g, w = got.contiguous(), want.contiguous()
    if g.dtype.is_floating_point:
        g, w = g.view(torch.int32 if g.element_size() == 4 else torch.int16), \
            w.view(torch.int32 if w.element_size() == 4 else torch.int16)
    return int((g != w).sum())


def judge(numbers: dict, limits: dict) -> tuple[int, dict]:
    """(how many numbers are outside their limits, {name: {"value",
    "limit"}}). A number that is missing or not finite is outside, and
    shows as None (the result line stays strict JSON)."""
    out, failed = {}, 0
    for name, limit in limits.items():
        v = numbers.get(name)
        ok = v is not None and math.isfinite(v)
        failed += not (ok and v <= limit)
        out[name] = {"value": v if ok else None, "limit": limit}
    return failed, out
