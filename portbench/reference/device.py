"""Frozen copy of the port's plain version, kept by the benchmark so that
later changes to `madrona_bots_tpu_torch` cannot move the reference.
Imports nothing of the port; its original docstring follows.

Device choice and device constants for the port.

Entry points run on the card unless the caller names another device. When
CUDA is asked for and absent they raise; nothing falls back to the CPU.
"""

from __future__ import annotations

import functools

import torch


def resolve(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "madrona_bots_tpu_torch runs on CUDA by default and "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions on the CPU")
    return dev


@functools.lru_cache(maxsize=None)
def _const(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def const(values, dtype: torch.dtype, device) -> torch.Tensor:
    """A constant tensor on `device`, made once: a host-to-device copy of
    pageable memory would stall the host on every step. Do not write to it."""
    return _const(tuple(values) if isinstance(values, (list, tuple)) else values,
                  dtype, torch.device(device))


def full(value, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim constant of `like`'s dtype and device. Dividing by it is a true
    IEEE division on every device: PyTorch's CUDA `x / python_float`
    multiplies by the reciprocal instead, which rounds differently."""
    return const(value, like.dtype, like.device)
