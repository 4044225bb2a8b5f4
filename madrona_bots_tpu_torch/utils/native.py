"""The export data plane of the SimManager, on the state's device.

Counterpart of `madrona_bots_tpu/utils/native.py`, whose host library
(`native/mbots_host.cpp`, through ctypes) builds the species-major export
permutation, the per-world offset table and the export gather / write-back
scatter on numpy arrays. Here the same functions take torch tensors and run
where the state lives, so on the card nothing but the species starts crosses
to the host. No host library and no numpy branch: the same code runs on
either device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def compaction(alive: torch.Tensor, species: torch.Tensor, num_species: int
               ) -> Tuple[torch.Tensor, np.ndarray]:
    """Species-major export permutation.

    alive [W, A] bool, species [W, A] int32 (1..num_species where alive) ->
    (perm [n_alive] int64 flat indices w * A + slot on the state's device,
    species_starts [num_species + 1] int32 on the host). The order is the
    JAX package's: species-major, ascending flat index within a species.

    One stable sort of the whole flat mask by key (the species where alive,
    num_species + 1 where dead) gives the order with the dead rows last, and
    the species boundaries are searches in the sorted keys; so the row count
    reaches the host with the starts, in the one copy this function makes.
    """
    if num_species > 254:
        raise ValueError(f"compaction: num_species must be <= 254, got {num_species}")
    keys = torch.where(alive.reshape(-1), species.reshape(-1),
                       num_species + 1).to(torch.uint8)
    sorted_keys, order = torch.sort(keys, stable=True)
    bounds = torch.arange(1, num_species + 2, dtype=torch.uint8, device=keys.device)
    starts = torch.searchsorted(sorted_keys, bounds).to(torch.int32).cpu().numpy()
    return order[: int(starts[-1])], starts


def world_offsets(alive: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-world (offsets, counts), int32 [W] on the state's device, over the
    world-major enumeration of the alive agents."""
    counts = alive.sum(dim=1, dtype=torch.int32)
    offsets = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    return offsets, counts


def inverse_perm(perm: torch.Tensor, n_total: int) -> torch.Tensor:
    """inv [n_total] int32: inv[perm[r]] = r, -1 where no row maps."""
    inv = torch.full((n_total,), -1, dtype=torch.int32, device=perm.device)
    inv[perm] = torch.arange(perm.numel(), dtype=torch.int32, device=perm.device)
    return inv


def gather_rows(src: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """out[r] = src[perm[r]] over the leading axis: the export gather."""
    return src.index_select(0, perm)


def scatter_rows(src: torch.Tensor, perm: torch.Tensor, dst: torch.Tensor) -> None:
    """dst[perm[r]] = src[r] in place (any strides): the write-back scatter."""
    dst[perm] = src
