"""Observation construction on the padded [W, A] layout.

Counterpart of `madrona_bots_tpu/learn/obs.py:25-67`. 69-dim layout:
[depth(32), health(1), pos(2), semantic(32), surrounding(2)].
"""

from __future__ import annotations

import torch

from madrona_bots_tpu_torch.config import EnvConfig
from madrona_bots_tpu_torch.env.state import WorldState


def obs_field_cols(state: WorldState, cfg: EnvConfig, prev: bool = False,
                   quirk_compat: bool = False, dtype=torch.float32):
    """The observation as a column list (depth, health, pos, semantic,
    surrounding). With quirk_compat the depth block carries the semantic
    bytes (Q1) and the health column is the int32 storage reinterpreted as
    float32 (Q2)."""
    if prev:
        depth, semantic = state.prev_sensor_depth, state.prev_sensor_semantic
        health, pos, surrounding = state.prev_health, state.prev_pos, state.prev_surrounding
    else:
        depth, semantic = state.sensor_depth, state.sensor_semantic
        health, pos, surrounding = state.health, state.pos, state.surrounding
    health_col = health[..., None]
    if quirk_compat:
        depth = semantic.to(torch.uint8)
        health_col = health_col.to(torch.int32).view(torch.float32)
    return [depth.to(dtype), health_col.to(dtype), pos.to(dtype),
            semantic.to(dtype), surrounding.to(dtype)]


def construct_obs(state: WorldState, cfg: EnvConfig, prev: bool = False,
                  quirk_compat: bool = False, dtype=torch.float32) -> torch.Tensor:
    """[W, A, obs_dim] in `dtype`: the tensor a policy reads."""
    return torch.cat(obs_field_cols(state, cfg, prev, quirk_compat, dtype), dim=-1)


def species_mask(state: WorldState, species_id: int) -> torch.Tensor:
    """[W, A] f32 mask: alive and of the given 1-based species."""
    return (state.alive & (state.species == species_id)).to(torch.float32)
