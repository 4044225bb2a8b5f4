"""Observation construction on the padded [W, A] layout.

Counterpart of `madrona_bots_tpu/learn/obs.py`. 69-dim layout: [depth(32),
health(1), pos(2), semantic(32), surrounding(2)]. `compact_obs_rows` builds
the learner rows' observations from the class fields without the
full-capacity [W, A, 69] tensor, through one `Packer` payload.
"""

from __future__ import annotations

import torch

from madrona_bots_tpu_torch.config import EnvConfig
from madrona_bots_tpu_torch.env.state import WorldState
from madrona_bots_tpu_torch.learn.pack import Packer, gather_rows


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


def compact_obs_rows(depth, health, pos, semantic, surrounding, oh,
                     quirk_compat: bool = False, dtype=torch.float32) -> torch.Tensor:
    """[G * rows, 69] learner-row observations in `dtype` from per-class
    fields [G, Asub(, k)] and the [G, rows, Asub] one-hot of the row
    compaction: `construct_obs` of the class view followed by the row
    gather, each field cast where `construct_obs` casts it, as the JAX
    `compact_obs_rows`. The quirk Q2 health column travels as its integer
    and is reinterpreted as f32 after the gather (its bits are f32
    denormals)."""
    G, rows, _ = oh.shape
    pk = Packer()
    fin = pack_obs_fields(pk, depth, health, pos, semantic, surrounding,
                          quirk_compat=quirk_compat, dtype=dtype)
    out = fin(*pk.unpack(gather_rows(oh, pk.payload())))
    return out.reshape(G * rows, out.shape[-1])


def pack_obs_fields(pk: Packer, depth, health, pos, semantic, surrounding,
                    quirk_compat: bool = False, dtype=torch.float32):
    """Add the 69-dim obs fields to `pk` (for a larger payload); returns
    finalize(d, h, p, sm, su) -> [..., 69] in `dtype`, to call on the
    matching `unpack` fields. Q1 puts the semantic bytes in the depth block
    before packing; Q2's health rides as its integer (<= 100) and becomes
    its int32 bits read as f32 after the gather. Floats ride as bf16 when
    `dtype` is bf16, else as exact f32 planes."""
    if quirk_compat:
        depth = semantic.to(torch.uint8)
    add_float = pk.add_bf16 if dtype == torch.bfloat16 else pk.add_f32
    pk.add_int(depth)
    pk.add_int(health)
    add_float(pos)
    pk.add_int(semantic)
    add_float(surrounding)

    def finalize(d, h, p, sm, su):
        if h.dim() < d.dim():
            h = h[..., None]
        if quirk_compat:
            h = torch.round(h).to(torch.int32).view(torch.float32)
        return torch.cat([d.to(dtype), h.to(dtype), p.to(dtype), sm.to(dtype),
                          su.to(dtype)], dim=-1)

    return finalize
