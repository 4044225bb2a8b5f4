"""The SimManager's step and exports, plain: a frozen copy of the port's
`api/manager.py` and `utils/native.py` logic for one step of a manager
whose action and hidden exports are live.

From the state a step starts from (the manager's state after the previous
step's shift) and the action rows written into the action export: the
write-back of both exports at the export order (species-major, ascending
flat index within a species), the plain env step, the new export order and
the 12 exports the manager's getters return.
"""

from __future__ import annotations

import torch

from portbench.reference import env
from portbench.reference.config import EnvConfig
from portbench.reference.state import WorldState


def compaction(alive: torch.Tensor, species: torch.Tensor, num_species: int):
    """(perm [n] int64 flat indices w * A + slot in species-major order,
    ascending within a species, n)."""
    keys = torch.where(alive.reshape(-1), species.reshape(-1),
                       num_species + 1).to(torch.uint8)
    sorted_keys, order = torch.sort(keys, stable=True)
    n = int((sorted_keys <= num_species).sum())
    return order[:n], n


def inverse_perm(perm: torch.Tensor, n_total: int) -> torch.Tensor:
    inv = torch.full((n_total,), -1, dtype=torch.int32, device=perm.device)
    inv[perm] = torch.arange(perm.numel(), dtype=torch.int32, device=perm.device)
    return inv


def _rows(field: torch.Tensor) -> torch.Tensor:
    return field.reshape((-1,) + tuple(field.shape[2:]))


def step(state: WorldState, actions: torch.Tensor, cfg: EnvConfig) -> WorldState:
    """The manager's step from `state` with `actions` [n, 6] written into
    the action export: both exports scattered into zeroed fields at the
    export order, then the env step. Consumes `state`."""
    perm, n = compaction(state.alive, state.species, cfg.num_species)
    action = torch.zeros_like(state.action)
    _rows(action)[perm] = actions[:n]
    hidden = torch.zeros_like(state.hidden)
    _rows(hidden)[perm] = _rows(state.hidden)[perm]
    return env.step(state.replace(action=action, hidden=hidden), cfg)


def exports(state: WorldState, cfg: EnvConfig) -> dict:
    """The 12 getters after a step: species_count, done, sensor_index and
    the nine current-step exports, each a gather of its field at the
    export order in the field's dtype (health as float32)."""
    perm, n = compaction(state.alive, state.species, cfg.num_species)

    def rows(field):
        return _rows(field).index_select(0, perm)

    inv = inverse_perm(perm, cfg.num_worlds * cfg.max_agents)
    world_major = torch.nonzero(state.alive.reshape(-1))[:, 0]
    return {"species_count": state.species_counts,
            "done": torch.zeros((n, 1), dtype=torch.int32, device=perm.device),
            "sensor_index": inv[world_major][:, None],
            "depth_0": rows(state.sensor_depth),
            "semantic_0": rows(state.sensor_semantic),
            "reward_0": rows(state.reward[..., None]),
            "position_0": rows(state.pos),
            "health_0": rows(state.health[..., None]).to(torch.float32),
            "surrounding_0": rows(state.surrounding),
            "action_0": rows(state.action),
            "stats_0": rows(state.stats),
            "hidden_state_0": rows(state.hidden)}
