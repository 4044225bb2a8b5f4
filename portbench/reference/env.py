"""The plain env step: the systems step (`step.step_systems_plain`) then the
raycast sensor (`raycast.raycast`), and the observation shift. A frozen copy
of the port's `env/env.py` without the kernels."""

from __future__ import annotations

from portbench.reference import raycast
from portbench.reference.config import EnvConfig
from portbench.reference.state import WorldState
from portbench.reference.step import step_systems_plain


def step(state: WorldState, cfg: EnvConfig) -> WorldState:
    """One full tick. Consumes `state`."""
    state = step_systems_plain(state, cfg)
    depth, semantic, finder = raycast.raycast(state.pos, state.heading, state.alive,
                                              state.species, cfg)
    return state.replace(sensor_depth=depth, sensor_semantic=semantic, finder=finder)


def shift_observations(state: WorldState, cfg: EnvConfig | None = None) -> WorldState:
    """Current -> prev for the observation components and the hidden state,
    in place (with cfg.quirk_d4_shift_typo prev.hitEnemy takes
    cur.hitFriendly)."""
    for name in ("species", "pos", "health", "surrounding", "reward", "action",
                 "stats", "hidden"):
        getattr(state, "prev_" + name).copy_(getattr(state, name))
    if cfg is not None and cfg.quirk_d4_shift_typo:
        state.prev_stats[..., 1].copy_(state.stats[..., 0])
    return state
