"""Frozen copy of the port's plain version, kept by the benchmark so that
later changes to `madrona_bots_tpu_torch` cannot move the reference.
Imports nothing of the port; its original docstring follows.

Environment configuration for the PyTorch port.

A copy of `madrona_bots_tpu/config.py` (same fields, defaults and derived
properties). The port keeps its own copy because importing the JAX package's
config module runs `madrona_bots_tpu/__init__.py`, which imports jax and
flax. tests/test_torch_config.py holds the two copies equal field by field.
"""

from __future__ import annotations

import dataclasses
import enum
import math


class RewardSetting(enum.IntEnum):
    """The reward settings of rewardSystem (sim.cpp:840-983); SETTING_8 is
    the active default and SETTING_7B the trailing "setting 7" block."""

    SETTING_2 = 2
    SETTING_3 = 3
    SETTING_4 = 4
    SETTING_5 = 5
    SETTING_6 = 6
    SETTING_7 = 7
    SETTING_8 = 8
    SETTING_7B = 9


# Action flag indices within the 6-wide int32 action vector.
ACTION_FORWARD = 0
ACTION_BACKWARD = 1
ACTION_ROTATE_LEFT = 2
ACTION_ROTATE_RIGHT = 3
ACTION_SHOOT = 4
ACTION_BREED = 5
NUM_ACTIONS = 6

# RNG stream salts (SPEC.md "RNG discipline").
SALT_WORLD = 0x5EED
SALT_INIT = 0
SALT_FOOD = 1
SALT_RESPAWN = 2


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Static environment parameters (defaults: the reference configuration,
    8x6 chunks of 16 one-metre cells, 32 initial agents, 4 species, a
    32-pixel sensor)."""

    num_worlds: int = 2048
    init_agents: int = 32
    max_agents: int = 128
    num_species: int = 4

    # Geometry
    num_chunks_x: int = 8
    num_chunks_y: int = 6
    chunk_width: int = 16
    cell_dim: float = 1.0

    # Food
    max_food_packages: int = 5
    total_allowed_food: int = 30

    # Combat / lifecycle
    shoot_damage: int = 50
    eat_health: int = 20
    breed_min_health: int = 10
    breed_cost: int = 40
    child_health: int = 50
    init_health: int = 100

    # Movement
    rotation_delta: float = 0.1
    move_speed: float = 1.0

    # Sensor
    sensor_size: int = 32
    fov_degrees: float = 90.0
    near: float = 1.1
    agent_radius: float = 1.0

    # Learner-side dims
    hidden_state_dim: int = 16

    reward_setting: RewardSetting = RewardSetting.SETTING_8

    # Reference-bug emulation toggles (SPEC.md deviations; default = fixed).
    quirk_d1_stale_finder: bool = False
    quirk_d3_oob_reward: bool = False
    quirk_d4_shift_typo: bool = False

    # --- derived ---

    @property
    def world_lim_x(self) -> float:
        return self.num_chunks_x * self.chunk_width * self.cell_dim

    @property
    def world_lim_y(self) -> float:
        return self.num_chunks_y * self.chunk_width * self.cell_dim

    @property
    def num_chunks(self) -> int:
        return self.num_chunks_x * self.num_chunks_y

    @property
    def num_forward_rays(self) -> int:
        return 3 * self.sensor_size // 4

    @property
    def num_backward_rays(self) -> int:
        return self.sensor_size // 4

    @property
    def max_range(self) -> float:
        return math.hypot(self.world_lim_x, self.world_lim_y)

    @property
    def respawn_floor(self) -> int:
        """Per-species population floor: init_agents / num_species."""
        return self.init_agents // self.num_species

    def __post_init__(self):
        assert self.sensor_size % 4 == 0, "ray fan split requires sensor_size % 4 == 0"
        assert self.max_agents >= self.init_agents
        assert self.init_agents % self.num_species == 0
        # Species-class slot quota (SPEC deviation D2b): slot i belongs to
        # species (i % num_species) + 1 for its whole lifetime.
        assert self.max_agents % self.num_species == 0
