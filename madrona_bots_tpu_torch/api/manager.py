"""SimManager: the public surface of the reference's `madrona_bots` module.

Counterpart of `madrona_bots_tpu/api/manager.py`, which mirrors the
reference's nanobind class (src/entry/entry.cpp:16-45, src/entry/mgr.cpp:
199-422): `SimManager(gpu_id, num_worlds, rand_seed,
init_num_agents_per_world)`, `step()`, `shift_observations()`, the exported
tensors in species-major row order, and `set_action`.

Everything stays on the manager's device. `step()` runs the port's env step
(on CUDA tensors the systems and raycast kernels, one launch each), then
builds the export order on the device (`utils/native.compaction`, whose
species starts are the step's one planned copy to the host, as the
reference reads its offsets back, mgr.cpp:57-62). Each exported tensor is
one `index_select` of the flattened field at that order, in the field's own
dtype, made on first access and cached until the next step.

The action and hidden exports are persistent buffers of W * A capacity rows
(the exported tensor is a view of the first n): refilled in place after
every step and shift, so a tensor fetched once stays live, and scattered
back into the state before the next step or shift, so writes into them
reach the simulator, as the reference's zero-copy device exports do
(training_loop.py:136-137).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from madrona_bots_tpu_torch.config import EnvConfig, NUM_ACTIONS
from madrona_bots_tpu_torch.device import resolve
from madrona_bots_tpu_torch.env import env as env_mod
from madrona_bots_tpu_torch.env.state import WorldState, init_state
from madrona_bots_tpu_torch.utils import native


class Tensor:
    """An exported tensor (ma::py::Tensor, mgr.cpp:70-76).

    `to_torch()` is the manager's own device tensor, so writes to it are seen
    by the manager (the port's drivers write actions through it or through
    `SimManager.set_action`). `to_numpy()` is `t.cpu().numpy()`: a view that
    shares those writes on the CPU, a copy on the card."""

    def __init__(self, tensor: torch.Tensor):
        self._tensor = tensor

    def to_torch(self) -> torch.Tensor:
        return self._tensor

    def to_numpy(self) -> np.ndarray:
        return self._tensor.cpu().numpy()

    @property
    def shape(self):
        return tuple(self._tensor.shape)

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.to_numpy(), dtype=dtype)


class SimManager:
    """The reference's constructor signature (entry.cpp:17-32) plus the JAX
    package's options. `device=None` means `cuda:{gpu_id}`, which raises
    where CUDA is absent; `use_kernels=None` means the kernels, whose
    wrappers run the plain versions on CPU tensors."""

    def __init__(self, gpu_id: int, num_worlds: int, rand_seed: int,
                 init_num_agents_per_world: int,
                 env_config: Optional[EnvConfig] = None,
                 quirk_compat: bool = False,
                 use_kernels: Optional[bool] = None,
                 device=None):
        if env_config is None:
            env_config = EnvConfig(num_worlds=num_worlds,
                                   init_agents=init_num_agents_per_world)
        elif (env_config.num_worlds != num_worlds
              or env_config.init_agents != init_num_agents_per_world):
            raise ValueError(
                f"env_config has {env_config.num_worlds} worlds and "
                f"{env_config.init_agents} initial agents, the arguments "
                f"{num_worlds} and {init_num_agents_per_world}")
        self.cfg = env_config
        self.quirk_compat = quirk_compat
        self.use_kernels = True if use_kernels is None else use_kernels
        self.device = resolve(f"cuda:{gpu_id}" if device is None else device)
        self.state: WorldState = init_state(self.cfg, rand_seed, self.device)
        self._cache: Dict[str, torch.Tensor] = {}
        self._perm: Optional[torch.Tensor] = None        # species-major order
        self._perm_world: Optional[torch.Tensor] = None  # world-major order
        self._action_buf: Optional[torch.Tensor] = None  # [W * A, 6] int32
        self._hidden_buf: Optional[torch.Tensor] = None  # [W * A, H] f32
        self._recompute_order()

    # ---- stepping (Manager::step, mgr.cpp:51-63) ----

    def step(self):
        self._flush_writes()
        self.state = env_mod.step(self.state, self.cfg, self.use_kernels)
        self._recompute_order()
        self._refresh_exports()

    def shift_observations(self):
        self._flush_writes()
        self.state = env_mod.shift_observations(self.state, self.cfg)
        self._cache.clear()
        self._refresh_exports()

    # ---- export order ----

    def _recompute_order(self):
        self._perm, self._species_starts = native.compaction(
            self.state.alive, self.state.species, self.cfg.num_species)
        self._perm_world = None
        self._cache.clear()

    @property
    def total_num_agents(self) -> int:
        """SimBridge::totalNumAgents (sim.hpp:74-78)."""
        return int(self._species_starts[-1])

    def agent_offset_for_world(self, world_idx: int) -> int:
        """World-major row offset (Manager::agentOffsetForWorld, mgr.cpp:274)."""
        offsets, _ = native.world_offsets(self.state.alive)
        return int(offsets[world_idx])

    def species_offsets(self) -> np.ndarray:
        """Per-species start rows of the exports, [NS + 1] int32 on the host:
        exact, where the reference's cumsum of species_count_tensor
        (training_loop.py:43-45) misses this tick's respawns (SPEC §6)."""
        return self._species_starts

    # ---- tensor getters (mgr.cpp:199-422) ----

    def _gather(self, name: str, field: torch.Tensor, dtype=None) -> Tensor:
        if name not in self._cache:
            rows = field.reshape((-1,) + tuple(field.shape[2:]))
            out = native.gather_rows(rows, self._perm)
            self._cache[name] = out if dtype is None else out.to(dtype)
        return Tensor(self._cache[name])

    def depth_tensor(self, is_prev: bool = False) -> Tensor:
        """uint8 [N, sensor]: the depth buffer (deviation D5); with
        quirk_compat the semantic bytes, as the reference exports them
        under this name (sim.cpp:98-104)."""
        s = self.state
        if self.quirk_compat:
            src = s.prev_sensor_semantic if is_prev else s.sensor_semantic
            return self._gather(f"depthQ{is_prev}", src.view(torch.uint8))
        src = s.prev_sensor_depth if is_prev else s.sensor_depth
        return self._gather(f"depth{is_prev}", src)

    def semantic_tensor(self, is_prev: bool = False) -> Tensor:
        s = self.state
        return self._gather(f"semantic{is_prev}",
                            s.prev_sensor_semantic if is_prev else s.sensor_semantic)

    def reward_tensor(self, is_prev: bool = False) -> Tensor:
        s = self.state
        src = s.prev_reward if is_prev else s.reward
        return self._gather(f"reward{is_prev}", src[..., None])

    def species_count_tensor(self) -> Tensor:
        """[num_worlds, num_species] int32: pre-respawn tracker counts."""
        return Tensor(self.state.species_counts)

    def position_tensor(self, is_prev: bool = False) -> Tensor:
        s = self.state
        return self._gather(f"pos{is_prev}", s.prev_pos if is_prev else s.pos)

    def health_tensor(self, is_prev: bool = False) -> Tensor:
        """float32 [N, 1] values (deviation D5); with quirk_compat the int32
        storage's bits read as float32, as the reference does (Q2,
        mgr.cpp:329-346)."""
        s = self.state
        src = (s.prev_health if is_prev else s.health)[..., None]
        if self.quirk_compat:
            return Tensor(self._gather(f"healthQ{is_prev}", src).to_torch()
                          .to(torch.int32).view(torch.float32))
        return self._gather(f"health{is_prev}", src, torch.float32)

    def surrounding_tensor(self, is_prev: bool = False) -> Tensor:
        s = self.state
        return self._gather(f"surrounding{is_prev}",
                            s.prev_surrounding if is_prev else s.surrounding)

    def action_tensor(self, is_prev: bool = False) -> Tensor:
        if is_prev:
            return self._gather("actionP", self.state.prev_action)
        if self._action_buf is None:
            self._action_buf = self._export_buffer(self.state.action)
        return Tensor(self._action_buf[: self.total_num_agents])

    def stats_tensor(self, is_prev: bool = False) -> Tensor:
        s = self.state
        return self._gather(f"stats{is_prev}", s.prev_stats if is_prev else s.stats)

    def hidden_state_tensor(self, is_prev: bool = False) -> Tensor:
        if is_prev:
            return self._gather("hiddenP", self.state.prev_hidden)
        if self._hidden_buf is None:
            self._hidden_buf = self._export_buffer(self.state.hidden)
        return Tensor(self._hidden_buf[: self.total_num_agents])

    def done_tensor(self) -> Tensor:
        """Always zeros: worlds never reset (quirk Q7, sim.cpp:302-305)."""
        return Tensor(torch.zeros((self.total_num_agents, 1), dtype=torch.int32,
                                  device=self.device))

    def sensor_index_tensor(self) -> Tensor:
        """[N, 1] int32: world-major agent index -> exported row (the
        SensorOutputIndex indirection, sim.cpp:736-789)."""
        if "sensor_index" not in self._cache:
            if self._perm_world is None:
                self._perm_world = torch.nonzero(self.state.alive.reshape(-1))[:, 0]
            inv = native.inverse_perm(self._perm, self.cfg.num_worlds * self.cfg.max_agents)
            self._cache["sensor_index"] = inv[self._perm_world][:, None]
        return Tensor(self._cache["sensor_index"])

    def set_action(self, agent_idx: int, forward: int, backward: int,
                   rotate_left: int, rotate_right: int, shoot: int, breed: int):
        """Write one agent's action by exported row (Manager::setAction,
        mgr.cpp:251-272)."""
        buf = self.action_tensor(False).to_torch()
        buf[agent_idx] = torch.tensor(
            [forward, backward, rotate_left, rotate_right, shoot, breed],
            dtype=torch.int32).to(buf.device)

    # ---- write-back ----

    def _export_buffer(self, field: torch.Tensor) -> torch.Tensor:
        """A persistent [W * A, d] export buffer, its first n rows filled."""
        rows = field.reshape(-1, field.shape[-1])
        buf = torch.zeros_like(rows)
        buf[: self.total_num_agents] = native.gather_rows(rows, self._perm)
        return buf

    def _flush_writes(self):
        """Scatter the export buffers into zeroed [W, A, d] fields that replace
        the state's action / hidden: whatever was written into them since the
        last step or shift reaches the simulator here. A buffer is never
        aliased into the state, which the systems kernel writes in place."""
        n = self.total_num_agents
        for name, buf in (("action", self._action_buf), ("hidden", self._hidden_buf)):
            if buf is not None:
                field = torch.zeros_like(getattr(self.state, name))
                native.scatter_rows(buf[:n], self._perm, field.view(-1, field.shape[-1]))
                self.state = self.state.replace(**{name: field})

    def _refresh_exports(self):
        """Refill the export buffers in place from the state in the current
        export order, so tensors fetched once stay live across steps."""
        n = self.total_num_agents
        for buf, field in ((self._action_buf, self.state.action),
                           (self._hidden_buf, self.state.hidden)):
            if buf is not None:
                buf[:n] = native.gather_rows(field.reshape(-1, field.shape[-1]), self._perm)
