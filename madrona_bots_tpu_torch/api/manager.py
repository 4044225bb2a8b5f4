"""SimManager: the public surface of the reference's `madrona_bots` module.

Counterpart of `madrona_bots_tpu/api/manager.py`, which mirrors the
reference's nanobind class (src/entry/entry.cpp:16-45, src/entry/mgr.cpp:
199-422): `SimManager(gpu_id, num_worlds, rand_seed,
init_num_agents_per_world)`, `step()`, `shift_observations()`, the exported
tensors in species-major row order, and `set_action`.

Everything stays on the manager's device. `step()` runs the port's env step
(on CUDA tensors the systems and raycast kernels, one launch each), then
builds the export order on the device (`utils/native.compaction_order`,
whose species starts are copied to the host, as the reference reads its
offsets back, mgr.cpp:57-62). The rows move through
`ops/export_rows_cuda.py` (on CUDA tensors one kernel launch a call, on CPU
tensors its plain version). The first access after a step or shift to any
export of the current tick gathers all seven of them (depth, semantic,
reward, position, health, surrounding, stats) in one launch, each a fresh
tensor in its own dtype, cached until the next step or shift; the is_prev
exports are a group of their own.

The action and hidden exports are persistent buffers of W * A capacity rows
(the exported tensor is a view of the first n): refilled in place after
every step and shift (one launch for both), so a tensor fetched once stays
live, and scattered back into the state before the next step or shift (one
launch over the whole sort order, the dead slots zeroed), so writes into
them reach the simulator, as the reference's zero-copy device exports do
(training_loop.py:136-137). A step plus the 12 getters and a shift is five
launches of the export kernel.

Spans (`utils/profiling.span`, recorded only under a profiler) mark the
step, the write-back, the order, the refresh, each export fill and the
shift; every blocking device-to-host read is a `profiling.host_sync` site,
counted in `host_syncs`. A step plus the 12 getters reads the device twice:
the species starts and `sensor_index_tensor`'s `nonzero`.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from madrona_bots_tpu_torch.config import EnvConfig, NUM_ACTIONS
from madrona_bots_tpu_torch.device import resolve
from madrona_bots_tpu_torch.env import env as env_mod
from madrona_bots_tpu_torch.env.state import WorldState, init_state
from madrona_bots_tpu_torch.ops import export_rows_cuda as export_rows
from madrona_bots_tpu_torch.utils import native, profiling


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
        with profiling.host_sync("to_numpy"):
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
    wrappers run the plain versions on CPU tensors; `use_kernels=False`
    runs the env step and the export rows on the plain versions."""

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
        self._gather_rows, self._scatter_rows = (
            (export_rows.gather, export_rows.scatter) if self.use_kernels
            else (export_rows.gather_reference, export_rows.scatter_reference))
        self.device = resolve(f"cuda:{gpu_id}" if device is None else device)
        self.state: WorldState = init_state(self.cfg, rand_seed, self.device)
        self._cache: Dict[str, torch.Tensor] = {}
        self._order: Optional[torch.Tensor] = None       # all W * A slots, dead last
        self._perm: Optional[torch.Tensor] = None        # its first n: species-major
        self._perm_world: Optional[torch.Tensor] = None  # world-major order
        self._action_buf: Optional[torch.Tensor] = None  # [W * A, 6] int32
        self._hidden_buf: Optional[torch.Tensor] = None  # [W * A, H] f32
        self._recompute_order()

    # ---- stepping (Manager::step, mgr.cpp:51-63) ----

    def step(self):
        profiling.count("steps")
        with profiling.span("mbots.manager.step"):
            self._flush_writes()
            self.state = env_mod.step(self.state, self.cfg, self.use_kernels)
            self._recompute_order()
            self._refresh_exports()

    def shift_observations(self):
        with profiling.span("mbots.manager.shift"):
            self._flush_writes()
            self.state = env_mod.shift_observations(self.state, self.cfg)
            self._cache.clear()
            self._refresh_exports()

    # ---- export order ----

    def _recompute_order(self):
        with profiling.span("mbots.manager.order"):
            self._order, self._species_starts = native.compaction_order(
                self.state.alive, self.state.species, self.cfg.num_species)
            self._perm = self._order[: self.total_num_agents]
            self._perm_world = None
            self._cache.clear()

    @property
    def total_num_agents(self) -> int:
        """SimBridge::totalNumAgents (sim.hpp:74-78)."""
        return int(self._species_starts[-1])

    def agent_offset_for_world(self, world_idx: int) -> int:
        """World-major row offset (Manager::agentOffsetForWorld, mgr.cpp:274)."""
        offsets, _ = native.world_offsets(self.state.alive)
        with profiling.host_sync("world_offset"):
            return int(offsets[world_idx])

    def species_offsets(self) -> np.ndarray:
        """Per-species start rows of the exports, [NS + 1] int32 on the host:
        exact, where the reference's cumsum of species_count_tensor
        (training_loop.py:43-45) misses this tick's respawns (SPEC §6)."""
        return self._species_starts

    # ---- tensor getters (mgr.cpp:199-422) ----

    def _export(self, name: str, is_prev: bool) -> Tensor:
        key = f"{name}{is_prev}"
        if key not in self._cache:
            self._fill(is_prev)
        return Tensor(self._cache[key])

    def _fill(self, is_prev: bool):
        """Gather every export of the current tick, or with is_prev of the
        previous one, in one launch: each a fresh tensor, cached. With
        quirk_compat depth is the semantic bytes and health the int32 bits
        read as float32, both copied as they are."""
        s, p, q = self.state, "prev_" if is_prev else "", self.quirk_compat
        semantic, health = getattr(s, p + "sensor_semantic"), getattr(s, p + "health")
        fields = {"depth": semantic.view(torch.uint8) if q else getattr(s, p + "sensor_depth"),
                  "semantic": semantic, "reward": getattr(s, p + "reward"),
                  "pos": getattr(s, p + "pos"),
                  "health": health.view(torch.float32) if q else health,
                  "surrounding": getattr(s, p + "surrounding"),
                  "stats": getattr(s, p + "stats")}
        if is_prev:
            fields.update(action=s.prev_action, hidden=s.prev_hidden)
        with profiling.span("mbots.manager.gather"):
            n, rows = self.total_num_agents, self.cfg.num_worlds * self.cfg.max_agents
            pairs = []
            for name, field in fields.items():
                src = field.reshape(rows, -1)
                out = torch.empty((n, src.shape[1]), device=self.device,
                                  dtype=torch.float32 if name == "health" else src.dtype)
                pairs.append((src, out))
                self._cache[f"{name}{is_prev}"] = out
            self._gather_rows(self._perm, pairs)

    def depth_tensor(self, is_prev: bool = False) -> Tensor:
        """uint8 [N, sensor]: the depth buffer (deviation D5); with
        quirk_compat the semantic bytes, as the reference exports them
        under this name (sim.cpp:98-104)."""
        return self._export("depth", is_prev)

    def semantic_tensor(self, is_prev: bool = False) -> Tensor:
        return self._export("semantic", is_prev)

    def reward_tensor(self, is_prev: bool = False) -> Tensor:
        return self._export("reward", is_prev)

    def species_count_tensor(self) -> Tensor:
        """[num_worlds, num_species] int32: pre-respawn tracker counts."""
        return Tensor(self.state.species_counts)

    def position_tensor(self, is_prev: bool = False) -> Tensor:
        return self._export("pos", is_prev)

    def health_tensor(self, is_prev: bool = False) -> Tensor:
        """float32 [N, 1] values (deviation D5); with quirk_compat the int32
        storage's bits read as float32, as the reference does (Q2,
        mgr.cpp:329-346)."""
        return self._export("health", is_prev)

    def surrounding_tensor(self, is_prev: bool = False) -> Tensor:
        return self._export("surrounding", is_prev)

    def action_tensor(self, is_prev: bool = False) -> Tensor:
        if is_prev:
            return self._export("action", True)
        if self._action_buf is None:
            self._action_buf = self._export_buffer(self.state.action)
        return Tensor(self._action_buf[: self.total_num_agents])

    def stats_tensor(self, is_prev: bool = False) -> Tensor:
        return self._export("stats", is_prev)

    def hidden_state_tensor(self, is_prev: bool = False) -> Tensor:
        if is_prev:
            return self._export("hidden", True)
        if self._hidden_buf is None:
            self._hidden_buf = self._export_buffer(self.state.hidden)
        return Tensor(self._hidden_buf[: self.total_num_agents])

    def done_tensor(self) -> Tensor:
        """Always zeros: worlds never reset (quirk Q7, sim.cpp:302-305)."""
        with profiling.span("mbots.manager.gather"):
            return Tensor(torch.zeros((self.total_num_agents, 1), dtype=torch.int32,
                                      device=self.device))

    def sensor_index_tensor(self) -> Tensor:
        """[N, 1] int32: world-major agent index -> exported row (the
        SensorOutputIndex indirection, sim.cpp:736-789)."""
        if "sensor_index" not in self._cache:
            with profiling.span("mbots.manager.gather"):
                if self._perm_world is None:
                    with profiling.host_sync("nonzero"):
                        self._perm_world = torch.nonzero(self.state.alive.reshape(-1))[:, 0]
                inv = native.inverse_perm(self._perm,
                                          self.cfg.num_worlds * self.cfg.max_agents)
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
        with profiling.span("mbots.manager.gather"):
            rows = field.reshape(-1, field.shape[-1])
            buf = torch.zeros_like(rows)
            self._gather_rows(self._perm, [(rows, buf)])
            return buf

    def _buffers(self):
        """(state field, export buffer) of each buffer made so far."""
        return [(name, buf) for name, buf in (("action", self._action_buf),
                                              ("hidden", self._hidden_buf)) if buf is not None]

    def _flush_writes(self):
        """Scatter the export buffers into fresh [W, A, d] fields that replace
        the state's action / hidden, over the whole sort order, so the dead
        slots come out zero: whatever was written into the buffers since the
        last step or shift reaches the simulator here. A buffer is never
        aliased into the state, which the systems kernel writes in place."""
        with profiling.span("mbots.manager.flush"):
            bufs = self._buffers()
            if bufs:
                fields = {name: torch.empty_like(getattr(self.state, name)) for name, _ in bufs}
                self._scatter_rows(self._order, self.total_num_agents,
                                    [(buf, fields[name].view(-1, buf.shape[1]))
                                     for name, buf in bufs])
                self.state = self.state.replace(**fields)

    def _refresh_exports(self):
        """Refill the export buffers in place from the state in the current
        export order, so tensors fetched once stay live across steps."""
        with profiling.span("mbots.manager.refresh"):
            bufs = self._buffers()
            if bufs:
                self._gather_rows(self._perm, [
                    (getattr(self.state, name).reshape(-1, buf.shape[1]), buf)
                    for name, buf in bufs])
