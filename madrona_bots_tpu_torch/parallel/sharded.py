"""The sharded train tick: the A2C tick on this rank's worlds.

Counterpart of `madrona_bots_tpu/parallel/sharded.py`. There GSPMD turns the
sum over the worlds-sharded batch into a psum; here `learn/a2c.py` with a
mesh all-reduces the same sums by hand (the critic's denominators, the
gradients, the metric sums), so the tick is the global tick and the
parameters stay replicated. The PPO trainer takes the mesh the same way
(`learn/ppo.py::make_ppo_trainer(..., mesh=mesh)`).
"""

from __future__ import annotations

from typing import Sequence

from madrona_bots_tpu_torch.config import EnvConfig
from madrona_bots_tpu_torch.learn import a2c
from madrona_bots_tpu_torch.models.actor_critic import ActorCritic
from madrona_bots_tpu_torch.parallel.mesh import Mesh


def make_sharded_train_tick(models: Sequence[ActorCritic], cfg: EnvConfig, mesh: Mesh,
                            lr: float = 3e-4, gamma: float = 1.0,
                            proper_log_probs: bool = False, use_kernels: bool = True,
                            compute_dtype=None, quirk_compat: bool = False,
                            learner_slots_per_class=None, stacked: bool = False):
    """`a2c.make_train_tick` over the mesh: (tick, optimizer), where
    tick(shard, train_states, key) takes this rank's shard of the
    `cfg.num_worlds` worlds (`shard_state`, or `init_state(...,
    worlds=mesh.world_range(cfg.num_worlds))`) and the replicated train
    states. The full single-card feature set: learner-row compaction,
    quirk_compat and the species-stacked update. `use_kernels` stands for
    the JAX `use_pallas`."""
    return a2c.make_train_tick(models, cfg, lr=lr, gamma=gamma,
                               proper_log_probs=proper_log_probs, quirk_compat=quirk_compat,
                               use_kernels=use_kernels, compute_dtype=compute_dtype,
                               learner_slots_per_class=learner_slots_per_class,
                               stacked=stacked, mesh=mesh)
