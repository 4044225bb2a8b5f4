"""PyTorch / CUDA port of madrona_bots_tpu for an NVIDIA H100.

The world rollout (init_state, step, shift_observations, construct_obs) with
the systems step and the raycast sensor as hand-written CUDA kernels
(`csrc/`), and the per-species A2C learner (`learn/a2c.py`, whose bf16
learner-row compaction is the row-gather kernel) and PPO behind the training
CLI `python -m madrona_bots_tpu_torch.learn.training_loop`; the reference's
`madrona_bots` surface (`madrona_bots.py`: `SimManager` with species-major
exports built on the card, `ScriptBotsViewer`) with the legacy drivers, the
viewers and the tools on top of it. Entry points run on CUDA unless given
`device="cpu"`, where the kernels' plain PyTorch versions run. Imports
torch, never jax.
"""

from madrona_bots_tpu_torch.config import EnvConfig, RewardSetting
from madrona_bots_tpu_torch.env.env import (rollout, sensor_pass, set_actions,
                                            shift_observations, step, step_systems)
from madrona_bots_tpu_torch.env.state import (WorldState, init_state,
                                              state_from_numpy, state_to_numpy)
from madrona_bots_tpu_torch.learn.obs import construct_obs

__all__ = ["EnvConfig", "RewardSetting", "WorldState", "init_state", "step",
           "step_systems", "sensor_pass", "shift_observations", "set_actions",
           "rollout", "construct_obs", "state_from_numpy", "state_to_numpy"]
