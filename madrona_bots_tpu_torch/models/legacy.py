"""The legacy non-recurrent model family (reference learn/model.py, used by
the legacy drivers `learn/env.py` and `learn/env_app.py`).

Counterpart of `madrona_bots_tpu/models/legacy.py`: `A2CNets(shared, actor,
critic)` without a recurrent layer (model.py:6-17), the same random
architecture generator minus the recurrent cell (model.py:19-58), the
discounted return (model.py:92-105) and the G - V advantage loss
(model.py:114-118). Parameters are leaves in the JAX tree's leaf order
(actor, critic, shared; b, w a layer), cut from one flat vector for the
port's flat Adam, as `ActorCritic`'s are.
"""

from __future__ import annotations

import random
from typing import Any, Dict, List, Sequence

import torch

from madrona_bots_tpu_torch import rng
from madrona_bots_tpu_torch.models.actor_critic import (FlatParams, _mlp, init_mlp,
                                                        mlp_specs)
from madrona_bots_tpu_torch.models.generator import ACTIVATIONS

_HEADS = ("actor", "critic", "shared")     # the JAX tree's sorted keys


class LegacySpeciesNetGenerator:
    """model.py:19-58: 1-3 random hidden layers, no recurrence; the same
    `random.Random(seed)` draws as the JAX package, so the same configs."""

    def __init__(self, input_dim: int, output_dim: int, hidden_dim: int,
                 seed: int | None = None):
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.hidden_dim = hidden_dim
        self._rng = random.Random(seed)

    def sample_config(self) -> Dict[str, Any]:
        rng_ = self._rng
        layers = [{"type": "linear", "in_features": self.input_dim,
                   "out_features": self.hidden_dim}]
        for _ in range(rng_.randint(1, 3)):
            layers.append({"type": "linear", "in_features": self.hidden_dim,
                           "out_features": self.hidden_dim})
            layers.append({"type": "activation",
                           "activation": rng_.choice(ACTIVATIONS)})

        def head(out):
            return [{"type": "linear", "in_features": self.hidden_dim,
                     "out_features": self.hidden_dim},
                    {"type": "activation", "activation": "ReLU"},
                    {"type": "linear", "in_features": self.hidden_dim,
                     "out_features": out}]

        return {"shared": layers, "actor": head(self.output_dim), "critic": head(1)}


class LegacyActorCritic(FlatParams):
    """logits, value = model(obs[, params]) (model.py:60-75)."""

    def __init__(self, config: Dict[str, Any], device=None):
        super().__init__(config, mlp_specs((h, config[h]) for h in _HEADS), device)

    def init(self, key: torch.Tensor) -> List[torch.Tensor]:
        """The JAX `LegacyActorCritic.init(key)` draw for draw: the shared,
        actor and critic MLPs from `split(key, 3)`."""
        out: Dict[str, torch.Tensor] = {}
        for head, k in zip(("shared", "actor", "critic"), rng.split(key, 3)):
            init_mlp(k, head, self.config[head], out)
        return [out[name] for name, _ in self.specs]

    def params_to_jax(self, leaves: Sequence[torch.Tensor] | None = None):
        """The leaves as the JAX package's param dict of numpy arrays (None
        at activations)."""
        leaves = list(self.leaves) if leaves is None else leaves
        byname = {n: t.detach().cpu().numpy() for (n, _), t in zip(self.specs, leaves)}
        return {head: [{"w": byname[f"{head}.{i}.w"], "b": byname[f"{head}.{i}.b"]}
                       if lc["type"] == "linear" else None
                       for i, lc in enumerate(self.config[head])]
                for head in _HEADS}

    def forward(self, obs: torch.Tensor, params: Sequence[torch.Tensor] | None = None):
        """obs [B, obs_dim] -> (logits [B, act], value [B])."""
        leaves = list(self.leaves) if params is None else params
        p = {name: t for (name, _), t in zip(self.specs, leaves)}
        h = _mlp(p, "shared", self.config["shared"], obs)
        logits = _mlp(p, "actor", self.config["actor"], h)
        value = _mlp(p, "critic", self.config["critic"], h)[..., 0]
        return logits, value


def discounted_returns(rewards: torch.Tensor, gamma: float = 0.99,
                       normalize: bool = True) -> torch.Tensor:
    """Episode returns G_t = sum_k gamma^k r_{t+k} along the leading axis,
    optionally normalised by the mean and the population std + 1e-8."""
    out = torch.empty_like(rewards)
    g = torch.zeros_like(rewards[0])
    for t in range(rewards.shape[0] - 1, -1, -1):
        g = rewards[t] + gamma * g
        out[t] = g
    if normalize:
        out = (out - out.mean()) / (out.std(correction=0) + 1e-8)
    return out


def legacy_loss(action_log_probs, returns, values):
    """adv = G - V (V detached); actor -sum(logp * adv); critic SmoothL1(G, V)
    as a mean."""
    adv = returns - values.detach()
    actor = -torch.sum(action_log_probs * adv)
    diff = returns - values
    huber = torch.where(diff.abs() < 1.0, 0.5 * diff * diff, diff.abs() - 0.5)
    return actor, huber.mean()
