"""Config-driven actor-critic.

Counterpart of `madrona_bots_tpu/models/actor_critic.py`. The architecture
is data (a config dict from `SpeciesNetGenerator`), so a checkpoint rebuilds
the net from its config. Linear weights are stored [in, out] and applied as
`x @ w + b`, as in the JAX package.

Parameters are a list of tensors in the JAX package's `jax.tree.flatten`
leaf order: top-level keys sorted (actor, critic, feature, recurrent), list
entries in order with activations (None) skipped, a linear layer's leaves as
(b, w) and the recurrent cell's as (bh, bi, wh, wi). `ActorCritic` registers
its parameters in that order, `param_specs` gives the (name, shape) list,
`unflatten` cuts one flat vector into views (the A2C learner keeps each
species' parameters as one flat vector for its flat Adam), and
`params_from_jax` / `params_to_jax` carry weights between the packages.

Recurrent memory: the cell's hidden state is the 16-vector kept inside the
simulator. LSTM carries only h (c0 = 0 every tick; TD(0) has sequence
length 1).
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from madrona_bots_tpu_torch import rng

_ACT = {
    "Tanh": torch.tanh,
    "ELU": F.elu,
    "LogSigmoid": F.logsigmoid,
    "LeakyReLU": lambda x: F.leaky_relu(x, 0.01),
    "ReLU": torch.relu,
}
_GATES = {"LSTM": 4, "GRU": 3, "RNN": 1}


def _bound(fan_in: int, device) -> torch.Tensor:
    return 1.0 / torch.sqrt(torch.tensor(float(fan_in), dtype=torch.float32, device=device))


def init_mlp(key: torch.Tensor, head: str, layer_cfgs, out: Dict[str, torch.Tensor]) -> None:
    """The JAX `_init_mlp(key, layer_cfgs)`: linear layer i's w [in, out]
    and b from `split(fold_in(key, i), 2)`, U(+-1/sqrt(in)); into `out`
    under `{head}.{i}.w` / `.b`."""
    for i, lc in enumerate(layer_cfgs):
        if lc["type"] != "linear":
            continue
        kw, kb = rng.split(rng.fold_in(key, i), 2)
        fi, fo = lc["in_features"], lc["out_features"]
        b = _bound(fi, key.device)
        out[f"{head}.{i}.w"] = rng.uniform(kw, (fi, fo), -b, b)
        out[f"{head}.{i}.b"] = rng.uniform(kb, (fo,), -b, b)


def mlp_specs(heads) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of the linear leaves of `(head, layer_cfgs)` pairs,
    given in the JAX tree's sorted key order; (b, w) within a layer."""
    specs = []
    for head, layer_cfgs in heads:
        for i, lc in enumerate(layer_cfgs):
            if lc["type"] == "linear":
                specs.append((f"{head}.{i}.b", (lc["out_features"],)))
                specs.append((f"{head}.{i}.w", (lc["in_features"], lc["out_features"])))
    return specs


def param_specs(config: Dict[str, Any]) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every parameter leaf, in JAX leaf order."""
    specs = mlp_specs((("actor", config["actor"]), ("critic", config["critic"]),
                       ("feature", config["layers"])))
    rc = config["recurrent"]
    din, dh, g = rc["input_dim"], rc["hidden_dim"], _GATES[rc["type"]]
    specs += [("recurrent.bh", (g * dh,)), ("recurrent.bi", (g * dh,)),
              ("recurrent.wh", (dh, g * dh)), ("recurrent.wi", (din, g * dh))]
    return specs


def _mlp(p: Dict[str, torch.Tensor], head: str, layer_cfgs, x):
    for i, lc in enumerate(layer_cfgs):
        if lc["type"] == "linear":
            x = x @ p[f"{head}.{i}.w"] + p[f"{head}.{i}.b"]
        else:
            x = _ACT[lc["activation"]](x)
    return x


def _recurrent(p: Dict[str, torch.Tensor], kind: str, x, h):
    gi = x @ p["recurrent.wi"] + p["recurrent.bi"]
    gh = h @ p["recurrent.wh"] + p["recurrent.bh"]
    if kind == "RNN":
        return torch.tanh(gi + gh)
    if kind == "GRU":
        ir, iz, in_ = gi.chunk(3, dim=-1)
        hr, hz, hn = gh.chunk(3, dim=-1)
        r = torch.sigmoid(ir + hr)
        z = torch.sigmoid(iz + hz)
        n = torch.tanh(in_ + r * hn)
        return (1.0 - z) * n + z * h
    ii, if_, ig, io = (gi + gh).chunk(4, dim=-1)       # LSTM, gates i,f,g,o
    c = torch.sigmoid(ii) * torch.tanh(ig)              # + f * c0, c0 = 0
    return torch.sigmoid(io) * torch.tanh(c)


class FlatParams(nn.Module):
    """A config-built net whose parameters are named leaves in JAX leaf
    order (`specs`), registered on the module and cut from or joined into
    one flat vector."""

    def __init__(self, config: Dict[str, Any], specs, device=None):
        super().__init__()
        self.config = config
        self.specs = specs
        self.sizes = [int(torch.Size(s).numel()) for _, s in self.specs]
        self.num_params = sum(self.sizes)
        self.leaves = nn.ParameterList(
            [nn.Parameter(torch.zeros(s, device=device)) for _, s in self.specs])

    @classmethod
    def from_generator(cls, generator, device=None):
        return cls(generator.sample_config(), device)

    def unflatten(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """Views of a flat [P] vector as the parameter leaves."""
        return [t.view(s) for t, (_, s) in zip(flat.split(self.sizes), self.specs)]

    def flatten(self, leaves: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.cat([t.reshape(-1) for t in leaves])

    def params_from_jax(self, tree, device=None) -> List[torch.Tensor]:
        """Leaves from a JAX param tree (nested dict of array-likes)."""
        leaves = []
        for name, shape in self.specs:
            head, *rest = name.split(".")
            node = tree[head]
            for part in rest:
                node = node[int(part)] if part.isdigit() else node[part]
            t = torch.as_tensor(np.array(node), dtype=torch.float32)
            if tuple(t.shape) != shape:
                raise ValueError(f"{name}: shape {tuple(t.shape)}, want {shape}")
            leaves.append(t.to(device))
        return leaves

    def load_leaves(self, leaves: Sequence[torch.Tensor]) -> None:
        with torch.no_grad():
            for p, t in zip(self.leaves, leaves):
                p.copy_(t)

    def get_config(self) -> Dict[str, Any]:
        return self.config


class ActorCritic(FlatParams):
    """logits, value, memory = model(obs, memory[, params])."""

    def __init__(self, config: Dict[str, Any], device=None):
        super().__init__(config, param_specs(config), device)

    # ---- parameters ----

    def init(self, key: torch.Tensor) -> List[torch.Tensor]:
        """The JAX `ActorCritic.init(key)` draw for draw: torch.nn.Linear's
        U(+-1/sqrt(fan_in)) through the threefry bits of `rng`. Returns the
        leaves (on the key's device) without touching the module."""
        kf, kr, ka, kc = rng.split(key, 4)
        out: Dict[str, torch.Tensor] = {}
        for head, k, cfg_key in (("feature", kf, "layers"), ("actor", ka, "actor"),
                                 ("critic", kc, "critic")):
            init_mlp(k, head, self.config[cfg_key], out)
        rc = self.config["recurrent"]
        din, dh, g = rc["input_dim"], rc["hidden_dim"], _GATES[rc["type"]]
        k1, k2 = rng.split(kr, 2)
        b = _bound(dh, key.device)
        out["recurrent.wi"] = rng.uniform(k1, (din, g * dh), -b, b)
        out["recurrent.wh"] = rng.uniform(k2, (dh, g * dh), -b, b)
        out["recurrent.bi"] = rng.uniform(rng.fold_in(kr, 2), (g * dh,), -b, b)
        out["recurrent.bh"] = rng.uniform(rng.fold_in(kr, 3), (g * dh,), -b, b)
        return [out[name] for name, _ in self.specs]

    def params_to_jax(self, leaves: Sequence[torch.Tensor] | None = None):
        """The leaves as the JAX package's nested param dict of numpy arrays
        (None at activations)."""
        leaves = list(self.leaves) if leaves is None else leaves
        byname = {n: t.detach().cpu().numpy() for (n, _), t in zip(self.specs, leaves)}
        tree: Dict[str, Any] = {}
        for head, cfg_key in (("feature", "layers"), ("actor", "actor"),
                              ("critic", "critic")):
            tree[head] = [{"w": byname[f"{head}.{i}.w"], "b": byname[f"{head}.{i}.b"]}
                          if lc["type"] == "linear" else None
                          for i, lc in enumerate(self.config[cfg_key])]
        tree["recurrent"] = {k: byname[f"recurrent.{k}"] for k in ("wi", "wh", "bi", "bh")}
        return tree

    # ---- forward ----

    def forward(self, obs: torch.Tensor, memory: torch.Tensor,
                params: Sequence[torch.Tensor] | None = None):
        """obs [B, obs_dim], memory [B, memory_dim] -> (logits [B, act],
        value [B], new_memory [B, memory_dim]), in the inputs' dtype."""
        leaves = list(self.leaves) if params is None else params
        p = {name: t for (name, _), t in zip(self.specs, leaves)}
        feat = _mlp(p, "feature", self.config["layers"], obs)
        h = _recurrent(p, self.config["recurrent"]["type"], feat, memory)
        logits = _mlp(p, "actor", self.config["actor"], h)
        value = _mlp(p, "critic", self.config["critic"], h)[..., 0]
        return logits, value, h

    @property
    def memory_dim(self) -> int:
        return self.config["recurrent"]["hidden_dim"]

    @property
    def action_dim(self) -> int:
        return self.config["actor"][-1]["out_features"]

    @property
    def obs_dim(self) -> int:
        return self.config["layers"][0]["in_features"]


def compute_loss(action_log_probs, reward, prev_v, new_v, gamma: float = 1.0,
                 mask=None, denom=None):
    """The TD(0) loss, masked for padded slots: advantage = r + gamma V(s')
    - V(s) with both values detached; actor = -sum(logp * adv); critic =
    SmoothL1(reward, V(s_prev)), mean over the mask. Sums run over the last
    axis, so rows [NS, N] give one loss per species. `denom` replaces the
    mask's own row count in the critic mean (a shard passes the count over
    every rank)."""
    if mask is None:
        mask = torch.ones_like(reward)
    if denom is None:
        denom = mask.sum(dim=-1)
    adv = reward + gamma * new_v.detach() - prev_v.detach()
    actor_loss = -torch.sum(action_log_probs * adv * mask, dim=-1)
    diff = reward - prev_v
    huber = torch.where(diff.abs() < 1.0, 0.5 * diff * diff, diff.abs() - 0.5)
    critic_loss = torch.sum(huber * mask, dim=-1) / torch.clamp(denom, min=1.0)
    return actor_loss, critic_loss
