"""Species-stacked actor-critic: all NS per-species nets as one batched net.

Counterpart of `madrona_bots_tpu/models/stacked.py`. The generator's
architectures differ only in trunk depth (1-3 hidden layers), per-layer
activation and recurrent cell type; every product shape is shared. So the
NS parameter sets stack along a leading [NS] axis and each product runs as
one batched `torch.matmul` over [NS, B, i] x [NS, i, o]:

* trunks are padded to the largest depth; a padded layer's weights are zero,
  get a zero gradient and never move under Adam, and a species shorter than
  the pad passes its input through unchanged;
* activations and cells run per species on slices, as in `ActorCritic`;
* the recurrent weights are padded to the LSTM gate width 4H: GRU reads the
  first 3H columns, RNN the first H;
* the actor and critic heads are the same for every species and batch with
  no slicing.

The stacked parameters are one flat f32 vector in the order of
`jax.tree.leaves` of the JAX package's stacked tree (top-level keys actor,
critic, hid, l0, rec; within a head b1, b2, w1, w2; hid and l0 b, w; rec
bh, bi, wh, wi), which is `optax.flatten`'s order: a stacked Adam state
carries over to and from the JAX package one to one. Each species' own
parameters are a fixed set of positions in that vector (`index`), so
stacking and unstacking parameters or Adam moments is a scatter or a
gather, exact both ways.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from madrona_bots_tpu_torch.models.actor_critic import _ACT, _GATES, ActorCritic

f32 = torch.float32


def _trunk_shape(config) -> tuple | None:
    """(D, hd, depth, (activation names...)) if the trunk fits the
    generator's pattern (linear D -> hd, then depth x (linear hd -> hd,
    activation)), else None."""
    layers = config["layers"]
    if not layers or layers[0]["type"] != "linear":
        return None
    D = layers[0]["in_features"]
    hd = layers[0]["out_features"]
    rest = layers[1:]
    if len(rest) % 2:
        return None
    acts = []
    for i in range(0, len(rest), 2):
        lin, act = rest[i], rest[i + 1]
        if (lin["type"] != "linear" or lin["in_features"] != hd
                or lin["out_features"] != hd or act["type"] != "activation"):
            return None
        acts.append(act["activation"])
    return D, hd, len(acts), tuple(acts)


def _head_shape(head, din, hd, dout) -> bool:
    return (len(head) == 3
            and head[0] == {"type": "linear", "in_features": din, "out_features": hd}
            and head[1] == {"type": "activation", "activation": "ReLU"}
            and head[2] == {"type": "linear", "in_features": hd, "out_features": dout})


def stackable(configs: Sequence[Dict[str, Any]]) -> bool:
    """True iff every config fits the generator's architecture space with
    shared (obs_dim, hidden_dim, memory_dim, action_dim)."""
    shapes = [_trunk_shape(c) for c in configs]
    if any(s is None for s in shapes):
        return False
    D, hd = shapes[0][0], shapes[0][1]
    if any((s[0], s[1]) != (D, hd) for s in shapes):
        return False
    for c in configs:
        rc = c["recurrent"]
        if (rc["type"] not in _GATES or rc["input_dim"] != hd
                or rc["hidden_dim"] != configs[0]["recurrent"]["hidden_dim"]):
            return False
        H = rc["hidden_dim"]
        aout = c["actor"][-1]["out_features"]
        if aout != configs[0]["actor"][-1]["out_features"]:
            return False
        if not (_head_shape(c["actor"], H, hd, aout) and _head_shape(c["critic"], H, hd, 1)):
            return False
    return True


class StackedActorCritic:
    """Batched execution of NS heterogeneous `ActorCritic` nets.

    `forward(obs [NS, B, D], memory [NS, B, H], params)` with `params` the
    leaves of `unflatten(flat)` replaces NS `ActorCritic.forward` calls; it
    has `ActorCritic`'s call signature, so the learners run either net
    through the same code."""

    def __init__(self, models: Sequence[ActorCritic]):
        configs = [m.config for m in models]
        if not stackable(configs):
            raise ValueError("architectures outside the stackable space")
        self.models = list(models)
        shapes = [_trunk_shape(c) for c in configs]
        D, hd = shapes[0][0], shapes[0][1]
        NS, H = len(models), configs[0]["recurrent"]["hidden_dim"]
        act = configs[0]["actor"][-1]["out_features"]
        self.depths = [s[2] for s in shapes]
        self.acts = [s[3] for s in shapes]
        self.max_depth = max(self.depths)
        self.cells = [c["recurrent"]["type"] for c in configs]
        self.obs_dim, self.hidden_dim, self.memory_dim, self.action_dim = D, hd, H, act
        g4 = 4 * H
        specs = []
        for head, dout in (("actor", act), ("critic", 1)):
            specs += [(f"{head}.b1", (NS, hd)), (f"{head}.b2", (NS, dout)),
                      (f"{head}.w1", (NS, H, hd)), (f"{head}.w2", (NS, hd, dout))]
        if self.max_depth:
            L = self.max_depth
            specs += [("hid.b", (NS, L, hd)), ("hid.w", (NS, L, hd, hd))]
        specs += [("l0.b", (NS, hd)), ("l0.w", (NS, D, hd)),
                  ("rec.bh", (NS, g4)), ("rec.bi", (NS, g4)),
                  ("rec.wh", (NS, H, g4)), ("rec.wi", (NS, hd, g4))]
        self.specs = specs
        self.sizes = [int(np.prod(s)) for _, s in specs]
        self.num_params = sum(self.sizes)
        self.index = [self._species_index(s) for s in range(NS)]
        self._on_device: Dict[torch.device, tuple] = {}

    @property
    def num_species(self) -> int:
        return len(self.models)

    def _species_index(self, s: int) -> torch.Tensor:
        """Positions in the stacked vector of species s's parameters, in the
        order of its own flat vector (`ActorCritic.specs`)."""
        pos, off = {}, 0
        for (name, shape), n in zip(self.specs, self.sizes):
            pos[name] = torch.arange(off, off + n, dtype=torch.int64).view(shape)[s]
            off += n
        m = _GATES[self.cells[s]] * self.memory_dim
        hidden = {1 + 2 * j: j for j in range(self.depths[s])}
        out = []
        for name, _ in self.models[s].specs:
            head, rest = name.split(".", 1)
            if head in ("actor", "critic"):
                i, leaf = rest.split(".")
                p = pos[f"{head}.{leaf}{1 if i == '0' else 2}"]
            elif head == "feature":
                i, leaf = rest.split(".")
                p = pos[f"l0.{leaf}"] if i == "0" else pos[f"hid.{leaf}"][hidden[int(i)]]
            else:
                p = pos[f"rec.{rest}"][..., :m]
            out.append(p.reshape(-1))
        return torch.cat(out)

    def _device_maps(self, device) -> tuple:
        """(per-species index vectors, species-major permutation of the
        stacked vector, species of each position) on `device`, made once."""
        device = torch.device(device)
        if device not in self._on_device:
            NS = self.num_species
            species = torch.empty(self.num_params, dtype=torch.int64)
            perm = []
            off = 0
            for n in self.sizes:            # every leaf leads with the [NS] axis
                ids = torch.arange(off, off + n, dtype=torch.int64).view(NS, n // NS)
                species[off:off + n] = torch.arange(NS).repeat_interleave(n // NS)
                perm.append(ids)
                off += n
            perm = torch.cat(perm, dim=1).reshape(-1)
            self._on_device[device] = (tuple(i.to(device) for i in self.index),
                                       perm.to(device), species.to(device))
        return self._on_device[device]

    # ---- layout conversion ----

    def unflatten(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """Views of a stacked [P] vector as the stacked leaves."""
        return [t.view(s) for t, (_, s) in zip(flat.split(self.sizes), self.specs)]

    def stack_params(self, params_list: Sequence[torch.Tensor]) -> torch.Tensor:
        """Per-species flat vectors -> the stacked flat vector (zeros at the
        padding)."""
        index = self._device_maps(params_list[0].device)[0]
        out = torch.zeros(self.num_params, dtype=params_list[0].dtype,
                          device=params_list[0].device)
        for idx, p in zip(index, params_list):
            out[idx] = p
        return out

    def unstack_params(self, stacked: torch.Tensor) -> List[torch.Tensor]:
        """The stacked flat vector -> per-species flat vectors."""
        return [stacked[idx] for idx in self._device_maps(stacked.device)[0]]

    def stack_opt_state(self, opt_states: Sequence[Any]):
        """Per-species optimizer states (NamedTuples of flat moment vectors
        and a step count) -> one stacked state: each moment vector converts
        like the parameters; the step counts must agree and pass through."""
        first = opt_states[0]
        return type(first)(*(
            self.stack_params([getattr(o, f) for o in opt_states]) if x.dim() == 1 else x
            for f, x in zip(first._fields, first)))

    def unstack_opt_state(self, opt_state) -> List[Any]:
        """One stacked optimizer state -> per-species states."""
        per = [self.unstack_params(x) if x.dim() == 1 else [x] * self.num_species
               for x in opt_state]
        return [type(opt_state)(*(p[s] for p in per)) for s in range(self.num_species)]

    def params_to_jax(self, flat: torch.Tensor) -> Dict[str, Dict[str, np.ndarray]]:
        """The stacked vector as the JAX package's stacked param tree (nested
        dict of numpy arrays)."""
        tree: Dict[str, Dict[str, np.ndarray]] = {}
        for (name, _), t in zip(self.specs, self.unflatten(flat.detach())):
            top, leaf = name.split(".")
            tree.setdefault(top, {})[leaf] = t.cpu().numpy()
        return tree

    def params_from_jax(self, tree, device=None) -> torch.Tensor:
        """The stacked vector from a JAX stacked param tree (nested dict of
        array-likes)."""
        leaves = []
        for name, shape in self.specs:
            top, leaf = name.split(".")
            t = torch.as_tensor(np.array(tree[top][leaf]), dtype=f32)
            if tuple(t.shape) != shape:
                raise ValueError(f"{name}: shape {tuple(t.shape)}, want {shape}")
            leaves.append(t.reshape(-1))
        return torch.cat(leaves).to(device)

    def train_state_from_jax(self, params_tree, opt_leaves, device=None):
        """A stacked `SpeciesTrainState` from the JAX package's stacked one:
        its param tree and its optimizer state's leaves (count, mu, nu; the
        A2C and the stacked PPO optimizer both have these), as numpy arrays."""
        from madrona_bots_tpu_torch.learn.a2c import AdamState, SpeciesTrainState

        count, mu, nu = (torch.as_tensor(np.array(x)) for x in opt_leaves)
        return SpeciesTrainState(self.params_from_jax(params_tree, device), AdamState(
            count.to(torch.int32).to(device), mu.to(f32).to(device), nu.to(f32).to(device)))

    def train_state_to_jax(self, ts) -> Tuple[Dict[str, Dict[str, np.ndarray]], list]:
        """(param tree, [count, mu, nu]) of a stacked train state, as numpy
        arrays in the JAX package's layout."""
        return (self.params_to_jax(ts.params),
                [x.detach().cpu().numpy() for x in ts.opt_state])

    # ---- forward ----

    def _cell(self, p, x, h):
        """Batched gate products, then each species' cell on its slice (the
        padded gate columns are cut off before any nonlinearity)."""
        H = self.memory_dim
        gi = torch.matmul(x, p["rec.wi"]) + p["rec.bi"][:, None, :]
        gh = torch.matmul(h, p["rec.wh"]) + p["rec.bh"][:, None, :]
        outs = []
        for s, kind in enumerate(self.cells):
            gis, ghs, hs = gi[s], gh[s], h[s]
            if kind == "RNN":
                outs.append(torch.tanh(gis[:, :H] + ghs[:, :H]))
            elif kind == "GRU":
                r = torch.sigmoid(gis[:, :H] + ghs[:, :H])
                z = torch.sigmoid(gis[:, H:2 * H] + ghs[:, H:2 * H])
                n = torch.tanh(gis[:, 2 * H:3 * H] + r * ghs[:, 2 * H:3 * H])
                outs.append((1.0 - z) * n + z * hs)
            else:                                     # LSTM, gates i, f, g, o; c0 = 0
                g = gis + ghs
                c = torch.sigmoid(g[:, :H]) * torch.tanh(g[:, 2 * H:3 * H])
                outs.append(torch.sigmoid(g[:, 3 * H:]) * torch.tanh(c))
        return torch.stack(outs, dim=0)

    def forward(self, obs: torch.Tensor, memory: torch.Tensor,
                params: Sequence[torch.Tensor]):
        """obs [NS, B, obs_dim], memory [NS, B, memory_dim] -> (logits [NS,
        B, act], value [NS, B], new memory [NS, B, memory_dim]), in the
        inputs' dtype. Species s's slices equal `ActorCritic.forward` on its
        own parameters up to the products' summation order."""
        p = {name: t for (name, _), t in zip(self.specs, params)}
        x = torch.matmul(obs, p["l0.w"]) + p["l0.b"][:, None, :]
        for j in range(self.max_depth):
            z = torch.matmul(x, p["hid.w"][:, j]) + p["hid.b"][:, j, None, :]
            x = torch.stack([_ACT[self.acts[s][j]](z[s]) if j < self.depths[s] else x[s]
                             for s in range(self.num_species)], dim=0)
        h = self._cell(p, x, memory)

        def head(name, y):
            y1 = torch.relu(torch.matmul(y, p[f"{name}.w1"]) + p[f"{name}.b1"][:, None, :])
            return torch.matmul(y1, p[f"{name}.w2"]) + p[f"{name}.b2"][:, None, :]

        return head("actor", h), head("critic", h)[..., 0], h

    __call__ = forward


def per_species_clip_by_global_norm(max_norm: float, sac: StackedActorCritic
                                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """optax.clip_by_global_norm applied to each species' slice of a stacked
    gradient on its own, never by the joint norm: species s's gradient is
    kept where sqrt(sum of its squares) < max_norm and is (g / norm) *
    max_norm otherwise (the padding is zero and adds nothing to a norm)."""
    NS = sac.num_species

    def clip(grad: torch.Tensor) -> torch.Tensor:
        _, perm, species = sac._device_maps(grad.device)
        sq = grad * grad
        norm = torch.sqrt(sq[perm].view(NS, -1).sum(dim=1))            # [NS]
        norm_e = norm[species]
        return torch.where(norm_e < max_norm, grad, (grad / norm_e) * max_norm)

    return clip
