"""The plain A2C TD(0) tick of the upstream's training loop, in plain torch
and float32: the upstream's per-species nets, the 69-column observation,
the loss, autograd over the reference's own modules, Adam, the action draw
and the write-back, around the frozen env step (`env.py`). Imports nothing
of the port; its nets come from the architecture dicts alone.

The nets are the upstream's (llGuy/madrona-bots learn/models.py:20-171):
a feature MLP (Linear layers, each hidden one followed by an activation
from {Tanh, ELU, LogSigmoid, LeakyReLU, ReLU}), a recurrent cell from
{LSTM, GRU, RNN} whose memory the simulator keeps, and two-layer actor and
critic heads, built here from `torch.nn` modules. Departures, each the
port's and each noted where it is made:

- LSTM: the simulator keeps one memory vector, h; the cell starts from
  c = 0 every tick (TD(0) sees one step).
- Rows: a species trains on every slot of its class (slot i holds class
  i % NS + 1) with dead slots masked, where the upstream slices the alive
  agents out of the species-major exports; masked rows add nothing to a
  sum, and the critic's mean divides by the masked count.
- Loss rows: rows whose slot held another species (or none) a tick ago have
  no previous transition and leave the loss.
- The draw: argmax(logits + Gumbel noise) from threefry bits (`rng.py`,
  `jax.random.categorical`), where the upstream samples
  `torch.distributions.Categorical`.
- Adam: optax's formula on one flat parameter vector, update = -lr * m_hat
  / (sqrt(v_hat) + eps), which is torch.optim.Adam's algebra.

Parameters travel as one flat f32 vector a species in the checkpoint's leaf
order: for the actor, then the critic, then the feature MLP, each Linear's
(bias, weight as [in, out]); then the recurrent cell's (hidden bias, input
bias, hidden weight as [memory, gates * memory], input weight as [in, gates *
memory]), gates in torch's order.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference import env, rng

NUM_ACTIONS = 6
ACTIVATIONS = {"Tanh": nn.Tanh, "ELU": nn.ELU, "LogSigmoid": nn.LogSigmoid,
               "LeakyReLU": nn.LeakyReLU, "ReLU": nn.ReLU}
CELLS = {"LSTM": nn.LSTMCell, "GRU": nn.GRUCell, "RNN": nn.RNNCell}
B1, B2, EPS = 0.9, 0.999, 1e-8


def _mlp(layer_cfgs, device) -> nn.Sequential:
    return nn.Sequential(*[
        nn.Linear(lc["in_features"], lc["out_features"], device=device)
        if lc["type"] == "linear" else ACTIVATIONS[lc["activation"]]()
        for lc in layer_cfgs])


class Net(nn.Module):
    """logits, value, memory = net(obs, memory), from an architecture dict
    ("layers", "recurrent", "actor", "critic")."""

    def __init__(self, arch: dict, device=None):
        super().__init__()
        rc = arch["recurrent"]
        self.kind = rc["type"]
        self.feature = _mlp(arch["layers"], device)
        self.cell = CELLS[self.kind](rc["input_dim"], rc["hidden_dim"], device=device)
        self.actor = _mlp(arch["actor"], device)
        self.critic = _mlp(arch["critic"], device)

    def forward(self, obs: torch.Tensor, memory: torch.Tensor):
        x = self.feature(obs)
        if self.kind == "LSTM":
            h, _ = self.cell(x, (memory, torch.zeros_like(memory)))   # c = 0 (see above)
        else:
            h = self.cell(x, memory)
        return self.actor(h), self.critic(h)[..., 0], h

    def leaves(self) -> list:
        """(parameter, stored transposed) in the flat vector's order."""
        out = []
        for mlp in (self.actor, self.critic, self.feature):
            for m in mlp:
                if isinstance(m, nn.Linear):
                    out += [(m.bias, False), (m.weight, True)]
        c = self.cell
        return out + [(c.bias_hh, False), (c.bias_ih, False), (c.weight_hh, True),
                      (c.weight_ih, True)]

    def load(self, flat: torch.Tensor) -> None:
        i = 0
        with torch.no_grad():
            for p, transposed in self.leaves():
                v = flat[i:i + p.numel()]
                p.copy_(v.view(p.shape[::-1]).t() if transposed else v.view(p.shape))
                i += p.numel()
        if i != flat.numel():
            raise ValueError(f"{flat.numel()} parameters for a net of {i}")

    def flat(self, tensors) -> torch.Tensor:
        """Tensors shaped as `leaves()` (the parameters or their gradients)
        as one flat f32 vector in the checkpoint's order."""
        return torch.cat([(t.t() if tr else t).reshape(-1).float()
                          for t, (_, tr) in zip(tensors, self.leaves())])


@contextlib.contextmanager
def exact_f32():
    """float32 products in float32: no TF32 in matmuls or cuDNN."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def observation(state, prev: bool) -> torch.Tensor:
    """[W, A, 69] f32: depth (32), health, position (2), semantic (32),
    surrounding (2), of this tick or (prev) of the last."""
    p = "prev_" if prev else ""
    return torch.cat([getattr(state, p + "sensor_depth").float(),
                      getattr(state, p + "health")[..., None].float(),
                      getattr(state, p + "pos"),
                      getattr(state, p + "sensor_semantic").float(),
                      getattr(state, p + "surrounding")], dim=-1)


def rows(x: torch.Tensor, s: int, num_species: int) -> torch.Tensor:
    """Class s's slots of a [W, A, ...] field as [W * A / NS, ...] rows,
    world-major (the order of the draw's counters)."""
    return x[:, s::num_species].reshape((-1,) + x.shape[2:])


def adam(params, grad, count, mu, nu, lr: float):
    """(params, count, mu, nu) after one optax Adam step."""
    mu = (1 - B1) * grad + B1 * mu
    nu = (1 - B2) * (grad * grad) + B2 * nu
    count = count + 1
    t = count.float()
    mu_hat = mu / (1 - torch.pow(torch.full_like(t, B1), t))
    nu_hat = nu / (1 - torch.pow(torch.full_like(t, B2), t))
    return params - lr * (mu_hat / (torch.sqrt(nu_hat) + EPS)), count, mu, nu


def species_update(net: Net, S1, s: int, key, params, opt, cfg, lr: float, gamma: float,
                   dtype=torch.float32) -> dict:
    """One species' update on the stepped state S1: the no-grad forward on
    this tick's rows, the draw, the loss on last tick's rows and its
    gradient, and Adam. `dtype` is the nets' precision (the control
    computes them in bfloat16). Returns its record: obs, memory, logits,
    the draw's first-to-second margin, actions, new memory (all rows),
    mask, gradient, parameters after and their step, Adam state after,
    actor loss, the sum of its terms' magnitudes, critic loss."""
    NS = cfg.num_species
    mask = rows(S1.alive & (S1.species == s + 1), s, NS).float()
    lmask = mask * rows(S1.prev_species == s + 1, s, NS).float()
    obs, obs_prev = rows(observation(S1, False), s, NS), rows(observation(S1, True), s, NS)
    mem, mem_prev = rows(S1.hidden, s, NS), rows(S1.prev_hidden, s, NS)
    prev_action = rows(torch.argmax(S1.action, dim=-1), s, NS)
    reward = rows(S1.reward, s, NS)
    net.load(params)
    net.to(dtype)
    with torch.no_grad():
        logits, v_new, h = (t.float() for t in net(obs.to(dtype), mem.to(dtype)))
    score = rng.gumbel(key, logits.shape) + logits
    top2 = torch.topk(score, 2, dim=-1).values
    logits_p, v_prev, _ = net(obs_prev.to(dtype), mem_prev.to(dtype))
    logits_p, v_prev = logits_p.float(), v_prev.float()
    # The upstream's default takes the raw actor outputs as log-probabilities.
    logp = torch.gather(logits_p, -1, prev_action[:, None])[:, 0]
    adv = reward + gamma * v_new - v_prev.detach()
    terms = logp * adv * lmask
    actor = -terms.sum()
    critic = ((F.smooth_l1_loss(v_prev, reward, reduction="none", beta=1.0) * lmask).sum()
              / torch.clamp(lmask.sum(), min=1.0))
    leaves = [p for p, _ in net.leaves()]
    grad = net.flat(torch.autograd.grad(actor + critic, leaves))
    new_params, count, mu, nu = adam(params, grad, *opt, lr)
    return {"obs": obs, "mem": mem, "logits": logits, "margin": top2[:, 0] - top2[:, 1],
            "actions": torch.argmax(score, dim=-1), "memory": h, "mask": mask, "grad": grad,
            "params": new_params, "step": new_params - params, "opt": (count, mu, nu),
            "actor": actor.detach(),
            "actor_scale": terms.detach().abs().sum(), "critic": critic.detach()}


def tick(state, train_states, key, cfg, archs, lr: float = 3e-4, gamma: float = 1.0,
         dtype=torch.float32):
    """One epoch of the upstream's loop from `state` (consumed), with
    `train_states[s]` = (params, (count, mu, nu)) and the loop's carried
    key: split the key and take the second half, step the worlds, update
    each species with its key fold_in(half, s), write the one-hot actions
    and new memory of the alive rows, shift. Returns (state, the species'
    records of `species_update`)."""
    NS, A = cfg.num_species, cfg.max_agents
    sub = rng.split(key, 2)[1]
    S1 = env.step(state, cfg)
    W = S1.alive.shape[0]
    action = torch.zeros(W, A, NUM_ACTIONS, dtype=torch.int32, device=S1.alive.device)
    hidden = torch.zeros_like(S1.hidden)
    records = []
    with exact_f32():
        for s, arch in enumerate(archs):
            net = Net(arch, S1.alive.device)
            params, opt = train_states[s]
            r = species_update(net, S1, s, rng.fold_in(sub, s), params, opt, cfg, lr, gamma,
                               dtype)
            m = r["mask"].view(W, -1)
            action[:, s::NS] = (F.one_hot(r["actions"], NUM_ACTIONS).view(W, -1, NUM_ACTIONS)
                                * m[..., None].to(torch.int32))
            hidden[:, s::NS] = r["memory"].view(W, -1, hidden.shape[-1]) * m[..., None]
            records.append(r)
    S2 = env.shift_observations(S1, cfg)
    return S2.replace(action=action, hidden=hidden), records
