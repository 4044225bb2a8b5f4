"""Legacy headless driver: the older loop of the reference's learn/env.py
(env.py:1-103) on the non-recurrent nets of `models/legacy.py`, printing the
simulator's FPS. Counterpart of `madrona_bots_tpu/learn/env.py`.

Each epoch: `sim_mgr.step()`, then per species one forward on its rows of
the exports, actions drawn as `jax.random.categorical` draws them, one
G - V update with Adam (`optax.adam`), the one-hot actions written into the
exported action tensor; then `shift_observations()`.

Run: python -m madrona_bots_tpu_torch.learn.env --num_worlds 2048 --num_epochs 100
(on CUDA; `--device cpu` runs the plain versions on the CPU).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from madrona_bots_tpu_torch import rng
from madrona_bots_tpu_torch.api.manager import SimManager
from madrona_bots_tpu_torch.config import NUM_ACTIONS
from madrona_bots_tpu_torch.device import resolve
from madrona_bots_tpu_torch.learn.a2c import Adam
from madrona_bots_tpu_torch.learn.util import construct_obs, set_seed
from madrona_bots_tpu_torch.models.legacy import (LegacyActorCritic,
                                                  LegacySpeciesNetGenerator,
                                                  legacy_loss)


def init_models(args, device):
    """Species nets from one generator seeded with `args.seed`, parameters
    from `fold_in(key(seed), s)`, Adam at `args.lr`: (models, optimizer,
    flat params, optimizer states)."""
    gen = LegacySpeciesNetGenerator(args.obs_dim, args.action_dim,
                                    args.hidden_dim, seed=args.seed)
    models = [LegacyActorCritic.from_generator(gen, device=device)
              for _ in range(args.num_species)]
    opt = Adam(args.lr)
    params = [m.flatten(m.init(rng.fold_in(rng.key(args.seed, device), i)))
              for i, m in enumerate(models)]
    return models, opt, params, [opt.init(p) for p in params]


def species_updates(sim_mgr, models, opt, params, opt_states, key_holder,
                    verbose: bool = False) -> None:
    """One frame's learning on the current exports, per species with rows:
    forward, sample, update `params[s]` / `opt_states[s]`, write the one-hot
    actions into the exported action tensor (env.py:75-93)."""
    offsets = sim_mgr.species_offsets()
    all_rewards = sim_mgr.reward_tensor(False).to_torch()[:, 0]
    action_buf = sim_mgr.action_tensor(False).to_torch()
    for s, model in enumerate(models):
        lo, hi = int(offsets[s]), int(offsets[s + 1])
        if hi <= lo:
            continue
        obs = construct_obs(sim_mgr, lo, hi, prev=False)
        ks = rng.split(key_holder[0])
        key_holder[0], k = ks[0], ks[1]
        p = params[s].detach().requires_grad_(True)
        logits, values = model(obs, model.unflatten(p))
        acts = rng.categorical(k, logits.detach())
        logp = torch.log_softmax(logits, -1).gather(1, acts[:, None])[:, 0]
        actor, critic = legacy_loss(logp, all_rewards[lo:hi], values)
        (grad,) = torch.autograd.grad(actor + critic, p)
        params[s], opt_states[s] = opt.update(grad, opt_states[s], params[s])
        if verbose:
            print(f"Species {s + 1}: updated on {hi - lo} agents")
        action_buf[lo:hi] = F.one_hot(acts, NUM_ACTIONS).to(action_buf.dtype)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--num_worlds", type=int, default=2048)
    p.add_argument("--num_epochs", type=int, default=100)
    p.add_argument("--num_species", type=int, default=4)
    p.add_argument("--obs_dim", type=int, default=69)
    p.add_argument("--hidden_dim", type=int, default=128)
    p.add_argument("--action_dim", type=int, default=6)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default CUDA (raises without a card)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    dev = resolve(args.device)
    set_seed(args.seed)
    sim_mgr = SimManager(0, args.num_worlds, args.seed, 32, device=dev)
    models, opt, params, opt_states = init_models(args, dev)
    key_holder = [rng.key(args.seed + 1, dev)]

    times = []
    for epoch in range(1, args.num_epochs + 1):
        if dev.type == "cuda":          # time the step, not its enqueue
            torch.cuda.synchronize(dev)
        t0 = time.time()
        sim_mgr.step()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times.append(time.time() - t0)

        counts = sim_mgr.species_count_tensor().to_numpy()
        species_updates(sim_mgr, models, opt, params, opt_states, key_holder)
        sim_mgr.shift_observations()
        if epoch % 10 == 0 or epoch == 1:
            print(f"epoch {epoch} pop={counts.sum()}")

    avg = float(np.mean(times[1:])) if len(times) > 1 else times[0]
    print(f"Average FPS for simulator: {args.num_worlds / avg}")
    return params


if __name__ == "__main__":
    main()
