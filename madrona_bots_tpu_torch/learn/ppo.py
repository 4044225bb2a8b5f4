"""PPO actor-learner with rollout buffers on the device.

Counterpart of `madrona_bots_tpu/learn/ppo.py`'s per-species loop path. One
iteration collects `rollout_len` env steps with the current policies, runs
GAE over them, and takes `update_epochs x num_minibatches` clipped-surrogate
minibatch updates per species. PyTorch runs it eagerly; the iteration's
values follow the jitted JAX `ppo_iteration`.

Species-class slot partitioning (SPEC D2b): slot i belongs to species
(i % NS) + 1, so each species' rows are a strided view of the [W, A] batch
and its policy forwards run on that view at full width. With
`learner_slots_per_class = L < A / NS` each step also packs every (world,
class)'s alive rows into L learner rows (`RolloutC`): in bf16 that is one
launch of the row-gather kernel (`ops/row_gather_cuda.py`) over four fields,
in f32 an exact gather of one payload (`learn/pack.py`). Overflow rows are
left out of the learner batch only, counted in `species_*_dropped_rows`;
trajectories do not depend on L.

Minibatches keep the JAX schedule: each species' B rows are rolled by a
key-derived offset (`decorrelate`), minibatch c holds rows i * M + c, and
epoch e visits minibatch (i + e) % M at step i. The buffers are built once
per iteration in that minibatch-major order with one gather each.

`compute_dtype=torch.bfloat16` runs the forwards (rollout and update) in
bf16 against f32 master parameters; GAE, losses, gradients and Adam stay
f32.

The species-stacked trainer (`stacked=True`, the JAX package's stacked
branches) runs every species through one `StackedActorCritic`
(`models/stacked.py`): one full-width forward and one categorical draw (keys
`fold_in(key, s)`) a rollout step, buffers [M, NS, mb, ...] with the same
rows, roll and minibatch classes as per species, and one loss and one Adam
step a minibatch with per-species advantage normalisation, losses and
gradient clip (`make_stacked_ppo_optimizer`). It needs learner slots; the
record pack is the loop's.

With a mesh (`parallel/`) an iteration runs on a rank's shard of the
worlds: its draws are its slices of the global draws, each minibatch is
its rows of the global minibatch (`shard_minibatches`), and the advantage
moments, gradients and metrics are all-reduced.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from madrona_bots_tpu_torch import rng
from madrona_bots_tpu_torch.config import NUM_ACTIONS, EnvConfig
from madrona_bots_tpu_torch.device import const
from madrona_bots_tpu_torch.env import env as env_mod
from madrona_bots_tpu_torch.env.state import WorldState
from madrona_bots_tpu_torch.learn.a2c import (Adam, SpeciesTrainState, class_masks,
                                              clip_by_global_norm, policy_forward)
from madrona_bots_tpu_torch.learn.pack import (class_major, compact_gather, compact_slots,
                                               kslot_from_class_slots, split3)
from madrona_bots_tpu_torch.models.actor_critic import ActorCritic
from madrona_bots_tpu_torch.models.stacked import (StackedActorCritic,
                                                   per_species_clip_by_global_norm)
from madrona_bots_tpu_torch.ops import row_gather_cuda

f32 = torch.float32
bf16 = torch.bfloat16

PER_SPECIES_METRICS = ("loss", "pg_loss", "v_loss", "entropy", "count", "reward",
                       "dropped_rows")
"""Per-species metrics of an iteration, each as `species_{s}_{name}`, s from 1;
`env_steps` follows them."""


class Rollout(NamedTuple):
    """[T, W, A, ...] per-step records (no learner slots)."""
    depth: torch.Tensor        # u8  [T, W, A, S]
    semantic: torch.Tensor     # i8  [T, W, A, S]
    health: torch.Tensor       # i32 [T, W, A]
    pos: torch.Tensor          # f32 [T, W, A, 2]
    surrounding: torch.Tensor  # f32 [T, W, A, 2]
    memory: torch.Tensor       # f32 [T, W, A, H] (input memory at step t)
    species: torch.Tensor      # i32 [T, W, A]
    action: torch.Tensor       # i8  [T, W, A]
    logp: torch.Tensor         # f32 [T, W, A]
    value: torch.Tensor        # f32 [T, W, A]
    reward: torch.Tensor       # f32 [T, W, A]
    alive: torch.Tensor        # bool [T, W, A]
    next_alive: torch.Tensor   # bool [T, W, A]


class RolloutC(NamedTuple):
    """Record-compacted rollout (learner slots set). `rec` holds each
    step's learner rows, groups class-outermost (g = s * W + w, `rows` rows
    a group), columns [obs(D), memory(H), action, logp, value] with logp
    and value as three bf16 planes each in bf16. GAE's inputs stay on the
    [W, A] slot domain: the advantage recursion chains per slot."""
    rec: torch.Tensor         # [T, G*rows, C] packed learner rows
    valid: torch.Tensor       # bool [T, G*rows] (row r < alive count)
    srcrow: torch.Tensor      # i32 [T, G*rows] source slot in [0, A)
    dropped: torch.Tensor     # i32 [T, NS] overflow rows beyond the cap
    value_full: torch.Tensor  # f32 [T, W, A] full-width values (GAE)
    alive: torch.Tensor       # bool [T, W, A] pre-step
    reward: torch.Tensor      # f32 [T, W, A]
    next_alive: torch.Tensor  # bool [T, W, A]


def _flat_obs(depth, health, pos, semantic, surrounding, dtype=f32):
    """The 69-dim obs layout [depth, health, pos, semantic, surrounding]."""
    return torch.cat([depth.to(dtype), health[..., None].to(dtype), pos.to(dtype),
                      semantic.to(dtype), surrounding.to(dtype)], dim=-1)


def make_ppo_optimizer(lr: float = 3e-4, max_grad_norm: float = 0.5) -> Adam:
    """`optax.flatten(chain(clip_by_global_norm(max_grad_norm), adam(lr,
    eps=1e-5)))` on the flat parameter vector."""
    return Adam(lr, eps=1e-5, clip=clip_by_global_norm(max_grad_norm))


def make_stacked_ppo_optimizer(sac: StackedActorCritic, lr: float = 3e-4,
                               max_grad_norm: float = 0.5) -> Adam:
    """The PPO optimizer of the stacked vector: each species' gradient
    clipped by its own global norm (never the joint one), then the flat Adam
    with eps 1e-5. Its state has the loop optimizer's leaves, so
    `StackedActorCritic.stack_opt_state` converts checkpoints both ways."""
    return Adam(lr, eps=1e-5, clip=per_species_clip_by_global_norm(max_grad_norm, sac))


def gae(reward, alive, next_alive, value, last_value, gamma: float,
        gae_lambda: float) -> torch.Tensor:
    """Advantages [T, ...] by the reverse GAE recursion on the slot domain:
    an agent's death (alive[t] & ~next_alive[t]) ends its trajectory with a
    bootstrap of 0; the env never resets (quirk Q7)."""
    adv = torch.empty_like(value)
    g = torch.zeros_like(last_value)
    next_value = last_value
    for t in reversed(range(value.shape[0])):
        alive_next = next_alive[t] & alive[t]
        nv = torch.where(alive_next, next_value, 0.0)
        delta = reward[t] + gamma * nv - value[t]
        g = delta + gamma * gae_lambda * torch.where(alive_next, g, 0.0)
        adv[t] = g
        next_value = value[t]
    return adv


def record_fields(state: WorldState, action: torch.Tensor, logp: torch.Tensor,
                  value: torch.Tensor):
    """The four [W, A, d] sources the bf16 record pack gathers in one
    launch: depth bytes, semantic bytes, 12 bf16 scalar columns [health,
    pos, surrounding, action, logp as three bf16 planes, value as three],
    and the input memory in bf16."""
    scal = torch.cat([state.health[..., None].to(bf16), state.pos.to(bf16),
                      state.surrounding.to(bf16), action[..., None].to(bf16),
                      *(p[..., None] for p in split3(logp)),
                      *(p[..., None] for p in split3(value))], dim=-1)
    return [state.sensor_depth, state.sensor_semantic, scal, state.hidden.to(bf16)]


class PPOTrainer:
    """The PPO iteration and its stages. Call it (or `ppo_iteration`) as
    (state, train_states, key) -> (state, train_states, metrics); it
    consumes `state`. `use_kernels=False` runs every kernel's plain version
    (on any device); on CUDA tensors the default launches the kernels."""

    def __init__(self, models: Sequence[ActorCritic], cfg: EnvConfig, optimizer: Adam,
                 rollout_len: int, num_minibatches: int, update_epochs: int,
                 clip_eps: float, gamma: float, gae_lambda: float, vf_coef: float,
                 ent_coef: float, use_kernels: bool, compute_dtype,
                 learner_slots_per_class, decorrelate: bool, stacked: bool = False,
                 mesh=None):
        self.models, self.cfg, self.optimizer = list(models), cfg, optimizer
        self.mesh = mesh
        self.lo = 0 if mesh is None else mesh.world_range(cfg.num_worlds)[0]
        self.NS = cfg.num_species
        if len(self.models) != self.NS:
            raise ValueError(f"{len(self.models)} models for {self.NS} species")
        if compute_dtype not in (None, bf16):
            raise ValueError(f"compute_dtype must be None or bfloat16, got {compute_dtype}")
        self.T, self.M, self.E = rollout_len, num_minibatches, update_epochs
        self.clip_eps, self.gamma, self.gae_lambda = clip_eps, gamma, gae_lambda
        self.vf_coef, self.ent_coef = vf_coef, ent_coef
        self.use_kernels, self.cd, self.decorrelate = use_kernels, compute_dtype, decorrelate
        self.Asub = cfg.max_agents // self.NS
        L = learner_slots_per_class
        self.rec_mode = L is not None and L < self.Asub
        self.rows = L if self.rec_mode else self.Asub
        self.obs_dtype = f32 if compute_dtype is None else compute_dtype
        if stacked and not self.rec_mode:
            raise ValueError("the stacked PPO trainer requires learner-slot compaction "
                             "(learner_slots_per_class < A / NS)")
        self.sac = StackedActorCritic(self.models) if stacked else None
        B = self.T * cfg.num_worlds * self.rows
        if B % num_minibatches:
            raise ValueError(f"{B} learner rows a species do not split into "
                             f"{num_minibatches} minibatches")

    def __call__(self, state, train_states, key):
        return self.ppo_iteration(state, train_states, key)

    # ---- rollout ----

    def policy_step(self, params, state: WorldState, key, sample: bool = True):
        """Every species' forward on its class rows (the species-major [NS, W
        * A / NS] view) at full width: NS forwards from the species' flat
        vectors `params`, or with the stacked trainer one forward of the
        stacked net from the stacked vector. Actions are sampled with
        `categorical(fold_in(key, s), logits)`, the stacked trainer's in one
        draw of the same bits. Returns [W, A]-shaped (action int64, logp,
        value, new memory [W, A, H]) masked to alive rows of the right
        class, and the [W, A, D] obs the forwards read. With sample=False
        only the values are computed (the rest None)."""
        NS, Asub = self.NS, self.Asub
        W, A = state.alive.shape

        def st(x):                             # [W, A(, k)] -> [NS, W * Asub(, k)]
            return class_major(x, NS).reshape((NS, W * Asub) + x.shape[2:])

        def unst(x):                           # [NS, W * Asub(, k)] -> [W, A(, k)]
            x = x.reshape((NS, W, Asub) + x.shape[2:])
            return x.permute((1, 2, 0) + tuple(range(3, x.dim()))).reshape((W, A) + x.shape[3:])

        obs = _flat_obs(state.sensor_depth, state.health, state.pos,
                        state.sensor_semantic, state.surrounding, self.obs_dtype)
        m = st(class_masks(state, NS)[0])
        with torch.no_grad():
            if self.sac is not None:
                logits, v, h = policy_forward(self.sac, params, st(obs), st(state.hidden),
                                              self.cd)
            else:
                logits, v, h = (torch.stack(x) for x in zip(*(
                    policy_forward(model, p, o, mem, self.cd) for model, p, o, mem in
                    zip(self.models, params, st(obs), st(state.hidden)))))
            value = unst(torch.where(m, v, 0.0))
            if not sample:
                return None, None, value, None, obs
            # A shard draws rows [lo * Asub, hi * Asub) of each species'
            # global draw.
            off = self.lo * Asub * NUM_ACTIONS
            if self.sac is not None:
                a = rng.categorical(rng.fold_in(key, torch.arange(NS, device=key.device)),
                                    logits, off)
            else:
                a = torch.stack([rng.categorical(rng.fold_in(key, s), logits[s], off)
                                 for s in range(NS)])
            lp = torch.gather(F.log_softmax(logits, dim=-1), -1, a[..., None])[..., 0]
            new_hidden = unst(h * m[..., None].to(h.dtype))
        return (unst(torch.where(m, a, 0)), unst(torch.where(m, lp, 0.0)), value,
                new_hidden, obs)

    def pack_records(self, state: WorldState, obs, action, logp, value):
        """One compaction of every (world, class)'s alive rows into `rows`
        learner rows: (rec [G*rows, C], valid [G*rows], srcrow [G*rows] =
        slot * NS + class, dropped [NS] int32). In bf16 one row-gather
        launch over `record_fields`; in f32 a gather of the [G, Asub, C]
        payload. Both move the bits the forwards read."""
        NS, Asub, rows = self.NS, self.Asub, self.rows
        W = state.alive.shape[0]
        G = NS * W
        m = class_major(class_masks(state, NS)[0], NS)                  # [G, Asub]
        slot, valid, keep = compact_slots(m, rows)
        if self.cd == bf16:
            gather = (row_gather_cuda.compact_fields if self.use_kernels
                      else row_gather_cuda.compact_fields_reference)
            kslot = kslot_from_class_slots(slot, valid, W, NS)
            depth, semantic, scal, hidden = gather(
                kslot, record_fields(state, action, logp, value))
            # [W, K, .] fields -> [G * rows, C] in the column order
            # [obs(D), memory(H), action, logp x3, value x3].
            rec = torch.cat([depth, scal[..., 0:3], semantic, scal[..., 3:5], hidden,
                             scal[..., 5:]], dim=-1)
            rec = rec.reshape(W, NS, rows, -1).permute(1, 0, 2, 3).reshape(G * rows, -1)
        else:
            payload = torch.cat([obs, state.hidden, action[..., None].to(f32),
                                 logp[..., None], value[..., None]], dim=-1)
            rec = compact_gather(class_major(payload, NS), slot, valid).reshape(G * rows, -1)
        cls = torch.arange(G, dtype=torch.int32, device=m.device) // W
        srcrow = slot * NS + cls[:, None]
        dropped = (m.reshape(NS, W * Asub).sum(dim=1)
                   - keep.reshape(NS, W * Asub).sum(dim=1)).to(torch.int32)
        return rec, valid.reshape(G * rows), srcrow.reshape(G * rows), dropped

    def rollout(self, state: WorldState, params, key):
        """`rollout_len` env steps with the current policies: (state, the key
        left after the T splits, Rollout or RolloutC). Consumes `state`."""
        T, NS, rows = self.T, self.NS, self.rows
        W, A = state.alive.shape
        dev = state.alive.device
        H, S = state.hidden.shape[-1], state.sensor_depth.shape[-1]

        def buf(*shape, dtype=f32):
            return torch.empty((T,) + shape, dtype=dtype, device=dev)

        slot_domain = dict(alive=buf(W, A, dtype=torch.bool), reward=buf(W, A),
                           next_alive=buf(W, A, dtype=torch.bool))
        if self.rec_mode:
            C = self.cfg.obs_dim + H + (6 if self.cd == bf16 else 2) + 1
            recs = dict(rec=buf(NS * W * rows, C, dtype=self.obs_dtype),
                        valid=buf(NS * W * rows, dtype=torch.bool),
                        srcrow=buf(NS * W * rows, dtype=torch.int32),
                        dropped=buf(NS, dtype=torch.int32), value_full=buf(W, A))
        else:
            recs = dict(depth=buf(W, A, S, dtype=torch.uint8),
                        semantic=buf(W, A, S, dtype=torch.int8),
                        health=buf(W, A, dtype=torch.int32), pos=buf(W, A, 2),
                        surrounding=buf(W, A, 2), memory=buf(W, A, H),
                        species=buf(W, A, dtype=torch.int32),
                        action=buf(W, A, dtype=torch.int8), logp=buf(W, A), value=buf(W, A))
        recs.update(slot_domain)
        for t in range(T):
            key, k_act = rng.split(key, 2)
            action, logp, value, new_hidden, obs = self.policy_step(params, state, k_act)
            recs["alive"][t].copy_(state.alive)
            if self.rec_mode:
                for name, x in zip(("rec", "valid", "srcrow", "dropped"),
                                   self.pack_records(state, obs, action, logp, value)):
                    recs[name][t].copy_(x)
                recs["value_full"][t].copy_(value)
            else:
                for name, x in (("depth", state.sensor_depth), ("semantic", state.sensor_semantic),
                                ("health", state.health), ("pos", state.pos),
                                ("surrounding", state.surrounding), ("memory", state.hidden),
                                ("species", state.species), ("action", action),
                                ("logp", logp), ("value", value)):
                    recs[name][t].copy_(x)
            onehot = F.one_hot(action, NUM_ACTIONS).to(torch.int32) * state.alive[..., None]
            state = env_mod.step(state.replace(action=onehot, hidden=new_hidden), self.cfg,
                                 self.use_kernels)
            recs["reward"][t].copy_(state.reward)
            recs["next_alive"][t].copy_(state.alive)
        return state, key, (RolloutC if self.rec_mode else Rollout)(**recs)

    def advantages(self, state: WorldState, params, key, roll) -> torch.Tensor:
        """GAE advantages [T, W, A], bootstrapped from the current policy's
        values at the state after the rollout. (JAX draws these values with
        `fold_in(key, 999)`; values do not depend on the key.)"""
        _, _, last_value, _, _ = self.policy_step(params, state, None, sample=False)
        value_t = roll.value_full if self.rec_mode else roll.value
        return gae(roll.reward, roll.alive, roll.next_alive, value_t, last_value,
                   self.gamma, self.gae_lambda)

    # ---- update ----

    def roll_offset(self, key, B: int, dev) -> torch.Tensor:
        """The iteration's roll of the B rows: `randint(fold_in(key, 777),
        (), 0, B)`, 0 without decorrelate."""
        if self.decorrelate:
            return rng.randint(rng.fold_in(key, 777), (), 0, B).to(torch.int64)
        return torch.zeros((), dtype=torch.int64, device=dev)

    def minibatch_order(self, key, B: int, dev) -> torch.Tensor:
        """[M * mb] row indices: the rows rolled by `roll_offset`, minibatch
        c = rolled rows i * M + c, minibatch-major."""
        M = self.M
        mb = B // M
        off = self.roll_offset(key, B, dev)
        c = torch.arange(M, device=dev)[:, None]
        i = torch.arange(mb, device=dev)[None, :]
        return torch.remainder(i * M + c - off, B).reshape(M * mb)

    def shard_minibatches(self, key, W: int, dev):
        """This rank's share of each global minibatch, with the mesh: ([M *
        P] local row indices, [M, P] present). Global row g = (t, world,
        r) of a species' T * num_worlds * rows rows lies in minibatch c =
        (g + roll) % M at position i = ((g + roll) % B) // M; the rank's
        rows of each minibatch keep ascending i. Their count depends on the
        roll, so each minibatch is padded to P = T * ceil(W * rows / M)
        rows (the most any roll gives; no sync) with `present` False; it is
        exact where W * rows divides by M or the rank holds every world
        (then this is `minibatch_order`)."""
        T, rows, M = self.T, self.rows, self.M
        Wg = self.cfg.num_worlds
        B, n = T * Wg * rows, W * rows
        local = torch.arange(T * n, device=dev)
        h = torch.remainder((local // n) * (Wg * rows) + self.lo * rows + local % n
                            + self.roll_offset(key, B, dev), B)
        cls = h % M
        srt = torch.argsort(cls * (B // M) + h // M)
        counts = torch.bincount(cls, minlength=M)
        cs = cls[srt]
        pos = local - (torch.cumsum(counts, 0) - counts)[cs]
        P = T * n // M if n % M == 0 or W == Wg else T * -(-n // M)
        idx = torch.zeros((M, P), dtype=torch.int64, device=dev)
        present = torch.zeros((M, P), dtype=torch.bool, device=dev)
        idx[cs, pos] = srt
        present[cs, pos] = True
        return idx.reshape(M * P), present

    def update_buffers(self, roll, advantages, key):
        """The update's buffers in minibatch-major order: (om [M, mb, D + H],
        action i32, old logp, advantage, return, old value, mask) per
        species, or with the stacked trainer one such tuple of [M, NS, mb,
        ...] buffers (the same rows for species s); and the dropped rows
        [NS]. Compacted rows are gathered straight from the records, their
        advantages at the recorded source slots; returns = advantage +
        recorded value. With the mesh a minibatch holds this rank's rows of
        the global one (`shard_minibatches`), the padding masked out."""
        T, NS, rows, Asub, M = self.T, self.NS, self.rows, self.Asub, self.M
        W, A = roll.alive.shape[1:]
        D = self.cfg.obs_dim
        dev = advantages.device
        if self.mesh is None:
            order, present = self.minibatch_order(key, T * W * rows, dev), None
        else:
            order, present = self.shard_minibatches(key, W, dev)
        B = order.numel()                     # this rank's rows over all minibatches

        if self.rec_mode:
            C = roll.rec.shape[-1]
            H = C - D - 1 - (2 if self.cd is None else 6)
            # Row b = (t, w, r) of species s is record (t, s, w, r).
            t, q = order // (W * rows), order % (W * rows)
            idx = (t * NS + torch.arange(NS, device=dev)[:, None]) * (W * rows) + q
            idx = idx.reshape(NS, M, B // M).transpose(0, 1)          # [M, NS, mb]
            valid = roll.valid.reshape(-1)[idx]
            if present is not None:
                valid = valid & present[:, None, :]
            rec = roll.rec.reshape(-1, C)[idx]
            src = roll.srcrow.reshape(-1)[idx].long()
            tw = (t * W + q // rows).reshape(M, 1, B // M)
            ad = advantages.reshape(-1)[tw * A + src]
            c0 = D + H + 1                                          # scalar columns
            if self.cd is None:
                lp, vv = rec[..., c0], rec[..., c0 + 1]
            else:
                lp = sum(rec[..., c0 + i].to(f32) for i in range(3))
                vv = sum(rec[..., c0 + 3 + i].to(f32) for i in range(3))
            bufs = (rec[..., 0:D + H], rec[..., D + H].to(torch.int32), lp, ad, ad + vv, vv,
                    valid)
            dropped = roll.dropped.sum(dim=0)
            if self.sac is not None:
                return bufs, dropped
            return [tuple(x[:, s] for x in bufs) for s in range(NS)], dropped

        def mbm(x):
            return x.index_select(0, order).reshape((M, B // M) + x.shape[1:])

        def fl(x, s):
            x4 = x.reshape((T, W, Asub, NS) + x.shape[3:])
            return x4[:, :, :, s].reshape((T * W * Asub,) + x.shape[3:])

        returns = advantages + roll.value
        bufs = []
        for s in range(NS):
            obs = _flat_obs(fl(roll.depth, s), fl(roll.health, s), fl(roll.pos, s),
                            fl(roll.semantic, s), fl(roll.surrounding, s), self.obs_dtype)
            om = torch.cat([obs, fl(roll.memory, s).to(obs.dtype)], dim=-1)
            mask = mbm(fl(roll.alive, s) & (fl(roll.species, s) == s + 1))
            if present is not None:
                mask = mask & present
            bufs.append(tuple(mbm(x) for x in (
                om, fl(roll.action, s).to(torch.int32), fl(roll.logp, s),
                fl(advantages, s), fl(returns, s), fl(roll.value, s))) + (mask,))
        return bufs, torch.zeros(NS, dtype=torch.int32, device=dev)

    def adv_moments(self, bufs_list):
        """Each minibatch's (valid-row count clamped to 1, advantage mean,
        advantage variance) for the advantage normalisation, in two passes:
        (sum w, sum w * adv), then sum w * (adv - mean)^2, each summed over
        the mesh's ranks in one all-reduce. `bufs_list` holds the buffers of
        each species, or the stacked ones; returns [len(bufs_list)][M]
        triples, scalars or [NS]."""
        M = self.M

        def reduce(xs):
            return xs if self.mesh is None else self.mesh.reduce_sum(xs)

        ws = [b[6].to(f32) for b in bufs_list]
        first = reduce([x for b, w in zip(bufs_list, ws) for c in range(M)
                        for x in (w[c].sum(dim=-1), torch.sum(b[3][c] * w[c], dim=-1))])
        denom = [torch.clamp(n, min=1.0) for n in first[0::2]]
        mu = [sa / d for sa, d in zip(first[1::2], denom)]
        second = reduce([torch.sum((b[3][c] - mu[j * M + c][..., None]) ** 2 * w[c], dim=-1)
                         for j, (b, w) in enumerate(zip(bufs_list, ws)) for c in range(M)])
        stats = [(d, m, v / d) for d, m, v in zip(denom, mu, second)]
        return [stats[j * M:(j + 1) * M] for j in range(len(bufs_list))]

    def loss(self, model, flat: torch.Tensor, picked, moments):
        """(loss, pg_loss, v_loss, entropy) of one minibatch, each summed
        over its valid rows and divided by max(their count, 1), the count
        and the advantage normalisation's `moments` (`adv_moments`) over
        every rank: scalars for a species' `ActorCritic`, [NS] for the
        stacked net on [NS, mb, ...] rows (advantages normalised per
        species). A shard's losses sum to the global minibatch's."""
        om, a, lp_old, adv, ret, vold, msk = picked
        D, eps = self.cfg.obs_dim, self.clip_eps
        w = msk.to(f32)
        denom, mu, var = moments
        adv_n = (adv - mu[..., None]) * torch.rsqrt(var + 1e-8)[..., None]
        logits, v, _ = policy_forward(model, flat, om[..., :D], om[..., D:], self.cd)
        lsm = F.log_softmax(logits, dim=-1)
        logp = torch.gather(lsm, -1, a.long()[..., None])[..., 0]
        ratio = torch.exp(logp - lp_old)
        pg = -torch.minimum(ratio * adv_n, torch.clamp(ratio, 1 - eps, 1 + eps) * adv_n)
        v_clip = vold + torch.clamp(v - vold, -eps, eps)
        v_loss = 0.5 * torch.maximum((v - ret) ** 2, (v_clip - ret) ** 2)
        probs = F.softmax(logits, dim=-1)
        ent = -torch.sum(probs * torch.log(torch.clamp(probs, min=1e-12)), dim=-1)
        pg_s = torch.sum(pg * w, dim=-1)
        vl_s = torch.sum(v_loss * w, dim=-1)
        ent_s = torch.sum(ent * w, dim=-1)
        loss = (pg_s + self.vf_coef * vl_s - self.ent_coef * ent_s) / denom
        return loss, pg_s / denom, vl_s / denom, ent_s / denom

    def updates(self, model, ts: SpeciesTrainState, bufs, moments):
        """`update_epochs x num_minibatches` Adam steps of one species
        (`model` its ActorCritic, `bufs` its buffers, `moments` their
        `adv_moments`) or of every species at once (the stacked net and
        buffers): (new train state, [E * M, 4] losses, [E * M, 4, NS]
        stacked). Epoch e visits minibatch (i + e) % M at step i with
        `decorrelate`. With the mesh each step's gradient is all-reduced
        before Adam (and its clip) sees it."""
        params, opt = ts
        losses = []
        for e in range(self.E):
            for i in range(self.M):
                cls = (i + e) % self.M if self.decorrelate else i
                flat = params.detach().requires_grad_(True)
                with torch.enable_grad():
                    out = self.loss(model, flat, tuple(x[cls] for x in bufs), moments[cls])
                    (grad,) = torch.autograd.grad(out[0].sum(), flat)
                if self.mesh is not None:
                    (grad,) = self.mesh.reduce_sum([grad])
                params, opt = self.optimizer.update(grad, opt, params)
                losses.append(torch.stack([x.detach() for x in out]))
        return SpeciesTrainState(params, opt), torch.stack(losses)

    def population(self, roll):
        """Per species, over the rollout's steps: ([NS] alive rows, [NS]
        reward summed over them), on the full alive set."""
        T, W, A = roll.alive.shape
        NS, Asub = self.NS, self.Asub
        alive4 = roll.alive.reshape(T, W, Asub, NS)
        if not self.rec_mode:
            # Uncompacted records keep the species field; compacted ones
            # rely on SPEC D2b (an alive slot carries its class's species).
            spec = torch.arange(1, NS + 1, dtype=roll.species.dtype, device=roll.alive.device)
            alive4 = alive4 & (roll.species.reshape(T, W, Asub, NS) == spec)
        reward = torch.sum(roll.reward.reshape(T, W, Asub, NS) * alive4, dim=(0, 1, 2))
        return alive4.sum(dim=(0, 1, 2)), reward

    def ppo_iteration(self, state: WorldState, train_states, key):
        stacked = self.sac is not None
        params = train_states.params if stacked else [ts.params for ts in train_states]
        state, key, roll = self.rollout(state, params, key)
        advantages = self.advantages(state, params, key, roll)
        bufs, dropped = self.update_buffers(roll, advantages, key)
        count, reward = self.population(roll)
        T, W = roll.alive.shape[:2]
        NS = self.NS
        del roll, advantages                      # the buffers hold what the update needs
        if stacked:
            (moments,) = self.adv_moments([bufs])
            new_ts, losses = self.updates(self.sac, train_states, bufs, moments)
            mean = losses.mean(dim=0)                                    # [4, NS]
        else:
            moments = self.adv_moments(bufs)
            new_ts, means = [], []
            for s in range(NS):
                ts, losses = self.updates(self.models[s], train_states[s], bufs[s], moments[s])
                bufs[s] = None                    # free the species' buffers
                new_ts.append(ts)
                means.append(losses.mean(dim=0))
            new_ts, mean = tuple(new_ts), torch.stack(means, dim=1)
        if self.mesh is not None:
            # One all-reduce: each rank's loss terms are its part of the
            # global minibatch's, its counts and rewards its worlds'.
            mean, count, reward, dropped = self.mesh.reduce_sum([mean, count, reward, dropped])
            W = self.cfg.num_worlds
        # The jitted JAX iteration divides by T as a product with the f32
        # reciprocal (XLA's rewrite of a division by a constant).
        inv_t = const(1.0 / T, f32, state.alive.device)
        metrics = {}
        for s in range(NS):
            values = (mean[0, s], mean[1, s], mean[2, s], mean[3, s], count[s] * inv_t,
                      reward[s] * inv_t, dropped[s])
            for name, v in zip(PER_SPECIES_METRICS, values):
                metrics[f"species_{s + 1}_{name}"] = v
        metrics["env_steps"] = const(float(T * W), f32, state.alive.device)
        return state, new_ts, metrics


def make_ppo_trainer(models: Sequence[ActorCritic], cfg: EnvConfig,
                     rollout_len: int = 16, num_minibatches: int = 8,
                     update_epochs: int = 1, clip_eps: float = 0.2,
                     gamma: float = 0.99, gae_lambda: float = 0.95,
                     vf_coef: float = 0.5, ent_coef: float = 0.01,
                     lr: float = 3e-4, max_grad_norm: float = 0.5,
                     use_kernels: bool = True, optimizer: Adam | None = None,
                     compute_dtype=None, learner_slots_per_class=None,
                     decorrelate: bool = True, stacked: bool = False, mesh=None):
    """Returns (ppo_iteration, optimizer), as the JAX `make_ppo_trainer`:
    ppo_iteration(state, train_states, key) -> (state, train_states,
    metrics) collects `rollout_len` env steps and takes `update_epochs x
    num_minibatches` clipped-surrogate updates per species. The returned
    `PPOTrainer` also exposes the stages (rollout, advantages, buffers,
    updates). `use_kernels` stands for the JAX `use_pallas`.

    stacked=True trains every species through one `StackedActorCritic`
    (learner slots required): `train_states` is then the one stacked state
    (`a2c.init_stacked_train_state`), and the default optimizer
    `make_stacked_ppo_optimizer`.

    With `mesh` (`parallel/mesh.py`) the iteration runs on this rank's
    shard of the `cfg.num_worlds` worlds and computes the global iteration:
    its action draws are its slices of the global draws, each minibatch is
    its rows of the global minibatch (`shard_minibatches`), and the loss
    denominators, advantage moments, gradients and metrics are
    all-reduced."""
    trainer = PPOTrainer(models, cfg, optimizer, rollout_len, num_minibatches,
                         update_epochs, clip_eps, gamma, gae_lambda, vf_coef, ent_coef,
                         use_kernels, compute_dtype, learner_slots_per_class, decorrelate,
                         stacked, mesh)
    if optimizer is None:
        optimizer = (make_stacked_ppo_optimizer(trainer.sac, lr, max_grad_norm) if stacked
                     else make_ppo_optimizer(lr, max_grad_norm))
        trainer.optimizer = optimizer
    return trainer, optimizer
