"""Per-species TD(0) advantage actor-critic: one train tick.

Counterpart of `madrona_bots_tpu/learn/a2c.py` (the per-species loop path):
sim step, per-species forward / sample / loss / Adam update, action and
memory write-back, then the observation shift. PyTorch runs it eagerly; the
tick's values follow the jitted JAX tick.

Species-class slot partitioning (SPEC D2b): slot i belongs to species
(i % NS) + 1, so each species' rows are a strided view of the [W, A] batch.
With `learner_slots_per_class = L < A / NS` each (world, class)'s alive rows
are compacted into L learner rows first (overflow rows are dropped for the
tick: null action, zero memory, counted in `species_*_dropped_rows`). In bf16
that compaction is one launch of the row-gather kernel
(`ops/row_gather_cuda.py`) over the tick's seven fields; in f32 it is an
exact gather of one payload (`learn/pack.py`).

The species-stacked update (`stacked=True`, the JAX package's stacked
branch) runs the four species as one: one forward of `StackedActorCritic`
(`models/stacked.py`) over the [NS, W * L] learner rows, one categorical
draw with the stacked keys `fold_in(key, s)`, one loss and one Adam step on
the stacked parameter vector. Its actions equal the loop's given equal
logits, and its metrics have the loop's names.

`compute_dtype=torch.bfloat16` runs the forwards in bf16 against f32 master
parameters; gradients and Adam stay f32, and memory written back in the
compacting path travels in bf16.

With a mesh (`parallel/`) the tick runs on a rank's shard of the worlds:
each species' gradient comes from `_species_grad`, and the critic's
denominators, the gradients and the metric sums are all-reduced before
they are used, so every rank computes the global tick.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Sequence

import torch
import torch.nn.functional as F

from madrona_bots_tpu_torch import rng
from madrona_bots_tpu_torch.config import NUM_ACTIONS, EnvConfig
from madrona_bots_tpu_torch.env import env as env_mod
from madrona_bots_tpu_torch.env.state import WorldState
from madrona_bots_tpu_torch.learn.obs import construct_obs, obs_field_cols
from madrona_bots_tpu_torch.learn.pack import (class_major, compact_gather, compact_slots,
                                               expand_scatter,
                                               kslot_from_class_slots, split3)
from madrona_bots_tpu_torch.models.actor_critic import ActorCritic, compute_loss
from madrona_bots_tpu_torch.models.stacked import StackedActorCritic
from madrona_bots_tpu_torch.ops import row_gather_cuda

f32 = torch.float32
bf16 = torch.bfloat16

METRIC_NAMES = ("actor_loss", "critic_loss", "total_loss", "count", "reward",
                "avg_action_prob", "avg_action_entropy", "dropped_rows",
                "avg_health", "count_per_world", "popular_action")
"""Per-species metrics of a tick, each as `species_{s}_{name}`, s from 1."""


class AdamState(NamedTuple):
    count: torch.Tensor   # [] int32
    mu: torch.Tensor      # [P] f32
    nu: torch.Tensor      # [P] f32


class SpeciesTrainState(NamedTuple):
    params: torch.Tensor  # [P] f32, the leaves of ActorCritic.unflatten
    opt_state: AdamState


class Adam:
    """`optax.flatten(optax.adam(lr, b1, b2, eps))` on one flat parameter
    vector: the same state leaves (count, mu, nu) and the same formula,
    update = -lr * m_hat / (sqrt(v_hat) + eps), so checkpoints carry over
    between the packages one to one.

    `clip` maps the gradient before the step: `clip_by_global_norm(n)`
    makes it `optax.flatten(optax.chain(clip_by_global_norm(n), adam(...)))`
    (the PPO optimizer), `StackedActorCritic`'s per-species clip the stacked
    PPO optimizer. A clip has no state, so the state leaves stay (count, mu,
    nu)."""

    def __init__(self, lr: float = 3e-4, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8,
                 clip: Callable[[torch.Tensor], torch.Tensor] | None = None):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.clip = clip

    def init(self, params: torch.Tensor) -> AdamState:
        return AdamState(torch.zeros((), dtype=torch.int32, device=params.device),
                         torch.zeros_like(params), torch.zeros_like(params))

    def update(self, grad: torch.Tensor, state: AdamState, params: torch.Tensor):
        """(new params, new state)."""
        if self.clip is not None:
            grad = self.clip(grad)
        mu = (1 - self.b1) * grad + self.b1 * state.mu
        nu = (1 - self.b2) * (grad * grad) + self.b2 * state.nu
        count = state.count + 1
        t = count.to(f32)
        mu_hat = mu / (1 - torch.pow(torch.full_like(t, self.b1), t))
        nu_hat = nu / (1 - torch.pow(torch.full_like(t, self.b2), t))
        upd = -self.lr * (mu_hat / (torch.sqrt(nu_hat) + self.eps))
        return params + upd, AdamState(count, mu, nu)


def clip_by_global_norm(max_norm: float) -> Callable[[torch.Tensor], torch.Tensor]:
    """`optax.clip_by_global_norm` on a flat gradient: kept where its norm
    sqrt(sum(g * g)) is below `max_norm`, (g / norm) * max_norm otherwise."""
    def clip(grad: torch.Tensor) -> torch.Tensor:
        norm = torch.sqrt(torch.sum(grad * grad))
        return torch.where(norm < max_norm, grad, (grad / norm) * max_norm)
    return clip


def make_optimizer(lr: float = 3e-4) -> Adam:
    """Adam at the reference defaults (b1 0.9, b2 0.999, eps 1e-8)."""
    return Adam(lr)


def init_train_states(models: Sequence[ActorCritic], key: torch.Tensor,
                      optimizer: Adam):
    """Species i's parameters from `fold_in(key, i)`, as the JAX package."""
    states = []
    for i, m in enumerate(models):
        params = m.flatten(m.init(rng.fold_in(key, i)))
        states.append(SpeciesTrainState(params, optimizer.init(params)))
    return tuple(states)


def init_stacked_train_state(models: Sequence[ActorCritic], key: torch.Tensor,
                             optimizer: Adam) -> SpeciesTrainState:
    """One train state over the stacked vector of `models/stacked.py`: the
    parameters `init_train_states` draws, stacked, and the optimizer's
    state of them. Adam is elementwise, so its stacked trajectory is the
    per-species one."""
    sac = StackedActorCritic(models)
    params = sac.stack_params([m.flatten(m.init(rng.fold_in(key, i)))
                               for i, m in enumerate(models)])
    return SpeciesTrainState(params, optimizer.init(params))


def policy_forward(model, flat: torch.Tensor, obs: torch.Tensor,
                   mem: torch.Tensor, compute_dtype=None):
    """(logits, value, new memory) in f32 from the flat parameters of an
    `ActorCritic` or a `StackedActorCritic`; with `compute_dtype` the
    leaves, obs and memory are cast to it first (bf16 forwards against f32
    master parameters)."""
    leaves = model.unflatten(flat)
    if compute_dtype is not None:
        leaves = [t.to(compute_dtype) for t in leaves]
        obs, mem = obs.to(compute_dtype), mem.to(compute_dtype)
    logits, v, h = model(obs, mem, leaves)
    return logits.to(f32), v.to(f32), h.to(f32)


def _species_grad(model, ts: SpeciesTrainState, obs_cur, obs_prev, mem_cur, mem_prev,
                  prev_actions, rewards, mask, key, gamma: float, proper_log_probs: bool,
                  compute_dtype=None, loss_mask=None, loss_denom=None, offset: int = 0):
    """One species' gradient on [N, ...] rows, or every species' at once:
    with `model` a `StackedActorCritic`, `ts` its stacked train state, rows
    [NS, N, ...] and `key` [NS, 2] (species s samples with its own key), one
    forward, one draw and one loss whose sum over species gives each species
    its own gradient in its own slice. `mask` [..., N] f32 selects alive
    rows and `loss_mask` (default `mask`) also drops rows without a valid
    previous transition (SPEC D9). `loss_denom` (default: `loss_mask`'s row
    count) is the critic mean's denominator and `offset` the first row's
    flat index in the global action draw: a shard passes both over every
    rank. Returns (gradient, sampled actions [..., N], new memory [..., N,
    H] f32, metric sums [..., 5]: actor loss, critic loss, sum of the taken
    actions' log-probabilities and of the entropies over `mask`, `mask`'s
    row count; `policy_metrics` turns them into the tick's metrics)."""
    if loss_mask is None:
        loss_mask = mask

    def fwd(flat, obs, mem):
        return policy_forward(model, flat, obs, mem, compute_dtype)

    with torch.no_grad():
        logits, v_new, new_mem = fwd(ts.params, obs_cur, mem_cur)
    actions = rng.categorical(key, logits, offset)

    flat = ts.params.detach().requires_grad_(True)
    with torch.enable_grad():
        logits_p, v_prev, _ = fwd(flat, obs_prev, mem_prev)
        # The reference indexes raw actor outputs as "log probs" unless
        # proper_log_probs asks for the log-softmax.
        logp_all = F.log_softmax(logits_p, dim=-1) if proper_log_probs else logits_p
        logp = torch.gather(logp_all, -1, prev_actions.long()[..., None])[..., 0]
        actor_loss, critic_loss = compute_loss(logp, rewards, v_prev, v_new,
                                               gamma=gamma, mask=loss_mask,
                                               denom=loss_denom)
        (grad,) = torch.autograd.grad((actor_loss + critic_loss).sum(), flat)

    with torch.no_grad():
        logp_soft = F.log_softmax(logits, dim=-1)
        logp_taken = torch.gather(logp_soft, -1, actions[..., None])[..., 0]
        probs = F.softmax(logits, dim=-1)
        entropy = -torch.sum(probs * torch.log(torch.clamp(probs, min=1e-12)), dim=-1)
        sums = torch.stack([actor_loss.detach(), critic_loss.detach(),
                            torch.sum(logp_taken * mask, dim=-1),
                            torch.sum(entropy * mask, dim=-1), mask.sum(dim=-1)], dim=-1)
    return grad, actions, new_mem, sums


def policy_metrics(sums: torch.Tensor) -> Dict[str, torch.Tensor]:
    """actor_loss, critic_loss, total_loss, avg_action_prob and
    avg_action_entropy from `_species_grad`'s metric sums (of one rank or
    summed over every rank)."""
    actor, critic, logp, ent, n = sums.unbind(-1)
    denom = torch.clamp(n, min=1.0)
    return {"actor_loss": actor, "critic_loss": critic, "total_loss": actor + critic,
            "avg_action_prob": torch.exp(logp / denom), "avg_action_entropy": ent / denom}


def class_masks(state: WorldState, NS: int):
    """([W, A] alive-and-own-class mask, the same with a valid previous
    transition (SPEC D9)): slot i holds class (i % NS) + 1."""
    A = state.alive.shape[1]
    spec_tile = torch.arange(1, NS + 1, dtype=state.species.dtype,
                             device=state.alive.device).repeat(A // NS)
    m_full = state.alive & (state.species == spec_tile)
    return m_full, m_full & (state.prev_species == spec_tile)


def learner_fields(state: WorldState, lm_full: torch.Tensor, quirk_compat: bool = False):
    """The seven [W, A, d] sources the bf16 tick gathers in one launch:
    depth and semantic bytes (current, previous), the 15 bf16 scalar
    columns [health, pos, surrounding, prev health, prev pos, prev
    surrounding, loss mask, prev action, reward as three bf16 planes], and
    hidden / prev hidden in bf16. `lm_full` is the [W, A] loss mask of
    `class_masks`. With quirk_compat the depth blocks carry the semantic
    bytes (Q1) and health its int32 bits read as f32 (Q2)."""
    if quirk_compat:
        d_cur = state.sensor_semantic.to(torch.uint8)
        d_prev = state.prev_sensor_semantic.to(torch.uint8)

        def hcol(h):
            return h[..., None].to(torch.int32).view(f32).to(bf16)
    else:
        d_cur, d_prev = state.sensor_depth, state.prev_sensor_depth

        def hcol(h):
            return h[..., None].to(bf16)
    scal = torch.cat([
        hcol(state.health), state.pos.to(bf16), state.surrounding.to(bf16),
        hcol(state.prev_health), state.prev_pos.to(bf16),
        state.prev_surrounding.to(bf16), lm_full[..., None].to(bf16),
        torch.argmax(state.action, dim=-1)[..., None].to(bf16),
        *(p[..., None] for p in split3(state.reward)),
    ], dim=-1)                                                 # [W, A, 15]
    return [d_cur, state.sensor_semantic, d_prev, state.prev_sensor_semantic,
            scal, state.hidden.to(bf16), state.prev_hidden.to(bf16)]


def compact_learner_rows(state: WorldState, cfg: EnvConfig, rows: int,
                         compute_dtype=None, quirk_compat: bool = False,
                         use_kernels: bool = True):
    """Every class's learner rows: ([NS, W, rows, C] payload, slot, valid_g,
    keep, m_full). Columns: [obs_cur, obs_prev, mem, mem_prev, loss mask,
    prev action, reward] with the reward as three bf16 planes in bf16.
    Groups are class-outermost (g = s * W + w)."""
    NS = cfg.num_species
    W = state.alive.shape[0]
    m_full, lm_full = class_masks(state, NS)
    slot, valid_g, keep = compact_slots(class_major(m_full, NS), rows)
    if compute_dtype == bf16:
        # One launch gathers all seven fields; sensor bytes stay bytes.
        gather = (row_gather_cuda.compact_fields if use_kernels
                  else row_gather_cuda.compact_fields_reference)
        kslot = kslot_from_class_slots(slot, valid_g, W, NS)
        cd, cs, pd, ps, csc, chid, cphid = gather(
            kslot, learner_fields(state, lm_full, quirk_compat))
        obs_c = torch.cat([cd, csc[..., 0:3], cs, csc[..., 3:5]], dim=-1)
        obs_p = torch.cat([pd, csc[..., 5:8], ps, csc[..., 8:10]], dim=-1)
        grec = torch.cat([obs_c, obs_p, chid, cphid, csc[..., 10:]], dim=-1)
        grec4 = grec.reshape(W, NS, rows, grec.shape[-1]).permute(1, 0, 2, 3)
    else:
        dt = f32 if compute_dtype is None else compute_dtype
        cols = obs_field_cols(state, cfg, prev=False, quirk_compat=quirk_compat, dtype=dt)
        cols += obs_field_cols(state, cfg, prev=True, quirk_compat=quirk_compat, dtype=dt)
        cols += [state.hidden.to(dt), state.prev_hidden.to(dt), lm_full[..., None].to(dt),
                 torch.argmax(state.action, dim=-1)[..., None].to(dt),
                 state.reward[..., None].to(dt)]
        grec = compact_gather(class_major(torch.cat(cols, dim=-1), NS), slot, valid_g)
        grec4 = grec.reshape(NS, W, rows, grec.shape[-1])
    return grec4, slot, valid_g, keep, m_full


def make_train_tick(models: Sequence[ActorCritic], cfg: EnvConfig,
                    lr: float = 3e-4, gamma: float = 1.0,
                    proper_log_probs: bool = False, quirk_compat: bool = False,
                    use_kernels: bool = True, compute_dtype=None,
                    learner_slots_per_class=None, stacked: bool = False,
                    quirk_inloop_shift: bool = False, mesh=None):
    """Build the train tick: returns (tick, optimizer) where
    tick(state, train_states, key) -> (state, train_states, metrics)
    runs sim step -> NS species updates -> write-back -> shift. Consumes
    `state`. `use_kernels=False` runs every kernel's plain version (on any
    device); on CUDA tensors the default launches the kernels.

    stacked=True runs the NS updates as one batched update over the
    species-stacked parameters (`models/stacked.py`): `train_states` is the
    one state of `init_stacked_train_state` instead of the per-species
    tuple, and the metrics keep the loop's names. It needs learner-slot
    compaction (learner_slots_per_class < A / NS).

    quirk_inloop_shift (SPEC Q8) reproduces the reference's shift inside
    the species loop; see the JAX `make_train_tick`. Loop path only, without
    compaction.

    With `mesh` (`parallel/mesh.py`) the tick runs on this rank's shard of
    the `cfg.num_worlds` worlds and computes the global tick: its action
    draw is its slice of the global draw, the critic's denominators, the
    gradients and the metric sums are all-reduced (one collective each),
    so every rank steps Adam on the same bits and the parameters stay
    replicated."""
    optimizer = make_optimizer(lr)
    NS = cfg.num_species
    if len(models) != NS:
        raise ValueError(f"{len(models)} models for {NS} species")
    Asub = cfg.max_agents // NS
    Lcap = learner_slots_per_class
    compacting = Lcap is not None and Lcap < Asub
    rows = Lcap if compacting else Asub
    if stacked and not compacting:
        raise ValueError("the stacked tick requires learner-slot compaction "
                         "(learner_slots_per_class < A / NS)")
    if quirk_inloop_shift and (compacting or stacked):
        raise ValueError("quirk_inloop_shift pins the reference ordering on the "
                         "uncompacted per-species loop path only")
    sac = StackedActorCritic(models) if stacked else None
    obs_dtype = f32 if compute_dtype is None else compute_dtype
    D, H = cfg.obs_dim, cfg.hidden_state_dim
    c0 = 2 * D + 2 * H                                      # scalar columns

    def learner_rows(state: WorldState):
        """Every species' update inputs as [NS, B, ...] rows (B = W * rows):
        (obs_cur, obs_prev, mem, mem_prev, prev action, reward), mask, loss
        mask, dropped rows [NS], the [W, A] class mask, and the compaction's
        (slot, valid_g) or None."""
        W = state.alive.shape[0]
        B = W * rows
        if compacting:
            grec4, slot, valid_g, keep, m_full = compact_learner_rows(
                state, cfg, rows, compute_dtype, quirk_compat, use_kernels)
            g = grec4.reshape(NS, B, grec4.shape[-1])
            mask = valid_g.reshape(NS, B).to(f32)
            if compute_dtype is None:
                rew = g[..., c0 + 2]
            else:
                rew = sum(g[..., c0 + 2 + i].to(f32) for i in range(3))
            up = (g[..., 0:D], g[..., D:2 * D], g[..., 2 * D:2 * D + H],
                  g[..., 2 * D + H:c0], g[..., c0 + 1].to(torch.int64), rew)
            dropped = (m_full.reshape(W, Asub, NS).sum(dim=(0, 1))
                       - keep.reshape(NS, -1).sum(dim=1))
            return up, mask, g[..., c0].to(f32) * mask, dropped, m_full, (slot, valid_g)

        def cm(x):
            return class_major(x, NS).reshape((NS, B) + x.shape[2:])

        m_full, lm_full = class_masks(state, NS)
        mask, loss_mask = cm(m_full).to(f32), cm(lm_full).to(f32)
        obs_cur = cm(construct_obs(state, cfg, prev=False, quirk_compat=quirk_compat,
                                   dtype=obs_dtype))
        obs_prev = cm(construct_obs(state, cfg, prev=True, quirk_compat=quirk_compat,
                                    dtype=obs_dtype))
        mem = cm(state.hidden)
        mem_prev = cm(state.prev_hidden)
        if quirk_inloop_shift:
            # Q8: species s >= 2 read post-shift prev buffers: PREV
            # depth/semantic with CURRENT health/pos/surrounding; every
            # species' prev memory is its current one, and the loss takes
            # all alive rows (no D9 mask).
            S_ = cfg.sensor_size
            spliced = torch.cat([obs_prev[..., :S_], obs_cur[..., S_:S_ + 3],
                                 obs_prev[..., S_ + 3:2 * S_ + 3],
                                 obs_cur[..., 2 * S_ + 3:]], dim=-1)
            obs_prev = torch.cat([obs_prev[:1], spliced[1:]])
            mem_prev, loss_mask = mem, mask
        up = (obs_cur, obs_prev, mem, mem_prev, cm(torch.argmax(state.action, dim=-1)),
              cm(state.reward))
        dropped = torch.zeros(NS, dtype=torch.int64, device=mask.device)
        return up, mask, loss_mask, dropped, m_full, None

    def tick(state: WorldState, train_states, key: torch.Tensor):
        state = env_mod.step(state, cfg, use_kernels)
        W, A = state.alive.shape
        up, mask, loss_mask, dropped, m_full, compaction = learner_rows(state)
        Wg, offset, loss_denom = W, 0, None
        if mesh is not None:
            # This rank's rows are rows [lo * rows, hi * rows) of each
            # species' global draw; the critic mean divides by the count
            # over every rank (the one collective before the loss).
            lo, hi = mesh.world_range(cfg.num_worlds)
            if hi - lo != W:
                raise ValueError(f"a shard of {W} worlds, the mesh gives [{lo}, {hi})")
            Wg, offset = cfg.num_worlds, lo * rows * NUM_ACTIONS
            (loss_denom,) = mesh.reduce_sum([loss_mask.sum(dim=-1)])
        if stacked:
            keys = rng.fold_in(key, torch.arange(NS, device=key.device))
            grad, actions, new_mem, sums = _species_grad(
                sac, train_states, *up, mask, keys, gamma, proper_log_probs,
                compute_dtype, loss_mask, loss_denom, offset)
            if mesh is not None:
                (grad,) = mesh.reduce_sum([grad])
            new_ts = SpeciesTrainState(*optimizer.update(grad, train_states.opt_state,
                                                         train_states.params))
        else:
            outs = [_species_grad(models[s], train_states[s], *(x[s] for x in up), mask[s],
                                  rng.fold_in(key, s), gamma, proper_log_probs, compute_dtype,
                                  loss_mask[s], None if loss_denom is None else loss_denom[s],
                                  offset)
                    for s in range(NS)]
            grads = [o[0] for o in outs]
            if mesh is not None:
                grads = mesh.reduce_sum(grads)           # one all-reduce for every species
            new_ts = tuple(SpeciesTrainState(*optimizer.update(g, ts.opt_state, ts.params))
                           for g, ts in zip(grads, train_states))
            actions = torch.stack([o[1] for o in outs])
            new_mem = torch.stack([o[2] for o in outs])
            sums = torch.stack([o[3] for o in outs])
        onehot = F.one_hot(actions, NUM_ACTIONS)

        # Population, reward and health always over the full alive set.
        with torch.no_grad():
            def per_class(x):
                return class_major(x, NS).reshape(NS, -1).to(f32)

            mfc = per_class(m_full)
            count = mfc.sum(dim=-1)
            hist = torch.sum(onehot.to(f32) * mask[..., None], dim=1)
            reward = torch.sum(per_class(state.reward) * mfc, dim=-1)
            health = torch.sum(per_class(state.health) * mfc, dim=-1)
            if mesh is not None:
                sums, count, hist, reward, health, dropped = mesh.reduce_sum(
                    [sums, count, hist, reward, health, dropped])
            m = policy_metrics(sums)
            m.update(count=count, reward=reward, dropped_rows=dropped,
                     avg_health=health / torch.clamp(count, min=1.0),
                     count_per_world=count / Wg,
                     popular_action=torch.argmax(hist, dim=-1).to(f32))
        metrics = {f"species_{s + 1}_{k}": m[k][s] for s in range(NS) for k in METRIC_NAMES}

        if compaction is not None:
            # One expansion for all species' actions and memory: zeros where
            # no learner row maps (dead slots and dropped overflow).
            slot, valid_g = compaction
            sdt = bf16 if compute_dtype == bf16 else f32
            src = torch.cat([onehot.to(f32) * mask[..., None], new_mem * mask[..., None]],
                            dim=-1).reshape(NS * W, rows, NUM_ACTIONS + H).to(sdt)
            out4 = expand_scatter(src, slot, valid_g, Asub).reshape(
                NS, W, Asub, NUM_ACTIONS + H).permute(1, 2, 0, 3)
            new_action = out4[..., :NUM_ACTIONS].to(torch.int32)
            new_hidden = out4[..., NUM_ACTIONS:]
        else:
            new_action = (onehot.to(torch.int32) * mask[..., None].to(torch.int32)).reshape(
                NS, W, Asub, NUM_ACTIONS).permute(1, 2, 0, 3)
            new_hidden = (new_mem * mask[..., None]).reshape(NS, W, Asub, H).permute(1, 2, 0, 3)
        state = env_mod.shift_observations(state, cfg)
        state = state.replace(
            action=new_action.reshape(W, A, NUM_ACTIONS).contiguous(),
            hidden=new_hidden.reshape(W, A, H).to(state.hidden.dtype).contiguous())
        if quirk_inloop_shift:
            # The reference's last shift runs after species 1..NS-1 wrote
            # but before species NS did: only class NS-1 keeps old prevs.
            last = ((torch.arange(A, device=state.alive.device) % NS)
                    == NS - 1)[None, :, None]
            state = state.replace(
                prev_action=torch.where(last, state.prev_action, state.action),
                prev_hidden=torch.where(last, state.prev_hidden, state.hidden))
        return state, new_ts, metrics

    return tick, optimizer


def stack_metrics(metrics: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The tick's metrics as one f32 vector in the dict's order, so they
    leave the card in one copy."""
    return torch.stack([v.to(f32) for v in metrics.values()])
