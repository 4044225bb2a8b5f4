"""Training CLI: per-species A2C or PPO on the card.

    python -m madrona_bots_tpu_torch.learn.training_loop --num_worlds 8 \\
        --num_epochs 5 --create_universe --universe_id demo \\
        --model_save_dir ckpts --hidden_dim 32

Counterpart of `madrona_bots_tpu/learn/training_loop.py` with the same flags
and flow: per-species ActorCritic creation or restore under a "universe"
checkpoint directory, one train tick (`--algo a2c`, the default) or one PPO
iteration of `--rollout_len` env steps (`--algo ppo`) per epoch, the JAX
package's metric names, latest and best-metric checkpoints (PPO has no
best metric, as in the JAX CLI), and the FPS report. `--create_universe
--seed s` creates the same universe as the JAX package's CLI, and either
package restores the other's. Runs on CUDA unless `--device cpu` is given.
An epoch's metrics leave the card as one stacked tensor, one copy per epoch.

`--stacked` trains the four species as one species-stacked net
(`models/stacked.py`; A2C and PPO; `--learner_slots` defaults to 12 there).
Checkpoints stay per species, so one universe directory serves loop and
stacked runs of either package.

`--ticks_per_block K > 1` runs K ticks (iterations) between host syncs
(`make_block`): their metrics leave the card as one [K, M] tensor, the best
A2C losses are tracked on the card with snapshots of the improving tick's
train state, and the files are written once a block.

`--use_mesh` shards the worlds over the processes of a torch.distributed
group (`parallel/`): one process per card, launched by
`torchrun --nproc_per_node=N -m madrona_bots_tpu_torch.learn.training_loop
--use_mesh ...`; without a launcher, a group of one process in this
process. Every rank builds or reads the same parameters, trains on its
`num_worlds / N` worlds and all-reduces what crosses worlds, so every rank
holds the same parameters and metrics; only rank 0 writes checkpoints and
metrics.
"""

from __future__ import annotations

import argparse
import functools
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from madrona_bots_tpu_torch import rng
from madrona_bots_tpu_torch.config import EnvConfig, RewardSetting
from madrona_bots_tpu_torch.device import resolve
from madrona_bots_tpu_torch.env.state import init_state
from madrona_bots_tpu_torch.learn.a2c import (SpeciesTrainState, make_optimizer,
                                              make_train_tick, stack_metrics)
from madrona_bots_tpu_torch.learn.ckpt import CheckpointManager
from madrona_bots_tpu_torch.learn.metrics import MetricsLogger
from madrona_bots_tpu_torch.learn.ppo import (make_ppo_optimizer, make_ppo_trainer,
                                              make_stacked_ppo_optimizer)
from madrona_bots_tpu_torch.models.actor_critic import ActorCritic
from madrona_bots_tpu_torch.models.generator import SpeciesNetGenerator
from madrona_bots_tpu_torch.models.stacked import StackedActorCritic
from madrona_bots_tpu_torch.parallel import distributed
from madrona_bots_tpu_torch.parallel.mesh import make_mesh
from madrona_bots_tpu_torch.utils import profiling

BEST_METRICS = ("actor_loss", "critic_loss", "total_loss")


def construct_run_name(args) -> str:
    """The run name encodes the universe and the reward setting."""
    return f"universe_{args.universe_id}-r{args.reward_setting}"


class _ReadOnlyCheckpoints(CheckpointManager):
    """A rank's checkpoints other than the coordinator's: loads, never
    writes (not even the directory)."""

    def __init__(self, base_ckpt_dir: str):
        self.base_ckpt_dir, self.restore = base_ckpt_dir, True

    def save(self, *args, **kwargs) -> None:
        pass


def _tree_where(cond: torch.Tensor, a, b):
    """`torch.where(cond, a, b)` over the tensors of two train states."""
    if isinstance(a, torch.Tensor):
        return torch.where(cond, a, b)
    return type(a)(*(_tree_where(cond, x, y) for x, y in zip(a, b)))


def make_block(tick, ticks: int, num_species: int, ts_view, track_best: bool):
    """The block of `--ticks_per_block`: block(state, train_states, key,
    best_vals [3, NS]) -> (state, train_states, metrics [ticks, M] f32 in
    sorted key order, best values [3, NS], snapshots, best tick index [3,
    NS] int32, -1 where nothing improved; the metric names). One split of
    `key` a tick, `k, sub = split(k)`, as the JAX block's scan does; no host
    sync inside. With `track_best` each tracked A2C loss (`BEST_METRICS`)
    of each species is kept on the card below `best_vals`, and snapshots[m][s]
    holds `ts_view(train_states, s)` as of the tick that improved it (PPO
    has no such metric). Consumes `state`."""
    NM = len(BEST_METRICS)

    def block(state, tstates, key, best_vals):
        # Train states are never written in place, so a snapshot holds
        # references until a tick improves on it.
        snaps = ([[ts_view(tstates, sp) for sp in range(num_species)]
                  for _ in range(NM)] if track_best else [])
        bidx = torch.full((NM, num_species), -1, dtype=torch.int32, device=best_vals.device)
        bv = best_vals
        rows, names = [], None
        k = key
        for i in range(ticks):
            k, sub = rng.split(k, 2)
            state, tstates, m = tick(state, tstates, sub)
            if names is None:
                names = sorted(m)
            if track_best:
                v = torch.stack([torch.stack([m[f"species_{sp + 1}_{mn}"].to(torch.float32)
                                              for sp in range(num_species)])
                                 for mn in BEST_METRICS])
                better = v < bv
                bv = torch.where(better, v, bv)
                bidx = torch.where(better, i, bidx)
                for mi in range(NM):
                    for sp in range(num_species):
                        snaps[mi][sp] = _tree_where(better[mi, sp], ts_view(tstates, sp),
                                                    snaps[mi][sp])
            rows.append(torch.stack([m[n].to(torch.float32) for n in names]))
        return state, tstates, torch.stack(rows), bv, snaps, bidx, names

    return block


def run_tick(tick, state, train_states, key):
    """One epoch of the loop at `--ticks_per_block 1`: split the key, run
    the tick (A2C) or iteration (PPO) under the second half, and read its
    metrics to the host in one copy, the loop's one blocking read
    (`profiling.host_sync("metrics")`). Returns (state, train states, the
    carried key, {metric name: float}); consumes `state`.

    A tick that carries a graph (`tick.graph`: the A2C tick without a mesh)
    runs all but the copy as one CUDA graph on a CUDA state
    (`learn/tick_graph.py`); the state it returns is the graph's and is
    written by the next call."""
    graph = getattr(tick, "graph", None)
    if graph is not None and state.device.type == "cuda":
        state, train_states, key, names, stacked = graph(
            functools.partial(_loop_body, tick), state, train_states, key)
    else:
        state, train_states, key, names, stacked = _loop_body(tick, state, train_states, key)
    with profiling.host_sync("metrics"):
        host = stacked.cpu()                         # one copy; waits for the card
    return state, train_states, key, dict(zip(names, host.tolist()))


def _loop_body(tick, state, train_states, key):
    """run_tick's work on the card: (state, train states, carried key,
    metric names, the metrics stacked in one f32 vector)."""
    key, sub = rng.split(key, 2)
    state, train_states, metrics = tick(state, train_states, sub)
    return state, train_states, key, tuple(metrics), stack_metrics(metrics)


def train(args):
    """Run the CLI; with `--use_mesh` in the process group that exists, else
    in one this call starts (from a launcher's environment, or of one
    process) and destroys."""
    if not args.use_mesh:
        return _train(args, None)
    if dist.is_initialized():
        return _train(args, make_mesh(args.device))
    mesh = distributed.initialize(device=args.device)
    try:
        return _train(args, mesh)
    finally:
        distributed.shutdown()


def _train(args, mesh):
    dev = resolve(args.device) if mesh is None else mesh.device
    writer = mesh is None or mesh.rank == 0
    run_name = construct_run_name(args)
    cfg = EnvConfig(num_worlds=args.num_worlds, init_agents=32,
                    max_agents=args.max_agents, num_species=args.num_species,
                    reward_setting=RewardSetting(args.reward_setting))
    base_ckpt_dir = os.path.join(args.model_save_dir, f"universe_{args.universe_id}")
    # Under a mesh the coordinator alone creates the universe, so only it
    # can tell a universe that existed before the run.
    if args.create_universe and writer and os.path.exists(base_ckpt_dir):
        raise FileExistsError(f"Universe {args.universe_id} already exists")
    if not args.create_universe and not os.path.exists(base_ckpt_dir):
        raise FileNotFoundError(f"Universe {args.universe_id} does not exist")
    logger = MetricsLogger(use_wandb=args.use_wandb and writer, run_name=run_name,
                           config=vars(args),
                           jsonl_path=os.path.join(args.model_save_dir,
                                                   f"{run_name}.metrics.jsonl")
                           if writer else None)

    ckpt = (CheckpointManager(base_ckpt_dir, restore=True) if writer
            else _ReadOnlyCheckpoints(base_ckpt_dir))
    gen = SpeciesNetGenerator(args.obs_dim, args.action_dim, args.hidden_dim,
                              args.memory_dim, seed=args.seed)
    if args.stacked and args.learner_slots is None:
        # The stacked update trains on compacted learner rows; 12 slots a
        # class cover typical populations with no row dropped.
        args.learner_slots = 12
        print("--stacked: defaulting --learner_slots to 12")
    # Checkpoints are always per species: the per-species optimizer defines
    # the checkpoint's Adam state; both have the leaves (count, mu, nu).
    optimizer = make_ppo_optimizer(args.lr) if args.algo == "ppo" else make_optimizer(args.lr)
    models, tstates, start_epochs = [], [], []
    init_key = rng.key(args.seed, dev)
    for sp in range(1, args.num_species + 1):
        if args.create_universe:
            print(f"Creating universe: new model for species {sp}...")
            model = ActorCritic.from_generator(gen, device=dev)
            print(f"Species {sp} model: ", model.get_config())
            params = model.flatten(model.init(rng.fold_in(init_key, sp)))
            opt_state = optimizer.init(params)
            ckpt.save(model, params, opt_state, f"species_{sp}", 0,
                      metric_name="latest", verbose=True)
            start_epochs.append(0)
        else:
            print(f"Loading cached model for species {sp}...")
            model, params, opt_state, epoch = ckpt.load(
                ActorCritic, optimizer, f"species_{sp}", metric_name=args.model_load,
                verbose=True, device=dev)
            start_epochs.append(epoch)
        models.append(model)
        tstates.append(SpeciesTrainState(params, opt_state))
    tstates = tuple(tstates)
    compute_dtype = {"f32": None, "bf16": torch.bfloat16}[args.compute_dtype]

    sac = None
    if args.stacked:
        # Stack the restored parameters and Adam moments once (an exact
        # resume); the stacked PPO optimizer clips per species.
        sac = StackedActorCritic(models)
        tstates = SpeciesTrainState(sac.stack_params([ts.params for ts in tstates]),
                                    sac.stack_opt_state([ts.opt_state for ts in tstates]))
        if args.algo == "ppo":
            optimizer = make_stacked_ppo_optimizer(sac, args.lr)

    def species_states(ts):
        """Per-species (params, opt_state) views for checkpointing."""
        if sac is None:
            return ts
        return [SpeciesTrainState(p, o) for p, o in
                zip(sac.unstack_params(ts.params), sac.unstack_opt_state(ts.opt_state))]

    if args.algo == "ppo":
        tick, _ = make_ppo_trainer(models, cfg, rollout_len=args.rollout_len,
                                   gamma=args.gamma, lr=args.lr, optimizer=optimizer,
                                   compute_dtype=compute_dtype,
                                   learner_slots_per_class=args.learner_slots,
                                   stacked=args.stacked, mesh=mesh)
    else:
        tick, _ = make_train_tick(models, cfg, lr=args.lr, gamma=args.gamma,
                                  proper_log_probs=args.proper_log_probs,
                                  quirk_compat=args.quirk_compat,
                                  compute_dtype=compute_dtype,
                                  learner_slots_per_class=args.learner_slots,
                                  stacked=args.stacked, mesh=mesh)
    if mesh is None:
        state = init_state(cfg, args.seed, dev)
    else:
        # This rank's worlds only: equal to that slice of the full state.
        state = init_state(cfg, args.seed, dev, worlds=mesh.world_range(cfg.num_worlds))
        print(f"mesh: {mesh.size} devices, worlds sharded")
    key = rng.key(args.seed + 1, dev)

    best = {m: [float("inf")] * args.num_species for m in BEST_METRICS}
    time_values = []

    def handle_epoch(rel_epoch, host_metrics, dt, track_best: bool = True):
        """Log one epoch; with track_best=False (block mode) only log: the
        block tracks the best losses on the card and writes the files."""
        if rel_epoch % args.print_freq == 0 or rel_epoch == 1:
            print("Relative Epoch ", rel_epoch)
        host_metrics["epoch_fps"] = args.num_worlds / dt
        if not track_best:
            logger.log(host_metrics)
            return
        sps = species_states(tstates)
        for sp in range(args.num_species):
            epoch = start_epochs[sp] + rel_epoch
            ts = sps[sp]
            host_metrics[f"species_{sp+1}_learning_rate"] = args.lr
            host_metrics["epoch"] = epoch
            if rel_epoch % args.ckpt_every == 0:
                ckpt.save(models[sp], ts.params, ts.opt_state, f"species_{sp+1}",
                          epoch, metric_name="latest", verbose=args.verbose)
            for metric in BEST_METRICS:
                v = host_metrics.get(f"species_{sp+1}_{metric}")
                if v is None:                      # PPO has its own metric names
                    continue
                if v < best[metric][sp]:
                    best[metric][sp] = v
                    ckpt.save(models[sp], ts.params, ts.opt_state, f"species_{sp+1}",
                              epoch, metric_name=metric, verbose=args.verbose)
        logger.log(host_metrics)

    tpb = max(1, args.ticks_per_block)
    if tpb == 1:
        for rel_epoch in range(1, args.num_epochs + 1):
            t0 = time.time()
            state, tstates, key, host = run_tick(tick, state, tstates, key)
            dt = time.time() - t0
            time_values.append(dt)
            handle_epoch(rel_epoch, host, dt)
    else:
        # Under --stacked a species' view is the whole stacked state,
        # unstacked to that species only when its file is written.
        track_best = args.algo == "a2c"
        block = make_block(tick, tpb, args.num_species,
                           (lambda ts, sp: ts) if args.stacked else (lambda ts, sp: ts[sp]),
                           track_best)
        rel_epoch = 0
        while rel_epoch < args.num_epochs:
            block_start = rel_epoch
            t0 = time.time()
            key, sub = rng.split(key, 2)
            best_in = torch.tensor([best[m] for m in BEST_METRICS], dtype=torch.float32,
                                   device=dev)
            state, tstates, ms, bv, snaps, bidx, names = block(state, tstates, sub, best_in)
            host_stack = ms.cpu()                        # one [tpb, M] copy
            dt = (time.time() - t0) / tpb
            for row in host_stack.tolist():
                rel_epoch += 1
                time_values.append(dt)
                handle_epoch(rel_epoch, dict(zip(names, row)), dt, track_best=False)
                if rel_epoch >= args.num_epochs:
                    break
            # One save pass a block: latest (the block's end) and each best
            # that improved, from the snapshot of its improving tick.
            sps = species_states(tstates)
            for sp in range(args.num_species):
                ckpt.save(models[sp], sps[sp].params, sps[sp].opt_state, f"species_{sp+1}",
                          start_epochs[sp] + rel_epoch, metric_name="latest",
                          verbose=args.verbose)
            if track_best:
                bv_h, bidx_h = bv.cpu().tolist(), bidx.cpu().tolist()
                for mi, metric in enumerate(BEST_METRICS):
                    for sp in range(args.num_species):
                        if bv_h[mi][sp] < best[metric][sp]:
                            best[metric][sp] = bv_h[mi][sp]
                            epoch = start_epochs[sp] + block_start + bidx_h[mi][sp] + 1
                            snap = snaps[mi][sp]
                            if sac is not None:
                                snap = species_states(snap)[sp]
                            ckpt.save(models[sp], snap.params, snap.opt_state,
                                      f"species_{sp+1}", epoch, metric_name=metric,
                                      verbose=args.verbose)

    if time_values:
        avg = (float(np.mean(time_values[1:])) if len(time_values) > 1
               else time_values[0])
        print(f"Average FPS for simulator: {args.num_worlds / avg}")
    logger.finish()
    return state, tstates


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Training loop for species simulation (PyTorch / CUDA).")
    parser.add_argument('--num_worlds', type=int, default=2048)
    parser.add_argument('--universe_id', type=str, default='luc')
    parser.add_argument('--num_species', type=int, default=4)
    parser.add_argument('--obs_dim', type=int, default=69)
    parser.add_argument('--hidden_dim', type=int, default=128)
    parser.add_argument('--action_dim', type=int, default=6)
    parser.add_argument('--memory_dim', type=int, default=16)
    parser.add_argument('--lr', type=float, default=3e-4)
    parser.add_argument('--init_epsilon', type=float, default=0.5)
    parser.add_argument('--num_epochs', type=int, default=100)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--use_wandb', action='store_true')
    parser.add_argument('--create_universe', action='store_true')
    parser.add_argument('--model_save_dir', type=str, default='checkpoints')
    parser.add_argument('--model_load', type=str, default='latest')
    parser.add_argument('--enable_viewer', action='store_true')
    parser.add_argument('--verbose', action='store_true')
    parser.add_argument('--max_agents', type=int, default=128)
    parser.add_argument('--gamma', type=float, default=1.0)
    parser.add_argument('--reward_setting', type=int, default=8)
    parser.add_argument('--proper_log_probs', action='store_true',
                        help='use log-softmax instead of raw logits in the '
                             'actor loss (fixes a reference quirk)')
    parser.add_argument('--quirk_compat', action='store_true',
                        help='train on the exact reference observation: '
                             'depth block = semantic bytes (Q1) and health '
                             'bit-reinterpreted int32->f32 (Q2)')
    parser.add_argument('--use_pallas', action='store_true',
                        help='accepted for command-line parity with the JAX '
                             'CLI; on CUDA the port always runs its kernels')
    parser.add_argument('--ckpt_every', type=int, default=1)
    parser.add_argument('--print_freq', type=int, default=10)
    parser.add_argument('--ticks_per_block', type=int, default=1,
                        help='run N ticks per host sync (one metrics copy a '
                             'block, best tracking on the card)')
    parser.add_argument('--use_mesh', action='store_true',
                        help='shard worlds over the processes of a torch.distributed '
                             'group, one a card (torchrun, or one process without a '
                             'launcher); only rank 0 writes files')
    parser.add_argument('--compute_dtype', choices=['f32', 'bf16'],
                        default='f32', help='forward-pass precision')
    parser.add_argument('--algo', choices=['a2c', 'ppo'], default='a2c',
                        help='a2c = reference-parity TD(0); ppo = PPO iterations '
                             '(an epoch is one iteration of --rollout_len env steps)')
    parser.add_argument('--rollout_len', type=int, default=16,
                        help='PPO: env steps per iteration')
    parser.add_argument('--learner_slots', type=int, default=None,
                        help='cap learner rows per (world, species) via '
                             'on-device compaction; None trains on all '
                             'padded slots')
    parser.add_argument('--stacked', action='store_true',
                        help='train all species through one species-stacked '
                             'batched net (models/stacked.py), A2C or PPO; '
                             'checkpoints stay per species. Implies '
                             '--learner_slots (default 12)')
    parser.add_argument('--device', type=str, default=None,
                        help="torch device; default CUDA (raises without a card); "
                             "'cpu' runs the kernels' plain versions")
    return parser


def main(argv=None):
    train(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
