"""The upstream's training loop as the port's CLI runs it at `--ticks_per_block
1`: a call is one epoch of `learn/training_loop.run_tick` (split the key,
one A2C TD(0) tick of `learn/a2c.make_train_tick` over every world, one
read of the tick's metrics to the host), seeded as the CLI's `_train` is:
the worlds from `init_state(cfg, seed)`, species sp's parameters from
`fold_in(key(seed), sp)`, sp = 1..NS, the loop's key from `key(seed + 1)`.
The nets are the configuration's `species_nets`.

The check follows the program tick by tick from its own inputs: at the
window's first call and at `check.count` calls drawn from the seed among
the `check.within` after it, the state, the train states and the key the
tick starts from are kept with what it returns; after the window the plain
reference (`reference/a2c.py`) redoes each kept tick and the numbers
below compare the two.
"""

from __future__ import annotations

import math
import random

import torch
from torch.profiler import record_function

from portbench import compare, core
from portbench.drivers.manager import FLOAT_FIELDS, env_config

LEARNER_FIELDS = ("action", "hidden", "prev_hidden")
"""The fields that hold the learner's output (`prev_hidden` is the memory
it wrote a tick earlier, shifted); every other field is the env step's and
its shift's, held to the bit."""
SUPPORTED = {"ticks_per_call": 1, "syncs_per_call": 1, "compute_dtype": "f32",
             "ckpt_every": None}
"""The traffic this driver runs: the CLI's loop at its defaults, without
its checkpoint saves."""


class Driver:

    def __init__(self, config: dict, workload: dict, seed: int, device, trace: bool):
        from madrona_bots_tpu_torch import rng
        from madrona_bots_tpu_torch.config import EnvConfig, RewardSetting
        from madrona_bots_tpu_torch.env.state import init_state
        from madrona_bots_tpu_torch.learn import a2c, training_loop
        from madrona_bots_tpu_torch.models.actor_critic import ActorCritic
        from madrona_bots_tpu_torch.utils import profiling

        # The run's own counts: the process's counters are set aside here
        # and put back in `finish`.
        self.process_counts = profiling.counts()
        profiling.reset_counts()
        t, check = workload["traffic"], workload["check"]
        for k, v in SUPPORTED.items():
            if t.get(k) != v:
                core.die(f"the a2c driver runs {k} = {v!r}, the cell asks {t.get(k)!r}")
        self.run_tick = getattr(training_loop, "run_tick", None)
        if self.run_tick is None:
            core.die("the program has no learn.training_loop.run_tick, the CLI's loop body")
        self.config, self.workload = config, workload
        self.cfg = env_config(EnvConfig, RewardSetting, config, t)
        self.policy_forward = a2c.policy_forward
        self.models = [ActorCritic(arch, device=device) for arch in config["species_nets"]]
        self.tick, opt = a2c.make_train_tick(self.models, self.cfg, lr=config["lr"],
                                             gamma=config["gamma"])
        self.state = init_state(self.cfg, seed, device)
        init_key = rng.key(seed, device)
        params = [m.flatten(m.init(rng.fold_in(init_key, sp)))
                  for sp, m in enumerate(self.models, 1)]
        self.train_states = tuple(a2c.SpeciesTrainState(p, opt.init(p)) for p in params)
        self.key = rng.key(seed + 1, device)
        self.check_at = {0, *random.Random(seed).sample(range(1, check["within"]),
                                                        check["count"])}
        self.kept = []     # (state, train states, key, metrics, state after, states after)
        self.calls = -workload["warmup"]
        self.tracing = False
        self.world_steps = self.cfg.num_worlds
        for _ in range(workload["warmup"]):
            self.call()

    def call(self) -> int:
        keep = self.calls in self.check_at
        self.calls += 1
        if keep:
            # The tick writes the state in place; train states and keys are
            # never written in place, so references keep them.
            before = (self.state.clone(), self.train_states, self.key)
        with record_function("portbench.tick"):
            self.state, self.train_states, self.key, metrics = self.run_tick(
                self.tick, self.state, self.train_states, self.key)
        if keep:
            self.kept.append((*before, metrics, self.state.clone(), self.train_states))
        return self.world_steps

    def finish(self) -> None:
        """Free the program's state and tick; keep the run's counts in
        `counts` and put the process's counters back as they were, so runs
        in one process do not read each other's."""
        from madrona_bots_tpu_torch.utils import profiling

        self.state = self.tick = None
        self.counts = profiling.counts()
        profiling.reset_counts()
        for name, n in self.process_counts.items():
            profiling.count(name, n)

    def numbers(self, quant=None) -> dict:
        """The compared numbers (`tick_numbers`) over the kept ticks: the
        mismatches summed, the gaps the largest. With `quant` the control:
        the reference with the state's floats rounded through `quant`
        before its tick and the nets computed in `quant`."""
        from portbench.reference import a2c as ref
        from portbench.reference.config import EnvConfig, RewardSetting
        from portbench.reference.state import FIELDS

        if not self.kept:                  # the window ended before its first call
            return {**dict.fromkeys(NUMBERS), "ticks_checked": 0}
        n = {**dict.fromkeys(NUMBERS, 0), "ticks_checked": len(self.kept)}
        cfg = env_config(EnvConfig, RewardSetting, self.config, self.workload["traffic"])
        for state, ts0, key, metrics, after, ts1 in self.kept:
            state = state.replace(**{f: getattr(state, f).clone() for f in FIELDS})
            if quant is not None:
                state = state.replace(**{f: getattr(state, f).to(quant).float()
                                         for f in FLOAT_FIELDS})
            want, records = ref.tick(state, [(ts.params, tuple(ts.opt_state)) for ts in ts0],
                                     key, cfg, self.config["species_nets"], self.config["lr"],
                                     self.config["gamma"], quant or torch.float32)

            def logits_of(s, obs, mem):
                return self.policy_forward(self.models[s], ts0[s].params, obs, mem)[0]

            one = tick_numbers(after, ts0, ts1, metrics, want, records, logits_of,
                               cfg.num_species, self.workload["check"]["limits"]["logit_gap"])
            for k, v in one.items():
                n[k] = n[k] + v if k.endswith("_mismatch") else max(n[k], v)
        return n


NUMBERS = ("state_mismatch", "action_mismatch", "logit_gap", "memory_gap", "grad_gap",
           "delta_gap", "loss_gap")


def tick_numbers(after, ts0, ts1, metrics: dict, want, records, logits_of, num_species: int,
                 logit_limit: float) -> dict:
    """One tick's numbers: the program's state after the tick `after`, its
    train states before and after (`ts0`, `ts1`) and its metrics, against
    the reference's state `want` and species records (`reference/a2c.py`).
    `logits_of(s, obs, mem)` gives the program's logits of species s on
    rows the reference built.

    state_mismatch: elements of every field but the learner's
    (`LEARNER_FIELDS`) that differ in bits. logit_gap: the largest
    |program - reference| logit over the largest |reference| logit, of a
    species' rows. action_mismatch: rows whose written action differs,
    where the row is dead or the reference's Gumbel-plus-logit margin
    between its first and second choice exceeds twice the logit limit
    times that species' largest logit (no logit gap within the limit can
    flip such a row). memory_gap: the largest difference of the memory
    written (and of last tick's, shifted) over its largest reference
    value. grad_gap: the 2-norm of the difference of Adam's first moments
    over the 2-norm of (1 - b1) times the reference's gradient (from equal
    moments the difference is (1 - b1) times the gradients'). delta_gap:
    the 2-norm of the difference of the parameter steps over the
    reference's step's. loss_gap: the actor loss's difference over the sum
    of its terms' magnitudes, and the critic loss's over itself, the
    larger. Gaps are the largest over species."""
    from portbench.reference import a2c as ref
    from portbench.reference.state import FIELDS

    NS = num_species
    n = dict.fromkeys(NUMBERS, 0)
    n["state_mismatch"] = sum(compare.mismatched(getattr(after, f), getattr(want, f))
                              for f in FIELDS if f not in LEARNER_FIELDS)
    for s, r in enumerate(records):
        with torch.no_grad():
            logits = logits_of(s, r["obs"], r["mem"])
        scale = float(r["logits"].abs().max())
        differ = (ref.rows(after.action, s, NS) != ref.rows(want.action, s, NS)).any(-1)
        counted = (r["mask"] == 0) | (r["margin"] > 2 * logit_limit * scale)
        n["action_mismatch"] += int((differ & counted).sum())
        mem_gap = max(_gap(float((ref.rows(getattr(after, f), s, NS)
                                  - ref.rows(getattr(want, f), s, NS)).abs().max()),
                           float(ref.rows(getattr(want, f), s, NS).abs().max()))
                      for f in ("hidden", "prev_hidden"))
        step_p = ts1[s].params - ts0[s].params
        actor = metrics[f"species_{s + 1}_actor_loss"]
        critic = metrics[f"species_{s + 1}_critic_loss"]
        gaps = {"logit_gap": _gap(float((logits - r["logits"]).abs().max()), scale),
                "memory_gap": mem_gap,
                "grad_gap": _gap(_norm(ts1[s].opt_state.mu - r["opt"][1]),
                                 _norm((1 - ref.B1) * r["grad"])),
                "delta_gap": _gap(_norm(step_p - r["step"]), _norm(r["step"])),
                "loss_gap": max(_gap(abs(actor - float(r["actor"])), float(r["actor_scale"])),
                                _gap(abs(critic - float(r["critic"])), float(r["critic"])))}
        for k, v in gaps.items():
            n[k] = max(n[k], v)
    return n


def _norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x))


def _gap(diff: float, scale: float) -> float:
    """diff / scale; 0 where there is no difference, inf where the
    difference is not finite or the reference's scale is 0 (so `max`
    keeps it)."""
    if diff == 0:
        return 0.0
    if not math.isfinite(diff):
        return math.inf
    return diff / scale if scale > 0 else math.inf
