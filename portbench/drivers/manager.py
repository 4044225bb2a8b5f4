"""The SimManager loop of upstream users: a call writes one-hot actions into
`action_tensor().to_torch()`, steps, reads the 12 getters and shifts the
observations, then synchronises.

Actions are a pool drawn at set-up on the device from the seed and used in
turn. The check follows the program step by step from its own state: at the
window's first call and at `check.count` calls drawn from the seed among
the `check.within` after it, the state the step starts from, the exports
and the state after the step are kept; after the window the reference
steps each kept state with the same actions. The start (the state `SimManager` builds from the seed) is
compared with the reference's own `init_state`.
"""

from __future__ import annotations

import random

import torch
from torch.profiler import record_function

from portbench import compare, yardstick
from portbench.core import sync

NINE = ("depth", "semantic", "reward", "position", "health", "surrounding", "action",
        "stats", "hidden_state")
FLOAT_FIELDS = ("pos", "heading", "surrounding", "reward", "hidden", "prev_pos",
                "prev_surrounding", "prev_reward", "prev_hidden", "species_rewards")


def getters(mgr) -> dict:
    """The 12 getters' device tensors."""
    out = {"species_count": mgr.species_count_tensor().to_torch(),
           "done": mgr.done_tensor().to_torch(),
           "sensor_index": mgr.sensor_index_tensor().to_torch()}
    for name in NINE:
        out[f"{name}_0"] = getattr(mgr, f"{name}_tensor")(False).to_torch()
    return out


def env_config(EnvConfig, RewardSetting, config: dict, traffic: dict):
    return EnvConfig(num_worlds=config["num_worlds"], init_agents=traffic["init_agents"],
                     max_agents=config["max_agents"], num_species=config["num_species"],
                     reward_setting=RewardSetting(config["reward_setting"]))


class Driver:

    def __init__(self, config: dict, workload: dict, seed: int, device, trace: bool):
        from madrona_bots_tpu_torch.api import SimManager
        from madrona_bots_tpu_torch.config import EnvConfig, RewardSetting

        t, check = workload["traffic"], workload["check"]
        self.config, self.workload, self.seed, self.device = config, workload, seed, device
        self.cfg = env_config(EnvConfig, RewardSetting, config, t)
        W, A = self.cfg.num_worlds, self.cfg.max_agents
        self.mgr = SimManager(0, W, seed, t["init_agents"], env_config=self.cfg, device=device)
        self.start = self.mgr.state.clone()
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        draws = torch.randint(0, 6, (t["action_pool"], W * A), generator=gen, device=device)
        self.pool = torch.nn.functional.one_hot(draws, 6).to(torch.int32)
        self.check_at = {0, *random.Random(seed).sample(range(1, check["within"]),
                                                        check["count"])}
        self.kept = []                 # (call, state before, exports, state after)
        self.calls = -workload["warmup"]
        self.tracing, self.traced = False, 0
        n = workload["bound_samples"] if trace else 0
        self.bound_every = max(1, workload["trace_calls"] // max(n, 1))
        # Traced steps' (alive, food cells) before and (alive, food cells,
        # pos, heading) after, copied into buffers made here.
        s = self.mgr.state
        self.samples = [tuple(torch.empty_like(x) for x in (s.alive, s.food_cell, s.alive,
                                                             s.food_cell, s.pos, s.heading))
                        for _ in range(n)]
        self.sampled = 0
        self.world_steps = W
        if trace:
            for name in ("_recompute_order", "_refresh_exports"):
                setattr(self.mgr, name, self._spanned(getattr(self.mgr, name)))
        for _ in range(workload["warmup"]):
            self.call()

    @staticmethod
    def _spanned(fn):
        def run():
            with record_function("portbench.export"):
                return fn()
        return run

    def call(self) -> int:
        mgr, i = self.mgr, self.calls
        self.calls += 1
        keep = i in self.check_at
        sample = (self.tracing and self.traced % self.bound_every == 0
                  and self.sampled < len(self.samples))
        if self.tracing:
            self.traced += 1
        if keep:
            before = mgr.state.clone()
        if sample:
            buf = self.samples[self.sampled]
            self.sampled += 1
            buf[0].copy_(mgr.state.alive)
            buf[1].copy_(mgr.state.food_cell)
        with record_function("portbench.write"):
            act = mgr.action_tensor().to_torch()
            act.copy_(self.pool[i % self.pool.shape[0], : act.shape[0]])
        with record_function("portbench.step"):
            mgr.step()
        with record_function("portbench.export"):
            out = getters(mgr)
        if keep:
            self.kept.append((i, before, {k: v.clone() for k, v in out.items()},
                              mgr.state.clone()))
        if sample:
            s = mgr.state
            for dst, src in zip(buf[2:], (s.alive, s.food_cell, s.pos, s.heading)):
                dst.copy_(src)
        with record_function("portbench.shift"):
            mgr.shift_observations()
        sync(self.device)
        return self.world_steps

    def finish(self) -> None:
        """Free the manager; count the traced steps' bounds."""
        self.mgr = None
        self.pool = None
        sysb, rayb = [], []
        for alive0, food0, alive1, food1, pos, heading in self.samples[:self.sampled]:
            nb, fl = yardstick.step_bound(alive0, alive1,
                                          yardstick.food_placed(food0, food1), self.cfg)
            sysb.append(yardstick.bound_s(nb, fl))
            rayb.append(yardstick.bound_s(*yardstick.raycast_bound(pos, heading, alive1,
                                                                   self.cfg)))
        self.samples = []
        if sysb:
            self.systems_bound_s = sum(sysb) / len(sysb)
            self.raycast_bound_s = sum(rayb) / len(rayb)

    def numbers(self, quant=None) -> dict:
        """The compared numbers; with `quant` the control: the reference
        with every float field of the state rounded through `quant` before
        and after its step."""
        from portbench.reference import manager as ref
        from portbench.reference.config import EnvConfig, RewardSetting
        from portbench.reference.state import FIELDS, init_state

        cfg = env_config(EnvConfig, RewardSetting, self.config, self.workload["traffic"])
        start = init_state(cfg, self.seed, self.device)
        n = {"start_mismatch": sum(compare.mismatched(getattr(self.start, f), getattr(start, f))
                                   for f in FIELDS),
             "state_mismatch": 0, "export_mismatch": 0, "steps_checked": len(self.kept)}
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed)
        W, A = cfg.num_worlds, cfg.max_agents
        draws = torch.randint(0, 6, (self.workload["traffic"]["action_pool"], W * A),
                              generator=gen, device=self.device)
        for i, before, got, after in self.kept:
            state = before.replace(**{f: getattr(before, f).clone() for f in FIELDS})
            if quant is not None:
                state = _rounded(state, quant)
            actions = torch.nn.functional.one_hot(draws[i % draws.shape[0]], 6).to(torch.int32)
            want_state = ref.step(state, actions, cfg)
            if quant is not None:
                want_state = _rounded(want_state, quant)
            want = ref.exports(want_state, cfg)
            n["state_mismatch"] += sum(compare.mismatched(getattr(after, f),
                                                          getattr(want_state, f))
                                       for f in FIELDS)
            n["export_mismatch"] += sum(compare.mismatched(got[k], w) for k, w in want.items())
        if not self.kept:                  # the window ended before its first call
            n.update(state_mismatch=None, export_mismatch=None)
        return n


def _rounded(state, dtype):
    return state.replace(**{f: getattr(state, f).to(dtype).to(torch.float32)
                            for f in FLOAT_FIELDS})
