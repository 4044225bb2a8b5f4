"""Utilities, as `madrona_bots_tpu/learn/util.py`.

`construct_obs` builds the 69-dim flat observation from a SimManager's
exported tensors in the reference's layout: [depth(32), health(1), pos(2),
semantic(32), surrounding(2)] (util.py:14-29). `set_seed` seeds the Python,
numpy and torch generators that callers may use (the port's own randomness
is explicit threefry keys, `rng.py`).
"""

from __future__ import annotations

import random
from typing import Sequence

import numpy as np
import torch


def set_seed(seed_value: int) -> None:
    random.seed(seed_value)
    np.random.seed(seed_value)
    torch.manual_seed(seed_value)


def construct_obs(sim_mgr, start: int, end: int, prev: bool = False,
                  verbose: bool = False) -> torch.Tensor:
    """float32 [end - start, 69] on the manager's device: rows [start, end)
    of the exports."""
    fields = [("depth", sim_mgr.depth_tensor(prev)),
              ("health", sim_mgr.health_tensor(prev)),
              ("position", sim_mgr.position_tensor(prev)),
              ("semantic", sim_mgr.semantic_tensor(prev)),
              ("surrounding", sim_mgr.surrounding_tensor(prev))]
    cols = [t.to_torch()[start:end] for _, t in fields]
    if verbose:
        for (name, _), t in zip(fields, cols):
            print(f"Shape of {name} tensor: ", tuple(t.shape))
    return torch.cat([c.to(torch.float32) for c in cols], dim=1)


def confirm_load(original_params: Sequence[torch.Tensor],
                 loaded_params: Sequence[torch.Tensor]) -> bool:
    """Parameter equality after a restore (reference util.py:53-62), over
    two sequences of parameter tensors (leaves or flat vectors)."""
    ok = True
    for i, (a, b) in enumerate(zip(original_params, loaded_params)):
        if not torch.equal(a.detach().cpu(), b.detach().cpu()):
            print(f"Mismatch in parameter: [{i}]")
            ok = False
    if ok:
        print("All parameters match successfully!")
    return ok
