"""Utilities: `set_seed`, as `madrona_bots_tpu/learn/util.py`.

The port's own randomness is explicit threefry keys (`rng.py`); this seeds
the Python, numpy and torch generators that callers may use."""

from __future__ import annotations

import random

import numpy as np
import torch


def set_seed(seed_value: int) -> None:
    random.seed(seed_value)
    np.random.seed(seed_value)
    torch.manual_seed(seed_value)
