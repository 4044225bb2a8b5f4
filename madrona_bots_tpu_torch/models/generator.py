"""Random per-species architecture sampling.

A copy of `madrona_bots_tpu/models/generator.py` (the port imports nothing of
the JAX package). Each species gets a randomly generated actor-critic: a
feature MLP with 1-3 hidden Linear layers and random activations from {Tanh,
ELU, LogSigmoid, LeakyReLU, ReLU}, a random recurrent cell from {LSTM, GRU,
RNN} whose hidden state is the 16-dim memory carried inside the simulator,
and fixed 2-layer actor/critic heads. Configs are JSON-able dicts in the
checkpoint format, drawn from Python's `random.Random(seed)`, so a seed gives
the same configs in both packages (tests/test_torch_models.py).
"""

from __future__ import annotations

import random
from typing import Any, Dict

ACTIVATIONS = ["Tanh", "ELU", "LogSigmoid", "LeakyReLU", "ReLU"]
RECURRENT_TYPES = ["LSTM", "GRU", "RNN"]


class SpeciesNetGenerator:
    """Samples architecture configs: (obs_dim, action_dim, hidden_dim,
    memory_dim)."""

    def __init__(self, input_dim: int, output_dim: int, hidden_dim: int,
                 memory_dim: int = 16, seed: int | None = None):
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.hidden_dim = hidden_dim
        self.memory_dim = memory_dim
        self._rng = random.Random(seed)

    def sample_config(self) -> Dict[str, Any]:
        """One random architecture, as a config dict."""
        rng = self._rng
        layers = [{"type": "linear", "in_features": self.input_dim,
                   "out_features": self.hidden_dim}]
        for _ in range(rng.randint(1, 3)):
            layers.append({"type": "linear", "in_features": self.hidden_dim,
                           "out_features": self.hidden_dim})
            layers.append({"type": "activation",
                           "activation": rng.choice(ACTIVATIONS)})
        return {
            "layers": layers,
            "recurrent": {
                "type": rng.choice(RECURRENT_TYPES),
                "input_dim": self.hidden_dim,
                "hidden_dim": self.memory_dim,
            },
            "actor": [
                {"type": "linear", "in_features": self.memory_dim,
                 "out_features": self.hidden_dim},
                {"type": "activation", "activation": "ReLU"},
                {"type": "linear", "in_features": self.hidden_dim,
                 "out_features": self.output_dim},
            ],
            "critic": [
                {"type": "linear", "in_features": self.memory_dim,
                 "out_features": self.hidden_dim},
                {"type": "activation", "activation": "ReLU"},
                {"type": "linear", "in_features": self.hidden_dim,
                 "out_features": 1},
            ],
        }
