"""Model FLOPs of the learner cells, counted from the configuration's
architecture dicts: 2 FLOPs a multiply-add of each Linear layer and
recurrent cell; biases, activations and gates' elementwise work are left
out."""

from __future__ import annotations

GATES = {"LSTM": 4, "GRU": 3, "RNN": 1}


def forward_macs(arch: dict) -> int:
    """Multiply-adds of one row's forward through a net: its feature MLP,
    its recurrent cell (input and hidden products of every gate) and both
    heads."""
    macs = sum(lc["in_features"] * lc["out_features"]
               for part in ("layers", "actor", "critic") for lc in arch[part]
               if lc["type"] == "linear")
    rc = arch["recurrent"]
    return macs + GATES[rc["type"]] * rc["hidden_dim"] * (rc["input_dim"] + rc["hidden_dim"])


def a2c_tick_flops(config: dict) -> float:
    """FLOPs of one A2C TD(0) tick on the loop path: each species' net over
    every slot of its class (num_worlds * max_agents / num_species rows,
    masked), four forwards' worth a row: the no-grad forward on this tick's
    rows, the forward on the last tick's rows and its backward, counted as
    twice a forward."""
    rows = config["num_worlds"] * config["max_agents"] // config["num_species"]
    return 2.0 * 4 * rows * sum(forward_macs(a) for a in config["species_nets"])
