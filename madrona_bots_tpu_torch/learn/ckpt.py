"""Checkpoint manager, in the JAX package's file layout.

Counterpart of `madrona_bots_tpu/learn/ckpt.py::CheckpointManager`: per-species
subdirectories holding `latest_model_epoch_N.ckpt.npz` and
`best_{metric}_epoch_N.ckpt.npz`, one file per name pattern (stale files are
deleted only after the new one is written), and highest-epoch restore that
rebuilds the random architecture from the saved `model_config`.

One `.npz` per checkpoint: `p_i` the parameter leaves and `o_i` the Adam
leaves (count, mu, nu), both in the JAX package's leaf order, `model_config`
as JSON bytes and `epoch`. A universe written by either package loads in
the other (tests/test_torch_ckpt.py).

Also the JAX module's interop helpers: `import_torch_checkpoint` (a
reference `.pt` file as the port's net) and `save_sim_state` /
`load_sim_state` (the simulator state in the JAX package's `.npz` layout).
"""

from __future__ import annotations

import fnmatch
import glob
import json
import os
from typing import Tuple

import numpy as np
import torch

from madrona_bots_tpu_torch.env.state import (FIELDS, WorldState, state_from_numpy,
                                              state_to_numpy)
from madrona_bots_tpu_torch.learn.a2c import Adam, AdamState
from madrona_bots_tpu_torch.models.actor_critic import ActorCritic


def _pattern(metric_name: str) -> str:
    return ("latest_model_epoch_*.ckpt.npz" if metric_name == "latest"
            else f"best_{metric_name}_epoch_*.ckpt.npz")


def _epoch(path: str) -> int:
    return int(path.split("_")[-1].split(".")[0])


class CheckpointManager:
    def __init__(self, base_ckpt_dir: str, restore: bool = True):
        self.base_ckpt_dir = base_ckpt_dir
        self.restore = restore
        os.makedirs(base_ckpt_dir, exist_ok=True)

    def save(self, model: ActorCritic, params: torch.Tensor, opt_state: AdamState,
             sub_dir: str, epoch: int, metric_name: str = "latest",
             verbose: bool = False) -> None:
        """Write `params` (the flat vector) and `opt_state`, then delete the
        older files of the same name pattern."""
        full_path = os.path.join(self.base_ckpt_dir, sub_dir)
        os.makedirs(full_path, exist_ok=True)
        stem = "latest_model" if metric_name == "latest" else f"best_{metric_name}"
        filename = f"{stem}_epoch_{epoch}.ckpt.npz"
        save_path = os.path.join(full_path, filename)
        leaves = model.unflatten(params.detach())
        arrays = {f"p_{i}": t.cpu().numpy() for i, t in enumerate(leaves)}
        arrays["o_0"] = np.int32(int(opt_state.count))
        arrays["o_1"] = opt_state.mu.detach().cpu().numpy()
        arrays["o_2"] = opt_state.nu.detach().cpu().numpy()
        arrays["model_config"] = np.frombuffer(
            json.dumps(model.get_config()).encode(), dtype=np.uint8)
        arrays["epoch"] = np.int64(epoch)
        np.savez(save_path, **arrays)
        for f in os.listdir(full_path):
            if f != filename and fnmatch.fnmatch(f, _pattern(metric_name)):
                os.remove(os.path.join(full_path, f))
        if verbose:
            print(f"Saved model to {save_path}")

    def load(self, model_class, optimizer: Adam, sub_dir: str,
             metric_name: str = "latest", verbose: bool = True, device=None
             ) -> Tuple[ActorCritic, torch.Tensor, AdamState, int]:
        """(model, flat params, Adam state, epoch) of the highest-epoch file."""
        files = glob.glob(os.path.join(self.base_ckpt_dir, sub_dir, _pattern(metric_name)))
        if not files:
            raise FileNotFoundError(f"No model found for metric:{metric_name}")
        if not self.restore:
            raise RuntimeError("Restore must be True to load a model")
        load_path = max(files, key=_epoch)
        if verbose:
            print(f"Loading model from {load_path}")
        with np.load(load_path) as data:
            config = json.loads(bytes(data["model_config"]).decode())
            model = model_class(config, device=device)
            leaves = [torch.from_numpy(np.array(data[f"p_{i}"], dtype=np.float32))
                      for i in range(len(model.specs))]
            for t, (name, shape) in zip(leaves, model.specs):
                if tuple(t.shape) != shape:
                    raise ValueError(f"{load_path}: {name} has shape {tuple(t.shape)}, "
                                     f"the config says {shape}")
            params = model.flatten(leaves).to(device)
            opt_state = AdamState(
                torch.tensor(int(data["o_0"]), dtype=torch.int32, device=device),
                torch.from_numpy(np.array(data["o_1"], dtype=np.float32)).to(device),
                torch.from_numpy(np.array(data["o_2"], dtype=np.float32)).to(device))
        if opt_state.mu.shape != params.shape or opt_state.nu.shape != params.shape:
            raise ValueError(f"{load_path}: Adam moments do not match the parameters")
        return model, params, opt_state, _epoch(load_path)


def import_torch_checkpoint(path: str, device=None) -> Tuple[ActorCritic, torch.Tensor]:
    """A reference-format `.pt` checkpoint as (the port's ActorCritic, its
    flat parameter vector). The file holds `model_config` (which rebuilds
    the random architecture) and `model_state_dict`, whose keys are
    positional within each `nn.Sequential` (`a2c_nets.feature.{i}`,
    `a2c_nets.actor.{i}`, `a2c_nets.critic.{i}`) and the recurrent cell's
    `weight_ih_l0` / `weight_hh_l0` / `bias_*_l0`. torch stores a Linear
    weight [out, in] and the cell's [gates * dh, din]; the port's are [in,
    out] and [din, gates * dh], with the same gate order (LSTM i, f, g, o;
    GRU r, z, n), as the JAX package's `import_torch_checkpoint`."""
    ck = torch.load(path, map_location="cpu", weights_only=False)
    config = ck["model_config"]
    sd = {k: v.detach().to(torch.float32) for k, v in ck["model_state_dict"].items()}
    model = ActorCritic(config, device=device)
    src = {"recurrent.wi": sd["a2c_nets.recurrent.weight_ih_l0"].T,
           "recurrent.wh": sd["a2c_nets.recurrent.weight_hh_l0"].T,
           "recurrent.bi": sd["a2c_nets.recurrent.bias_ih_l0"],
           "recurrent.bh": sd["a2c_nets.recurrent.bias_hh_l0"]}
    for head in ("feature", "actor", "critic"):
        for i, lc in enumerate(config["layers" if head == "feature" else head]):
            if lc["type"] == "linear":
                src[f"{head}.{i}.w"] = sd[f"a2c_nets.{head}.{i}.weight"].T
                src[f"{head}.{i}.b"] = sd[f"a2c_nets.{head}.{i}.bias"]
    leaves = []
    for name, shape in model.specs:
        if tuple(src[name].shape) != shape:
            raise ValueError(f"{path}: {name} has shape {tuple(src[name].shape)}, "
                             f"the config says {shape}")
        leaves.append(src[name].contiguous())
    return model, model.flatten(leaves).to(device)


def save_sim_state(state: WorldState, path: str) -> None:
    """The whole simulator state in the JAX package's layout: one `.npz`
    with `s_{i}` the i-th `WorldState` field in field order, with the JAX
    dtypes (world keys as their uint32 words), so either package loads a
    state the other saved."""
    arrays = state_to_numpy(state)
    np.savez(path, **{f"s_{i}": arrays[name] for i, name in enumerate(FIELDS)})


def load_sim_state(path: str, device=None) -> WorldState:
    """A state saved by `save_sim_state` (either package's), on `device`
    (default CUDA)."""
    with np.load(path) as data:
        return state_from_numpy({name: data[f"s_{i}"] for i, name in enumerate(FIELDS)},
                                device)
