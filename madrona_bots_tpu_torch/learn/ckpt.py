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
"""

from __future__ import annotations

import fnmatch
import glob
import json
import os
from typing import Tuple

import numpy as np
import torch

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
