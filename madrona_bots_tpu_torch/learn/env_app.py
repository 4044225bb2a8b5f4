"""Legacy viewer-embedded training loop: the reference's learn/env_app.py
(env_app.py:1-87). Counterpart of `madrona_bots_tpu/learn/env_app.py`.

A `ScriptBotsViewer(0, 4, 69, 32, 1375, 768)` whose loop calls a
`train_step(sim_mgr)` closure each frame: step the simulator, one update per
species on its rows of the exports (`learn/env.py::species_updates`), the
one-hot actions written back into the exported action tensor, then shift
the observations. Headless backends save frames instead of opening a window
(`viz/viewer.py`).

Run: python -m madrona_bots_tpu_torch.learn.env_app --num_worlds 4 --num_epochs 20
(on CUDA; `--device cpu` runs the plain versions on the CPU).
"""

from __future__ import annotations

import argparse

from madrona_bots_tpu_torch import rng
from madrona_bots_tpu_torch.device import resolve
from madrona_bots_tpu_torch.learn.env import init_models, species_updates
from madrona_bots_tpu_torch.learn.util import set_seed
from madrona_bots_tpu_torch.viz.viewer import ScriptBotsViewer


def make_train_step(models, opt, params, opt_states, num_species, key_holder):
    """The per-frame closure the viewer loop drives (env_app.py:40-87).
    `params[s]` and `opt_states[s]` are updated in the lists, the key in
    `key_holder[0]`."""
    models = models[:num_species]

    def train_step(sim_mgr, verbose: bool = False):
        sim_mgr.step()
        species_updates(sim_mgr, models, opt, params, opt_states, key_holder, verbose)
        sim_mgr.shift_observations()

    return train_step


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--num_worlds", type=int, default=4)      # env_app.py:13
    p.add_argument("--num_epochs", type=int, default=100)
    p.add_argument("--num_species", type=int, default=4)
    p.add_argument("--obs_dim", type=int, default=69)
    p.add_argument("--hidden_dim", type=int, default=128)
    p.add_argument("--action_dim", type=int, default=6)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--seed", type=int, default=69)           # env_app.py:13
    p.add_argument("--window_width", type=int, default=1375)
    p.add_argument("--window_height", type=int, default=768)
    p.add_argument("--frame_dir", type=str, default="viewer_frames")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default CUDA (raises without a card)")
    args = p.parse_args(argv)

    dev = resolve(args.device)
    set_seed(args.seed)
    viewer_app = ScriptBotsViewer(0, args.num_worlds, args.seed, 32,
                                  args.window_width, args.window_height,
                                  frame_dir=args.frame_dir, device=dev)
    sim_mgr = viewer_app.get_sim_mgr()
    models, opt, params, opt_states = init_models(args, dev)
    key_holder = [rng.key(args.seed + 1, dev)]

    train_step = make_train_step(models, opt, params, opt_states,
                                 args.num_species, key_holder)
    viewer_app.loop(args.num_epochs, lambda epoch, carry: train_step(sim_mgr))
    return params


if __name__ == "__main__":
    main()
