"""ScriptBotsViewer: the reference's viewer class (src/entry/entry.cpp:47-80).

Counterpart of `madrona_bots_tpu/viz/viewer.py`: the constructor
`(gpu_id, num_worlds, rand_seed, init_num_agents_per_world, window_width,
window_height)`, `loop(num_epochs, step_fn, carry)` and `get_sim_mgr()`.
The Vulkan window and ImGui raycast panel (src/gfx/gfx.cpp) become a
matplotlib figure; with an interactive backend the reference's keys work
(gfx.cpp:176-205): W/S forward/backward, R/F rotate left/right, SPACE shoot,
B breed, arrow keys switch the inspected agent / world. Headless (Agg),
`loop` saves a PNG frame every `frame_every` epochs instead. Each frame and
each key press reads one host copy of the inspected world.
"""

from __future__ import annotations

import os
from typing import Any, Callable

from madrona_bots_tpu_torch.api.manager import SimManager
from madrona_bots_tpu_torch.viz.render import (render_sensor_strip, render_world,
                                               save_world_frame, selected_slot,
                                               world_to_host)


class ScriptBotsViewer:
    def __init__(self, gpu_id: int, num_worlds: int, rand_seed: int,
                 init_num_agents_per_world: int,
                 window_width: int = 1375, window_height: int = 768,
                 frame_dir: str = "viewer_frames", frame_every: int = 10,
                 device=None, **mgr_kwargs):
        self.sim_mgr = SimManager(gpu_id, num_worlds, rand_seed,
                                  init_num_agents_per_world, device=device,
                                  **mgr_kwargs)
        self.window = (window_width, window_height)
        self.frame_dir = frame_dir
        self.frame_every = frame_every
        self.inspect_world = 0
        self.inspect_agent = 0
        self._keys = set()
        self._fig = None

    def get_sim_mgr(self) -> SimManager:
        return self.sim_mgr

    # ---- input (the keyboard scheme of gfx.cpp:176-205) ----

    def _on_key(self, event):
        k = (event.key or "").lower()
        if k == "right":
            self.inspect_agent += 1
        elif k == "left":
            self.inspect_agent = max(0, self.inspect_agent - 1)
        elif k == "up":
            self.inspect_world = min(self.sim_mgr.cfg.num_worlds - 1,
                                     self.inspect_world + 1)
        elif k == "down":
            self.inspect_world = max(0, self.inspect_world - 1)
        else:
            self._keys.add(k)

    def _selected_slot(self, world=None) -> int:
        """The capacity slot of the inspected agent, an index into the
        inspected world's alive agents (clamped), from `world` (a
        `world_to_host` copy) or one copy of the world's alive mask."""
        alive = (world.alive if world is not None else
                 self.sim_mgr.state.alive[self.inspect_world].cpu().numpy())
        self.inspect_agent, slot = selected_slot(alive, self.inspect_agent)
        return slot

    def _apply_keys(self):
        if not self._keys:
            return
        mgr = self.sim_mgr
        self._selected_slot()  # clamps inspect_agent to the alive count
        offset = mgr.agent_offset_for_world(self.inspect_world)
        row = int(mgr.sensor_index_tensor().to_torch()[offset + self.inspect_agent, 0])
        k = self._keys
        mgr.set_action(row,
                       forward=int("w" in k), backward=int("s" in k),
                       rotate_left=int("r" in k), rotate_right=int("f" in k),
                       shoot=int(" " in k or "space" in k),
                       breed=int("b" in k))
        self._keys.clear()

    # ---- main loop ----

    def loop(self, num_epochs: int, step_fn: Callable[[int, Any], None],
             carry: Any = None, print_freq: int = 10):
        import matplotlib
        interactive = matplotlib.get_backend().lower() not in (
            "agg", "pdf", "svg", "ps")
        import matplotlib.pyplot as plt

        if interactive:
            self._fig = plt.figure(
                figsize=(self.window[0] / 110, self.window[1] / 110))
            gs = self._fig.add_gridspec(8, 1)
            self._ax = self._fig.add_subplot(gs[:6])
            self._axd = self._fig.add_subplot(gs[6])
            self._axs = self._fig.add_subplot(gs[7])
            self._fig.canvas.mpl_connect("key_press_event", self._on_key)
            plt.ion()
            plt.show(block=False)
        else:
            os.makedirs(self.frame_dir, exist_ok=True)

        for epoch in range(1, num_epochs + 1):
            if epoch % print_freq == 0 or epoch == 1:
                print("Relative Epoch ", epoch)
            self._apply_keys()
            step_fn(epoch, carry)
            if interactive:
                self._draw()
                self._fig.canvas.draw_idle()
                self._fig.canvas.flush_events()
            elif epoch % self.frame_every == 0 or epoch == 1:
                world = world_to_host(self.sim_mgr.state, self.inspect_world)
                save_world_frame(world, self.sim_mgr.cfg,
                                 os.path.join(self.frame_dir, f"epoch_{epoch:06d}.png"),
                                 agent_slot=self._selected_slot(world))

    def _draw(self):
        cfg = self.sim_mgr.cfg
        world = world_to_host(self.sim_mgr.state, self.inspect_world)
        slot = self._selected_slot(world)
        render_world(self._ax, world, cfg, selected_agent=slot)
        render_sensor_strip(self._axd, self._axs, world, slot, cfg)
