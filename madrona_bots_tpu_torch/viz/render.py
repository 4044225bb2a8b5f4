"""World and sensor rendering (matplotlib, imported where a frame is drawn).

Counterpart of `madrona_bots_tpu/viz/render.py`, which replaces the
reference's Vulkan viewer and ImGui raycast panel (src/gfx/gfx.cpp:214-318):
a top-down arena view (agents coloured by species with heading ticks, food
markers, chunk grid) and one agent's sensor strip, depth as a grey row and
semantics as a colour row, 24 forward over 8 backward rays as in the
reference panel (gfx.cpp:252-253).

The state may live on the card, so the drawing functions read a host copy
of one world (`world_to_host`), taken once a frame.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Optional

import numpy as np

from madrona_bots_tpu_torch.config import EnvConfig

SPECIES_COLORS = np.array([
    [0.55, 0.55, 0.55],   # 0: unused / wall
    [0.90, 0.30, 0.25],   # species 1
    [0.25, 0.60, 0.90],   # species 2
    [0.35, 0.80, 0.35],   # species 3
    [0.95, 0.75, 0.20],   # species 4
])

WORLD_FIELDS = ("alive", "pos", "heading", "species", "health", "food_count",
                "food_cell", "sensor_depth", "sensor_semantic")


def world_to_host(state, world_idx: int) -> SimpleNamespace:
    """World `world_idx`'s fields (`WORLD_FIELDS`) and the step count as
    numpy arrays: the one copy to the host a frame or snapshot needs."""
    out = {f: getattr(state, f)[world_idx].cpu().numpy() for f in WORLD_FIELDS}
    return SimpleNamespace(step_count=int(state.step_count), **out)


def selected_slot(alive: np.ndarray, agent: int) -> tuple[int, int]:
    """(agent clamped to the world's alive count, its capacity slot): the
    agent is an index into the world's alive agents, so rendering and
    keyboard control target the same one. Slot 0 where none is alive."""
    slots = np.flatnonzero(alive)
    if slots.size == 0:
        return agent, 0
    agent = min(max(agent, 0), slots.size - 1)
    return agent, int(slots[agent])


def semantic_to_rgb(semantic: np.ndarray) -> np.ndarray:
    """[S] int8 -> [S, 3] float colours. -1 (no hit) is near-black; 0 = wall."""
    out = np.zeros(semantic.shape + (3,), np.float32)
    out[semantic < 0] = [0.08, 0.08, 0.08]
    for v in range(0, 5):
        out[semantic == v] = SPECIES_COLORS[v]
    return out


def render_world(ax, world: SimpleNamespace, cfg: EnvConfig,
                 selected_agent: Optional[int] = None):
    """Draw one world's top-down view (a `world_to_host` copy) onto a
    matplotlib Axes."""
    from matplotlib.patches import Circle

    ax.clear()
    ax.set_xlim(0, cfg.world_lim_x)
    ax.set_ylim(0, cfg.world_lim_y)
    ax.set_aspect("equal")
    ax.set_facecolor("#101010")
    cw = cfg.chunk_width * cfg.cell_dim
    for i in range(1, cfg.num_chunks_x):
        ax.axvline(i * cw, color="#222222", lw=0.5)
    for j in range(1, cfg.num_chunks_y):
        ax.axhline(j * cw, color="#222222", lw=0.5)

    for c in range(cfg.num_chunks):
        cx0 = (c % cfg.num_chunks_x) * cfg.chunk_width
        cy0 = (c // cfg.num_chunks_x) * cfg.chunk_width
        for p in range(cfg.max_food_packages):
            if world.food_count[c, p] > 0:
                fx = (cx0 + world.food_cell[c, p, 0]) * cfg.cell_dim
                fy = (cy0 + world.food_cell[c, p, 1]) * cfg.cell_dim
                ax.plot(fx, fy, marker="s", ms=4, color="#d0f0a0")

    pos, heading = world.pos, world.heading
    for a in np.where(world.alive)[0]:
        col = SPECIES_COLORS[world.species[a]]
        ax.add_patch(Circle(pos[a], cfg.agent_radius, color=col,
                            ec="white" if a == selected_agent else None, lw=1.5))
        tip = pos[a] + cfg.agent_radius * 1.6 * np.array(
            [np.cos(heading[a]), np.sin(heading[a])])
        ax.plot([pos[a][0], tip[0]], [pos[a][1], tip[1]], color=col, lw=1.2)
    ax.set_xticks([])
    ax.set_yticks([])


def render_sensor_strip(ax_depth, ax_sem, world: SimpleNamespace,
                        agent_slot: int, cfg: EnvConfig):
    """Draw the reference's raycast panel rows for one agent: depth grey
    and semantic colours, forward rays on top, backward below."""
    nf = cfg.num_forward_rays
    depth = world.sensor_depth[agent_slot]
    sem = world.sensor_semantic[agent_slot]

    dimg = np.zeros((2, nf), np.float32)
    dimg[0, :] = depth[:nf] / 255.0
    dimg[1, : cfg.num_backward_rays] = depth[nf:] / 255.0
    ax_depth.clear()
    ax_depth.imshow(dimg, cmap="gray", vmin=0, vmax=1, aspect="auto",
                    interpolation="nearest")
    ax_depth.set_title("depth", fontsize=7)
    ax_depth.set_xticks([])
    ax_depth.set_yticks([])

    simg = np.zeros((2, nf, 3), np.float32)
    simg[0] = semantic_to_rgb(sem[:nf])
    simg[1, : cfg.num_backward_rays] = semantic_to_rgb(sem[nf:])
    ax_sem.clear()
    ax_sem.imshow(simg, aspect="auto", interpolation="nearest")
    ax_sem.set_title("semantic", fontsize=7)
    ax_sem.set_xticks([])
    ax_sem.set_yticks([])


def save_frame(state, world_idx: int, cfg: EnvConfig, path: str,
               agent_slot: int = 0):
    """Headless one-shot render of one world and one agent's sensor strips
    to a PNG."""
    return save_world_frame(world_to_host(state, world_idx), cfg, path, agent_slot)


def save_world_frame(world: SimpleNamespace, cfg: EnvConfig, path: str,
                     agent_slot: int = 0):
    """`save_frame` of a `world_to_host` copy."""
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(8, 7))
    gs = fig.add_gridspec(8, 1)
    ax = fig.add_subplot(gs[:6])
    axd = fig.add_subplot(gs[6])
    axs = fig.add_subplot(gs[7])
    render_world(ax, world, cfg, selected_agent=agent_slot)
    render_sensor_strip(axd, axs, world, agent_slot, cfg)
    fig.savefig(path, dpi=110, facecolor="#181818")
    plt.close(fig)
    return path
