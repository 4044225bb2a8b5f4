"""Frozen copy of the port's plain version, kept by the benchmark so that
later changes to `madrona_bots_tpu_torch` cannot move the reference.
Imports nothing of the port; its original docstring follows.

Lidar raycast sensor and crosshair finder: the plain PyTorch version.

Counterpart of `madrona_bots_tpu/env/raycast.py` and the plain version of
the raycast kernel (`csrc/raycast.cu`). Brute force ray-versus-circle over
target slots as a loop with a running minimum, in the JAX function's
operation order. Every product and sum is its own f32 op: no `addcmul`,
`einsum`, `matmul` or `torch.compile`, which could fuse a multiply-add and
round differently from the reference (SPEC D7b).
"""

from __future__ import annotations

import math

import torch

from portbench.reference import trig
from portbench.reference.config import EnvConfig
from portbench.reference.device import const

_INF = 3.0e38


def ray_angle_offsets(cfg: EnvConfig, device=None) -> torch.Tensor:
    """Per-ray angular offsets from the heading: 3/4 of the pixels sweep the
    forward fan left to right, 1/4 the backward fan. [S] f32."""
    fov = math.radians(cfg.fov_degrees)
    nf, nb = cfg.num_forward_rays, cfg.num_backward_rays
    fwd = [fov / 2 - fov * (i + 0.5) / nf for i in range(nf)]
    bwd = [math.pi + fov / 2 - fov * (j + 0.5) / nb for j in range(nb)]
    return const(fwd + bwd, torch.float32, device or "cpu")


def _wall_distance(pos: torch.Tensor, dirs: torch.Tensor, cfg: EnvConfig) -> torch.Tensor:
    """Distance along each ray to the arena boundary. pos, dirs: [..., 2]."""
    lim = const([cfg.world_lim_x, cfg.world_lim_y], torch.float32, pos.device)
    d = torch.where(dirs == 0, 1.0, dirs)
    t_hi = torch.where(dirs > 0, (lim - pos) / d, _INF)
    t_lo = torch.where(dirs < 0, -pos / d, _INF)
    t = torch.minimum(t_hi, t_lo)
    return torch.minimum(t[..., 0], t[..., 1])


def raycast(pos, heading, alive, species, cfg: EnvConfig):
    """(depth u8 [W,A,S], semantic i8 [W,A,S], finder i32 [W,A]).

    Rays hit alive agents (circles of radius agent_radius, self excluded)
    and walls; the nearest hit with t > near wins, ties to the lower slot.
    Depth byte = 255 - min(255, floor(255 t / max_range)); semantic = hit
    species, 0 for a wall, -1 for none. Finder = nearest agent (walls
    excluded) along the heading ray. Dead sources are empty."""
    W, A = heading.shape
    S = cfg.sensor_size
    dev = pos.device
    offsets = ray_angle_offsets(cfg, dev)
    ang = heading[..., None] + offsets                           # [W, A, S]
    cos_a, sin_a = trig.sincos(ang)
    cos_h, sin_h = trig.sincos(heading)

    r2 = const(cfg.agent_radius * cfg.agent_radius, torch.float32, dev)
    near = const(cfg.near, torch.float32, dev)
    self_idx = torch.arange(A, device=dev)
    px, py = pos[..., 0], pos[..., 1]

    t_min = torch.full((W, A, S), _INF, dtype=torch.float32, device=dev)
    arg_min = torch.full((W, A, S), -1, dtype=torch.int32, device=dev)
    f_min = torch.full((W, A), _INF, dtype=torch.float32, device=dev)
    f_arg = torch.full((W, A), -1, dtype=torch.int32, device=dev)
    for b in range(A):
        ocx = px[:, b:b + 1] - px                                # [W, A] target - source
        ocy = py[:, b:b + 1] - py
        oc2 = ocx * ocx + ocy * ocy
        ok = alive[:, b:b + 1] & (self_idx != b)
        q = torch.where(ok, r2 - oc2, -_INF)

        t_c = cos_a * ocx[..., None] + sin_a * ocy[..., None]   # [W, A, S]
        disc = t_c * t_c + q[..., None]
        t_hit = t_c - torch.sqrt(torch.clamp(disc, min=0.0))
        t_hit = torch.where((disc >= 0) & (t_hit > near), t_hit, _INF)
        closer = t_hit < t_min
        t_min = torch.where(closer, t_hit, t_min)
        arg_min = torch.where(closer, b, arg_min)

        ft_c = cos_h * ocx + sin_h * ocy
        fdisc = ft_c * ft_c + q
        ft = ft_c - torch.sqrt(torch.clamp(fdisc, min=0.0))
        ft = torch.where((fdisc >= 0) & (ft > near), ft, _INF)
        fcloser = ft < f_min
        f_min = torch.where(fcloser, ft, f_min)
        f_arg = torch.where(fcloser, b, f_arg)

    dirs = torch.stack([cos_a, sin_a], dim=-1)                   # [W, A, S, 2]
    t_wall = _wall_distance(pos[:, :, None, :], dirs, cfg)
    t_wall = torch.where(t_wall > near, t_wall, _INF)

    agent_wins = t_min < t_wall
    t = torch.minimum(t_min, t_wall)
    any_hit = t < _INF

    sp_hit = torch.gather(species, 1, arg_min.clamp(min=0).reshape(W, A * S).long())
    semantic = torch.where(any_hit,
                           torch.where(agent_wins, sp_hit.reshape(W, A, S), 0),
                           -1).to(torch.int8)

    scale = const(255.0 / cfg.max_range, torch.float32, dev)
    db = 255 - torch.clamp(torch.floor(t * scale), max=255.0).to(torch.int32)
    depth = torch.where(any_hit, db, 0).to(torch.uint8)
    finder = torch.where(f_min < _INF, f_arg, -1).to(torch.int32)

    src_alive = alive[..., None]
    depth = torch.where(src_alive, depth, 0).to(torch.uint8)
    semantic = torch.where(src_alive, semantic, -1).to(torch.int8)
    finder = torch.where(alive, finder, -1).to(torch.int32)
    return depth, semantic, finder
