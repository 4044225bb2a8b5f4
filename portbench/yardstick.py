"""The yardstick: the chip's published peaks, the bytes and operations a
world step and a raycast need (frozen copies of `chip_smoke.py`'s
`step_bound` and `raycast_bound`, on the reference's trigonometry)."""

from __future__ import annotations

import torch

from portbench.reference import trig
from portbench.reference.raycast import ray_angle_offsets

# One NVIDIA H100 SXM (data sheet; dense rates, 700 W).
HBM_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
"""FP32 outside the tensor cores."""


def food_placed(food_cell_before: torch.Tensor, food_cell_after: torch.Tensor) -> int:
    """Food package cells one step's spawn wrote."""
    return int((food_cell_after != food_cell_before).any(dim=-1).sum())


def step_bound(alive_before: torch.Tensor, alive_after: torch.Tensor, placed: int, cfg):
    """(bytes, FP32 operations) of one systems step. Read once: `alive` of
    every slot; species, health, position, heading, action and finder of the
    slots alive at step start; the two sensor rows of the slots that stay
    alive; per world the food tables, num_food, the key and (once) the step
    count. Written once: the new per-slot fields and both prev sensor rows
    of every slot; the hidden, action and prev rows of the slots cleared
    (dead or fresh); per world the food counts, the package cells the spawn
    changed, num_food, species counts and rewards; the new step count.
    Operations, one each for an f32 add, product, quotient, square root, two
    for a fused multiply-add: 22 for the move, speed, chunk and cell of a
    slot alive at step start, its glibc sin/cos in double (23) counted twice
    (the H100's FP64 rate outside the tensor cores is half its FP32 rate);
    the bilinear `surrounding` (32) and the reward (7) of each slot alive
    after the step; 6 per species reward."""
    Wn, An = alive_before.shape
    S, H, NS = cfg.sensor_size, cfg.hidden_state_dim, cfg.num_species
    CP = cfg.num_chunks * cfg.max_food_packages
    alive0 = int(alive_before.sum())
    alive1 = int(alive_after.sum())
    keep = int((alive_after & alive_before).sum())
    cleared = Wn * An - keep
    reads = (Wn * An + alive0 * (4 + 4 + 8 + 4 + 24 + 4) + keep * 2 * S
             + Wn * (CP * 4 + CP * 8 + 4 + 16) + 4)
    writes = (Wn * An * (8 + 4 + 4 + 1 + 4 + 16 + 8 + 4 + 2 * S)
              + cleared * (2 * 4 * H + 24 + 8 + 8 + 24 + 16 + 4 + 4 + 4)
              + Wn * (CP * 4 + 4 + 2 * 4 * NS) + 8 * placed + 4)
    flops = (22 + 2 * 23) * alive0 + (32 + 7) * alive1 + 6 * NS * Wn
    return reads + writes, float(flops)


def raycast_bound(pos: torch.Tensor, heading: torch.Tensor, alive: torch.Tensor, cfg):
    """(bytes, FP32 operations) of the raycast on these inputs. Bytes: each
    input (pos, heading, alive, species) read once, each output (depth,
    semantic, finder) written once, and the ray offsets. Ops: adds,
    subtractions, products and square roots, one each. Each ordered pair of
    alive agents in a world takes its offset and q = r^2 - |oc|^2 (6 ops);
    each of its S + 1 ray tests (the sensor rays and the finder) tc = d . oc
    and disc = tc^2 + q (5 ops); only a test that passes the exact cull
    disc >= 0 and tc > near takes the sqrt and th = tc - sqrt(disc) (2
    ops), counted from these inputs one target slot at a time."""
    Wn, An = heading.shape
    S = cfg.sensor_size
    ang = torch.cat([heading[..., None] + ray_angle_offsets(cfg, heading.device),
                     heading[..., None]], dim=-1)                       # [W, A, S + 1]
    dx, dy = trig.sincos(ang)
    px, py = pos[..., 0], pos[..., 1]
    r2 = torch.tensor(cfg.agent_radius * cfg.agent_radius, dtype=torch.float32,
                      device=px.device)
    near = torch.tensor(cfg.near, dtype=torch.float32, device=px.device)
    slots = torch.arange(An, device=heading.device)
    passed = torch.zeros((), dtype=torch.int64, device=heading.device)
    for b in range(An):
        ocx, ocy = px[:, b:b + 1] - px, py[:, b:b + 1] - py             # target b - source
        q = r2 - (ocx * ocx + ocy * ocy)
        tc = dx * ocx[..., None] + dy * ocy[..., None]
        disc = tc * tc + q[..., None]
        pair = (alive & alive[:, b:b + 1] & (slots != b))[..., None]
        passed += ((disc >= 0) & (tc > near) & pair).sum()
    n_alive = alive.sum(dim=1).to(torch.float64)
    pairs = float((n_alive * (n_alive - 1)).sum())
    flops = 6 * pairs + 5 * pairs * (S + 1) + 2 * float(passed)
    nbyte = Wn * An * (8 + 4 + 1 + 4) + Wn * An * (S + S + 4) + 4 * S
    return nbyte, flops


def bound_s(nbyte: float, flops: float) -> float:
    """The least time the chip could take: the larger of the bytes at the
    memory's rate and the operations at the FP32 rate."""
    return max(nbyte / HBM_BYTES_PER_S, flops / PEAK_F32_FLOPS)

