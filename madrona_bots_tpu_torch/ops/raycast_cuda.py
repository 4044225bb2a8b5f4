"""The raycast sensor kernel's wrapper.

`raycast` launches `csrc/raycast.cu` on CUDA tensors and runs the plain
version (`env/raycast.py::raycast`) on CPU tensors. It replaces the JAX
package's `raycast_pallas` dispatcher: the ladder kernel it picks at the
bench shape, and the packed and blocked kernels it picks for other shapes,
are one design here, for any W and any A <= 1024.
"""

from __future__ import annotations

import ctypes

import torch

from madrona_bots_tpu_torch.config import EnvConfig
from madrona_bots_tpu_torch.env import raycast as plain
from madrona_bots_tpu_torch.ops import _build
from madrona_bots_tpu_torch.utils import profiling

launches = 0
"""Launches of the raycast kernel since the count was last set to 0."""

_ARGS = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_float] * 5
         + [ctypes.c_void_p])


def check_inputs(kernel: str, specs) -> None:
    """Raise unless every (name, tensor, shape, dtype) matches and all the
    tensors are contiguous and on one device."""
    dev = specs[0][1].device
    for name, t, shape, dtype in specs:
        if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
                or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{kernel} kernel: {name} must be a contiguous "
                             f"{dtype} tensor of shape {tuple(shape)} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def raycast(pos, heading, alive, species, cfg: EnvConfig):
    """(depth u8 [W,A,S], semantic i8 [W,A,S], finder i32 [W,A]); see
    `env/raycast.py::raycast` for the function. The call is the span
    `mbots.env.raycast`."""
    global launches
    with profiling.span("mbots.env.raycast"):
        W, A = heading.shape
        S = cfg.sensor_size
        check_inputs("raycast", (("pos", pos, (W, A, 2), torch.float32),
                                 ("heading", heading, (W, A), torch.float32),
                                 ("alive", alive, (W, A), torch.bool),
                                 ("species", species, (W, A), torch.int32)))
        if pos.device.type == "cpu":
            return plain.raycast(pos, heading, alive, species, cfg)
        if pos.device.type != "cuda":
            raise ValueError(f"raycast kernel: tensors on {pos.device}")
        if A > 1024:
            raise ValueError(f"raycast kernel: max_agents must be <= 1024, got {A}")
        if S % 4:
            raise ValueError(f"raycast kernel: sensor_size must be a multiple of 4, got {S}")
        offsets = plain.ray_angle_offsets(cfg, pos.device)
        depth = torch.empty((W, A, S), dtype=torch.uint8, device=pos.device)
        semantic = torch.empty((W, A, S), dtype=torch.int8, device=pos.device)
        finder = torch.empty((W, A), dtype=torch.int32, device=pos.device)
        fn = _build.function("raycast", "mbots_raycast", _ARGS)
        err = fn(pos.data_ptr(), heading.data_ptr(), alive.data_ptr(),
                 species.data_ptr(), offsets.data_ptr(), depth.data_ptr(),
                 semantic.data_ptr(), finder.data_ptr(), W, A, S,
                 cfg.world_lim_x, cfg.world_lim_y,
                 cfg.agent_radius * cfg.agent_radius, cfg.near,
                 255.0 / cfg.max_range,
                 torch.cuda.current_stream(pos.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"raycast kernel launch failed: CUDA error {err}")
        launches += 1
        return depth, semantic, finder
