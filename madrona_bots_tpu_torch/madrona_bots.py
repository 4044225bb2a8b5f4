"""The port's `madrona_bots` module: the reference's import style
(src/entry/entry.cpp:12; learn/training_loop.py:8) against the port.

    from madrona_bots_tpu_torch.madrona_bots import SimManager, ScriptBotsViewer

Counterpart of the repo root's `madrona_bots.py`, which does the same for
the JAX package. It lives inside the package, so `api` and `viz` import
each other through no third module.
"""

from madrona_bots_tpu_torch.api.manager import SimManager, Tensor
from madrona_bots_tpu_torch.viz.viewer import ScriptBotsViewer

__all__ = ["SimManager", "ScriptBotsViewer", "Tensor"]
