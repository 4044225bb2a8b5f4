"""Metrics logging behind one interface: wandb when available, JSONL always.

A copy of `madrona_bots_tpu/learn/metrics.py`. Metric names follow the
reference: species_{i}_{actor,critic,total}_loss, species_{i}_count,
species_{i}_reward, species_{i}_avg_health, species_{i}_learning_rate,
species_{i}_avg_action_prob, species_{i}_popular_action,
species_{i}_avg_action_entropy, epoch_fps, epoch.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(self, use_wandb: bool = False, project: str = "madrona-bots",
                 run_name: Optional[str] = None, config: Optional[dict] = None,
                 jsonl_path: Optional[str] = None):
        self._wandb = None
        if use_wandb:
            try:
                import wandb
                wandb.init(project=project, name=run_name, config=config or {})
                self._wandb = wandb
            except Exception as e:  # an image without a wandb backend
                print(f"[metrics] wandb unavailable ({e}); logging to JSONL only")
        self._jsonl = None
        if jsonl_path:
            os.makedirs(os.path.dirname(jsonl_path) or ".", exist_ok=True)
            self._jsonl = open(jsonl_path, "a")
        self._t0 = time.time()

    def log(self, metrics: Dict[str, Any]):
        clean = {k: (float(v) if hasattr(v, "__float__") else v)
                 for k, v in metrics.items()}
        if self._wandb is not None:
            self._wandb.log(clean)
        if self._jsonl is not None:
            clean["_t"] = time.time() - self._t0
            self._jsonl.write(json.dumps(clean) + "\n")
            self._jsonl.flush()

    def finish(self):
        if self._wandb is not None:
            self._wandb.finish()
        if self._jsonl is not None:
            self._jsonl.close()
