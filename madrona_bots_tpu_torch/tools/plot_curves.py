"""Learning-curve plots from a metrics JSONL (`learn/metrics.py` output).

Counterpart of `madrona_bots_tpu/tools/plot_curves.py`. The reference keeps
its learning evidence in wandb dashboards (training_loop.py:105-120); this
renders the same per-species series (losses, population, reward, entropy)
to a PNG for offline inspection and for comparing runs.

Run: python -m madrona_bots_tpu_torch.tools.plot_curves run.metrics.jsonl out.png
"""

from __future__ import annotations

import json
import sys
from collections import defaultdict
from typing import Dict

import numpy as np

from madrona_bots_tpu_torch.viz.render import SPECIES_COLORS


def load_series(path: str) -> Dict[str, np.ndarray]:
    """Each top-level numeric key of the JSONL's records, as an array in
    record order."""
    series = defaultdict(list)
    with open(path) as f:
        for line in f:
            for k, v in json.loads(line).items():
                if isinstance(v, (int, float)):
                    series[k].append(v)
    return {k: np.asarray(v) for k, v in series.items()}


PANELS = [
    ("total_loss", "total loss"),
    ("actor_loss", "actor loss"),
    ("critic_loss", "critic loss"),
    ("count", "population"),
    ("reward", "reward sum"),
    ("avg_action_entropy", "action entropy"),
]


def plot(path: str, out: str):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    series = load_series(path)
    panels = [(suf, title) for suf, title in PANELS if f"species_1_{suf}" in series]
    fig, axes = plt.subplots(2, 3, figsize=(14, 7))
    for ax, (suf, title) in zip(axes.flat, panels):
        for s in range(1, 5):
            key = f"species_{s}_{suf}"
            if key in series:
                ax.plot(series[key], color=SPECIES_COLORS[s], lw=0.8,
                        label=f"species {s}")
        ax.set_title(title, fontsize=9)
        ax.tick_params(labelsize=7)
    axes.flat[0].legend(fontsize=7)
    for ax in axes.flat[len(panels):]:
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(out, dpi=110)
    print(f"wrote {out}")


if __name__ == "__main__":
    plot(sys.argv[1], sys.argv[2] if len(sys.argv) > 2 else "curves.png")
