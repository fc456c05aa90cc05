"""Matplotlib theming + dataset-distribution plots.

A copy of ``object_detection_cib_tpu/utils/plots.py``; matplotlib is
imported inside the functions.

Capability parity: kod/plots/_mat.py:5-14 (theme) and
kod/plots/dataset_distribution.py:9-42 (instance/image histograms), plus the
sampler-statistics plot reused by the SamplerDebug callback
(kod/test_utils/inspect_sampler.py:47-92).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Optional


def apply_theme():
    """Env-selectable matplotlib style (ref plots/_mat.py, MAT_THEME env)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    theme = os.environ.get("MAT_THEME", "default")
    if theme != "default":
        try:
            plt.style.use(theme)
        except OSError:
            pass
    return plt


def plot_instance_histogram(
    counts: Dict[str, int], out_path: Path, title: Optional[str] = None
):
    plt = apply_theme()
    fig, ax = plt.subplots(figsize=(max(6, len(counts) * 0.8), 4))
    names = list(counts)
    ax.bar(names, [counts[n] for n in names])
    ax.set_ylabel("instances")
    ax.set_title(title or "instances per class")
    ax.tick_params(axis="x", rotation=45)
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def plot_instances_per_class_per_epoch(
    per_epoch: Dict[int, Dict[str, int]], out_path: Path, title: str = ""
):
    """Sampled-class histogram across epochs (inspect_sampler parity)."""
    plt = apply_theme()
    fig, ax = plt.subplots(figsize=(8, 4.5))
    classes = list(next(iter(per_epoch.values())).keys())
    import numpy as np

    xs = np.arange(len(classes))
    width = 0.8 / max(len(per_epoch), 1)
    for i, (epoch, counts) in enumerate(sorted(per_epoch.items())):
        ax.bar(
            xs + i * width, [counts[c] for c in classes], width,
            label=f"epoch {epoch}",
        )
    ax.set_xticks(xs + 0.4)
    ax.set_xticklabels(classes, rotation=45)
    ax.set_ylabel("sampled instances")
    ax.set_title(title or "instances per class per epoch")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)
    return out_path
