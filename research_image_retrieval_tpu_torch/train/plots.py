"""Training-curve PNGs (port of ``research_image_retrieval_tpu/train/plots.py``).

``plot_curves`` draws each metric series of a history dict (the
driver's ``history``) on its own axis; ``plot_from_jsonl`` reads the
series from a ``metrics.jsonl`` log first.  matplotlib is imported
inside the call (Agg backend), so a machine without it fails only
there; the driver catches that, says why and stops plotting.
"""

from __future__ import annotations

import json
import os

__all__ = ["plot_curves", "plot_from_jsonl"]


def plot_curves(history: dict, out_path: str, title: str = "training"):
    """Render loss / LR / error curves to a PNG from a metric-series dict;
    returns ``out_path``.  Entries that are not non-empty lists (the
    driver's ``"preempted"`` flag) are skipped."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    series = {k: v for k, v in history.items()
              if isinstance(v, (list, tuple)) and len(v)}
    n = max(len(series), 1)
    fig, axes = plt.subplots(nrows=n, ncols=1, figsize=(8, 2.5 * n))
    if n == 1:
        axes = [axes]
    for ax, (key, values) in zip(axes, series.items()):
        ax.plot(values, "o-", label=key, linewidth=1, markersize=2)
        ax.legend(loc="upper right", fontsize="medium")
        ax.grid(True, which="major", color="gray", linestyle="-", alpha=0.1)
        ax.set_xlabel("iter")
        ax.set_ylabel(key)
        ax.minorticks_on()
    fig.suptitle(title)
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


def plot_from_jsonl(jsonl_path: str, out_path: str, keys=None):
    """Render the numeric series of a ``JsonlWriter`` log (all but
    ``step``, or only ``keys``)."""
    history: dict[str, list] = {}
    with open(jsonl_path) as f:
        for line in f:
            rec = json.loads(line)
            for k, v in rec.items():
                if k == "step" or (keys and k not in keys):
                    continue
                if isinstance(v, (int, float)):
                    history.setdefault(k, []).append(v)
    return plot_curves(history, out_path)
