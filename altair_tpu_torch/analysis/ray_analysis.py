"""Exit-direction log analysis — ``3drayanalysis.py`` equivalent.

A copy of ``altair_tpu/analysis/ray_analysis.py`` (numpy/scipy only, no JAX), so that
``altair_tpu_torch`` never imports the JAX package.

Loads a ``3dRayLog.txt``-dialect file (``# dx dy dz``), filters |dx| <= 1,
histograms the z-angle ``acos(dz)*180/pi - 180`` (angle from the -z port
axis, negative by convention) — ``3drayanalysis.py:5-24``.
"""

from __future__ import annotations

import numpy as np


def load_ray_log(path: str) -> np.ndarray:
    return np.loadtxt(path)


def z_angle_distribution(data: np.ndarray, x_cut: float = 1.0):
    """(filtered z-angles in degrees, mask) — ``3drayanalysis.py:12-16``."""
    mask = np.abs(data[:, 0]) <= x_cut
    dz = data[mask, 2]
    return np.arccos(np.clip(dz, -1, 1)) * 180 / np.pi - 180, mask


def plot_z_distribution(angles, bins: int = 100, save_path: str | None = None):
    """Histogram plot (``3drayanalysis.py:19-27``)."""
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(10, 6))
    plt.hist(angles, bins=bins, edgecolor="black")
    plt.xlabel("Z Angle (degrees)")
    plt.ylabel("Frequency")
    plt.title("Distribution of Ray Z Angles (at x = 0 ± 1)")
    plt.grid(True, alpha=0.3)
    if save_path:
        fig.savefig(save_path)
    return fig
