"""Exit angular-distribution debug canvas.

A copy of ``altair_tpu/viz/distribution.py`` on the port's
``DistributionResult``; matplotlib and scipy are imported inside the
plotting function only.

The 2x2 ROOT canvas of ``distributionSphereDetectorSweep.C:106-130``:
signed-angle histogram with its Lambertian fit, the dz histogram, and the
two 2D direction-component maps (hDirectionsXZ / hDirectionsYZ) — rendered
offline with matplotlib.
"""

from __future__ import annotations

import numpy as np

from ..sweep.distribution import DistributionResult


def plot_distribution_canvas(result: DistributionResult,
                             save_path: str | None = None):
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    from scipy.optimize import curve_fit

    fig, axes = plt.subplots(2, 2, figsize=(10, 10))

    # (1) signed port-axis angle histogram + Lambertian fit
    ax = axes[0, 0]
    centers = -90 + (np.arange(len(result.angle_hist)) + 0.5) * (
        180 / len(result.angle_hist))
    ax.step(centers, result.angle_hist, where="mid", lw=1)

    def f(x, a):
        t = np.deg2rad(x)
        return a * np.cos(t) * np.abs(np.sin(t))

    try:
        popt, _ = curve_fit(f, centers, result.angle_hist,
                            p0=[result.angle_hist.max() * 2.0])
        smooth = np.linspace(-90, 90, 720)
        ax.plot(smooth, f(smooth, *popt), "r-", lw=1,
                label=f"{popt[0]:.1f}·cosθ·|sinθ|")
        ax.legend(fontsize="small")
    except Exception:
        pass
    ax.set_title("Angular Distribution of Exiting Rays")
    ax.set_xlabel("Angle from port axis (degrees)")
    ax.set_ylabel("Count")

    # (2) dz histogram (hDirectionZ)
    ax = axes[0, 1]
    zc = -1 + (np.arange(len(result.dz_hist)) + 0.5) * (
        2 / len(result.dz_hist))
    ax.step(zc, result.dz_hist, where="mid", lw=1)
    ax.set_title("Z Direction Component")
    ax.set_xlabel("dz")
    ax.set_ylabel("Count")

    # (3)+(4) 2D component maps
    xz, yz, _ = result.direction_histograms_2d()
    for ax, h, title in ((axes[1, 0], xz, "Ray Direction Components X-Z"),
                         (axes[1, 1], yz, "Ray Direction Components Y-Z")):
        im = ax.imshow(h.T, origin="lower", extent=[-1, 1, -1, 1],
                       aspect="auto", cmap="viridis")
        fig.colorbar(im, ax=ax)
        ax.set_title(title)
        ax.set_xlabel("X" if "X" in title else "Y")
        ax.set_ylabel("Z")

    fig.suptitle(f"Flux of rays through the exit port: {result.n_exited}")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
    return fig
