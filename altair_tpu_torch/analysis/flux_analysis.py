"""Flux-map analysis — the capabilities of the reference's analysis CLI
(``flux_at_observer/flux_analysis.py``): per-file theta x phi heatmaps,
theta profiles with standard-error bars, ``a*cos(b*theta)+c`` fits with R^2,
multi-run averaging, comparison PNGs.

A copy of ``altair_tpu/analysis/flux_analysis.py`` on the port's
``io.read_fluxmap`` (numpy/scipy; matplotlib imported inside the plotting
functions only).

Behavioural parity map (reference file:line):
* metadata/CSV parsing          -> altair_tpu_torch.io.read_fluxmap (:11-57)
* cosine_func                    -> cosine_func (:60-62)
* per-file heatmap grid          -> plot_heatmaps (:111-129)
* averaging across runs          -> average_runs (:133-164)
* theta profile + fit + R^2      -> theta_profile / fit_cosine (:170-242)
* output file naming             -> analyze (:279-295)
"""

from __future__ import annotations

import dataclasses
import os
import sys
from datetime import datetime

import numpy as np

from ..io import read_fluxmap


def cosine_func(x, a, b, c):
    """``a * cos(deg2rad(b * x)) + c`` (``flux_analysis.py:60-62``)."""
    return a * np.cos(np.deg2rad(b * x)) + c


@dataclasses.dataclass
class FileData:
    filename: str
    theta: np.ndarray
    phi: np.ndarray
    fraction: np.ndarray
    metadata: dict
    stderr: np.ndarray | None = None   # only for averaged data

    def pivot(self):
        """theta x phi matrix (pandas pivot equivalent,
        ``flux_analysis.py:118``)."""
        thetas = np.unique(self.theta)
        phis = np.unique(self.phi)
        grid = np.full((len(thetas), len(phis)), np.nan)
        ti = np.searchsorted(thetas, self.theta)
        pi = np.searchsorted(phis, self.phi)
        grid[ti, pi] = self.fraction
        return thetas, phis, grid


@dataclasses.dataclass
class ProfileFit:
    theta: np.ndarray
    mean: np.ndarray
    stderr: np.ndarray
    popt: np.ndarray          # (a, b, c)
    perr: np.ndarray
    r_squared: float
    label: str


def load(path: str) -> FileData | None:
    """Parse one CSV; like the reference's ``process_file`` a missing or
    malformed file prints a message and returns None
    (``flux_analysis.py:24-26,55-57``)."""
    try:
        theta, phi, fraction, md = read_fluxmap(path)
    except FileNotFoundError:
        print(f"File not found: {path}")
        return None
    except Exception as e:
        print(f"Error reading CSV data from {path}: {e}")
        return None
    return FileData(os.path.basename(path), theta, phi, fraction, md)


def collect_files(path: str) -> list[str]:
    """Single CSV or every ``*.csv`` in a folder
    (``flux_analysis.py:73-86``)."""
    if os.path.isdir(path):
        files = sorted(
            os.path.join(path, f) for f in os.listdir(path)
            if f.endswith(".csv"))
        if not files:
            raise FileNotFoundError(f"No CSV files found in: {path}")
        return files
    return [path]


def average_runs(datasets: list[FileData]) -> FileData:
    """Pool repeat runs: mean, std and stderr per (theta, phi)
    (``flux_analysis.py:133-164``)."""
    keys = {}
    for d in datasets:
        for t, p, f in zip(d.theta, d.phi, d.fraction):
            keys.setdefault((t, p), []).append(f)
    items = sorted(keys.items())
    theta = np.array([k[0] for k, _ in items])
    phi = np.array([k[1] for k, _ in items])
    vals = [np.asarray(v) for _, v in items]
    mean = np.array([v.mean() for v in vals])
    std = np.array([v.std(ddof=1) if len(v) > 1 else 0.0 for v in vals])
    stderr = std / np.sqrt([len(v) for v in vals])
    meta = {
        "BRDF Model": "Average of all input files",
        "Created": datetime.now().strftime("%Y-%m-%d %H:%M:%S"),
        "Source Files": ", ".join(d.filename for d in datasets),
    }
    return FileData("AVERAGE", theta, phi, mean, meta, stderr=stderr)


def theta_profile(data: FileData) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Group by theta: mean fraction and standard error
    (``flux_analysis.py:178-199``)."""
    thetas = np.unique(data.theta)
    mean = np.empty_like(thetas)
    stderr = np.empty_like(thetas)
    for i, t in enumerate(thetas):
        vals = data.fraction[data.theta == t]
        mean[i] = vals.mean()
        std = vals.std(ddof=1) if len(vals) > 1 else 0.001
        stderr[i] = std / np.sqrt(len(vals))
    return thetas, mean, stderr


def fit_cosine(theta: np.ndarray, mean: np.ndarray, label: str,
               stderr: np.ndarray | None = None) -> ProfileFit:
    """curve_fit of a*cos(b*theta)+c with the reference's initial guess and
    fallback (``flux_analysis.py:201-242``)."""
    from scipy.optimize import curve_fit

    try:
        p0 = [(np.max(mean) - np.min(mean)) / 2, 1.0, np.mean(mean)]
        popt, pcov = curve_fit(cosine_func, theta, mean, p0=p0)
        perr = np.sqrt(np.diag(pcov))
    except Exception as e:  # same fallback approximation as the reference
        print(f"Fit error for {label}: {e}")
        popt = np.array([np.mean(mean) / 2, 1.0, np.mean(mean) / 2])
        perr = np.zeros(3)
    resid = mean - cosine_func(theta, *popt)
    ss_res = float(np.sum(resid**2))
    ss_tot = float(np.sum((mean - mean.mean())**2))
    r2 = 1 - ss_res / ss_tot if ss_tot > 0 else 0.0
    if stderr is None:
        stderr = np.zeros_like(mean)
    return ProfileFit(theta, mean, stderr, np.asarray(popt), perr, r2, label)


def plot_heatmaps(datasets: list[FileData], fig=None):
    """Grid of per-file theta x phi heatmaps (``flux_analysis.py:111-129``)."""
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    n = len(datasets)
    if fig is None:
        fig = plt.figure(figsize=(15, 10))
    rows = n // 2 + n % 2
    cols = 2 if n > 1 else 1
    for i, d in enumerate(datasets):
        ax = fig.add_subplot(rows, cols, i + 1)
        _, _, grid = d.pivot()
        im = ax.imshow(grid, aspect="auto", origin="lower",
                       extent=[0, 360, 0, 90], interpolation="nearest",
                       cmap="viridis")
        cbar = fig.colorbar(im, ax=ax)
        cbar.set_label("Fraction of rays detected")
        ax.set_title(f"{d.filename}\n{d.metadata.get('BRDF Model', '')}")
        ax.set_xlabel("φ (degrees)")
        ax.set_ylabel("θ (degrees)")
        ax.grid(True)
    fig.tight_layout()
    return fig


def plot_theta_comparison(fits: list[ProfileFit], fig=None):
    """Overlaid theta profiles + fits (``flux_analysis.py:167-262``)."""
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    if fig is None:
        fig = plt.figure(figsize=(12, 8))
    ax = fig.gca()
    colors = plt.cm.tab10.colors
    markers = ["o", "s", "^", "D", "v", "<", ">", "p", "*", "h"]
    for i, f in enumerate(fits):
        is_avg = f.label == "AVERAGE"
        color = "black" if is_avg else colors[i % len(colors)]
        marker = "X" if is_avg else markers[i % len(markers)]
        ax.errorbar(f.theta, f.mean, yerr=f.stderr, fmt=marker, color=color,
                    alpha=0.9 if is_avg else 0.5, capsize=5, elinewidth=1,
                    markersize=10 if is_avg else 6,
                    zorder=10 if is_avg else 1,
                    label=f"Data: {f.label}")
        smooth = np.linspace(f.theta.min(), f.theta.max(), 1000)
        ax.plot(smooth, cosine_func(smooth, *f.popt), "-", color=color,
                linewidth=3 if is_avg else 1, zorder=10 if is_avg else 1,
                label=(f"{f.label}: {f.popt[0]:.3f}*cos({f.popt[1]:.3f}θ)"
                       f" + {f.popt[2]:.3f}"))
    ax.set_xlabel("θ (degrees)")
    ax.set_ylabel("Fraction")
    ax.set_title("Flux Fraction vs Theta with Cosine Fit - "
                 "Multiple Files Comparison")
    ax.legend(loc="best", fontsize="small")
    ax.grid(True)
    fig.tight_layout()
    return fig


def analyze(path: str, average_mode: bool = False, save: bool = True,
            show: bool = False, out_dir: str = "."):
    """Full pipeline of the reference CLI: load file(s), heatmaps, optional
    averaging, theta fits, save ``{base}_theta_comparison.png`` and
    ``{base}_heatmap_comparison.png`` (``flux_analysis.py:279-295``)."""
    files = collect_files(path)
    datasets = [d for d in (load(f) for f in files) if d is not None]
    if not datasets:
        print("No readable CSV data found.")
        return []

    if average_mode and os.path.isdir(path) and len(datasets) > 1:
        print("Averaging data across all files...")
        datasets.append(average_runs(datasets))

    fits = []
    for d in datasets:
        if d.stderr is not None:  # averaged dataset: pool per theta
            thetas = np.unique(d.theta)
            mean = np.array([d.fraction[d.theta == t].mean() for t in thetas])
            stderr = np.array([d.stderr[d.theta == t].mean() for t in thetas])
        else:
            thetas, mean, stderr = theta_profile(d)
        fit = fit_cosine(thetas, mean, d.filename, stderr)
        fits.append(fit)
        print(f"File: {d.filename}")
        print(f"  Fit parameters: a={fit.popt[0]:.5f}, b={fit.popt[1]:.5f}, "
              f"c={fit.popt[2]:.5f}")
        print(f"  R-squared value: {fit.r_squared:.5f}")

    theta_fig = plot_theta_comparison(fits)
    heat_fig = plot_heatmaps([d for d in datasets if d.stderr is None]
                             or datasets)

    base = (os.path.basename(os.path.normpath(path)) if os.path.isdir(path)
            else os.path.splitext(os.path.basename(path))[0])
    if average_mode:
        base += "_averaged"
    if save:
        theta_fig.savefig(os.path.join(out_dir, f"{base}_theta_comparison.png"),
                          dpi=300, bbox_inches="tight")
        heat_fig.savefig(os.path.join(out_dir, f"{base}_heatmap_comparison.png"),
                         dpi=300, bbox_inches="tight")
        print(f"Plots saved as {base}_theta_comparison.png and "
              f"{base}_heatmap_comparison.png")
    if show:  # pragma: no cover
        import matplotlib.pyplot as plt
        plt.show()
    return fits


def analyze_single(csv_path: str, save: bool = True, out_dir: str = "."):
    """Single-run outputs with the reference's retained PNG naming:
    ``{stem}_heatmap.png`` and ``{stem}_theta_analysis.png`` (e.g.
    ``fluxmap_50000rays_180x90_src-60_0_-75_heatmap.png`` in the corpus)."""
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    d = load(csv_path)
    if d is None:
        return None
    stem = os.path.splitext(os.path.basename(csv_path))[0]

    fig = plt.figure(figsize=(10, 8))
    ax = fig.gca()
    _, _, grid = d.pivot()
    im = ax.imshow(grid, aspect="auto", origin="lower",
                   extent=[0, 360, 0, 90], interpolation="nearest",
                   cmap="viridis")
    fig.colorbar(im, ax=ax, label="Fraction of rays detected")
    ax.set_title(stem)
    ax.set_xlabel("φ (degrees)")
    ax.set_ylabel("θ (degrees)")
    heat_path = os.path.join(out_dir, f"{stem}_heatmap.png")

    thetas, mean, stderr = theta_profile(d)
    fit = fit_cosine(thetas, mean, stem, stderr)
    tfig = plot_theta_comparison([fit])
    theta_path = os.path.join(out_dir, f"{stem}_theta_analysis.png")
    if save:
        fig.savefig(heat_path, dpi=300, bbox_inches="tight")
        tfig.savefig(theta_path, dpi=300, bbox_inches="tight")
    return fit


def main(argv=None):  # pragma: no cover
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 1:
        print("Usage: python -m altair_tpu_torch.analysis.flux_analysis "
              "<csv_file_or_folder> [average]")
        return 1
    average = len(argv) > 1 and argv[1].lower() == "average"
    analyze(argv[0], average_mode=average)
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
