"""ASCII / 2D fallback visualizers.

A copy of ``altair_tpu/viz/ascii.py`` (numpy/scipy only, no JAX), so that
``altair_tpu_torch`` never imports the JAX package.

The archived reference macro ships terminal-friendly fallbacks for
environments without OpenGL (``nonLambertianFlux copy.C:540-665``: a 2D
projection view and an ASCII scene dump).  Equivalents here: an ASCII
intensity map of any (theta, phi) flux map and a 2D x-z projection of traced
ray paths.
"""

from __future__ import annotations

import numpy as np

_RAMP = " .:-=+*#%@"


def ascii_fluxmap(fluxmap: np.ndarray, width: int = 72,
                  height: int = 24) -> str:
    """Render a [n_theta, n_phi] map as ASCII intensity art (theta down,
    phi across)."""
    fm = np.asarray(fluxmap, dtype=np.float64)
    ti = np.linspace(0, fm.shape[0] - 1, height).astype(int)
    pi = np.linspace(0, fm.shape[1] - 1, width).astype(int)
    sub = fm[np.ix_(ti, pi)]
    peak = sub.max()
    if peak <= 0:
        return "\n".join(" " * width for _ in range(height))
    idx = np.clip((sub / peak * (len(_RAMP) - 1)).astype(int), 0,
                  len(_RAMP) - 1)
    rows = ["".join(_RAMP[i] for i in row) for row in idx]
    header = f"phi 0{' ' * (width - 12)}360  (peak {peak:.3e})"
    return "\n".join([header] + rows)


def ascii_ray_projection(points: np.ndarray, lengths: np.ndarray,
                         classes: np.ndarray | None = None,
                         extent: float = 310.0, width: int = 72,
                         height: int = 36) -> str:
    """2D x-z projection of ray paths ([K, N, 3] history buffer), marking
    path points; '*' = never-exits, 'o' = exits, '+' = detector hits."""
    grid = np.full((height, width), " ", dtype="<U1")
    marks = {"hit": "+", "exit": "o", "noexit": "*", "suspended": "?"}
    for ray in range(points.shape[1]):
        k = int(lengths[ray])
        mark = marks.get(str(classes[ray]), "o") if classes is not None \
            else "o"
        for p in points[:k, ray]:
            x, z = p[0], p[2]
            cx = int((x + extent) / (2 * extent) * (width - 1))
            cz = int((extent - z) / (2 * extent) * (height - 1))
            if 0 <= cx < width and 0 <= cz < height:
                grid[cz, cx] = mark
    return "\n".join("".join(row) for row in grid)
