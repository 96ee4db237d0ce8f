"""Ray-path visualization — the counterpart of ``altair_tpu/viz/rays.py``:
the OpenGL demo/debug layer of the reference
(``makeIntegratingSphere1Ray.C``, ``visualizeDetector`` at
``fluxAtObserver.C:408-468`` / ``fluxAtObserverFast.C:1400-1634``,
``showRedRaysOnly`` ``:1637-1639``) as offline matplotlib 3D.

Uses the trace kernel's bounded history buffer (``TraceConfig.keep_history``,
the ``ARay::MakePolyLine3D`` payload) and the reference's classification
color code (``fluxAtObserver.C:204-217``, legend at
``fluxAtObserverFast.C:1561-1611``):

  green  — exits the port AND hits the detector
  yellow — exits the port, misses the detector
  red    — never exits (absorbed / reflected back)
  gray   — suspended at the bounce limit
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import SphereScene, Source, TraceConfig
from ..core.geometry import detector_position, line_hits_disk
from ..core.trace import SUSPENDED, trace_rays

COLOR_HIT = "green"
COLOR_EXIT_MISS = "yellow"
COLOR_NO_EXIT = "red"
COLOR_SUSPENDED = "gray"


@dataclasses.dataclass
class RayPaths:
    points: np.ndarray        # [K, N, 3] recorded path points
    lengths: np.ndarray       # [N] number of valid points per ray
    classes: np.ndarray       # [N] of {"hit", "exit", "noexit", "suspended"}
    census: dict              # class -> count (the printed census,
                              # fluxAtObserverFast.C:1601-1611)
    detector: tuple | None = None   # (center xyz, normal xyz, width cm) of
                                    # the scored detector, for drawing
    source: tuple | None = None     # source position xyz


def trace_paths(
    scene: SphereScene,
    source: Source,
    *,
    device,
    n_rays: int = 100,
    seed: int = 0,
    keep_history: int = 256,
    detector_theta: float | None = 45.0,
    detector_phi: float = 0.0,
    detector_width: float = 20.0,
    detector_radius: float = 100.0,
) -> RayPaths:
    """Trace a small batch on ``device`` with full path history (the eager
    ``trace_rays``; ``n_rays * keep_history * 12`` bytes of history) and
    classify each ray.

    Defaults mirror ``visualizeDetector(45, 0)`` with its 20x20 cm detector
    (``fluxAtObserver.C:408-468``: n=100 rays).
    """
    cfg = TraceConfig(keep_history=keep_history)
    res = trace_rays(torch.Generator().manual_seed(seed), scene, source,
                     n_rays, cfg, device=device)
    exit_mask = res.exited_port_mask(scene.exit_port_z).cpu().numpy()
    status = res.status.cpu().numpy()

    detector = None
    if detector_theta is not None:
        c, nrm = detector_position(
            torch.tensor(detector_theta, dtype=torch.float32, device=device),
            torch.tensor(detector_phi, dtype=torch.float32, device=device),
            detector_radius, scene.exit_port_z)
        hit = line_hits_disk(res.last_point, res.direction, c, nrm,
                             detector_width / 2.0).cpu().numpy()
        detector = (np.array([float(c.x), float(c.y), float(c.z)]),
                    np.array([float(nrm.x), float(nrm.y), float(nrm.z)]),
                    float(detector_width))
    else:
        hit = np.zeros(n_rays, bool)

    classes = np.where(
        exit_mask & hit, "hit",
        np.where(exit_mask, "exit",
                 np.where(status == SUSPENDED, "suspended", "noexit")))
    census = {k: int((classes == k).sum())
              for k in ("hit", "exit", "noexit", "suspended")}
    return RayPaths(
        points=res.history.cpu().numpy(),
        lengths=res.history_len.cpu().numpy(),
        classes=classes,
        census=census,
        detector=detector,
        source=(float(source.x), float(source.y), float(source.z)),
    )


_CLASS_COLORS = {"hit": COLOR_HIT, "exit": COLOR_EXIT_MISS,
                 "noexit": COLOR_NO_EXIT, "suspended": COLOR_SUSPENDED}


def _detector_curves(detector):
    """(disk circle [73,3], square outline [5,3]) of the detector —
    the acceptance disk (radius width/2, ``fluxAtObserver.C:106``) inside
    the drawn square plate (``Detector::CreateGeometry``, ``:109-144``)."""
    c, n, width = detector
    c = np.asarray(c, float)
    n = np.asarray(n, float)
    a = np.array([1.0, 0.0, 0.0]) if abs(n[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
    u = np.cross(n, a)
    u /= np.linalg.norm(u)
    v = np.cross(n, u)
    half = float(width) / 2.0
    t = np.linspace(0, 2 * np.pi, 73)
    disk = c[None, :] + half * (np.outer(np.cos(t), u) + np.outer(np.sin(t), v))
    sq = np.array([c + half * (su * u + sv * v)
                   for su, sv in ((1, 1), (1, -1), (-1, -1), (-1, 1), (1, 1))])
    return disk, sq


def _port_circle(scene, n_pts: int = 73):
    """The port rim circle (theta = theta_max on the inner shell)."""
    r = float(scene.inner_radius)
    tmax = np.deg2rad(float(scene.theta_max_deg))
    rho, z = r * np.sin(tmax), r * np.cos(tmax)
    t = np.linspace(0, 2 * np.pi, n_pts)
    return np.stack([rho * np.cos(t), rho * np.sin(t),
                     np.full_like(t, z)], axis=1)


def plot_rays(
    paths: RayPaths,
    scene: SphereScene,
    *,
    only_show_red: bool = False,
    max_rays: int = 200,
    elev: float = 15.0,
    azim: float = -60.0,
    save_path: str | None = None,
):
    """3D ray-path plot with sphere wireframe and the classification legend;
    ``only_show_red`` reproduces ``showRedRaysOnly``
    (``fluxAtObserverFast.C:1637-1639``)."""
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(10, 10))
    ax = fig.add_subplot(111, projection="3d")

    # sphere wireframe with the port cap cut out (theta <= theta_max)
    r = float(scene.inner_radius)
    tmax = np.deg2rad(float(scene.theta_max_deg))
    th = np.linspace(0, tmax, 24)
    ph = np.linspace(0, 2 * np.pi, 36)
    T, P = np.meshgrid(th, ph)
    ax.plot_wireframe(r * np.sin(T) * np.cos(P), r * np.sin(T) * np.sin(P),
                      r * np.cos(T), color="lightsteelblue", alpha=0.25,
                      linewidth=0.5)

    # port rim circle (the hole the rays escape through)
    port = _port_circle(scene)
    ax.plot(port[:, 0], port[:, 1], port[:, 2], color="navy", linewidth=1.2,
            label="_port")

    # the detector the green rays hit (Detector::AddToGeometry content,
    # fluxAtObserver.C:109-144): square plate + acceptance disk
    if paths.detector is not None:
        disk, sq = _detector_curves(paths.detector)
        ax.plot(sq[:, 0], sq[:, 1], sq[:, 2], color="black", linewidth=1.0)
        ax.plot(disk[:, 0], disk[:, 1], disk[:, 2], color="darkgreen",
                linewidth=1.4)

    # source marker
    if paths.source is not None:
        sx, sy, sz = paths.source
        ax.scatter([sx], [sy], [sz], color="crimson", s=40, marker="*",
                   depthshade=False)

    shown = 0
    for i in range(len(paths.classes)):
        cls = str(paths.classes[i])
        if only_show_red and cls != "noexit":
            continue
        if shown >= max_rays:
            break
        k = int(paths.lengths[i])
        pts = paths.points[:k, i]
        ax.plot(pts[:, 0], pts[:, 1], pts[:, 2],
                color=_CLASS_COLORS[cls], linewidth=0.7, alpha=0.8)
        shown += 1

    handles = [plt.Line2D([0], [0], color=c, label=f"{k} ({paths.census[k]})")
               for k, c in _CLASS_COLORS.items()]
    ax.legend(handles=handles, loc="upper right")
    ax.set_xlabel("x (cm)")
    ax.set_ylabel("y (cm)")
    ax.set_zlabel("z (cm)")
    ax.view_init(elev=elev, azim=azim)
    if save_path:
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
    return fig


def print_census(paths: RayPaths, n_total: int):
    """The classification census print (``fluxAtObserverFast.C:1601-1611``)."""
    print("Ray classification:")
    print(f"  Hits detector (green):      {paths.census['hit']}/{n_total}")
    print(f"  Exits, misses (yellow):     {paths.census['exit']}/{n_total}")
    print(f"  Never exits (red):          {paths.census['noexit']}/{n_total}")
    print(f"  Suspended (gray):           {paths.census['suspended']}/{n_total}")
