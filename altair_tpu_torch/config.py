"""Configuration dataclasses — the PyTorch counterpart of
``altair_tpu/config.py``.

Same fields, defaults and presets as the JAX package, as plain frozen
dataclasses: PyTorch runs eagerly, so there is no pytree registration and
no split into traced data and static metadata.  Numeric fields are Python
numbers; every kernel and tensor function reads them when it runs.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Any

import torch

from .units import cm


class SurfaceModel(enum.IntEnum):
    """Wall scatter law of the integrating sphere (the values match
    ``altair_tpu.config.SurfaceModel``).

    LAMBERTIAN — cosine-weighted re-emission about the inward normal
                 (``roughness`` ignored, as in ROBAST).
    SPECULAR   — mirror reflection about a Gaussian-roughened normal.
    MIXED_BRDF — ``nonLambertianFlux.C:147-208``: specular with probability
                 `specular_prob` (Gaussian tilt sigma = roughness*pi/6),
                 else cosine-weighted diffuse.
    COS_N_LOBE — ``nonLambertianFlux copy.C:187-220``: theta uniform on
                 [0, max_angle], accepted with probability cos(theta)^n.
    """

    LAMBERTIAN = 0
    SPECULAR = 1
    MIXED_BRDF = 2
    COS_N_LOBE = 3


@dataclasses.dataclass(frozen=True)
class SphereScene:
    """The integrating-sphere scene (``fluxAtObserverOptimize.C:192-230``):
    a shell of inner radius `inner_radius` spanning polar angles
    [0, `theta_max_deg`] (the missing cap around -z is the exit port), wall
    reflectance `reflectance`, inside a world box of half-width
    `world_half`."""

    inner_radius: Any = 100.1 * cm     # fluxAtObserverOptimize.C:38
    outer_radius: Any = 101.0 * cm     # fluxAtObserverOptimize.C:39
    theta_max_deg: Any = 170.0         # fluxAtObserverOptimize.C:35
    reflectance: Any = 0.99            # fluxAtObserverOptimize.C:40
    roughness: Any = 0.01              # fluxAtObserverOptimize.C:41
    world_half: Any = 300.0 * cm       # fluxAtObserverOptimize.C:199
    exit_port_z: Any = -100.0 * cm     # fluxAtObserver.C:236 (exitPortZ)
    # MIXED_BRDF parameters (nonLambertianFlux.C:211  gBRDF(0.3, 0.4, 0.6)):
    specular_prob: Any = 0.4           # renormalised spec/(spec+diff) at use
    diffuse_prob: Any = 0.6
    brdf_roughness: Any = 0.3
    # COS_N_LOBE parameters (nonLambertianFlux copy.C:31-44):
    cos_n: Any = 2.0
    max_angle_deg: Any = 60.0
    surface_model: SurfaceModel = SurfaceModel.LAMBERTIAN
    max_bounces: int = 50000           # MAX_REFLECTIONS, fluxAtObserverOptimize.C:36
    exact_rim: bool = True             # model the shell's conical rim face

    def with_(self, **kw) -> "SphereScene":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class Source:
    """Point source with a fixed emission direction (``fluxAtObserver.C:
    193-201``).  The direction need not be normalised."""

    x: Any = -60.0 * cm
    y: Any = 0.0 * cm
    z: Any = -80.0 * cm
    dir_x: Any = 5.0
    dir_y: Any = 2.0
    dir_z: Any = 0.0
    wavelength_nm: Any = 660.0

    def with_(self, **kw) -> "Source":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class DetectorGrid:
    """The observer detector sweep grid (``fluxAtObserverOptimize.C:
    459-461,542-555``): theta x phi bins, detector centres at bin midpoints
    `radius` from the port centre; disk acceptance of radius width/2."""

    n_theta: int = 180
    n_phi: int = 90
    theta_lo: float = 0.0
    theta_hi: float = 90.0
    phi_lo: float = 0.0
    phi_hi: float = 360.0
    radius: float = 100.0 * cm        # fluxAtObserverOptimize.C:555
    width: float = 40.0 * cm          # fluxAtObserverOptimize.C:495
    height: float = 40.0 * cm

    @property
    def n_positions(self) -> int:
        return self.n_theta * self.n_phi

    def theta_centers(self) -> torch.Tensor:
        """Bin midpoints in degrees, a float32 CPU tensor."""
        step = (self.theta_hi - self.theta_lo) / self.n_theta
        return self.theta_lo + (torch.arange(self.n_theta, dtype=torch.float32) + 0.5) * step

    def phi_centers(self) -> torch.Tensor:
        step = (self.phi_hi - self.phi_lo) / self.n_phi
        return self.phi_lo + (torch.arange(self.n_phi, dtype=torch.float32) + 0.5) * step


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Execution configuration of the trace engines.

    `block_iters`: bounce iterations between the alive-count checks of the
    eager bounce loop (each check is one device-to-host sync).

    `engine`: ``"auto"`` (closed-form direct sampler for Lambertian scenes,
    the bounce kernel otherwise), ``"simulate"`` (always the bounce kernel)
    or ``"direct"`` (require the direct sampler).

    `rng_impl` is kept for field parity with the JAX package; the port
    draws from ``torch.Generator`` streams (Philox on CUDA) and from the
    bounce kernel's own generator, and does not read it.
    `qmc`: Sobol draws in the direct sampler and in the deferred-rim
    hybrid's closed-form finish (``core/qmc.py``): 1 digital shift, 2 Owen
    scramble; the simulating engines ignore it, as in the JAX package.
    `keep_history`: K > 0 keeps each ray's first K path points
    (``TraceResult.history``, N*K*12 bytes in float32); only the eager
    ``trace_rays`` has the buffer, and ``trace_rays_auto`` routes there.
    """

    dtype: Any = torch.float32
    block_iters: int = 32
    rng_impl: str = "threefry2x32"
    keep_history: int = 0
    engine: str = "auto"             # "auto" | "simulate" | "direct"
    qmc: int = 0


# Per-macro presets (the same as altair_tpu.config).
# fluxAtObserver.C:147-160 — reflectance 1.0, roughness 0.5, limit 10000,
# world half 200 cm.
SCENE_V1 = SphereScene(reflectance=1.0, roughness=0.5, world_half=200.0 * cm,
                       max_bounces=10000)
# fluxAtObserverOptimize.C / fluxAtObserverFast.C production scene.
SCENE_OPTIMIZE = SphereScene()
SCENE_DEMO = SCENE_V1
# integratingSphereDetectorSweep.C:119 — outer radius 105 cm variant.
SCENE_INSPHERE = SphereScene(reflectance=1.0, roughness=0.5,
                             outer_radius=105.0 * cm,
                             world_half=200.0 * cm, max_bounces=10000)

SOURCE_V1 = Source()                                   # (-60,0,-80), (5,2,0)
SOURCE_DEMO = Source(dir_y=0.0, wavelength_nm=400.0)   # (-60,0,-80), (5,0,0)
SOURCE_OVERNIGHT = Source(z=-75.0 * cm, dir_y=0.0)     # sweepSeries variants


def validate(scene: SphereScene, source: Source) -> None:
    """Fail-fast sanity checks on scalar scene and source parameters."""
    import numbers

    def _concrete(v):
        return isinstance(v, numbers.Number)

    if all(_concrete(v) for v in (source.x, source.y, source.z,
                                  scene.inner_radius)):
        r2 = float(source.x) ** 2 + float(source.y) ** 2 + float(source.z) ** 2
        if r2 >= float(scene.inner_radius) ** 2:
            raise ValueError(
                f"source at radius {math.sqrt(r2):.2f} lies outside the "
                f"sphere (inner radius {float(scene.inner_radius)}); the "
                "trace kernel assumes an interior source")
    if all(_concrete(v) for v in (source.dir_x, source.dir_y, source.dir_z)):
        d2 = (float(source.dir_x) ** 2 + float(source.dir_y) ** 2
              + float(source.dir_z) ** 2)
        if d2 == 0.0:
            raise ValueError("source direction must be non-zero")
    if _concrete(scene.theta_max_deg) and not (
            90.0 < float(scene.theta_max_deg) < 180.0):
        raise ValueError(
            "theta_max_deg must be in (90, 180) — the port cap must be a "
            "proper cap around -z")
    if _concrete(scene.reflectance) and not (
            0.0 <= float(scene.reflectance) <= 1.0):
        raise ValueError("reflectance must be a probability")


def port_escape_probability(port_angle_deg) -> float:
    """Cap-area fraction p = (1 - cos(180 - port_angle)) / 2 — the
    per-bounce escape probability of a Lambertian sphere."""
    return (1 - math.cos(math.radians(180 - float(port_angle_deg)))) / 2


def expected_exit_fraction(port_angle_deg, reflectance) -> float:
    """Closed-form exit fraction p/(p + 1 - rho) of the roulette random walk
    (no-rim model: an upper bound once the shell rim is modelled)."""
    p = port_escape_probability(port_angle_deg)
    denom = p + (1 - float(reflectance))
    return 1.0 if denom <= 0 else p / denom
