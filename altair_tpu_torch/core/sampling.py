"""Scatter-law sampling — the PyTorch counterpart of
``altair_tpu/core/sampling.py``.

Each law draws from a ``torch.Generator`` on the device of its tensors, in
the place of a JAX key.  The streams differ from JAX's, so parity with the
JAX package is statistical; the laws and their constructions are the same
(see the JAX module's docstring for their reference sources).  ``scatter``
also takes a custom callable in the place of a law, as the JAX module does.
"""

from __future__ import annotations

import math

import torch

from ..config import SurfaceModel
from .geometry import Vec3, orthonormal_basis

TWO_PI = 6.283185307179586


def _uniform(gen: torch.Generator, like: torch.Tensor) -> torch.Tensor:
    return torch.rand(like.shape, generator=gen, device=like.device,
                      dtype=like.dtype)


def _normal(gen: torch.Generator, like: torch.Tensor) -> torch.Tensor:
    return torch.randn(like.shape, generator=gen, device=like.device,
                       dtype=like.dtype)


def _from_local(normal: Vec3, sin_t, cos_t, phi) -> Vec3:
    """Direction at polar angle (sin_t, cos_t) and azimuth phi about normal."""
    u, v = orthonormal_basis(normal)
    sp = torch.sin(phi)
    cp = torch.cos(phi)
    return (u.scale(sin_t * cp) + v.scale(sin_t * sp)
            + normal.scale(cos_t)).normalized()


def cosine_hemisphere(gen, normal: Vec3) -> Vec3:
    """Cosine-weighted hemisphere about ``normal``: theta = acos(sqrt(u1))
    (``BRDF::SampleDiffuse``, ``nonLambertianFlux.C:191-207``)."""
    u1 = _uniform(gen, normal.x)
    u2 = _uniform(gen, normal.x)
    cos_t = torch.sqrt(u1)
    sin_t = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
    return _from_local(normal, sin_t, cos_t, TWO_PI * u2)


def specular_reflect(incident: Vec3, normal: Vec3) -> Vec3:
    """Mirror reflection r = d - 2 (d.n) n (``nonLambertianFlux.C:174``)."""
    return incident - normal.scale(2.0 * incident.dot(normal))


def gaussian_tilt(gen, direction: Vec3, sigma) -> Vec3:
    """Additive Gaussian angular tilt of ``BRDF::SampleSpecular``
    (``nonLambertianFlux.C:178-188``), renormalised."""
    theta = sigma * _normal(gen, direction.x)
    phi = TWO_PI * _uniform(gen, direction.x)
    p1, p2 = orthonormal_basis(direction)
    st = torch.sin(theta)
    out = (direction + p1.scale(st * torch.cos(phi))
           + p2.scale(st * torch.sin(phi)))
    return out.normalized()


def rough_normal(gen, normal: Vec3, sigma) -> Vec3:
    """ROBAST ``SetGaussianRoughness``: tilt the normal by a Gaussian angle
    of std ``sigma`` (radians) at uniform azimuth."""
    theta = sigma * _normal(gen, normal.x)
    phi = TWO_PI * _uniform(gen, normal.x)
    return _from_local(normal, torch.sin(theta), torch.cos(theta), phi)


def specular_rough(gen, incident: Vec3, normal: Vec3, sigma) -> Vec3:
    """Specular bounce about a Gaussian-roughened normal, flipped back into
    the inward hemisphere where the tilt drove it below the horizon."""
    n_r = rough_normal(gen, normal, sigma)
    out = specular_reflect(incident, n_r)
    below = out.dot(normal) < 0
    return Vec3.where(below, out - normal.scale(2.0 * out.dot(normal)), out)


def mixed_brdf(gen, incident: Vec3, normal: Vec3, specular_prob,
               diffuse_prob, roughness) -> Vec3:
    """``BRDF::SampleDirection`` (``nonLambertianFlux.C:162-169``)."""
    p_spec = specular_prob / (specular_prob + diffuse_prob)
    take_spec = _uniform(gen, normal.x) < p_spec
    spec = gaussian_tilt(gen, specular_reflect(incident, normal),
                         roughness * (math.pi / 6.0))
    diff = cosine_hemisphere(gen, normal)
    return Vec3.where(take_spec, spec, diff)


def cos_n_lobe(gen, normal: Vec3, n, max_angle_rad, rounds: int = 16) -> Vec3:
    """Rejection-sampled cos^n lobe about ``normal`` (``nonLambertianFlux
    copy.C:38-71``) as a fixed-round masked loop: first accepted proposal
    wins, stragglers keep the last proposal."""
    theta_acc = torch.zeros_like(normal.x)
    phi_acc = torch.zeros_like(normal.x)
    accepted = torch.zeros_like(normal.x, dtype=torch.bool)
    for _ in range(rounds):
        theta = max_angle_rad * _uniform(gen, normal.x)
        phi = TWO_PI * _uniform(gen, normal.x)
        p = torch.abs(torch.cos(theta)) ** n
        ok = _uniform(gen, normal.x) <= p
        take = ~accepted
        theta_acc = torch.where(take, theta, theta_acc)
        phi_acc = torch.where(take, phi, phi_acc)
        accepted = accepted | (take & ok)
    out = _from_local(normal, torch.sin(theta_acc), torch.cos(theta_acc),
                      phi_acc)
    below = out.dot(normal) < 0      # hemisphere guard (copy.C:210-213)
    return Vec3.where(below, -out, out)


def scatter(gen, model, incident: Vec3, normal: Vec3, scene) -> Vec3:
    """Dispatch on the surface model: a ``SurfaceModel`` value, or a custom
    callable ``(gen, incident, normal, scene) -> Vec3`` (the archived
    macro's user-overridable ``Reflection()`` hook, ``nonLambertianFlux
    copy.C:187-220``).  The callable draws from ``gen``, a generator on the
    device of the ray tensors.  A callable is not a static law, so the
    kernels and the closed-form sampler leave such a scene to the eager
    tracers."""
    if callable(model) and not isinstance(model, SurfaceModel):
        return model(gen, incident, normal, scene)
    model = SurfaceModel(model)
    if model == SurfaceModel.LAMBERTIAN:
        return cosine_hemisphere(gen, normal)
    if model == SurfaceModel.SPECULAR:
        return specular_rough(gen, incident, normal, scene.roughness)
    if model == SurfaceModel.MIXED_BRDF:
        return mixed_brdf(gen, incident, normal, scene.specular_prob,
                          scene.diffuse_prob, scene.brdf_roughness)
    if model == SurfaceModel.COS_N_LOBE:
        return cos_n_lobe(gen, normal, scene.cos_n,
                          math.radians(scene.max_angle_deg))
    raise ValueError(f"unknown surface model: {model}")
