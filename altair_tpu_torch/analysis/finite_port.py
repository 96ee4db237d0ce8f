"""Closed-form integrating-sphere flux models — the ``finitePort/`` analytic
validation layer (SURVEY.md §1 L7, §4.1).

A copy of ``altair_tpu/analysis/finite_port.py`` (numpy/scipy only, no JAX), so that
``altair_tpu_torch`` never imports the JAX package.

These are the oracles the Monte Carlo is validated against:

* ``projection_factor_quad``     <- ``finitePort/flux.py:11-29`` (dblquad)
* ``projection_factor_grid``     <- ``finitePort/projectionFactor.py:17-46``
  (midpoint grid sum, numerically-stabilised cos(theta') clip)
* ``sphere_multiplier``,
  ``subtended_flux``             <- ``finitePort/subtendedFlux.py:16-27``
  (Phi_in/(1 - rho(1-f)) * 1/2 sin^2(alpha) * cos(theta))
* ``ideal_cosine_flux``          <- ``finitePort/test.py:11-14``
"""

from __future__ import annotations

import numpy as np


def projection_factor_integrand(r, phi, theta, R=1.0, eps=1e-8):
    """Integrand of the finite-port projection factor
    (``finitePort/flux.py:11-21``)."""
    spt = np.sin(phi) * np.tan(theta)
    radical = max(R**2 + r**2 - 2 * R * r * spt, eps)
    return (R - r * spt) / np.sqrt(radical) * r


def projection_factor_quad(theta, R=1.0, a=1.0, I0=1.0):
    """Double integral over the port disk via scipy dblquad
    (``finitePort/flux.py:24-29``).  theta in radians, must be < pi/2."""
    import scipy.integrate as spi

    if theta >= np.pi / 2:
        raise ValueError(
            "Theta must be less than 90 degrees (pi/2 radians) to avoid "
            "instability.")
    result, _ = spi.dblquad(projection_factor_integrand, 0, 2 * np.pi,
                            lambda phi: 0, lambda phi: a, args=(theta,))
    return I0 * result


def projection_factor_grid(theta, R=1.0, r_p=0.1, num_points=100):
    """Midpoint-grid version with the stability clip
    (``finitePort/projectionFactor.py:17-46``).  theta in radians."""
    r_vals = np.linspace(0, r_p, num_points)
    phi_vals = np.linspace(0, 2 * np.pi, num_points)
    R_grid, Phi_grid = np.meshgrid(r_vals, phi_vals)
    denominator = np.sqrt(np.maximum(
        R**2 + R_grid**2 - 2 * R * R_grid * np.sin(Phi_grid)
        * np.tan(theta), 1e-10))
    cos_theta_prime = (R - R_grid * np.sin(Phi_grid) * np.tan(theta)) \
        / denominator
    cos_theta_prime = np.clip(cos_theta_prime, -1, 1)
    dA = R_grid * (r_p / num_points) * (2 * np.pi / num_points)
    return float(np.sum(cos_theta_prime * dA))


def projection_factor_curve(theta_deg, R=1.0, r_p=0.1, num_points=100,
                            normalize=True):
    """Projection factor over a theta sweep, optionally normalised to its
    maximum (the reference's comparison-plot convention,
    ``projectionFactor.py:49-56``)."""
    th = np.deg2rad(np.asarray(theta_deg, float))
    vals = np.array([projection_factor_grid(t, R, r_p, num_points)
                     for t in th])
    if normalize and vals.max() > 0:
        vals = vals / vals.max()
    return vals


def sphere_multiplier(rho, f):
    """Effective-flux multiplier M = 1 / (1 - rho (1 - f))
    (``finitePort/test.py:11``, ``subtendedFlux.py:24``)."""
    return 1.0 / (1.0 - rho * (1.0 - f))


def subtended_flux(theta, a, R=1.0, rho=0.99, phi_input=1.0):
    """Phi(theta) = Phi_in/(1-rho(1-f)) * 1/2 sin^2(alpha) * cos(theta) with
    alpha = arcsin(a/R), f = (a/R)^2 (``subtendedFlux.py:16-27``).
    theta in radians."""
    alpha = np.arcsin(a / R)
    f = (a / R) ** 2
    return (phi_input * sphere_multiplier(rho, f)
            * 0.5 * np.sin(alpha) ** 2 * np.cos(theta))


def ideal_cosine_flux(theta, rho=0.95, f=0.3, phi_input=1.0):
    """Phi_eff * f * cos(theta) minimal model (``finitePort/test.py:11-14``).
    theta in radians."""
    return phi_input * sphere_multiplier(rho, f) * f * np.cos(theta)


def port_area_fraction(port_angle_deg):
    """Vectorised cap-area fraction (see config.port_escape_probability for
    the scalar shared by the engine-side capacity/safety checks)."""
    return (1 - np.cos(np.deg2rad(180 - np.asarray(port_angle_deg)))) / 2


def expected_exit_fraction(port_angle_deg, rho):
    """Closed-form exit fraction p/(p + (1-rho)) of the roulette random walk
    — reproduces the corpus footers: 160->0.751, 164->0.659, 170->0.432.
    (Vectorised; the scalar engine-side twin lives in altair_tpu_torch.config.)"""
    p = port_area_fraction(port_angle_deg)
    return p / (p + (1 - rho))
