"""The bounce kernel's wrapper, its plain PyTorch version, and the simulate
engine built on them — the counterpart of ``altair_tpu/core/trace_pallas.py``
(``_bounce_kernel``, ``trace_rays_pallas``, ``trace_rays_fast``).

``bounce`` is the wrapper.  On a CUDA tensor it launches the hand-written
kernel ``csrc/bounce.cu`` (built at first use by ``_build``) or raises; on a
CPU tensor it runs ``bounce_plain``, the same computation in plain tensor
ops.  There is no fallback from one to the other.

Dispatch: the JAX package hands batches of n >= 2^20 to its refill kernel
(``trace_pallas.py::_refill_kernel``).  That kernel is not ported yet, so
the port runs the bounce kernel at every n until refill is ported and
measured against it on the card.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ..config import SphereScene, Source, SurfaceModel, TraceConfig
from . import _build
from .geometry import Vec3
from .trace import (ABSORBED, EXITED, RUNNING, SUSPENDED, RimOverflow,
                    TraceResult, draw_seeds, no_overflow,
                    rim_deferred_capacity_shift, trace_rays_rim_deferred)

KERNEL_SOURCE = "altair_tpu_torch/csrc/bounce.cu"
REPLACES = "altair_tpu/core/trace_pallas.py:247"

# launches of each kernel since the last reset: a run shows it went through
# the kernel by reading these
launch_counts = {"bounce": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


_COS_N_ROUNDS = 12
# uniforms drawn per bounce (survival + the law's scatter draws)
N_DRAWS = {
    SurfaceModel.LAMBERTIAN: 3,
    SurfaceModel.SPECULAR: 4,
    SurfaceModel.MIXED_BRDF: 7,
    SurfaceModel.COS_N_LOBE: 1 + 3 * _COS_N_ROUNDS,
}
RNG_MODES = ("philox", "hash")
# bounce iterations of the plain version between its all-dead checks
INNER_ITERS = 64

_TWO_PI = 6.2831853071795864
_INV24 = 2.0 ** -24
_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _model_supported(scene: SphereScene) -> bool:
    return (not callable(scene.surface_model)
            and SurfaceModel(scene.surface_model) in N_DRAWS)


def kernel_operands(scene: SphereScene, source: Source, device):
    """``(scene_vec, src_vec)``, float32[8] each, on ``device`` —
    ``trace_pallas.py::_kernel_operands`` computed the same way in float32:

    scene_vec = [inner_radius, cos_cap (= r*cos(theta_max)), reflectance,
                 world_half, exit_port_z, max_bounces, m0, m1], where
      (m0, m1) are the law's parameters — SPECULAR (roughness, 0);
      MIXED_BRDF (normalised specular prob, brdf_roughness*pi/6);
      COS_N_LOBE (cos_n, max angle in radians);
    src_vec = [x, y, z, dx, dy, dz, 0, 0] with the direction normalised.
    """
    f = np.float32
    theta_max = np.deg2rad(f(scene.theta_max_deg))
    model = SurfaceModel(scene.surface_model)
    m0 = m1 = f(0.0)
    if model == SurfaceModel.SPECULAR:
        m0 = f(scene.roughness)
    elif model == SurfaceModel.MIXED_BRDF:
        sp = f(scene.specular_prob)
        m0 = sp / (sp + f(scene.diffuse_prob))
        m1 = f(scene.brdf_roughness) * f(np.pi / 6.0)
    elif model == SurfaceModel.COS_N_LOBE:
        m0 = f(scene.cos_n)
        m1 = np.deg2rad(f(scene.max_angle_deg))
    r = f(scene.inner_radius)
    scene_vec = np.array([
        r, r * np.cos(theta_max), f(scene.reflectance), f(scene.world_half),
        f(scene.exit_port_z), f(float(scene.max_bounces)), m0, m1,
    ], np.float32)
    dx, dy, dz = f(source.dir_x), f(source.dir_y), f(source.dir_z)
    dnorm = np.sqrt(dx * dx + dy * dy + dz * dz)
    src_vec = np.array([f(source.x), f(source.y), f(source.z),
                        dx / dnorm, dy / dnorm, dz / dnorm, 0.0, 0.0],
                       np.float32)
    return (torch.from_numpy(scene_vec).to(device),
            torch.from_numpy(src_vec).to(device))


def seed_pair(gen: torch.Generator) -> tuple[int, int]:
    """The kernel's two 32-bit seed words, drawn from the CPU key ``gen``."""
    s0, s1 = draw_seeds(gen, 2, 1 << 32)
    return s0, s1


# ---------------------------------------------------------------------------
# The plain version's random numbers.  Torch has no uint32 arithmetic on
# every device, so uint32 values ride in int64 tensors and every product is
# split into 16-bit halves, which keeps it exact below 2^63.
# ---------------------------------------------------------------------------

def _mul32(x, c: int):
    """(x * c) mod 2^32 for uint32 values ``x`` and a uint32 constant."""
    return ((x & 0xFFFF) * c + ((((x >> 16) * c) & 0xFFFF) << 16)) & _M32


def _mulhilo(c: int, x):
    """(hi, lo) words of the 64-bit product of a uint32 constant and
    uint32 values ``x``."""
    p_lo = (x & 0xFFFF) * c
    p_hi = (x >> 16) * c
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (t >> 32), t & _M32


def _fmix32(x):
    """murmur3's 32-bit finaliser (``trace_pallas.py::_fmix32``)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 (Salmon et al. 2011) on counter words ``c0..c3``
    (int64 tensors of uint32 values) under the key ``(k0, k1)``."""
    for r in range(10):
        if r:
            k0 = (k0 + 0x9E3779B9) & _M32
            k1 = (k1 + 0xBB67AE85) & _M32
        hi0, lo0 = _mulhilo(0xD2511F53, c0)
        hi1, lo1 = _mulhilo(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _unit(bits):
    return (bits >> 8).to(torch.float32) * _INV24


def _hash_draws(lane_h, it: int, n_draws: int):
    """``_sw_uniform`` draws of iteration ``it``, bit for bit."""
    c = it * n_draws
    return [_unit(_fmix32((lane_h + (((c + i) * _GOLDEN) & _M32)) & _M32))
            for i in range(n_draws)]


def _philox_draws(lane, it: int, n_draws: int, seed0: int, seed1: int):
    """The kernel's philox draws of iteration ``it``: counter (ray index
    low word, high word, it, draw group)."""
    lo = lane & _M32
    hi = lane >> 32
    out = []
    for g in range(-(-n_draws // 4)):
        words = philox4x32_10(lo, hi, torch.full_like(lane, it),
                              torch.full_like(lane, g), seed0, seed1)
        out += [_unit(w) for w in words]
    return out[:n_draws]


# ---------------------------------------------------------------------------
# The plain version of the kernel
# ---------------------------------------------------------------------------

def _from_local(ax, ay, az, st, ct, ph):
    """Unit direction at polar (st, ct), azimuth ph about unit axis a
    (branchless Duff basis, sign by comparison)."""
    one = torch.ones_like(az)
    sign = torch.where(az >= 0, one, -one)
    a = -1.0 / (sign + az)
    bb = ax * ay * a
    t1x = 1.0 + sign * ax * ax * a
    t1y = sign * bb
    t1z = -sign * ax
    t2x = bb
    t2y = sign + ay * ay * a
    t2z = -ay
    cp = torch.cos(ph)
    sp = torch.sin(ph)
    ox = st * (cp * t1x + sp * t2x) + ct * ax
    oy = st * (cp * t1y + sp * t2y) + ct * ay
    oz = st * (cp * t1z + sp * t2z) + ct * az
    inv = torch.rsqrt(ox * ox + oy * oy + oz * oz)
    return ox * inv, oy * inv, oz * inv


def _gauss(ua, ub):
    """standard normal via Box-Muller (log(1-u) is safe: u < 1)."""
    return torch.sqrt(-2.0 * torch.log(1.0 - ua)) * torch.cos(_TWO_PI * ub)


def _scatter_dir(model, m0, m1, u, nx, ny, nz, dx, dy, dz):
    """The scatter laws of ``trace_pallas.py::_scatter_dir``; ``u[0]`` is
    the survival roulette, the law consumes ``u[1:]``."""
    if model == SurfaceModel.LAMBERTIAN:
        ct = torch.sqrt(u[1])
        st = torch.sqrt(torch.clamp(1.0 - u[1], min=0.0))
        return _from_local(nx, ny, nz, st, ct, _TWO_PI * u[2])
    if model == SurfaceModel.SPECULAR:
        tilt = m0 * _gauss(u[1], u[2])
        nrx, nry, nrz = _from_local(nx, ny, nz, torch.sin(tilt),
                                    torch.cos(tilt), _TWO_PI * u[3])
        dn = dx * nrx + dy * nry + dz * nrz
        ndx = dx - 2.0 * dn * nrx
        ndy = dy - 2.0 * dn * nry
        ndz = dz - 2.0 * dn * nrz
        below = ndx * nx + ndy * ny + ndz * nz
        flip = torch.where(below < 0, 2.0 * below, torch.zeros_like(below))
        return ndx - flip * nx, ndy - flip * ny, ndz - flip * nz
    if model == SurfaceModel.MIXED_BRDF:
        ct = torch.sqrt(u[4])
        st = torch.sqrt(torch.clamp(1.0 - u[4], min=0.0))
        ddx, ddy, ddz = _from_local(nx, ny, nz, st, ct, _TWO_PI * u[5])
        dn = dx * nx + dy * ny + dz * nz
        rx = dx - 2.0 * dn * nx
        ry = dy - 2.0 * dn * ny
        rz = dz - 2.0 * dn * nz
        theta = m1 * _gauss(u[2], u[3])
        # the additive tilt of r by sin(theta), renormalised: cos part 1
        sx, sy, sz = _from_local(rx, ry, rz, torch.sin(theta), 1.0,
                                 _TWO_PI * u[6])
        take_spec = u[1] < m0
        return (torch.where(take_spec, sx, ddx),
                torch.where(take_spec, sy, ddy),
                torch.where(take_spec, sz, ddz))
    if model == SurfaceModel.COS_N_LOBE:
        theta = torch.zeros_like(nx)
        phi = torch.zeros_like(nx)
        accepted = torch.zeros_like(nx, dtype=torch.bool)
        for i in range(_COS_N_ROUNDS):
            th = m1 * u[1 + 3 * i]
            ph = _TWO_PI * u[2 + 3 * i]
            p = torch.exp(m0 * torch.log(torch.clamp(
                torch.abs(torch.cos(th)), min=1e-30)))
            take = ~accepted
            theta = torch.where(take, th, theta)
            phi = torch.where(take, ph, phi)
            accepted = accepted | (take & (u[3 + 3 * i] <= p))
        ox, oy, oz = _from_local(nx, ny, nz, torch.sin(theta),
                                 torch.cos(theta), phi)
        below = ox * nx + oy * ny + oz * nz < 0
        sgn = torch.where(below, -torch.ones_like(ox), torch.ones_like(ox))
        return ox * sgn, oy * sgn, oz * sgn
    raise NotImplementedError(model)


def _check_args(seed, scene_vec, src_vec, n, model, max_bounces, rng):
    if rng not in RNG_MODES:
        raise ValueError(f"rng must be one of {RNG_MODES}, got {rng!r}")
    if SurfaceModel(model) not in N_DRAWS:
        raise NotImplementedError(f"no bounce kernel for law {model!r}")
    if n < 0 or max_bounces < 0:
        raise ValueError("n and max_bounces must be non-negative")
    if len(seed) != 2:
        raise ValueError("seed must be a pair of 32-bit words")
    for name, v in (("scene_vec", scene_vec), ("src_vec", src_vec)):
        if v.dtype != torch.float32 or v.shape != (8,):
            raise ValueError(f"{name} must be float32[8], got "
                             f"{v.dtype}{list(v.shape)}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if src_vec.device != scene_vec.device:
        raise ValueError("scene_vec and src_vec must be on one device")


def bounce_plain(seed, scene_vec, src_vec, n: int, model, max_bounces: int,
                 rng: str = "philox") -> TraceResult:
    """The bounce kernel's computation in plain tensor ops, on the device
    of ``scene_vec``: every lane runs each iteration under an ``active``
    mask, as the Pallas kernel does, with an all-dead check every
    ``INNER_ITERS`` iterations."""
    _check_args(seed, scene_vec, src_vec, n, model, max_bounces, rng)
    model = SurfaceModel(model)
    dev = scene_vec.device
    radius, cos_cap, reflectance, world_half = (scene_vec[0], scene_vec[1],
                                                scene_vec[2], scene_vec[3])
    m0, m1 = scene_vec[6], scene_vec[7]
    inv_r = 1.0 / radius
    nd = N_DRAWS[model]
    seed0, seed1 = int(seed[0]) & _M32, int(seed[1]) & _M32

    lane = torch.arange(n, dtype=torch.int64, device=dev)
    lane_h = _fmix32((lane & _M32) ^ (seed0 ^ seed1))
    zt = torch.zeros((n,), dtype=torch.float32, device=dev)
    px, py, pz = src_vec[0] + zt, src_vec[1] + zt, src_vec[2] + zt
    dx, dy, dz = src_vec[3] + zt, src_vec[4] + zt, src_vec[5] + zt
    prevx, prevy, prevz = px, py, pz
    status = torch.zeros((n,), dtype=torch.int32, device=dev)
    bounces = torch.zeros((n,), dtype=torch.int32, device=dev)

    it = 0
    while it < max_bounces and bool((status == RUNNING).any()):
        for _ in range(min(INNER_ITERS, max_bounces - it)):
            active = status == RUNNING
            b = px * dx + py * dy + pz * dz
            c = px * px + py * py + pz * pz - radius * radius
            disc = torch.clamp(b * b - c, min=0.0)
            t = torch.clamp(-b + torch.sqrt(disc), min=0.0)
            qx = px + dx * t
            qy = py + dy * t
            qz = pz + dz * t
            rn = radius * torch.rsqrt(qx * qx + qy * qy + qz * qz)
            qx, qy, qz = qx * rn, qy * rn, qz * rn
            escaped = qz < cos_cap

            if rng == "hash":
                u = _hash_draws(lane_h, it, nd)
            else:
                u = _philox_draws(lane, it, nd, seed0, seed1)
            survive = u[0] < reflectance
            ndx, ndy, ndz = _scatter_dir(model, m0, m1, u, -qx * inv_r,
                                         -qy * inv_r, -qz * inv_r,
                                         dx, dy, dz)

            # guard order of the Pallas kernel: status, positions,
            # direction, bounces — each under `active`
            new_status = torch.where(
                escaped, EXITED, torch.where(survive, RUNNING, ABSORBED))
            status = torch.where(active, new_status.to(torch.int32), status)
            prevx = torch.where(active, px, prevx)
            prevy = torch.where(active, py, prevy)
            prevz = torch.where(active, pz, prevz)
            px = torch.where(active, qx, px)
            py = torch.where(active, qy, py)
            pz = torch.where(active, qz, pz)
            upd_dir = active & ~escaped & survive
            dx = torch.where(upd_dir, ndx, dx)
            dy = torch.where(upd_dir, ndy, dy)
            dz = torch.where(upd_dir, ndz, dz)
            bounces = torch.where(active & ~escaped, bounces + 1, bounces)
            it += 1

    # epilogue: exited lanes fly from the cap crossing to the world box
    def axis_t(pc, dc):
        face = torch.where(dc >= 0, world_half, -world_half)
        return torch.where(dc == 0, torch.full_like(pc, math.inf),
                           (face - pc) / dc)

    tb = torch.minimum(axis_t(px, dx),
                       torch.minimum(axis_t(py, dy), axis_t(pz, dz)))
    exited = status == EXITED
    px = torch.where(exited, px + dx * tb, px)
    py = torch.where(exited, py + dy * tb, py)
    pz = torch.where(exited, pz + dz * tb, pz)
    status = torch.where(status == RUNNING, SUSPENDED, status)
    return TraceResult(status, Vec3(px, py, pz), Vec3(prevx, prevy, prevz),
                       Vec3(dx, dy, dz), bounces)


@functools.cache
def _bounce_fn():
    fn = _build.load("bounce").altair_bounce
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32,
                    ctypes.c_uint32, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_longlong] + [ctypes.c_void_p] * 12)
    fn.restype = ctypes.c_int
    return fn


def _bounce_cuda(seed, scene_vec, src_vec, n, model, max_bounces, rng):
    dev = scene_vec.device
    out = ([torch.empty((n,), dtype=torch.int32, device=dev)]
           + [torch.empty((n,), dtype=torch.float32, device=dev)
              for _ in range(9)]
           + [torch.empty((n,), dtype=torch.int32, device=dev)])
    if n:
        fn = _bounce_fn()
        with torch.cuda.device(dev):
            err = fn(scene_vec.data_ptr(), src_vec.data_ptr(),
                     int(seed[0]) & _M32, int(seed[1]) & _M32,
                     int(max_bounces), int(model), int(rng == "hash"), n,
                     *[o.data_ptr() for o in out],
                     torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"bounce kernel launch failed: CUDA error {err}")
        launch_counts["bounce"] += 1
    (status, lx, ly, lz, sx, sy, sz, dx, dy, dz, bounces) = out
    return TraceResult(status, Vec3(lx, ly, lz), Vec3(sx, sy, sz),
                       Vec3(dx, dy, dz), bounces)


def bounce(seed, scene_vec, src_vec, n: int, model, max_bounces: int,
           rng: str = "philox") -> TraceResult:
    """Trace ``n`` rays from the source to termination under one static
    scatter law (simple-mode physics, no rim).

    ``seed``: two 32-bit words; ``scene_vec``/``src_vec``: the float32[8]
    operands of ``kernel_operands``, on the device to run on; ``rng``:
    ``"philox"`` (production) or ``"hash"`` (the Pallas kernel's software
    generator, bit for bit).  A CUDA ``scene_vec`` launches the CUDA kernel;
    a CPU one runs ``bounce_plain``."""
    _check_args(seed, scene_vec, src_vec, n, model, max_bounces, rng)
    if scene_vec.device.type == "cuda":
        return _bounce_cuda(seed, scene_vec, src_vec, n, model, max_bounces,
                            rng)
    if scene_vec.device.type == "cpu":
        return bounce_plain(seed, scene_vec, src_vec, n, model, max_bounces,
                            rng)
    raise ValueError(f"no bounce kernel for device {scene_vec.device}")


def _check_simulate(scene: SphereScene, cfg: TraceConfig):
    if not _model_supported(scene):
        raise NotImplementedError(
            "the bounce kernel implements the four static scatter laws; "
            "custom scatter callables are not ported to altair_tpu_torch yet")
    if cfg.keep_history:
        raise NotImplementedError(
            "path history (keep_history) is not ported to altair_tpu_torch")
    if cfg.dtype != torch.float32:
        raise NotImplementedError("the bounce kernel traces in float32 only")


def trace_rays_bounce(
    gen: torch.Generator,
    scene: SphereScene,
    source: Source,
    n_rays: int,
    cfg: TraceConfig = TraceConfig(),
    *,
    device,
) -> TraceResult:
    """Simple-mode trace through the bounce kernel (the counterpart of
    ``trace_rays_pallas``): any ``n_rays``, the kernel's seed words drawn
    from the CPU key ``gen``, the philox stream.  Exact-rim scenes go
    through ``trace_rays_fast``."""
    _check_simulate(scene, cfg)
    if scene.exact_rim:
        raise NotImplementedError(
            "the bounce kernel traces simple-mode physics; exact-rim scenes "
            "go through trace_rays_fast (deferred rim post-pass)")
    scene_vec, src_vec = kernel_operands(scene, source, device)
    return bounce(seed_pair(gen), scene_vec, src_vec, n_rays,
                  SurfaceModel(scene.surface_model), int(scene.max_bounces),
                  rng="philox")


def trace_rays_fast(
    gen: torch.Generator,
    scene: SphereScene,
    source: Source,
    n_rays: int,
    cfg: TraceConfig = TraceConfig(),
    *,
    device,
) -> tuple[TraceResult, RimOverflow]:
    """The simulate engine: the bounce kernel, composed with the deferred
    rim post-pass for exact-rim scenes.

    Returns ``(TraceResult, RimOverflow)`` — the JAX function drops the
    overflow count; the port returns it so a caller can check it."""
    _check_simulate(scene, cfg)
    if not scene.exact_rim:
        return (trace_rays_bounce(gen, scene, source, n_rays, cfg,
                                  device=device),
                no_overflow(device))
    shift = rim_deferred_capacity_shift(scene)
    if shift is None:
        raise NotImplementedError(
            "a thick rim (or non-scalar scene parameters) needs the in-loop "
            "exact-rim main trace, which is not wired to the bounce kernel "
            "in altair_tpu_torch yet")
    return trace_rays_rim_deferred(gen, scene, source, n_rays, cfg,
                                   capacity_shift=shift,
                                   main_tracer=trace_rays_bounce,
                                   device=device)
