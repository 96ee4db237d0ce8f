"""The kernels' wrappers, their plain PyTorch versions, and the simulate
engine built on them — the counterpart of ``altair_tpu/core/trace_pallas.py``
(``_bounce_kernel``, ``trace_rays_pallas``, ``_refill_kernel``,
``trace_rays_refill``, ``trace_rays_fast``).

``bounce`` and ``refill`` are the wrappers.  On a CUDA tensor each launches
its hand-written kernel (``csrc/bounce.cu``, ``csrc/refill.cu``, built at
first use by ``_build``) or raises; on a CPU tensor it runs its plain
version (``bounce_plain``, ``refill_plain``), the same computation in
plain tensor ops.  There is no fallback from one to the other.

Dispatch, as in the JAX package: batches of n >= ``REFILL_MIN`` run the
refill kernel with ``_REFILL_BUDGET`` rays per lane and the tail handoff
at ``_REFILL_HANDOFF``, whose stragglers finish in the waves tracer; smaller
batches run the bounce kernel.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import SphereScene, Source, SurfaceModel, TraceConfig
from . import _build
from .geometry import Vec3
from .compact import nonzero_indices_grouped
from .trace import (ABSORBED, EXITED, RUNNING, SUSPENDED, RimOverflow,
                    TraceResult, _i32, _put_result, draw_seeds,
                    no_overflow, rim_deferred_capacity_shift, split,
                    trace_rays, trace_rays_rim_deferred)

# per kernel: its source and the Pallas kernel it replaces
KERNELS = {
    "bounce": ("altair_tpu_torch/csrc/bounce.cu",
               "altair_tpu/core/trace_pallas.py:247"),
    "refill": ("altair_tpu_torch/csrc/refill.cu",
               "altair_tpu/core/trace_pallas.py:399"),
}

# launches of each kernel since the last reset: a run shows it went through
# the kernel by reading these, and ``launch_sizes`` holds the ray counts
# (n) those launches took
launch_counts = {"bounce": 0, "refill": 0}
launch_sizes: dict[str, set] = {"bounce": set(), "refill": set()}

# lanes of one refill unit: a warp's pool and the handoff unit
# (csrc/refill.cu LANES)
REFILL_LANES = 128
# threads that share one unit's pool in the kernel: a warp
REFILL_THREADS = 32
# batches at least this big run the refill kernel (the JAX package's
# constants, trace_pallas.py:933-942; module constants so a test can lower
# them)
REFILL_MIN = 1 << 20
_REFILL_BUDGET = 4
_REFILL_HANDOFF = 0.01


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0
        launch_sizes[name].clear()


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


def _hash_draws(lane_h, it, n_draws: int):
    """``_sw_uniform`` draws of iteration ``it`` (an int, or an int64
    tensor of one counter per lane), bit for bit."""
    c = it * n_draws
    return [_unit(_fmix32((lane_h + (((c + i) * _GOLDEN) & _M32)) & _M32))
            for i in range(n_draws)]


def _philox_draws(lane, it, n_draws: int, seed0: int, seed1: int):
    """The kernel's philox draws of iteration ``it`` (an int, or an int64
    tensor of one counter per lane): counter (ray index low word, high
    word, it, draw group)."""
    lo = lane & _M32
    hi = lane >> 32
    out = []
    for g in range(-(-n_draws // 4)):
        words = philox4x32_10(lo, hi, torch.zeros_like(lane) + it,
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


def _box_flight(mask, px, py, pz, dx, dy, dz, world_half):
    """Fly the ``mask`` lanes from their point to the world box
    (``trace_pallas.py::_box_flight``)."""
    def axis_t(pc, dc):
        face = torch.where(dc >= 0, world_half, -world_half)
        return torch.where(dc == 0, torch.full_like(pc, math.inf),
                           (face - pc) / dc)

    tb = torch.minimum(axis_t(px, dx),
                       torch.minimum(axis_t(py, dy), axis_t(pz, dz)))
    return (torch.where(mask, px + dx * tb, px),
            torch.where(mask, py + dy * tb, py),
            torch.where(mask, pz + dz * tb, pz))


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
    px, py, pz = _box_flight(status == EXITED, px, py, pz, dx, dy, dz,
                             world_half)
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
        launch_sizes["bounce"].add(n)
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


# ---------------------------------------------------------------------------
# The refill kernel
# ---------------------------------------------------------------------------

class LiveState(NamedTuple):
    """The refill kernel's loop-exit carry, one entry per lane (written
    with the tail handoff).  A lane whose last ray finished reads as a
    fresh source ray with ``ray_idx == budget``."""

    pos: Vec3
    direction: Vec3
    ray_idx: torch.Tensor   # [n / budget] int32: the slot of its live ray
    bounces: torch.Tensor   # [n / budget] int32: that ray's bounces so far


def _check_refill_args(n, budget, thresh, lane_block, threads_per_unit=1):
    if budget < 1 or thresh < 0 or lane_block < 1 or threads_per_unit < 1:
        raise ValueError("budget, lane_block and threads_per_unit must be "
                         ">= 1, thresh >= 0")
    if n % (lane_block * budget):
        raise ValueError(f"n must be a multiple of lane_block * budget = "
                         f"{lane_block * budget}, got {n}")


class _Physics(NamedTuple):
    """What a refill bounce step reads: the law, the stream, the seed
    words, the caps and the scene's and source's scalars (0-d tensors)."""

    model: SurfaceModel
    rng: str
    seed0: int
    seed1: int
    max_bounces: int
    budget: int
    radius: torch.Tensor
    cos_cap: torch.Tensor
    reflectance: torch.Tensor
    m0: torch.Tensor
    m1: torch.Tensor
    src: tuple           # x, y, z, dx, dy, dz of the source ray


def _physics(seed, scene_vec, src_vec, model, max_bounces, budget,
             rng) -> _Physics:
    return _Physics(SurfaceModel(model), rng, int(seed[0]) & _M32,
                    int(seed[1]) & _M32, int(max_bounces), int(budget),
                    scene_vec[0], scene_vec[1], scene_vec[2], scene_vec[6],
                    scene_vec[7], tuple(src_vec[i] for i in range(6)))


def _refill_step(ph: _Physics, lane, lane_h, k, active, px, py, pz, dx, dy,
                 dz, rbounces):
    """One bounce of every ``active`` lane, its draws keyed by (``lane``,
    ``k``).  Returns ``(done, status, q, nbounces, state)``: the lanes
    whose ray finished, the status, segment start and bounce count of
    their slot (the slot's direction is the ``dx, dy, dz`` passed in), and
    every lane's next ``(px, py, pz, dx, dy, dz, rbounces)`` (a finished
    ray respawns at the source)."""
    b = px * dx + py * dy + pz * dz
    c = px * px + py * py + pz * pz - ph.radius * ph.radius
    disc = torch.clamp(b * b - c, min=0.0)
    t = torch.clamp(-b + torch.sqrt(disc), min=0.0)
    qx = px + dx * t
    qy = py + dy * t
    qz = pz + dz * t
    rn = ph.radius * torch.rsqrt(qx * qx + qy * qy + qz * qz)
    qx, qy, qz = qx * rn, qy * rn, qz * rn
    escaped = qz < ph.cos_cap

    nd = N_DRAWS[ph.model]
    if ph.rng == "hash":
        u = _hash_draws(lane_h, k, nd)
    else:
        u = _philox_draws(lane, k, nd, ph.seed0, ph.seed1)
    survive = u[0] < ph.reflectance
    inv_r = 1.0 / ph.radius
    ndx, ndy, ndz = _scatter_dir(ph.model, ph.m0, ph.m1, u, -qx * inv_r,
                                 -qy * inv_r, -qz * inv_r, dx, dy, dz)

    done_exit = active & escaped
    done_abs = active & ~escaped & ~survive
    done_susp = (active & ~escaped & survive
                 & (rbounces + 1 >= ph.max_bounces))
    done = done_exit | done_abs | done_susp
    status = _i32(torch.where(done_exit, EXITED,
                              torch.where(done_abs, ABSORBED, SUSPENDED)))
    nbounces = torch.where(done_exit, rbounces, rbounces + 1)

    cont = active & ~done   # a wall bounce: the ray goes on
    sx0, sy0, sz0, dx0, dy0, dz0 = ph.src
    state = (torch.where(done, sx0, torch.where(cont, qx, px)),
             torch.where(done, sy0, torch.where(cont, qy, py)),
             torch.where(done, sz0, torch.where(cont, qz, pz)),
             torch.where(done, dx0, torch.where(cont, ndx, dx)),
             torch.where(done, dy0, torch.where(cont, ndy, dy)),
             torch.where(done, dz0, torch.where(cont, ndz, dz)),
             torch.where(done, 0, torch.where(cont, rbounces + 1, rbounces)))
    return done, status, (qx, qy, qz), nbounces, state


def refill_plain(seed, scene_vec, src_vec, n: int, model, max_bounces: int,
                 budget: int, thresh: int = 0, rng: str = "philox",
                 lane_block: int = REFILL_LANES,
                 threads_per_unit: int = REFILL_THREADS
                 ) -> tuple[TraceResult, LiveState | None]:
    """The refill kernel's loop in plain tensor ops, on the device of
    ``scene_vec``: ``n / budget`` lanes in units of ``lane_block``, each
    unit's pool shared by ``threads_per_unit`` threads.  32 (a warp) is
    the kernel's schedule; ``== lane_block`` is the lane-static one of the
    Pallas kernel and of this port before the warp pools.  Slot ``j`` of
    pool lane ``l`` in unit ``u`` is flat index ``u*budget*lane_block +
    j*lane_block + l``; slots never reached read RUNNING with zero fields.
    ``lane_block=16384`` is the Pallas kernel's layout and block.

    Step by step over ``[units, threads]``, as ``csrc/refill.cu``: every
    ``INNER_ITERS`` steps a unit sums its rays left (``budget - ray_idx``
    over its threads' lanes, ``budget`` for each lane not yet taken) and
    leaves once that is at most ``thresh``, or at a step cap that binds
    only at ``max_bounces == 0``; at every step the threads holding no
    lane take the pool's next ones in thread order (the kernel's ballot
    and prefix count), then each thread holding a lane makes one bounce,
    its draws keyed by (lane, the lane's own step count).  Units that
    left are dropped from the tensors at each check."""
    _check_args(seed, scene_vec, src_vec, n, model, max_bounces, rng)
    _check_refill_args(n, budget, thresh, lane_block, threads_per_unit)
    dev = scene_vec.device
    ph = _physics(seed, scene_vec, src_vec, model, max_bounces, budget, rng)
    lanes, threads = lane_block, min(threads_per_unit, lane_block)
    units = n // (budget * lanes)
    cap = (lanes - threads + 1) * budget * max_bounces
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    # per unit in the loop: its id and the pool lanes handed out; per
    # thread (unit-major): its lane's pool index and step count, the slot
    # of the ray in flight (budget: no lane) and that ray's state
    uid = torch.arange(units, dtype=torch.int64, device=dev)
    nxt = torch.zeros_like(uid)
    p = torch.zeros(units * threads, dtype=torch.int64, device=dev)
    k = torch.zeros_like(p)
    ray_idx = torch.full((units * threads,), budget, **i32)
    rb = torch.zeros_like(ray_idx)
    px, py, pz, dx, dy, dz = (s + torch.zeros(units * threads, **f32)
                              for s in ph.src)
    planes = ([torch.zeros(n + 1, **i32)]
              + [torch.zeros(n + 1, **f32) for _ in range(6)]
              + [torch.zeros(n + 1, **i32)])
    live = None
    if thresh > 0:      # every lane the source ray until its unit leaves
        live = ([s + torch.zeros(n // budget, **f32) for s in ph.src]
                + [torch.zeros(n // budget, **i32) for _ in range(2)])
    pool = torch.arange(lanes, dtype=torch.int64, device=dev)
    step = 0
    while uid.numel():
        m = uid.shape[0]
        rem = ((budget - ray_idx).view(m, threads).sum(1)
               + budget * (lanes - nxt))
        leave = (rem <= thresh) | (step >= cap)
        if bool(leave.any()):
            tl = leave.repeat_interleave(threads)
            if live is not None:
                # taken lanes are spent unless a thread holds them
                lu = uid[leave]
                live[6][(lu[:, None] * lanes + pool).view(-1)] = _i32(
                    torch.where(pool < nxt[leave][:, None], budget, 0)
                ).view(-1)
                held = tl & (ray_idx < budget)
                gl = (uid.repeat_interleave(threads) * lanes + p)[held]
                for plane, v in zip(live, (px, py, pz, dx, dy, dz, ray_idx,
                                           rb)):
                    plane[gl] = v[held]
            uid, nxt = uid[~leave], nxt[~leave]
            p, k, ray_idx, rb, px, py, pz, dx, dy, dz = (
                t[~tl] for t in (p, k, ray_idx, rb, px, py, pz, dx, dy, dz))
            m = uid.shape[0]
            if not m:
                break
        unit = uid.repeat_interleave(threads)
        for _ in range(INNER_ITERS):
            need = (ray_idx >= budget).view(m, threads).long()
            q = (nxt[:, None] + need.cumsum(1) - need).view(-1)
            take = need.view(-1).bool() & (q < lanes)
            p = torch.where(take, q, p)
            k = torch.where(take, 0, k)
            ray_idx = torch.where(take, 0, ray_idx)
            nxt = torch.clamp(nxt + need.sum(1), max=lanes)
            active = ray_idx < budget
            lane = unit * lanes + p
            lane_h = (_fmix32((lane & _M32) ^ (ph.seed0 ^ ph.seed1))
                      if ph.rng == "hash" else None)
            done, status, q3, nb, (px, py, pz, ndx, ndy, ndz, rb) = (
                _refill_step(ph, lane, lane_h, k, active, px, py, pz, dx,
                             dy, dz, rb))
            sidx = torch.where(done, unit * (budget * lanes)
                               + ray_idx.long() * lanes + p, n)
            for plane, v in zip(planes, (status, *q3, dx, dy, dz, nb)):
                plane[sidx] = v
            dx, dy, dz = ndx, ndy, ndz
            k = k + active.long()
            ray_idx = ray_idx + _i32(done)
        step += INNER_ITERS

    status, segx, segy, segz, dirx, diry, dirz, bounces = (
        pl[:n] for pl in planes)
    seg = Vec3(segx, segy, segz)
    direction = Vec3(dirx, diry, dirz)
    last = Vec3(*_box_flight(status == EXITED, *seg, *direction,
                             scene_vec[3]))
    res = TraceResult(status, last, seg, direction, bounces)
    if live is None:
        return res, None
    return res, LiveState(Vec3(*live[0:3]), Vec3(*live[3:6]), live[6],
                          live[7])


@functools.cache
def _refill_fn():
    lib = _build.load("refill")
    lanes = lib.altair_refill_lanes()
    if lanes != REFILL_LANES:
        raise RuntimeError(f"csrc/refill.cu has {lanes} lanes per unit, "
                           f"the wrapper {REFILL_LANES}")
    fn = lib.altair_refill
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32,
                    ctypes.c_uint32, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_void_p] * 20)
    fn.restype = ctypes.c_int
    return fn


def _refill_cuda(seed, scene_vec, src_vec, n, model, max_bounces, budget,
                 thresh, rng):
    dev = scene_vec.device

    def planes(k, shape):
        return ([torch.empty(shape, dtype=torch.float32, device=dev)
                 for _ in range(k)])

    def ints(shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)

    # the kernel writes every slot, zeros where no ray finished
    out = [ints((n,))] + planes(9, (n,)) + [ints((n,))]
    live = (planes(6, (n // budget,)) + [ints((n // budget,)),
                                         ints((n // budget,))]
            if thresh > 0 else None)
    if n:
        fn = _refill_fn()
        live_ptrs = ([t.data_ptr() for t in live] if live is not None
                     else [None] * 8)
        with torch.cuda.device(dev):
            err = fn(scene_vec.data_ptr(), src_vec.data_ptr(),
                     int(seed[0]) & _M32, int(seed[1]) & _M32,
                     int(max_bounces), int(model), int(rng == "hash"), n,
                     int(budget), int(thresh), *[o.data_ptr() for o in out],
                     *live_ptrs, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"refill kernel launch failed: CUDA error {err}")
        launch_counts["refill"] += 1
        launch_sizes["refill"].add(n)
    (status, lx, ly, lz, sx, sy, sz, dx, dy, dz, bounces) = out
    res = TraceResult(status, Vec3(lx, ly, lz), Vec3(sx, sy, sz),
                      Vec3(dx, dy, dz), bounces)
    if live is None:
        return res, None
    return res, LiveState(Vec3(*live[0:3]), Vec3(*live[3:6]), live[6],
                          live[7])


def refill(seed, scene_vec, src_vec, n: int, model, max_bounces: int,
           budget: int, thresh: int = 0, rng: str = "philox",
           lane_block: int = REFILL_LANES
           ) -> tuple[TraceResult, LiveState | None]:
    """Trace ``n`` rays, ``budget`` back to back in each of ``n / budget``
    lanes, under one static scatter law (simple-mode physics, no rim).

    Returns the 11 per-slot fields as a ``TraceResult`` (unfinished slots
    read RUNNING with zero fields) and, when ``thresh > 0``, the lanes'
    ``LiveState``.  ``thresh`` is the handoff threshold: a unit of
    ``lane_block`` lanes leaves its loop once at most ``thresh`` of its
    rays are left.  ``n`` must be a multiple of ``lane_block * budget``;
    the kernel's ``lane_block`` is ``REFILL_LANES`` (one warp's pool).
    Operands and ``rng`` as for ``bounce``.  A CUDA ``scene_vec`` launches
    the CUDA kernel; a CPU one runs ``refill_plain`` with the kernel's
    lanes per thread (``REFILL_LANES / REFILL_THREADS``): the kernel's
    warp schedule at its own ``lane_block``, and the same kind of pool
    schedule at another (the Pallas block, which the tests compare)."""
    _check_args(seed, scene_vec, src_vec, n, model, max_bounces, rng)
    _check_refill_args(n, budget, thresh, lane_block)
    if scene_vec.device.type == "cuda":
        if lane_block != REFILL_LANES:
            raise ValueError(f"the refill kernel's unit is "
                             f"{REFILL_LANES} lanes, got {lane_block}")
        return _refill_cuda(seed, scene_vec, src_vec, n, model, max_bounces,
                            budget, thresh, rng)
    if scene_vec.device.type == "cpu":
        threads = max(1, lane_block * REFILL_THREADS // REFILL_LANES)
        return refill_plain(seed, scene_vec, src_vec, n, model, max_bounces,
                            budget, thresh, rng, lane_block, threads)
    raise ValueError(f"no refill kernel for device {scene_vec.device}")


def _check_simulate(scene: SphereScene, cfg: TraceConfig):
    if not _model_supported(scene):
        raise NotImplementedError(
            "the kernels implement the four static scatter laws; a custom "
            "scatter callable runs in the eager tracers (trace_rays_auto)")
    if cfg.keep_history:
        raise NotImplementedError(
            "the kernels keep no path history; trace_rays does")
    if cfg.dtype != torch.float32:
        raise NotImplementedError("the kernels trace in float32 only")


def kernel_applicable(scene: SphereScene, cfg: TraceConfig) -> bool:
    """True when ``trace_rays_fast`` runs the kernels (``pallas_applicable``
    without the TPU test): a static law, float32, no history, and a rim
    the deferred post-pass admits."""
    if not (_model_supported(scene) and not cfg.keep_history
            and cfg.dtype == torch.float32):
        return False
    return not scene.exact_rim or rim_deferred_capacity_shift(scene) is not None


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


def trace_rays_refill(
    gen: torch.Generator,
    scene: SphereScene,
    source: Source,
    n_rays: int,
    cfg: TraceConfig = TraceConfig(),
    rays_per_lane: int = 8,
    handoff_frac: float = 0.0,
    *,
    device,
) -> tuple[TraceResult, torch.Tensor]:
    """Simple-mode trace through the refill kernel (the counterpart of
    ``trace_rays_refill``): ``n_rays`` a multiple of ``REFILL_LANES *
    rays_per_lane``, the philox stream, the seed words drawn from ``gen``.
    For exits ``seg_start`` is the cap crossing, on the escape line.

    ``handoff_frac > 0`` turns on the tail handoff: each unit leaves its
    loop once at most ``int(handoff_frac * REFILL_LANES * rays_per_lane)``
    of its rays are left, and the stragglers finish in the waves tracer
    (``_refill_handoff_continue``); their ``seg_start`` is the last wall
    point (the source for an exit at bounce 0), also on the escape line.

    Returns ``(TraceResult, n_overflow)``: the rays the continuation lost.
    The JAX function drops that count."""
    chunk = REFILL_LANES * rays_per_lane
    if n_rays % chunk:
        raise ValueError(f"n_rays must be a multiple of {chunk}")
    _check_simulate(scene, cfg)
    if scene.exact_rim:
        raise NotImplementedError(
            "the refill kernel traces simple-mode physics; exact-rim scenes "
            "go through trace_rays_fast (deferred rim post-pass)")
    thresh = int(handoff_frac * chunk)
    scene_vec, src_vec = kernel_operands(scene, source, device)
    res, live = refill(seed_pair(gen), scene_vec, src_vec, n_rays,
                       SurfaceModel(scene.surface_model),
                       int(scene.max_bounces), rays_per_lane, thresh,
                       rng="philox")
    n_overflow = torch.zeros((), dtype=torch.int32, device=device)
    if live is not None and n_rays:
        res, n_overflow = _refill_handoff_continue(
            split(gen, 1)[0], scene, cfg, res, live, src_vec, rays_per_lane,
            thresh, device)
    # slots that no ray reached (the iteration cap) are suspended
    return (res._replace(status=torch.where(res.status == RUNNING, SUSPENDED,
                                            res.status)), n_overflow)


def _refill_handoff_continue(gen, scene, cfg, res, live: LiveState, src_vec,
                             budget, thresh, device):
    """Finish the refill kernel's stragglers in the waves tracer
    (``trace_pallas.py::_refill_handoff_continue``).

    A slot still RUNNING is the lane's live ray (slot == its ``ray_idx``:
    it goes on from the live state) or one never started (a source ray).
    A unit leaves its loop with at most ``thresh`` rays left, so
    ``n_units * thresh`` lanes hold them all and the grouped compaction
    drops none; its drop count is added to the overflow all the same.

    As in the JAX package, a straggler's bounce budget restarts: the waves
    tracer caps its iterations at ``scene.max_bounces``, whatever bounces
    the ray made in the kernel, so a ray could reach about twice the cap.
    At the 4096 cap that needs a ray of more than 4096 bounces (P < 1e-15),
    the same slack as the deferred-rim continuation's.

    Returns ``(TraceResult, n_overflow)``."""
    from .trace_waves import trace_waves_from_state

    n = res.status.shape[0]
    per_unit = budget * REFILL_LANES
    cap = (n // per_unit) * thresh
    pending = res.status == RUNNING
    idx, dropped = nonzero_indices_grouped(pending, cap, n,
                                           group_capacity=cap)
    valid = idx < n
    safe = torch.clamp(idx, max=n - 1)
    unit = safe // per_unit
    rem = safe - unit * per_unit
    slot = rem // REFILL_LANES
    lane = unit * REFILL_LANES + (rem - slot * REFILL_LANES)
    is_live = valid & (slot == live.ray_idx[lane])

    def pick(plane, src_value):
        return torch.where(is_live, plane[lane], src_value)

    pos = Vec3(*(pick(p, src_vec[i]) for i, p in enumerate(live.pos)))
    dirv = Vec3(*(pick(d, src_vec[3 + i])
                  for i, d in enumerate(live.direction)))
    bounces0 = _i32(torch.where(is_live, live.bounces[lane], 0))
    status0 = _i32(torch.where(valid, RUNNING, ABSORBED))
    carry = (pos, dirv, pos, status0, bounces0,
             torch.zeros((cap,), dtype=torch.bool, device=device))
    cont, n_overflow = trace_waves_from_state(gen, scene, carry, cfg,
                                              device=device)
    return (_put_result(res, torch.where(valid, idx, n), cont),
            n_overflow + dropped)


def _slice(res: TraceResult, n: int) -> TraceResult:
    return TraceResult(res.status[:n], Vec3(*(v[:n] for v in res.last_point)),
                       Vec3(*(v[:n] for v in res.seg_start)),
                       Vec3(*(v[:n] for v in res.direction)),
                       res.n_bounces[:n])


def _kernel_padded(gen, scene, source, n_rays, cfg, *, device):
    """The simulate engine's main trace, ``(TraceResult, n_overflow)``:
    the refill kernel with the tail handoff for n >= ``REFILL_MIN`` (the
    batch padded up to a multiple of ``REFILL_LANES * _REFILL_BUDGET`` and
    cut back), the bounce kernel otherwise."""
    if n_rays >= REFILL_MIN:
        chunk = REFILL_LANES * _REFILL_BUDGET
        padded = -(-n_rays // chunk) * chunk
        res, ovf = trace_rays_refill(gen, scene, source, padded, cfg,
                                     rays_per_lane=_REFILL_BUDGET,
                                     handoff_frac=_REFILL_HANDOFF,
                                     device=device)
        return (res if padded == n_rays else _slice(res, n_rays)), ovf
    return (trace_rays_bounce(gen, scene, source, n_rays, cfg, device=device),
            torch.zeros((), dtype=torch.int32, device=device))


def trace_rays_fast(
    gen: torch.Generator,
    scene: SphereScene,
    source: Source,
    n_rays: int,
    cfg: TraceConfig = TraceConfig(),
    *,
    device,
) -> tuple[TraceResult, RimOverflow]:
    """The simulate engine: the bounce kernel, or the refill kernel and its
    straggler finish at n >= ``REFILL_MIN``, composed with the deferred rim
    post-pass for exact-rim scenes.  What the kernels cannot take
    (float64, a thick rim, a scatter callable, path history) runs the
    eager ``trace_rays``, as the JAX function falls back to its XLA kernel.

    Returns ``(TraceResult, RimOverflow)``; ``RimOverflow.total`` counts
    rim-capacity overflow and the rays the refill handoff's continuation
    lost.  The JAX function drops both counts; the port returns them so a
    caller can check them."""
    if not kernel_applicable(scene, cfg):
        return (trace_rays(gen, scene, source, n_rays, cfg, device=device),
                no_overflow(device))
    if not scene.exact_rim:
        res, ovf = _kernel_padded(gen, scene, source, n_rays, cfg,
                                  device=device)
        return res, RimOverflow(total=ovf, grouped_drops=torch.zeros_like(ovf))
    shift = rim_deferred_capacity_shift(scene)
    return trace_rays_rim_deferred(gen, scene, source, n_rays, cfg,
                                   capacity_shift=shift,
                                   main_tracer=_kernel_padded, device=device)
