"""The kernels' wrappers, their plain PyTorch versions, and the simulate
engine's traces built on them — the counterpart of
``altair_tpu/core/trace_pallas.py`` (``_bounce_kernel``,
``trace_rays_pallas``, ``_refill_kernel``, ``trace_rays_refill``; its
``trace_rays_fast`` is ``core/route.py``'s).

``bounce``, ``refill`` and ``finish`` are the wrappers.  On a CUDA tensor
each launches its hand-written kernel (``csrc/bounce.cu``,
``csrc/refill.cu``, ``csrc/finish.cu``, built at first use by ``_build``)
or raises; on a CPU tensor it runs its plain version (``bounce_plain``,
``refill_plain``, ``finish_plain``), the same computation in plain tensor
ops.  There is no fallback from one to the other.

Routes, as in the JAX package (chosen by ``route.plan``): batches of
n >= ``REFILL_MIN`` run the refill kernel with ``_REFILL_BUDGET`` rays per
lane and the tail handoff at ``_REFILL_HANDOFF``
(``trace_rays_refill_padded``), whose stragglers finish in the finish
kernel; smaller batches run the bounce kernel.  The finish kernel also
runs the deferred rim post-pass's continuation (``finish_from_state``),
which the JAX package runs as an XLA loop, and traces thick-rim scenes
from the source in one launch (``trace_rays_finish``), where the JAX
package runs its in-loop exact-rim ``trace_rays``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import SphereScene, Source, SurfaceModel, TraceConfig
from ..io.profiling import count, host_bool, span
from . import _build
from .geometry import Vec3
from .compact import nonzero_indices_grouped
from .trace import (ABSORBED, EXITED, RUNNING, SUSPENDED, RimOverflow,
                    TraceResult, _i32, _put_result, draw_seeds,
                    no_overflow, split)

# per kernel: its source and the Pallas kernel it replaces
KERNELS = {
    "bounce": ("altair_tpu_torch/csrc/bounce.cu",
               "altair_tpu/core/trace_pallas.py:247"),
    "refill": ("altair_tpu_torch/csrc/refill.cu",
               "altair_tpu/core/trace_pallas.py:399"),
    "finish": ("altair_tpu_torch/csrc/finish.cu", None),
    # the Plucker scorer's kernel; its wrapper is core/score.py's
    "score": ("altair_tpu_torch/csrc/score.cu", None),
}

# threads of one finish block (csrc/finish.cu THREADS)
FINISH_THREADS = 256
# lanes of one refill unit: a warp's pool and the handoff unit
# (csrc/refill.cu LANES)
REFILL_LANES = 128
# threads that share one unit's pool in the kernel: a warp
REFILL_THREADS = 32
# batches at least this big run the refill kernel (the JAX package's
# constants, trace_pallas.py:933-942; module constants so a test can lower
# them: route.plan reads REFILL_MIN at each call)
REFILL_MIN = 1 << 20
_REFILL_BUDGET = 4
_REFILL_HANDOFF = 0.01


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


def rim_operand(scene: SphereScene, device) -> torch.Tensor:
    """The finish kernel's rim operand, float32[2] on ``device``:
    ``[cos(theta_max), outer_radius]``, cos(theta_max) as
    ``kernel_operands`` computes it."""
    f = np.float32
    cos_tm = np.cos(np.deg2rad(f(scene.theta_max_deg)))
    return torch.from_numpy(np.array([cos_tm, f(scene.outer_radius)],
                                     np.float32)).to(device)


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
    dx, dy, dz = f(source.dir_x), f(source.dir_y), f(source.dir_z)
    dnorm = np.sqrt(dx * dx + dy * dy + dz * dz)
    src_vec = np.array([f(source.x), f(source.y), f(source.z),
                        dx / dnorm, dy / dnorm, dz / dnorm, 0.0, 0.0],
                       np.float32)
    return (torch.from_numpy(_scene_array(scene)).to(device),
            torch.from_numpy(src_vec).to(device))


def _scene_array(scene: SphereScene) -> np.ndarray:
    """``kernel_operands``' scene_vec as a numpy float32[8]."""
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
    return np.array([
        r, r * np.cos(theta_max), f(scene.reflectance), f(scene.world_half),
        f(scene.exit_port_z), f(float(scene.max_bounces)), m0, m1,
    ], np.float32)


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
    while it < max_bounces and host_bool((status == RUNNING).any()):
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
        with span("kernel.bounce", n=n), torch.cuda.device(dev):
            err = fn(scene_vec.data_ptr(), src_vec.data_ptr(),
                     int(seed[0]) & _M32, int(seed[1]) & _M32,
                     int(max_bounces), int(model), int(rng == "hash"), n,
                     *[o.data_ptr() for o in out],
                     torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"bounce kernel launch failed: CUDA error {err}")
        count("kernel.bounce.launches")
        count("kernel.bounce.rays", n)
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
# The finish kernel: a mid-flight ray state run to each ray's death
# ---------------------------------------------------------------------------

def _check_finish_args(seed, scene_vec, rim_vec, state, model, max_iters):
    if SurfaceModel(model) not in N_DRAWS:
        raise NotImplementedError(f"no finish kernel for law {model!r}")
    if max_iters < 0:
        raise ValueError("max_iters must be non-negative")
    if len(seed) != 2:
        raise ValueError("seed must be a pair of 32-bit words")
    for name, v, k in (("scene_vec", scene_vec, 8), ("rim_vec", rim_vec, 2)):
        if v.dtype != torch.float32 or v.shape != (k,):
            raise ValueError(f"{name} must be float32[{k}], got "
                             f"{v.dtype}{list(v.shape)}")
        if v.device != scene_vec.device:
            raise ValueError(f"{name} must be on the device of scene_vec")
    pos, direction, prev, status, bounces, in_gap = state
    n = status.shape[0]
    planes = [*pos, *direction, *prev]
    for name, v, dt in ([("position, direction or prev", p, torch.float32)
                         for p in planes]
                        + [("status", status, torch.int32),
                           ("bounces", bounces, torch.int32),
                           ("in_gap", in_gap, torch.bool)]):
        if v.dtype != dt or v.shape != (n,) or v.device != scene_vec.device:
            raise ValueError(f"{name} must be {dt}[{n}] on "
                             f"{scene_vec.device}, got {v.dtype}"
                             f"{list(v.shape)} on {v.device}")


def finish_plain(seed, scene_vec, rim_vec, state, model, max_iters: int,
                 exact_rim: bool) -> TraceResult:
    """The finish kernel's computation in plain tensor ops, on the device
    of ``scene_vec``: each step runs the lanes still RUNNING, with the
    step of ``csrc/finish.cu`` in the same float operations, and drops the
    lanes it finished (a lane's draws are keyed by (lane, step), so which
    lanes share a step changes nothing).  A lane not RUNNING at entry
    comes back as it went in."""
    from .geometry import cone_crossing_t, cone_face_normal, sphere_crossing_t

    _check_finish_args(seed, scene_vec, rim_vec, state, model, max_iters)
    model = SurfaceModel(model)
    radius, cos_cap, reflectance, world_half = (scene_vec[0], scene_vec[1],
                                                scene_vec[2], scene_vec[3])
    m0, m1 = scene_vec[6], scene_vec[7]
    inv_r = 1.0 / radius
    cos_tm, r_out = rim_vec[0], rim_vec[1]
    nd = N_DRAWS[model]
    seed0, seed1 = int(seed[0]) & _M32, int(seed[1]) & _M32
    inf = 1e30

    pos, direction, prev, status, bounces, in_gap = state
    # the output planes start as the entry state; a lane's fields are
    # written when it finishes
    out = [t.clone() for t in (status, *pos, *prev, *direction, bounces)]
    w = torch.nonzero(status == RUNNING).flatten()
    px, py, pz, dx, dy, dz, sx, sy, sz = (t[w] for t in (*pos, *direction,
                                                         *prev))
    st, nb = status[w], bounces[w]
    g = in_gap[w] & exact_rim

    it = 0
    while it < max_iters and w.numel():
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
        p, d = Vec3(px, py, pz), Vec3(dx, dy, dz)
        if exact_rim:
            interior = ~g
            o = Vec3.where(g, p, Vec3(qx, qy, qz))
            s_rim = cone_crossing_t(o, d, cos_tm, radius, r_out, inf)
            s_in = sphere_crossing_t(p, d, radius, inf)
            s_out = sphere_crossing_t(p, d, r_out, inf)
            gap_cone = g & (s_rim < s_in) & (s_rim < s_out)
            gap_enter = g & ~gap_cone & (s_in < s_out)
            gap_exit = g & ~gap_cone & ~gap_enter & (s_out < inf)
            stuck = g & ~gap_cone & ~gap_enter & ~gap_exit
            rim = (interior & escaped & (s_rim < inf)) | gap_cone
            wall = interior & ~escaped
            exits = (interior & escaped & ~rim) | gap_exit
            rim_pt = o + d.scale(s_rim)
            e = p + d.scale(s_in)
            enter = e.scale(radius * torch.rsqrt(e.norm2()))
        else:
            rim = gap_enter = stuck = torch.zeros_like(escaped)
            wall, exits = ~escaped, escaped
            rim_pt = enter = p
        bounce = rim | wall
        u = _philox_draws(w, it, nd, seed0, seed1)
        survive = u[0] < reflectance
        normal = Vec3(-qx * inv_r, -qy * inv_r, -qz * inv_r)
        if exact_rim:
            normal = Vec3.where(rim, cone_face_normal(rim_pt), normal)
        ndx, ndy, ndz = _scatter_dir(model, m0, m1, u, *normal, dx, dy, dz)
        bx, by, bz = _box_flight(exits, px, py, pz, dx, dy, dz, world_half)

        st = _i32(torch.where(exits, EXITED, torch.where(
            bounce & ~survive, ABSORBED,
            torch.where(stuck, SUSPENDED, RUNNING))))
        moved = ~stuck
        sx, sy, sz = (torch.where(moved, a, s_) for a, s_ in
                      ((px, sx), (py, sy), (pz, sz)))
        px, py, pz = (torch.where(exits, bc, torch.where(
            rim, rc, torch.where(gap_enter, ec, torch.where(moved, qc, pc))))
            for bc, rc, ec, qc, pc in ((bx, rim_pt.x, enter.x, qx, px),
                                       (by, rim_pt.y, enter.y, qy, py),
                                       (bz, rim_pt.z, enter.z, qz, pz)))
        turn = bounce & survive
        dx, dy, dz = (torch.where(turn, a, d_) for a, d_ in
                      ((ndx, dx), (ndy, dy), (ndz, dz)))
        nb = nb + _i32(bounce)
        g = rim & survive
        it += 1

        done = st != RUNNING
        if it == max_iters or host_bool(done.any()):
            if it == max_iters:
                done = torch.ones_like(done)
                st = torch.where(st == RUNNING, SUSPENDED, st)
            wd = w[done]
            for plane, v in zip(out, (st, px, py, pz, sx, sy, sz, dx, dy,
                                      dz, nb)):
                plane[wd] = v[done]
            keep = ~done
            w, px, py, pz, dx, dy, dz, sx, sy, sz, st, nb, g = (
                v[keep] for v in (w, px, py, pz, dx, dy, dz, sx, sy, sz, st,
                                  nb, g))
    if w.numel():       # max_iters == 0: every running lane is suspended
        out[0][w] = SUSPENDED
    (st, lx, ly, lz, sx, sy, sz, dx, dy, dz, nb) = out
    return TraceResult(st, Vec3(lx, ly, lz), Vec3(sx, sy, sz),
                       Vec3(dx, dy, dz), nb)


def finish_lanes_per_thread(n: int, slots: int) -> int:
    """The finish kernel's pool depth for a buffer of ``n`` lanes on a card
    that keeps ``slots`` of the kernel's threads resident: ceil(n / slots)
    lanes a thread, so 1 (one lane a thread, every lane started at once)
    at or below the slots.  At a depth above 1 the launch is the resident
    grid, and a thread takes the next lane when its own stops."""
    return max(1, -(-n // slots))


def finish_grid_threads(n: int, slots: int) -> int:
    """The threads of a finish launch over ``n`` lanes: one a lane,
    rounded up to whole blocks, at depth 1; the resident grid (``slots``,
    whole blocks) above it."""
    if finish_lanes_per_thread(n, slots) > 1:
        return slots
    return -(-n // FINISH_THREADS) * FINISH_THREADS


@functools.cache
def _finish_lib() -> ctypes.CDLL:
    lib = _build.load("finish")
    lib.altair_finish.argtypes = ([ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_uint32, ctypes.c_uint32,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_longlong, ctypes.c_longlong]
                                  + [ctypes.c_void_p] * 24)
    lib.altair_finish.restype = ctypes.c_int
    lib.altair_finish_slots.argtypes = [ctypes.c_int, ctypes.c_int,
                                        ctypes.POINTER(ctypes.c_longlong)]
    lib.altair_finish_slots.restype = ctypes.c_int
    if lib.altair_finish_threads() != FINISH_THREADS:
        raise RuntimeError("csrc/finish.cu's block is not "
                           f"{FINISH_THREADS} threads")
    return lib


@functools.cache
def finish_slots(device: torch.device, model: int, exact_rim: bool) -> int:
    """The threads the CUDA ``device`` keeps resident at once for the
    finish kernel's pooled instantiation of the law ``model`` and the
    physics ``exact_rim`` (its occupancy times the SMs)."""
    out = ctypes.c_longlong(0)
    with torch.cuda.device(device):
        err = _finish_lib().altair_finish_slots(int(model), int(exact_rim),
                                                ctypes.byref(out))
    if err != 0 or out.value < FINISH_THREADS:
        raise RuntimeError("finish kernel occupancy query failed: CUDA "
                           f"error {err}, {out.value} threads")
    return out.value


def _finish_cuda(seed, scene_vec, rim_vec, state, model, max_iters,
                 exact_rim, entry):
    dev = scene_vec.device
    pos, direction, prev, status, bounces, in_gap = state
    n = status.shape[0]
    out = ([torch.empty((n,), dtype=torch.int32, device=dev)]
           + [torch.empty((n,), dtype=torch.float32, device=dev)
              for _ in range(9)]
           + [torch.empty((n,), dtype=torch.int32, device=dev)])
    if n:
        # the compactions hand over strided column views: the kernel reads
        # dense planes
        planes = [t.contiguous() for t in (*pos, *direction, *prev, status,
                                           bounces, in_gap)]
        fn = _finish_lib().altair_finish
        slots = finish_slots(dev, int(model), bool(exact_rim))
        depth = finish_lanes_per_thread(n, slots)
        with (span("kernel.finish", n=n, exact_rim=bool(exact_rim),
                   entry=entry, lanes_per_thread=depth),
              torch.cuda.device(dev)):
            err = fn(scene_vec.data_ptr(), rim_vec.data_ptr(),
                     int(seed[0]) & _M32, int(seed[1]) & _M32,
                     int(max_iters), int(model), int(bool(exact_rim)), n,
                     finish_grid_threads(n, slots),
                     *[t.data_ptr() for t in planes],
                     *[o.data_ptr() for o in out],
                     torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"finish kernel launch failed: CUDA error {err}")
        count("kernel.finish.launches")
        count("kernel.finish.rays", n)
        count("kernel.finish.pooled", int(depth > 1))
    (status, lx, ly, lz, sx, sy, sz, dx, dy, dz, bounces) = out
    return TraceResult(status, Vec3(lx, ly, lz), Vec3(sx, sy, sz),
                       Vec3(dx, dy, dz), bounces)


def finish(seed, scene_vec, rim_vec, state, model, max_iters: int,
           exact_rim: bool, *, entry: str = "state") -> TraceResult:
    """Run the mid-flight ray state ``state`` (the bounce-step carry
    ``(pos, direction, prev, status, bounces, in_gap)`` of
    ``trace.make_bounce_step``: float32, int32 and bool planes of one
    width) to each ray's death under one static scatter law, at most
    ``max_iters`` steps from the entry state, then SUSPENDED.

    ``exact_rim`` picks the step's physics: the exact-rim branch of
    ``make_bounce_step`` (the rim cone, the gap between the shell radii)
    or its simple branch.  Exits follow the eager step's convention: the
    segment start is the last wall or rim point, the last point the box
    point flown to from it.  ``seed``: two 32-bit words of the philox
    stream, counter (lane, step from entry, draw group); ``scene_vec`` as
    from ``kernel_operands``, ``rim_vec`` from ``rim_operand``, on the
    device to run on.  A CUDA ``scene_vec`` launches the CUDA kernel; a
    CPU one runs ``finish_plain``.  ``entry`` names the launch on its
    ``kernel.finish`` span: ``"source"`` for a buffer of fresh source rays
    (``trace_rays_finish``), ``"state"`` for rays already in flight."""
    _check_finish_args(seed, scene_vec, rim_vec, state, model, max_iters)
    if scene_vec.device.type == "cuda":
        return _finish_cuda(seed, scene_vec, rim_vec, state, model,
                            max_iters, exact_rim, entry)
    if scene_vec.device.type == "cpu":
        return finish_plain(seed, scene_vec, rim_vec, state, model,
                            max_iters, exact_rim)
    raise ValueError(f"no finish kernel for device {scene_vec.device}")


def finish_from_state(gen: torch.Generator, scene: SphereScene, state, *,
                      exact_rim: bool) -> TraceResult:
    """``finish`` for a scene the kernels take: the operands from
    ``scene`` on the state's device, the seed words drawn from the CPU key
    ``gen``, at most ``scene.max_bounces`` steps."""
    dev = state[3].device
    scene_vec = torch.from_numpy(_scene_array(scene)).to(dev)
    return finish(seed_pair(gen), scene_vec, rim_operand(scene, dev), state,
                  SurfaceModel(scene.surface_model), int(scene.max_bounces),
                  exact_rim)


def trace_rays_finish(
    gen: torch.Generator,
    scene: SphereScene,
    source: Source,
    n_rays: int,
    cfg: TraceConfig = TraceConfig(),
    *,
    device,
) -> tuple[TraceResult, RimOverflow]:
    """Trace ``n_rays`` from ``source`` with the in-loop exact-rim physics
    of ``trace_rays`` in one launch of the finish kernel: the bounce-step
    carry built at the source (every lane at the source point with the
    normalised source direction, ``prev`` the source, RUNNING, no bounce,
    none in the gap), at most ``scene.max_bounces`` steps, the seed words
    drawn from the CPU key ``gen``.  The route of thick-rim scenes, whose
    rim the deferred post-pass cannot take (``route.plan``).

    Returns ``(TraceResult, RimOverflow)``; the kernel drops no ray, so
    the overflow is zero."""
    _check_simulate(scene, cfg)
    if not scene.exact_rim:
        raise NotImplementedError(
            "trace_rays_finish traces exact-rim scenes; simple-mode scenes "
            "go through trace_rays_fast")
    scene_vec, src_vec = kernel_operands(scene, source, device)
    px, py, pz, dx, dy, dz = src_vec[:6, None].expand(6, n_rays) \
        .contiguous().unbind(0)
    pos = Vec3(px, py, pz)
    zeros = torch.zeros((n_rays,), dtype=torch.int32, device=device)
    state = (pos, Vec3(dx, dy, dz), pos, zeros, zeros,
             torch.zeros((n_rays,), dtype=torch.bool, device=device))
    res = finish(seed_pair(gen), scene_vec, rim_operand(scene, device), state,
                 SurfaceModel(scene.surface_model), int(scene.max_bounces),
                 exact_rim=True, entry="source")
    return res, no_overflow(device)


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
        if host_bool(leave.any()):
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
        with span("kernel.refill", n=n), torch.cuda.device(dev):
            err = fn(scene_vec.data_ptr(), src_vec.data_ptr(),
                     int(seed[0]) & _M32, int(seed[1]) & _M32,
                     int(max_bounces), int(model), int(rng == "hash"), n,
                     int(budget), int(thresh), *[o.data_ptr() for o in out],
                     *live_ptrs, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"refill kernel launch failed: CUDA error {err}")
        count("kernel.refill.launches")
        count("kernel.refill.rays", n)
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
    """True when the kernels take the scene (``pallas_applicable`` without
    the TPU test and the rim): a static law, float32 and no history."""
    return (_model_supported(scene) and not cfg.keep_history
            and cfg.dtype == torch.float32)


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
    of its rays are left, and the stragglers finish in the finish kernel
    (``_refill_handoff_continue``); their ``seg_start`` is the last wall
    point (the source for an exit at bounce 0), also on the escape line.

    Returns ``(TraceResult, n_overflow)``: the rays the handoff's
    compaction lost (none: its buffer holds every straggler).  The JAX
    function drops that count."""
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
            split(gen, 1)[0], scene, res, live, src_vec, rays_per_lane,
            thresh, device)
    # slots that no ray reached (the iteration cap) are suspended
    return (res._replace(status=torch.where(res.status == RUNNING, SUSPENDED,
                                            res.status)), n_overflow)


def _refill_handoff_continue(gen, scene, res, live: LiveState, src_vec,
                             budget, thresh, device):
    """Finish the refill kernel's stragglers in one launch of the finish
    kernel, simple-mode physics (``trace_pallas.py::_refill_handoff_continue``
    runs the waves tracer there).

    A slot still RUNNING is the lane's live ray (slot == its ``ray_idx``:
    it goes on from the live state) or one never started (a source ray).
    A unit leaves its loop with at most ``thresh`` rays left, so
    ``n_units * thresh`` lanes hold them all and the grouped compaction
    drops none; its drop count is the overflow all the same.  The kernel
    loses no ray.

    As in the JAX package, a straggler's bounce budget restarts: the finish
    caps its steps at ``scene.max_bounces``, whatever bounces the ray made
    in the refill kernel, so a ray could reach about twice the cap.  At the
    4096 cap that needs a ray of more than 4096 bounces (P < 1e-15), the
    same slack as the deferred-rim continuation's.

    The span ``trace.straggler``, with the lane capacity ``cap``.  Returns
    ``(TraceResult, n_overflow)``."""
    n = res.status.shape[0]
    per_unit = budget * REFILL_LANES
    cap = (n // per_unit) * thresh
    with span("trace.straggler", cap=cap):
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
        cont = finish_from_state(gen, scene, carry, exact_rim=False)
        return _put_result(res, torch.where(valid, idx, n), cont), dropped


def _slice(res: TraceResult, n: int) -> TraceResult:
    return TraceResult(res.status[:n], Vec3(*(v[:n] for v in res.last_point)),
                       Vec3(*(v[:n] for v in res.seg_start)),
                       Vec3(*(v[:n] for v in res.direction)),
                       res.n_bounces[:n])


def trace_rays_refill_padded(
    gen: torch.Generator,
    scene: SphereScene,
    source: Source,
    n_rays: int,
    cfg: TraceConfig = TraceConfig(),
    *,
    device,
) -> tuple[TraceResult, torch.Tensor]:
    """The simulate engine's large-batch trace: ``trace_rays_refill`` with
    ``_REFILL_BUDGET`` rays a lane and the tail handoff at
    ``_REFILL_HANDOFF``, over the batch padded up to a multiple of
    ``REFILL_LANES * _REFILL_BUDGET`` and cut back to ``n_rays``.  Returns
    ``(TraceResult, n_overflow)``."""
    chunk = REFILL_LANES * _REFILL_BUDGET
    padded = -(-n_rays // chunk) * chunk
    res, ovf = trace_rays_refill(gen, scene, source, padded, cfg,
                                 rays_per_lane=_REFILL_BUDGET,
                                 handoff_frac=_REFILL_HANDOFF, device=device)
    return (res if padded == n_rays else _slice(res, n_rays)), ovf
