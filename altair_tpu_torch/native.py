"""ctypes bindings for the native CPU engine tier (``native/``) — a copy of
``altair_tpu/native.py`` bound to the port's ``config`` types.

The compiled library is an independent implementation of the bounce loop and
the trace-once scorer (see ``native/altair_native.cpp``) — the rebuild's
equivalent of the reference's compiled ROBAST/ROOT tier.  It is optional:
``available()`` is False when the shared library hasn't been built
(``make -C native``), and nothing on a GPU path depends on it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os

import numpy as np

from .config import DetectorGrid, SphereScene, Source

_LIB_NAMES = ("libaltair_native.so",)
_SEARCH_DIRS = (
    os.path.join(os.path.dirname(__file__), "..", "native"),
    os.path.join(os.path.dirname(__file__), "_native"),
)

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    for d in _SEARCH_DIRS:
        for name in _LIB_NAMES:
            path = os.path.abspath(os.path.join(d, name))
            if os.path.exists(path):
                lib = ctypes.CDLL(path)
                _bind(lib)
                _lib = lib
                return lib
    return None


def _bind(lib):
    c_ll = ctypes.c_longlong
    c_d = ctypes.c_double
    c_u64 = ctypes.c_uint64
    p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    p_f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")

    lib.altair_trace.restype = c_ll
    lib.altair_trace.argtypes = [
        c_ll, c_u64,
        c_d, c_d, c_d, c_d, c_d, c_ll,
        c_d, c_d, c_d, c_d, c_d, c_d,
        p_i32, p_f64, p_f64, p_f64, p_i32,
    ]
    lib.altair_trace_ex.restype = c_ll
    lib.altair_trace_ex.argtypes = [
        c_ll, c_u64,
        c_d, c_d, c_d, c_d, c_d, c_d, c_ll, ctypes.c_int,
        c_d, c_d, c_d, c_d, c_d, c_d,
        p_i32, p_f64, p_f64, p_f64, p_i32,
    ]
    lib.altair_trace_direct.restype = c_ll
    lib.altair_trace_direct.argtypes = [
        c_ll, c_u64,
        c_d, c_d, c_d, c_d, c_d, c_ll,
        c_d, c_d, c_d, c_d, c_d, c_d,
        p_i32, p_f64, p_f64, p_f64, p_i32,
    ]
    lib.altair_score_grid.restype = None
    lib.altair_score_grid.argtypes = [
        c_ll, p_f64, p_f64, p_u8,
        c_ll, p_f64, p_f64, c_d, p_i32,
    ]
    lib.altair_detector_grid.restype = None
    lib.altair_detector_grid.argtypes = [
        c_ll, c_ll, c_d, c_d, c_d, c_d, c_d, c_d, p_f64, p_f64,
    ]
    lib.altair_num_threads.restype = ctypes.c_int
    lib.altair_num_threads.argtypes = []


def available() -> bool:
    return _load() is not None


def num_threads() -> int:
    lib = _load()
    return lib.altair_num_threads() if lib else 0


@dataclasses.dataclass
class NativeTraceResult:
    status: np.ndarray       # [N] int32, same codes as core.trace
    last_point: np.ndarray   # [N, 3] float64
    seg_start: np.ndarray    # [N, 3]
    direction: np.ndarray    # [N, 3]
    n_bounces: np.ndarray    # [N] int32
    n_exited: int


def trace_rays_native(scene: SphereScene, source: Source, n_rays: int,
                      seed: int = 0,
                      exact_rim: bool | None = None) -> NativeTraceResult:
    """Run the compiled bounce loop (Lambertian walls only — the native tier
    implements the production scatter law; other BRDFs live on the
    torch paths).

    ``exact_rim=True`` models the shell's conical rim face (theta ==
    theta_max, r in [inner, outer]): escaping rays that clip it reflect
    Lambertian (+ roulette) instead of passing through — ROBAST's exact
    TGeoSphere behaviour.  ~4.6% of escaping rays clip the rim at port 170.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "native library not built — run `make -C native`")
    if callable(scene.surface_model) or int(scene.surface_model) != 0:
        raise NotImplementedError(
            "native tracer implements the Lambertian production scene")
    if exact_rim is None:
        exact_rim = bool(scene.exact_rim)
    status = np.empty(n_rays, np.int32)
    last = np.empty((n_rays, 3), np.float64)
    seg = np.empty((n_rays, 3), np.float64)
    dirs = np.empty((n_rays, 3), np.float64)
    bounces = np.empty(n_rays, np.int32)
    n_exit = lib.altair_trace_ex(
        n_rays, seed,
        float(scene.inner_radius), float(scene.outer_radius),
        float(scene.theta_max_deg),
        float(scene.reflectance), float(scene.world_half),
        float(scene.exit_port_z), int(scene.max_bounces),
        1 if exact_rim else 0,
        float(source.x), float(source.y), float(source.z),
        float(source.dir_x), float(source.dir_y), float(source.dir_z),
        status, last.reshape(-1), seg.reshape(-1), dirs.reshape(-1), bounces)
    return NativeTraceResult(status, last, seg, dirs, bounces, int(n_exit))


def trace_rays_native_direct(scene: SphereScene, source: Source,
                             n_rays: int, seed: int = 0) -> NativeTraceResult:
    """Run the compiled closed-form direct sampler — the native fp64
    cross-check of ``core/trace_direct.py`` (independent RNG and
    arithmetic; same simple-mode Lambertian chain law).  Exact-rim scenes
    must use ``trace_rays_native`` (the native tier has no deferred rim
    post-pass)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "native library not built — run `make -C native`")
    if callable(scene.surface_model) or int(scene.surface_model) != 0:
        raise NotImplementedError(
            "direct sampling requires the Lambertian production scene")
    status = np.empty(n_rays, np.int32)
    last = np.empty((n_rays, 3), np.float64)
    seg = np.empty((n_rays, 3), np.float64)
    dirs = np.empty((n_rays, 3), np.float64)
    bounces = np.empty(n_rays, np.int32)
    n_exit = lib.altair_trace_direct(
        n_rays, seed,
        float(scene.inner_radius), float(scene.theta_max_deg),
        float(scene.reflectance), float(scene.world_half),
        float(scene.exit_port_z), int(scene.max_bounces),
        float(source.x), float(source.y), float(source.z),
        float(source.dir_x), float(source.dir_y), float(source.dir_z),
        status, last.reshape(-1), seg.reshape(-1), dirs.reshape(-1), bounces)
    return NativeTraceResult(status, last, seg, dirs, bounces, int(n_exit))


def detector_grid_native(grid: DetectorGrid, exit_port_z: float = -100.0):
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "native library not built — run `make -C native`")
    P = grid.n_positions
    centers = np.empty((P, 3), np.float64)
    normals = np.empty((P, 3), np.float64)
    lib.altair_detector_grid(
        grid.n_theta, grid.n_phi, grid.theta_lo, grid.theta_hi,
        grid.phi_lo, grid.phi_hi, grid.radius, exit_port_z,
        centers.reshape(-1), normals.reshape(-1))
    return centers, normals


def fluxmap_trace_once_native(res: NativeTraceResult, grid: DetectorGrid,
                              exit_port_z: float = -100.0) -> np.ndarray:
    """Score the full grid with the compiled scorer; returns
    [n_theta, n_phi] int32 counts (same contract as ``core.score.fluxmap_trace_once``)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "native library not built — run `make -C native`")
    centers, normals = detector_grid_native(grid, exit_port_z)
    mask = ((res.status == 1) & (res.last_point[:, 2] < exit_port_z)).astype(
        np.uint8)
    counts = np.empty(grid.n_positions, np.int32)
    lib.altair_score_grid(
        len(mask), np.ascontiguousarray(res.last_point).reshape(-1),
        np.ascontiguousarray(res.direction).reshape(-1), mask,
        grid.n_positions, centers.reshape(-1), normals.reshape(-1),
        grid.width / 2.0, counts)
    return counts.reshape(grid.n_theta, grid.n_phi)
