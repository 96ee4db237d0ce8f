"""SPMD execution over several devices — the counterpart of
``altair_tpu/parallel/mesh.py`` on ``torch.distributed``.

What the layer computes: every rank traces ``n / world_size`` rays from
``fold_in(key, rank)``, scores its own shard, and one sum over the ranks
merges the counts.  Tracing is embarrassingly parallel, so that sum (a few
hundred KB per sweep) is the only traffic between devices.

The JAX module is a single controller: one process builds a device mesh and
``shard_map`` splits the ray axis over it.  PyTorch's idiom is SPMD: every
process holds one device and calls the same function with the same
arguments, and the "mesh" is a small handle on a process group (``Mesh``).
Start the processes with ``torchrun`` (or any launcher that sets its
variables), call ``init_distributed()`` and ``make_mesh()`` in each
(``device="cpu"`` to both for a run on the CPU: the default is the card,
and no card is an error), and pass the mesh to a ``sharded_*`` route or
to a sweep's ``mesh=``.

What follows from that difference:

* the key is a CPU ``torch.Generator``; every rank must build the same one
  (same seed, nothing drawn from it) before it calls a route.  ``fold_in``
  reads the key's state and does not advance it;
* ``sharded_trace`` and ``sharded_distribution`` return this rank's shard
  of the per-ray arrays, where the JAX functions return one global array
  sharded over the devices;
* the port's tracers return their overflow counts (rim capacity, waves,
  refill handoff) and its sweeps raise on a nonzero one.  A route reduces
  every overflow count with the result, then tests it, so all ranks raise
  together or none does; argument checks come before the first collective;
* the trace-once routes score the compacted exit subset
  (``fluxmap_trace_once_compact``), as the port's single-device sweep does;
* ``_pick_tracer`` has no counterpart: scenes are concrete here, so
  ``trace_rays_auto`` dispatches (its ``waves_threshold`` argument is where
  the JAX module's ``WAVES_THRESHOLD`` lives); ``scene_spec`` and
  ``_result_spec`` are ``shard_map`` plumbing and have none either.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

from ..config import (DetectorGrid, SphereScene, Source, TraceConfig,
                      validate)
from ..core.geometry import detector_position
from ..core.score import (binomial_cells_from_counts, binomial_pos_chunk,
                          exit_angle_histogram, exit_capacity,
                          exit_directions, fluxmap_retrace_counts,
                          fluxmap_trace_once, fluxmap_trace_once_compact,
                          hits_insphere_disks, hits_single_detector,
                          z_angle_histogram)
from ..core.trace import TraceResult, fold_in, split
from ..core.trace_waves import trace_rays_auto

_SUMMED = (torch.int32, torch.int64)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in a 1-D mesh over the ray axis: its ``rank``
    among ``world_size`` processes, the ``device`` it traces on, and the
    process group (None: the default group) its collectives run over.

    Several ranks may share one card over the ``gloo`` backend (NCCL
    refuses two ranks on one card); gloo takes CUDA tensors as they are."""

    rank: int
    world_size: int
    device: torch.device
    group: object = None

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)

    def _src(self) -> int:
        """Rank 0 of the group, as a rank of the default group."""
        return 0 if self.group is None else dist.get_global_rank(self.group, 0)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of the integer tensor ``t`` over the ranks, on every
        rank.  Always a collective call, at world size 1 too."""
        if t.dtype not in _SUMMED:
            raise TypeError(f"counts are summed as int32 or int64, not "
                            f"{t.dtype}")
        t = t.contiguous()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's value of ``t`` on every rank."""
        t = t.contiguous()
        dist.broadcast(t, src=self._src(), group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (equal shapes) stacked in rank order,
        ``[world_size, *t.shape]``, on every rank."""
        parts = [torch.empty_like(t, memory_format=torch.contiguous_format)
                 for _ in range(self.world_size)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.stack(parts)

    def on_rank0(self, fn):
        """Call ``fn()`` on rank 0 and return its (picklable) result on
        every rank.  The other ranks wait for it, so a file that ``fn``
        writes is there when they go on.  If ``fn`` raises, every rank
        raises after the broadcast: no rank is left waiting for a value
        that never comes."""
        box = [None]
        if self.rank == 0:
            try:
                box[0] = (True, fn())
            except Exception as exc:
                box[0] = (False, f"{type(exc).__name__}: {exc}")
        dist.broadcast_object_list(box, src=self._src(), group=self.group,
                                   device=(self.device
                                           if self.backend == "nccl"
                                           else torch.device("cpu")))
        ok, value = box[0]
        if not ok:
            raise RuntimeError(f"rank 0 failed: {value}")
        return value

    def check_device(self, device) -> None:
        """Raise unless ``device`` names the mesh's device."""
        d = torch.device(device)
        if d.type != self.device.type or (
                d.index is not None and d.index != self.device.index):
            raise ValueError(f"device {d} is not the mesh's device "
                             f"{self.device}")


def _device(device) -> torch.device:
    """``device`` (None: ``cuda``) as a device that is there: a CUDA
    device that is not is an error, never a fall-back to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"no CUDA device is visible for {device}; "
                               "name device='cpu' to run on the CPU")
        if device.index is not None \
                and device.index >= torch.cuda.device_count():
            raise RuntimeError(f"{device} is not there "
                               f"({torch.cuda.device_count()} visible)")
    return device


def init_distributed(backend: str | None = None,
                     init_method: str | None = None,
                     rank: int | None = None,
                     world_size: int | None = None,
                     store=None,
                     timeout: datetime.timedelta | None = None,
                     device=None) -> None:
    """Join this process to the process group: call once per process
    before ``make_mesh``.

    With no arguments it reads what ``torchrun`` sets (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``);
    ``init_method``/``store`` with ``rank`` and ``world_size`` name another
    rendezvous.  ``device`` is where this process will trace (None:
    ``cuda``, and an error where there is none); ``backend`` defaults to
    ``nccl`` for a CUDA device and to ``gloo`` for the CPU.  Under ``nccl``
    the process takes the CUDA device ``LOCAL_RANK`` (0 when unset).
    ``timeout`` bounds the rendezvous and, for gloo, every collective."""
    if rank is None and store is None and init_method is None \
            and "RANK" not in os.environ:
        raise RuntimeError(
            "init_distributed() found no RANK in the environment: start "
            "the processes with torchrun (torchrun --nproc-per-node=N -m "
            "altair_tpu_torch.cli fluxmap --mesh ...), or pass rank, "
            "world_size and an init_method or a store")
    if backend is None:
        backend = "nccl" if _device(device).type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    kwargs = {} if timeout is None else {"timeout": timeout}
    if rank is not None:
        kwargs.update(rank=rank, world_size=world_size)
    dist.init_process_group(backend, init_method=init_method, store=store,
                            **kwargs)


def make_mesh(device=None, group=None) -> Mesh:
    """The mesh handle of this process: a 1-D mesh over every rank of
    ``group`` (default: all), the ray batch its only sharded axis.

    ``device`` is where this rank traces: None is the current CUDA device,
    whatever the backend, and the CPU only where the caller names it.  A
    CUDA device that is not there is an error, never a fall-back to the
    CPU."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_mesh() needs an initialised process group: call "
            "init_distributed() first, in processes started by torchrun "
            "(torchrun --nproc-per-node=N ...)")
    device = _device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return Mesh(dist.get_rank(group), dist.get_world_size(group), device,
                group)


def is_rank0(mesh: Mesh | None) -> bool:
    """True without a mesh and on its rank 0: the process that prints the
    stamps and writes the files."""
    return mesh is None or mesh.rank == 0


def on_rank0(mesh: Mesh | None, fn):
    """``fn()`` and its result: without a mesh at once; under one on rank 0
    alone, the result sent to every rank (``Mesh.on_rank0``)."""
    return fn() if mesh is None else mesh.on_rank0(fn)


def replicate(x, mesh: Mesh) -> torch.Tensor:
    """A host value as a tensor on the mesh's device, the same on every
    rank: rank 0's value is broadcast."""
    return mesh.broadcast(torch.as_tensor(x).to(mesh.device))


def _local(mesh: Mesh, n: int, what: str = "n_rays") -> int:
    if n % mesh.world_size:
        raise ValueError(f"{what}={n} must divide over {mesh.world_size} "
                         "devices")
    return n // mesh.world_size


def _reduce(mesh: Mesh, *parts: torch.Tensor) -> list[torch.Tensor]:
    """Sum int32 tensors over the ranks in ONE collective: flattened into
    one buffer, reduced, cut back to their shapes."""
    flat = mesh.all_reduce_sum(torch.cat(
        [p.to(torch.int32).reshape(-1) for p in parts]))
    out, at = [], 0
    for p in parts:
        out.append(flat[at:at + p.numel()].reshape(p.shape))
        at += p.numel()
    return out


def _raise_on_overflow(route: str, overflow) -> None:
    """``overflow`` is already reduced, so every rank takes the same
    branch."""
    if int(overflow):
        raise RuntimeError(
            f"{route}: {int(overflow)} rays unscored or unfinished over the "
            "mesh — statistically impossible at the planned capacities; "
            "investigate")


def _n_exit(res: TraceResult, scene: SphereScene) -> torch.Tensor:
    return res.exited_port_mask(scene.exit_port_z).sum(dtype=torch.int32)


def _score_local(res, scene, grid, pos_chunk):
    """This rank's trace-once map: ``(counts, n_exit, overflow)``."""
    counts, overflow = fluxmap_trace_once_compact(
        res, grid, exit_capacity(scene, res.status.shape[0]),
        scene.exit_port_z, pos_chunk)
    return counts, _n_exit(res, scene), overflow


def sharded_fluxmap(
    mesh: Mesh,
    gen: torch.Generator,
    scene: SphereScene,
    source: Source,
    grid: DetectorGrid,
    n_rays: int,
    cfg: TraceConfig = TraceConfig(),
    pos_chunk: int = 1080,
):
    """Trace ``n_rays`` (total, split evenly over the mesh) and score the
    full detector grid; returns ``(counts [n_theta, n_phi] int32,
    n_exited)`` on the mesh's device, the same on every rank.

    The trace-once sweep as one sharded call: per-rank trace from
    ``fold_in(gen, rank)``, per-rank partial map, one sum."""
    n_local = _local(mesh, n_rays)
    res, rim = trace_rays_auto(fold_in(gen, mesh.rank), scene, source,
                               n_local, cfg, device=mesh.device)
    counts, n_exit, overflow = _score_local(res, scene, grid, pos_chunk)
    counts, n_exit, overflow = _reduce(mesh, counts, n_exit,
                                       overflow + rim.total)
    _raise_on_overflow("sharded_fluxmap", overflow)
    return counts, n_exit


def sharded_exit_histogram(
    mesh: Mesh,
    gen: torch.Generator,
    scene: SphereScene,
    source: Source,
    n_rays: int,
    cfg: TraceConfig = TraceConfig(),
    n_bins: int = 180,
):
    """Sharded equivalent of the exit angular-distribution run
    (``distributionSphereDetectorSweep.C``): per-rank trace + histogram,
    one sum.  Returns ``(hist [n_bins] int32, n_exited)``."""
    n_local = _local(mesh, n_rays)
    res, rim = trace_rays_auto(fold_in(gen, mesh.rank), scene, source,
                               n_local, cfg, device=mesh.device)
    hist = exit_angle_histogram(res, n_bins, exit_port_z=scene.exit_port_z)
    hist, n_exit, overflow = _reduce(mesh, hist, _n_exit(res, scene),
                                     rim.total)
    _raise_on_overflow("sharded_exit_histogram", overflow)
    return hist, n_exit


def sharded_trace(
    mesh: Mesh,
    gen: torch.Generator,
    scene: SphereScene,
    source: Source,
    n_rays: int,
    cfg: TraceConfig = TraceConfig(),
) -> TraceResult:
    """Trace ``n_rays`` split evenly over the mesh; returns THIS RANK's
    ``TraceResult`` of ``n_rays / world_size`` rays, on its device for a
    following ``sharded_score_traced`` (the JAX function returns one
    global result sharded over the devices).  The overflow counts are
    summed over the ranks and a nonzero sum raises on all of them.

    The trace/score split mirrors the reference's two timed phases
    (``fluxAtObserverFast.C:1144-1254``), letting the sweep report both."""
    if cfg.keep_history:
        raise ValueError("history tracing is a single-device debug path")
    n_local = _local(mesh, n_rays)
    res, rim = trace_rays_auto(fold_in(gen, mesh.rank), scene, source,
                               n_local, cfg, device=mesh.device)
    (overflow,) = _reduce(mesh, rim.total)
    _raise_on_overflow("sharded_trace", overflow)
    return res


def sharded_score_traced(
    mesh: Mesh,
    result: TraceResult,
    scene: SphereScene,
    grid: DetectorGrid,
    pos_chunk: int = 1080,
):
    """Score this rank's already-traced shard (from ``sharded_trace``)
    against the detector grid: per-rank partial hit maps, one sum.
    Returns ``(counts [n_theta, n_phi] int32, n_exited)``."""
    counts, n_exit, overflow = _reduce(
        mesh, *_score_local(result, scene, grid, pos_chunk))
    _raise_on_overflow("sharded_score_traced", overflow)
    return counts, n_exit


def sharded_param_sweep(
    mesh: Mesh,
    gen: torch.Generator,
    scenes: SphereScene,          # batched (stack_scenes), or plain
    source: Source,
    n_rays_per_scene: int,
    cfg: TraceConfig = TraceConfig(),
    grid: DetectorGrid | None = None,
    pos_chunk: int = 1080,
    sources: Source | None = None,
):
    """Scene-parameter sweep (the ``sweepSeries`` axis): the members of a
    batched scene (port angle / roughness / reflectance ...) one after
    another with the ray axis sharded inside each — the multi-device
    equivalent of ``run_series_vmapped``.

    Returns per-scene exit counts ``[S]``; pass ``grid`` to also get the
    per-scene flux maps: ``(fluxmaps [S, n_theta, n_phi] counts, exits
    [S])``.  All members are summed over the mesh in one collective at
    the end.

    ``sources`` adds the SOURCE axis of ``sweepSeries`` (the srcX/Y/Z/
    dirXBase loops, ``fluxAtObserverOptimize.C:892-921``): a batched
    ``Source`` (``sweep.series.stack_sources``) that replaces ``source``.
    ``scenes`` may then be a plain scene, broadcast over the source
    members, or a batch of EQUAL length, zipped member for member.

    Member ``i`` traces from ``fold_in(fold_in(gen, rank), i)``; one
    tracer, one rim capacity and one exit capacity serve every member
    (planned from the concrete members, as ``run_series_vmapped`` does)."""
    from ..sweep.series import (members_tracer, scene_members,
                                source_members)

    n_local = _local(mesh, n_rays_per_scene, "n_rays_per_scene")
    batched = getattr(scenes.theta_max_deg, "ndim", 0) == 1
    members = list(scene_members(scenes)) if batched else [scenes]
    if sources is not None:
        srcs = list(source_members(sources))
        if not batched:
            members = members * len(srcs)
        elif len(members) != len(srcs):
            raise ValueError(
                f"scenes batch ({len(members)}) and sources batch "
                f"({len(srcs)}) must have equal length — the series zips "
                "them member-for-member")
        for sc, s in zip(members, srcs):
            validate(sc, s)
    else:
        srcs = [source] * len(members)

    tracer = members_tracer(members, cfg)
    cap = max(exit_capacity(m, n_local) for m in members)
    k = fold_in(gen, mesh.rank)
    rows = []
    for i, (scene, src) in enumerate(zip(members, srcs)):
        res, rim = tracer(fold_in(k, i), scene, src, n_local, cfg,
                          device=mesh.device)
        row = [_n_exit(res, scene).reshape(1), rim.total.reshape(1)]
        if grid is not None:
            counts, overflow = fluxmap_trace_once_compact(
                res, grid, cap, scene.exit_port_z, pos_chunk)
            row[1] = row[1] + overflow
            row.append(counts.reshape(-1))
        rows.append(torch.cat(row))
    (out,) = _reduce(mesh, torch.stack(rows))
    _raise_on_overflow("sharded_param_sweep", out[:, 1].sum())
    if grid is None:
        return out[:, 0]
    return (out[:, 2:].reshape(len(rows), grid.n_theta, grid.n_phi),
            out[:, 0])


def sharded_retrace(
    mesh: Mesh,
    gen: torch.Generator,
    scene: SphereScene,
    source: Source,
    grid: DetectorGrid,
    n_rays_per_pos: int,
    cfg: TraceConfig = TraceConfig(),
    pos_chunk: int | None = None,
):
    """Multi-device honest retrace sweep (``sweepDetector``,
    ``fluxAtObserverOptimize.C:433-702``): each rank traces
    ``n_rays_per_pos / world_size`` fresh rays for every detector position
    and scores them; the partial maps merge in one sum.  Statistically
    identical to ``fluxmap_retrace`` (each position's rays are independent
    across ranks, so counts just add).

    Returns ``[n_theta, n_phi]`` hit counts out of ``n_rays_per_pos`` rays
    per position.  ``pos_chunk`` is per device."""
    n_local = _local(mesh, n_rays_per_pos, "n_rays_per_pos")
    if pos_chunk is None:
        pos_chunk = max(1, min(32, (1 << 22) // max(n_local, 1)))
    counts, overflow = fluxmap_retrace_counts(
        fold_in(gen, mesh.rank), scene, source, grid, n_local, cfg,
        pos_chunk=pos_chunk, device=mesh.device)
    counts, overflow = _reduce(mesh, counts, overflow)
    _raise_on_overflow("sharded_retrace", overflow)
    return counts


def sharded_retrace_binomial(
    mesh: Mesh,
    gen: torch.Generator,
    scene: SphereScene,
    source: Source,
    grid: DetectorGrid,
    n_rays_per_pos: int,
    cfg: TraceConfig = TraceConfig(),
    oversample: int = 128,
    pos_chunk: int | None = None,
    qmc: bool = True,
    method: str = "mxu",
    stats: dict | None = None,
):
    """Multi-device binomial retrace: each rank traces ``oversample *
    n_rays_per_pos / world_size`` of the shared sample and scores its exit
    segments; one sum merges the hit counts (and the compaction overflow)
    into the global ``pi_hat``, and every rank draws the cells from the
    same key on the same kind of device, so all hold the same map with no
    second collective.

    Same error contract as ``fluxmap_retrace_binomial``: the shared sample
    is simply sharded.  Returns ``[n_theta, n_phi]`` int32 counts.
    ``stats``, when a dict, receives ``counts_M`` (the reduced hit counts
    of the shared sample) and ``compaction_overflow``."""
    if oversample < 2:
        raise ValueError("oversample must be >= 2: the shared "
                         "sample must exceed the per-position count")
    M = int(oversample) * int(n_rays_per_pos)
    m_local = _local(mesh, M, "oversample * n_rays_per_pos")
    if qmc and not cfg.qmc:
        # Sobol shared sample: the per-rank keys give each rank its own
        # randomisation, so the shards stay independent
        cfg = dataclasses.replace(cfg, qmc=1)
    cap = exit_capacity(scene, m_local)
    if pos_chunk is None:
        pos_chunk = binomial_pos_chunk(cap)
    k_trace, k_draw = split(fold_in(gen, 0x51), 2)
    res, rim = trace_rays_auto(fold_in(k_trace, mesh.rank), scene, source,
                               m_local, cfg, device=mesh.device)
    counts, overflow = fluxmap_trace_once_compact(
        res, grid, cap, scene.exit_port_z, pos_chunk, method)
    counts, overflow, rim_total = _reduce(mesh, counts, overflow, rim.total)
    _raise_on_overflow("sharded_retrace_binomial", rim_total)
    if stats is not None:
        stats["counts_M"] = counts
        stats["compaction_overflow"] = int(overflow)
    return binomial_cells_from_counts(k_draw, counts, overflow, M,
                                      n_rays_per_pos, grid.n_positions)


def sharded_insphere(
    mesh: Mesh,
    gen: torch.Generator,
    scene: SphereScene,
    source: Source,
    centers,
    normals,
    disk_radius,
    n_rays: int,
    cfg: TraceConfig = TraceConfig(),
    retrace: bool = False,
    pos_chunk: int | None = None,
):
    """Multi-device in-sphere focal-disk sweep
    (``integratingSphereDetectorSweep.C:31-105``).

    ``centers`` / ``normals``: ``[P, 3]`` disk placements (from
    ``core.score.insphere_disk_position``), the same on every rank.

    * ``retrace=False`` — one shared trace, ray axis sharded: each rank
      traces ``n_rays / world_size`` rays and scores them against every
      disk; one sum merges the ``[P]`` hit counts.
    * ``retrace=True`` — fresh rays per position: each rank traces
      ``n_rays / world_size`` rays for EVERY position, ``pos_chunk``
      positions per trace (the last chunk padded with disks nothing hits),
      chunk ``i`` from ``fold_in(fold_in(gen, rank), i)``.

    Returns ``[P]`` int32 hit counts out of ``n_rays`` rays per position
    (retrace) / in total (trace-once)."""
    from ..sweep.insphere import _retrace_counts

    n_local = _local(mesh, n_rays)
    C = torch.as_tensor(centers, dtype=torch.float32).to(mesh.device)
    Nrm = torch.as_tensor(normals, dtype=torch.float32).to(mesh.device)
    k = fold_in(gen, mesh.rank)
    if not retrace:
        res, rim = trace_rays_auto(k, scene, source, n_local, cfg,
                                   device=mesh.device)
        counts = hits_insphere_disks(res, C, Nrm, float(disk_radius))
        overflow = rim.total
    else:
        if pos_chunk is None:
            pos_chunk = max(1, min(32, (1 << 22) // max(n_local, 1)))
        counts, overflow = _retrace_counts(
            k, scene, source, C, Nrm, float(disk_radius), n_local, cfg,
            min(pos_chunk, C.shape[0]), mesh.device)
    counts, overflow = _reduce(mesh, counts, overflow)
    _raise_on_overflow("sharded_insphere", overflow)
    return counts


def sharded_scatter_retrace(
    mesh: Mesh,
    gen: torch.Generator,
    scene: SphereScene,
    source: Source,
    grid: DetectorGrid,
    n_rays: int,
    cfg: TraceConfig = TraceConfig(),
    only_rescatter_absorbed: bool = False,
):
    """Multi-device two-stage scatter-retrace (``nonLambertianFlux.C:
    235-304`` methodology; ``sweep/scatter_retrace.py``).

    Both stages are embarrassingly parallel over rays: trace, endpoint
    re-scatter and re-trace all stay on the rank; the only communication
    is one sum of the ``[n_theta, n_phi]`` hit map.  Returns int32 counts
    out of ``n_rays`` total."""
    from ..sweep.scatter_retrace import trace_scatter_retrace

    n_local = _local(mesh, n_rays)
    res, overflow = trace_scatter_retrace(
        fold_in(gen, mesh.rank), scene, source, n_local, cfg,
        bool(only_rescatter_absorbed), device=mesh.device)
    counts = fluxmap_trace_once(res, grid, scene.exit_port_z)
    counts, overflow = _reduce(mesh, counts, overflow)
    _raise_on_overflow("sharded_scatter_retrace", overflow)
    return counts


def sharded_distribution(
    mesh: Mesh,
    gen: torch.Generator,
    scene: SphereScene,
    source: Source,
    n_rays: int,
    cfg: TraceConfig = TraceConfig(),
):
    """Multi-device exit angular-distribution run
    (``distributionSphereDetectorSweep.C`` / ``sweep/distribution.py``).

    The histograms are summed over the mesh; the per-ray exit-direction
    payload (the ``3dRayLog.txt`` product) is THIS RANK's shard of
    ``n_rays / world_size`` rays (``run_distribution(mesh=)`` gathers it,
    where the JAX function returns one global sharded array).

    Returns ``(angle_hist [180], dz_hist [100], mask [n_local], dx, dy,
    dz)``."""
    n_local = _local(mesh, n_rays)
    res, rim = trace_rays_auto(fold_in(gen, mesh.rank), scene, source,
                               n_local, cfg, device=mesh.device)
    mask, dx, dy, dz = exit_directions(res, scene.exit_port_z)
    ang, dzh, overflow = _reduce(
        mesh, exit_angle_histogram(res, exit_port_z=scene.exit_port_z),
        z_angle_histogram(dz, mask), rim.total)
    _raise_on_overflow("sharded_distribution", overflow)
    return ang, dzh, mask, dx, dy, dz


def sharded_twofold_pair(
    mesh: Mesh,
    gen: torch.Generator,
    scene: SphereScene,
    source: Source,
    grid: DetectorGrid,
    n_rays: int,
    cfg: TraceConfig,
    theta,
    phi,
):
    """Multi-device twofold pair (``sweepDetectorTwofold``,
    ``fluxAtObserverFast.C:336-408``): one fresh batch split over the
    ranks, scored against the antipodal detector pair (theta, phi) /
    (theta, phi + 180); one sum of the 2-vector of hit counts.  Driven per
    pair by ``sweep_detector_twofold(mesh=...)``."""
    n_local = _local(mesh, n_rays)
    res, rim = trace_rays_auto(fold_in(gen, mesh.rank), scene, source,
                               n_local, cfg, device=mesh.device)
    theta = torch.as_tensor(theta, dtype=torch.float32).to(mesh.device)
    phi = torch.as_tensor(phi, dtype=torch.float32).to(mesh.device)
    out = []
    for p in (phi, phi + 180.0):
        c, n = detector_position(theta, p, grid.radius, scene.exit_port_z)
        out.append(hits_single_detector(res, c, n, grid.width / 2.0,
                                        scene.exit_port_z))
    pair, overflow = _reduce(mesh, torch.stack(out), rim.total)
    _raise_on_overflow("sharded_twofold_pair", overflow)
    return pair
