"""altair_tpu_torch — the integrating-sphere photon tracer on PyTorch and
CUDA (NVIDIA Hopper).

A port of ``altair_tpu`` (JAX), which stays the reference it is tested
against.  This package imports torch and never JAX.  Ported: everything
the JAX package does —

* the trace-once flux-map path: the direct and simulate engines of
  ``trace_rays_auto``, the deferred rim post-pass, the trace-once scorer
  and ``sweep.sweep_detector_trace_once``;
* the large-batch simulate path (the refill kernel's tail handoff and the
  wave-compaction tracer), with both TPU kernels rewritten as CUDA kernels
  (``csrc/bounce.cu``, ``csrc/refill.cu``);
* the retrace flux-map path: Sobol QMC draws, the honest and binomial
  retrace sweeps, replicates and the exit distribution;
* path history (``TraceConfig.keep_history``) and the custom scatter
  callable, the port-angle and source series, the in-sphere disk sweep and
  the two-stage scatter-retrace sweep (``sweep``), the ray-path, HTML and
  ASCII views (``viz``), the flux-map analysis and the closed-form
  finite-port models (``analysis``), the ``torch.profiler`` wrappers
  (``io.profiling``), the native CPU tier's binding (``native``), and all
  seven CLI subcommands (``python -m altair_tpu_torch.cli``);
* the multi-device layer (``parallel``): SPMD over ``torch.distributed``,
  one process a device, every ``sharded_*`` route, ``mesh=`` on the sweeps
  and ``--mesh`` on the CLI under ``torchrun``.

Not ported: ``core/memo.py`` (eager torch has no compile to memoize).
"""

from .config import (  # noqa: F401
    SCENE_DEMO,
    SCENE_INSPHERE,
    SCENE_OPTIMIZE,
    SCENE_V1,
    SOURCE_DEMO,
    SOURCE_OVERNIGHT,
    SOURCE_V1,
    DetectorGrid,
    SphereScene,
    Source,
    SurfaceModel,
    TraceConfig,
)
from .core import TraceResult, Vec3, exit_count, trace_rays, trace_rays_auto  # noqa: F401

__version__ = "0.1.0"
