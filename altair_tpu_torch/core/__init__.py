from .geometry import Vec3  # noqa: F401
from .trace import (  # noqa: F401
    ABSORBED,
    EXITED,
    RUNNING,
    SUSPENDED,
    RimOverflow,
    TraceResult,
    exit_count,
    trace_rays,
    trace_rays_rim_deferred,
)
from .trace_direct import direct_applicable, trace_rays_direct  # noqa: F401
from .trace_waves import trace_rays_auto, trace_rays_waves, waves_safe  # noqa: F401
