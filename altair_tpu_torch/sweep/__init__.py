from .distribution import (  # noqa: F401
    DistributionResult,
    run_distribution,
    write_angular_dist,
    write_ray_log,
)
from .observer import (  # noqa: F401
    SweepResult,
    fluxmap_replicates,
    sweep_detector_retrace,
    sweep_detector_trace_once,
    sweep_detector_twofold,
    write_fluxmap_csv,
)
