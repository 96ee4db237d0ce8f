from .distribution import (  # noqa: F401
    DistributionResult,
    run_distribution,
    write_angular_dist,
    write_ray_log,
)
from .insphere import (  # noqa: F401
    InsphereSweepResult,
    read_detector_sweep,
    sweep_insphere_detector,
)
from .observer import (  # noqa: F401
    SweepResult,
    fluxmap_replicates,
    sweep_detector_retrace,
    sweep_detector_trace_once,
    sweep_detector_twofold,
    write_fluxmap_csv,
)
from .scatter_retrace import (  # noqa: F401
    ScatterRetraceSweep,
    sweep_scatter_retrace,
    trace_scatter_retrace,
)
from .series import (  # noqa: F401
    run_series,
    run_series_vmapped,
    scene_members,
    series_folder,
    source_members,
    stack_scenes,
    stack_sources,
)
