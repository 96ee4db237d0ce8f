from .csvdialect import (  # noqa: F401
    FluxmapMetadata,
    FluxmapWriter,
    fluxmap_filename,
    read_fluxmap,
    timestamp,
    unique_filename,
)
from .profiling import (  # noqa: F401
    PhaseTimer,
    clear,
    count,
    device_busy_s,
    device_trace,
    records,
    span,
    tracing,
)
from .progress import EtaTracker, debug_stamp, notify_bell, position_line  # noqa: F401
