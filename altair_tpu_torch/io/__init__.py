from .csvdialect import (  # noqa: F401
    FluxmapMetadata,
    FluxmapWriter,
    fluxmap_filename,
    read_fluxmap,
    timestamp,
    unique_filename,
)
from .progress import EtaTracker, debug_stamp, notify_bell, position_line  # noqa: F401
