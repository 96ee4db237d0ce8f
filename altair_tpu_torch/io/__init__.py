from .csvdialect import (  # noqa: F401
    FluxmapMetadata,
    FluxmapWriter,
    fluxmap_filename,
    read_fluxmap,
    timestamp,
    unique_filename,
)
