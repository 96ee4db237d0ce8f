"""trace_roofline_pct.map: ``trace_roofline_pct.trace`` in the map cells
(the same work, step count and peaks), moving ``map_s``.  Layer
``kernels``."""

from portbench.harness import metric_reader

UNIT = "%"
SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "map_s"


def read(run):
    return metric_reader("trace_roofline_pct.trace").read(run)
