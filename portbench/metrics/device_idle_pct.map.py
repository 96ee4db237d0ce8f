"""device_idle_pct.map: 100 x (1 - device busy / profiled wall) over the
profiled jobs: the union of the device's activities (kernels, copies,
sets; not the spans of annotation labels) from ``torch.profiler``.
Layer ``device``; moves ``map_s``."""

from portbench import readers

UNIT = "%"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "map_s"


def read(run):
    return readers.idle_pct(run)
