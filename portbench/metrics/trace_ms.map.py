"""trace_ms.map: mean milliseconds of the trace layer per job
(``trace_rays_auto``: the sampler or the kernels, plus the rim
post-pass), from the benchmark's own span around the call, which ends in
a device sync; in a binomial map, the program's ``trace_s`` lap.  Layer
``trace``; moves ``map_s``."""

from portbench import readers

UNIT = "ms"
SOURCE = "host_clock"
LAYER = "trace"
MOVES = "map_s"


def read(run):
    return readers.span_mean_ms(run, "trace")
