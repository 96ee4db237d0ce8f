"""score_ms.insphere: mean milliseconds a retrace disk sweep spends in its
disk test (``insphere_disk_hit_mask`` and the count over each chunk), from
the sweep's own laps (``stats=``), each ended by a device sync: the sum of
a job's ``score`` spans, averaged over the jobs outside the profiled ones.
Layer ``score``; moves ``map_s``."""

from portbench.harness import metric_reader

UNIT = "ms"
SOURCE = "host_clock"
LAYER = "score"
MOVES = "map_s"


def read(run):
    return metric_reader("trace_ms.insphere").job_mean_ms(run, "score")
