"""trace_ms.insphere: mean milliseconds a retrace disk sweep spends in its
trace layer (``trace_rays_auto`` over each chunk of disks), from the
sweep's own laps (``stats=``), each ended by a device sync: the sum of a
job's ``trace`` spans, averaged over the jobs outside the profiled ones.
Layer ``trace``; moves ``map_s``."""

from portbench import readers

UNIT = "ms"
SOURCE = "host_clock"
LAYER = "trace"
MOVES = "map_s"


def read(run):
    return job_mean_ms(run, "trace")


def job_mean_ms(run, name: str):
    """The mean over jobs of the sum of each job's ``name`` spans."""
    per_job = {}
    for s in readers.timed_spans(run, name):
        per_job[s[1]] = per_job.get(s[1], 0.0) + (s[3] - s[2])
    if not per_job:
        return None
    return 1e3 * sum(per_job.values()) / len(per_job)
