"""map_s: seconds of the window over the maps completed in it (host
clock; the window runs from the first job's start to the end of the
last).  Moves with every layer a map passes through."""

from portbench import arith

UNIT = "s"
SOURCE = "host_clock"


def read(run):
    return arith.seconds_per_job([(j[0], j[1]) for j in run.jobs],
                                 len(run.completed))
