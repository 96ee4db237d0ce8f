"""rays_per_s: rays traced in the completed jobs over the window (host
clock)."""

from portbench import arith

UNIT = "rays/s"
SOURCE = "host_clock"


def read(run):
    return arith.per_second(sum(j[3] for j in run.completed),
                            [(j[0], j[1]) for j in run.jobs])
