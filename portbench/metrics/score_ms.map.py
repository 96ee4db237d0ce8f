"""score_ms.map: mean milliseconds of the scorer per job
(``fluxmap_trace_once_compact``), from the
benchmark's own span; in a binomial map, the program's ``score_s`` lap.
Layer ``score``; moves ``map_s``."""

from portbench import readers

UNIT = "ms"
SOURCE = "host_clock"
LAYER = "score"
MOVES = "map_s"


def read(run):
    return readers.span_mean_ms(run, "score")
