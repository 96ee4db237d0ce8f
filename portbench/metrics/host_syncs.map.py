"""host_syncs.map: the program's device-to-host reads per job: its
``host_syncs`` counter (``altair_tpu_torch.io.profiling``: the trace
loops' alive checks and every read of a count on the trace and score
paths), a process total that counts with tracing off, over the jobs the
process ran (the window's and the warm one).  Layer ``trace``; moves
``map_s``."""

from portbench import program_trace

UNIT = "count"
SOURCE = "program_counter"
LAYER = "trace"
MOVES = "map_s"


def read(run):
    return program_trace.host_syncs_per_job(run)
