"""score_roofline_pct.map: the least time of the scoring work over the
device-busy time inside the profiled score spans, in percent.  Layer
``score``; moves ``map_s``.

The work is the same whatever scorer runs: every exit scored against
every grid position by the plain disk-hit test, ``PAIR_FLOPS`` float
operations a pair, counted once from ``portbench/reference.py::score``
(an add, multiply, compare-select or special function each count one):

    d.n                       3 mul + 2 add        5
    e.n, then (c.n - e.n)     3 mul + 2 add + 1    6
    t = (c.n - e.n) / d.n     1 div                1
    e.c                       3 mul + 2 add        5
    |e - c|^2 = |e|^2 - 2 e.c + |c|^2   (|e|^2, |c|^2 once a ray, a position)
                              1 mul + 2 add        3
    d.c, then e.d - d.c       3 mul + 2 add + 1    6
    r2 = |e-c|^2 + t (2 (e-c).d + t |d|^2)
                              3 mul + 2 add        5
    |d.n| >= eps, r2 <= (w/2)^2, and              4
                                            total 35

Bytes (each input read once, each output written once): an exit's point
and direction, a position's centre and normal (float32), its int32
count; the scorer is bound by compute.  In a trace-once map the exits
are the job's own count; in a binomial map, whose call returns no exit
count, they are its shared rays times the reference's exit fraction
from the same run (within 0.1% at 4M reference rays).  Peaks: 67 TFLOP/s
float32 (no TF32: the scorer refuses it), 3.35 TB/s.
"""

from portbench import readers

UNIT = "%"
SOURCE = "device_trace"
LAYER = "score"
MOVES = "map_s"
PAIR_FLOPS = 35


def read(run):
    f_exit = run.facts.get("exit_fraction_ref")

    def work(meta):
        if "pairs" in meta:
            pairs = meta["pairs"]
        elif f_exit is not None and "rays" in meta:
            pairs = round(meta["rays"] * f_exit) * meta["positions"]
        else:
            return None
        positions = meta.get("positions", run.cell["config_data"]["grid"]
                             ["n_theta"] * run.cell["config_data"]["grid"]
                             ["n_phi"])
        exits = pairs / positions
        return (pairs * PAIR_FLOPS,
                exits * readers.SCORE_BYTES_PER_EXIT
                + positions * readers.SCORE_BYTES_PER_POSITION)

    return readers.roofline(run, "score", work)
