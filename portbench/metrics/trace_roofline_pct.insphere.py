"""trace_roofline_pct.insphere: the least time of the bounce steps of a
retrace disk sweep's traces over the device-busy time inside its profiled
``trace`` spans, in percent: the finish kernel's share of its roofline on
the thick-rim route from the source.  Layer ``kernels``; moves ``map_s``.

The work of one ``trace`` span (one chunk of disks) is its rays' bounce
count (``bounce_steps``, the sum of ``n_bounces``) times the float
operations of one wall bounce of the configuration's law, as
``trace_roofline_pct.trace`` counts them (its ``STEP_FLOPS``, read from
that file), plus each ray's TraceResult written once
(``readers.TRACE_BYTES_PER_RAY``).  Steps beyond the bounces are not
counted: a ray's exit flight, its flights through the gap between the
shell's radii and the rim-cone tests of its escaping flights.  So the
share is a lower bound.  Peaks: 67 TFLOP/s float32, 3.35 TB/s.
"""

from portbench import readers
from portbench.harness import metric_reader

UNIT = "%"
SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "map_s"


def read(run):
    step_flops = metric_reader("trace_roofline_pct.trace").STEP_FLOPS
    law = run.cell["config_data"]["scene"]["surface_model"]

    def work(meta):
        if "bounce_steps" not in meta or "rays" not in meta:
            return None
        return (meta["bounce_steps"] * step_flops[law],
                meta["rays"] * readers.TRACE_BYTES_PER_RAY)

    return readers.roofline(run, "trace", work)
