"""trace_roofline_pct.trace: the least time of the bounce steps of a job
over the device-busy time inside its profiled trace spans, in percent.
Layer ``kernels``; moves ``rays_per_s``.

The work is the sum of ``n_bounces`` over every ray of the job (the wall
and rim bounces its TraceResult reports) times the float operations of
one bounce step of the configuration's law, counted once from the plain
step of ``portbench/reference.py::trace`` for a wall bounce (an add,
multiply, compare-select or special function each count one; drawing the
random numbers is not counted):

    roulette u < rho                                        1
    distance to the inner sphere (p.d, p.p - r^2, root)    17
    hit point q = p + t d                                   6
    reprojection onto the radius                           10
    port test, inward normal                                4
    state update (position, direction, bounce count)        7
    law, LAMBERTIAN: the frame about n (32), the cosine-weighted
         direction (33)                                    65
    law, MIXED_BRDF: the pick (1); with p 0.4 the mirror (12), its
         frame (32), the tilt and renormalisation (29): 73; with p 0.6
         the cosine-weighted direction (65); 1 + 0.4*73 + 0.6*65 = 69.2

So 110 for LAMBERTIAN and 114.2 for MIXED_BRDF.  Bytes: each ray's
TraceResult written once (44); the inputs are the source's scalars.
Peaks: 67 TFLOP/s float32, 3.35 TB/s.
"""

from portbench import readers

UNIT = "%"
SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "rays_per_s"
STEP_FLOPS = {"LAMBERTIAN": 110.0, "MIXED_BRDF": 114.2}


def read(run):
    law = run.cell["config_data"]["scene"]["surface_model"]
    rays = int(run.cell["traffic_data"]["rays"])

    def work(meta):
        if "bounce_steps" not in meta:
            return None
        return (meta["bounce_steps"] * STEP_FLOPS[law],
                rays * readers.TRACE_BYTES_PER_RAY)

    return readers.roofline(run, "trace", work)
