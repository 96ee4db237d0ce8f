from .observer import SweepResult, sweep_detector_trace_once  # noqa: F401
