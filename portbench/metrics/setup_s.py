"""setup_s: process start to the end of the warm job (imports, CUDA
start, the kernels' build or load, one job of the cell's own shape)."""

UNIT = "s"
SOURCE = "host_clock"


def read(run):
    return run.setup_s
