"""The benchmark of ``altair_tpu_torch`` on one NVIDIA H100: a harness
driven by data (``README.md``), a plain reference, and the arithmetic that
turns a run into its metrics."""
