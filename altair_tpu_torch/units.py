"""Unit system (a copy of ``altair_tpu/units.py``, which holds no JAX code).

The reference uses ROBAST's unit system (``AOpticsManager::cm()`` /
``::nm()``, see ``fluxAtObserver.C:27-28``) in which every macro multiplies
lengths by ``cm``.  Here the base length unit is the centimetre (``cm = 1.0``)
so all the reference's magic numbers (100.1, 101, -100, 200/300 world box)
carry over verbatim.  Wavelengths are carried only as metadata (the physics is
wavelength independent in this workload) but we keep ``nm`` for API parity.
"""

cm: float = 1.0
mm: float = 0.1 * cm
m: float = 100.0 * cm
nm: float = 1e-7 * cm
deg: float = 1.0  # angles at the API surface are degrees, like the reference
