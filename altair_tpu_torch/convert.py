"""Carry the JAX package's objects across to the port, so both packages can
compute the same thing from the same inputs.

Everything is read by attribute or through ``numpy.asarray``, so this
module imports neither JAX nor ``altair_tpu``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import config
from .core.geometry import Vec3
from .core.trace import TraceResult

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16, "float16": torch.float16}


def _fields_from(obj, cls, **overrides):
    kw = {f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)}
    kw.update(overrides)
    return cls(**kw)


def scene(obj) -> config.SphereScene:
    """A JAX-package ``SphereScene`` as the port's (scalar fields only)."""
    return _fields_from(obj, config.SphereScene,
                        surface_model=config.SurfaceModel(
                            int(obj.surface_model)))


def source(obj) -> config.Source:
    return _fields_from(obj, config.Source)


def grid(obj) -> config.DetectorGrid:
    return _fields_from(obj, config.DetectorGrid)


def trace_config(obj) -> config.TraceConfig:
    """A JAX-package ``TraceConfig``; its dtype maps by name."""
    return _fields_from(obj, config.TraceConfig,
                        dtype=_DTYPES[np.dtype(obj.dtype).name])


def trace_result(res, device) -> TraceResult:
    """A ``TraceResult`` whose fields are arrays (JAX or numpy) as the
    port's, on ``device``; a path history is carried along."""
    def t(a):
        return torch.from_numpy(np.array(a)).to(device)

    def v(p):
        return Vec3(t(p.x), t(p.y), t(p.z))

    return TraceResult(status=t(res.status).to(torch.int32),
                       last_point=v(res.last_point),
                       seg_start=v(res.seg_start),
                       direction=v(res.direction),
                       n_bounces=t(res.n_bounces).to(torch.int32),
                       history=(None if res.history is None
                                else t(res.history)),
                       history_len=(None if res.history_len is None
                                    else t(res.history_len).to(torch.int32)))


def seed_words(key_data) -> tuple[int, int]:
    """A JAX key's ``key_data`` words as the bounce kernel's seed pair —
    the first two words as uint32, as ``_kernel_operands`` takes them."""
    w = np.asarray(key_data).astype(np.uint32).ravel()[:2]
    return int(w[0]), int(w[1])
