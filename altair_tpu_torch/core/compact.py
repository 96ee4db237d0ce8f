"""Stream compaction with a fixed capacity — the PyTorch counterpart of
``altair_tpu/core/compact.py``.

``torch.nonzero_static`` gives the first ``size`` indices of a mask padded
with a fill value, without the device-to-host sync that plain
``torch.nonzero`` needs to size its output; it computes exactly what the
JAX package's blocked-cumsum + ordered-scatter replacement computes.
"""

from __future__ import annotations

import torch


def nonzero_indices(mask, size: int, fill: int) -> torch.Tensor:
    """First ``size`` indices where ``mask`` holds, ascending, padded with
    ``fill`` (``jnp.nonzero(mask, size=size, fill_value=fill)[0]``).
    Returns int64."""
    mask = mask.to(torch.bool)
    return torch.nonzero_static(mask, size=size, fill_value=fill)[:, 0]


def nonzero_indices_grouped(mask, size: int, fill: int, group_capacity: int,
                            group: int = 8):
    """Two-level ``nonzero_indices`` for sparse masks: the lanes are grouped
    by ``group``; level 1 keeps the first ``group_capacity`` groups holding
    a masked lane, level 2 compacts only those groups' lanes.

    Returns ``(idx, n_dropped)``: ``idx`` equals ``nonzero_indices(mask,
    size, fill)`` whenever ``n_dropped == 0``; ``n_dropped`` counts masked
    lanes lost because more than ``group_capacity`` groups hold one."""
    mask = mask.to(torch.bool)
    n = mask.shape[0]
    pad = (-n) % group
    mp = torch.cat([mask, mask.new_zeros(pad)]) if pad else mask
    m2 = mp.reshape(-1, group)                              # [ng, group]
    ng = m2.shape[0]
    group_capacity = min(group_capacity, ng)
    gidx = nonzero_indices(m2.any(dim=1), group_capacity, ng)
    gvalid = gidx < ng
    gsafe = torch.clamp(gidx, max=ng - 1)
    sub = m2[gsafe] & gvalid[:, None]                       # [gc, group]
    lanes = (gsafe * group)[:, None] + torch.arange(group, device=mask.device)
    flat_m = sub.reshape(-1)
    flat_l = lanes.reshape(-1)
    # rank the candidates; the ones past `size` or unmasked are dropped,
    # exactly as the JAX package's out-of-bounds scatter drops them
    k = nonzero_indices(flat_m, size, flat_m.shape[0])
    safe_k = torch.clamp(k, max=flat_m.shape[0] - 1)
    idx = torch.where(k < flat_m.shape[0], flat_l[safe_k],
                      torch.full_like(k, fill))
    n_dropped = (mask.sum(dtype=torch.int32) - flat_m.sum(dtype=torch.int32))
    return idx, n_dropped
