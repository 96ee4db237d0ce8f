"""The plain reference against the port's CPU path at a small size: the
exit fraction of both laws, and the scorer on the same exits."""

import json
import math

import pytest
import torch

from portbench import judge, reference
from portbench.harness import HERE
from portbench.jobs import program_exits


def config(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name,n_prog,n_ref", [("optimize170", 100_000, 60_000),
                                               ("mixedbrdf170", 8_000, 60_000)])
def test_exit_fraction_matches_the_port(name, n_prog, n_ref):
    """Both sides' port-exit fractions agree within 4 sigma (the port's
    direct sampler with the hybrid rim post-pass, and its bounce kernel's
    plain version with the eager rim continuation)."""
    from altair_tpu_torch import trace_rays_auto
    from portbench.jobs import program_objects

    cfg = config(name)
    scene, source, _, tcfg = program_objects({"config_data": cfg})
    res, rim = trace_rays_auto(torch.Generator().manual_seed(5), scene,
                               source, n_prog, tcfg, device="cpu")
    assert int(rim.total) == 0
    n_p = int(res.exited_port_mask(-100.0).sum())
    ex = reference.trace(cfg["scene"], cfg["source_point"], n_ref,
                         torch.Generator().manual_seed(6))
    n_r = int((ex.last_point[:, 2] < -100.0).sum())
    assert judge.exit_z(n_p, n_prog, n_r, n_ref) < 4.0
    # the reference's rays all end, none suspended at this cap
    assert ex.n_suspended == 0
    assert ex.n_absorbed + ex.seg_start.shape[0] == n_ref
    # and its exits are sound segments
    seg, last, d, nb = judge.exits_from_reference(ex, -100.0)
    assert judge.segment_err_cm(seg, last, d, nb, cfg["scene"],
                                cfg["source_point"]) < 1e-6


def test_scorer_matches_the_ports_exact_scorer():
    """The reference scorer (float64) and the port's plain per-pair scorer
    count the same hits on the same exits, cell for cell, up to a pair at
    a disk's edge."""
    from altair_tpu_torch import DetectorGrid, trace_rays_auto
    from altair_tpu_torch.core.score import fluxmap_trace_once
    from portbench.jobs import program_objects

    cfg = config("optimize170")
    cfg["grid"].update(n_theta=30, n_phi=15)
    scene, source, grid, tcfg = program_objects({"config_data": cfg})
    res, _ = trace_rays_auto(torch.Generator().manual_seed(9), scene, source,
                             4000, tcfg, device="cpu")
    port = fluxmap_trace_once(res, grid, -100.0, method="exact")
    x = program_exits(res, -100.0)
    ref, per_ray = reference.score(x["seg"], x["dir"], cfg["grid"], -100.0)
    assert int(ref.sum()) == int(per_ray.sum()) > 0
    assert judge.map_cell_diff(port, ref) <= 1


def test_grid_positions_follow_set_position():
    """Centres at the radius from the port centre, theta-major; the
    stored normal is the offset with x and y swapped and one sign
    flipped, a unit vector."""
    grid = config("optimize170")["grid"]
    c, n = reference.grid_positions(grid, -100.0)
    assert c.shape == (16200, 3)
    off = c - torch.tensor([0.0, 0.0, -100.0], dtype=torch.float64)
    assert torch.allclose(off.norm(dim=1), torch.full((16200,), 100.0, dtype=torch.float64))
    assert torch.allclose(n.norm(dim=1), torch.ones(16200, dtype=n.dtype))
    assert torch.allclose(n[:, 0] * 100.0, -off[:, 1])
    # theta-major: the second position is the next phi of the first theta
    th = torch.rad2deg(torch.acos(-off[:, 2] / 100.0))
    assert th[1] == pytest.approx(th[0]) and th[90] > th[0]


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11 + 2 ** -13, 300.123],
                     dtype=torch.float32)
    y = reference.round_tf32(x)
    assert y[0] == x[0]
    assert y[1] == 1.0 + 2 ** -10
    assert abs(float(y[2]) - 300.123) <= 300.123 * 2 ** -11
    assert float(y[2]) != float(x[2])


def test_binomial_numbers_on_hand_made_maps():
    p = torch.full((100,), 0.01, dtype=torch.float64)
    n = 10_000
    exact = [torch.full((100,), 100.0)]
    total_z, dev, surprise = judge.binomial_numbers(exact, p, n, 10 ** 9,
                                                    10 ** 9, 0.0)
    assert total_z == 0.0 and surprise == 0.0
    assert dev == pytest.approx(1.0)      # no draw noise: mean z^2 is 0
    g = torch.Generator().manual_seed(3)
    drawn = [torch.binomial(torch.full((100,), float(n)), p.float(),
                            generator=g) for _ in range(50)]
    total_z, dev, surprise = judge.binomial_numbers(drawn, p, n, 10 ** 9,
                                                    10 ** 9, 0.0)
    assert total_z < 4 and dev < 0.2 and surprise < 3
    drawn[0][7] *= 2      # one cell altered
    assert judge.binomial_numbers(drawn, p, n, 10 ** 9, 10 ** 9, 0.0)[2] > 6


def test_max_surprise_does_not_grow_with_the_cell_count():
    # the same tail probability read from 10x the cells is the same
    # surprise, and an underflowing erfc still gives a finite number
    assert judge.max_surprise(5.07, 108_992) == pytest.approx(1.372, abs=1e-3)
    assert judge.max_surprise(10.19, 108_992) == pytest.approx(18.62, abs=1e-2)
    assert math.isfinite(judge.max_surprise(60.0, 10 ** 5))
    assert judge.max_surprise(60.0, 10 ** 5) > judge.max_surprise(30.0, 10 ** 5)


def test_exit_z_and_chi2_on_hand_made_samples():
    assert judge.exit_z(500, 1000, 500, 1000) == 0.0
    assert judge.exit_z(600, 1000, 500, 1000) > 4
    g = torch.Generator().manual_seed(1)
    d = reference._unit(torch.randn(20000, 3, dtype=torch.float64,
                                    generator=g))
    s = torch.randn(20000, 3, dtype=torch.float64, generator=g)
    assert judge.exit_chi2_z(s[:10000], d[:10000], s[10000:], d[10000:], -98.6) < 4
    tilted = d[:10000].clone()
    tilted[:, 2] -= 0.2
    assert judge.exit_chi2_z(s[:10000], tilted, s[10000:], d[10000:], -98.6) > 10
    assert math.isinf(judge.exit_chi2_z(s[:0], d[:0], s, d, -98.6))
