"""The benchmark's plain elastic reference (``fwibench/reference_elastic.py``)
and the elastic cell's physics (``fwibench/physics/elastic.py``) on the CPU.

The reference, in float64, against the port's exact CPU engine
(``ElasticPropagator(impl="eager")``): seismograms, J and the three
gradients, whole and on the valid region; its forward against the JAX
package's numpy oracle ``oracle_elastic_2d``; its gradient against central
differences along seeded directions inside the valid region; its step
against the port's CFL rule. Then a tiny cell of the elastic physics runs
through ``fwibench.harness.run_cell``: correct, and not correct with every
seismogram off by one part in a thousand. Every test takes seconds on one
thread: a 20 x 28 grid, order 8, PML 6, nt 120.
"""

from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch

from fwibench import check, harness, models, reference, reference_elastic, spec

F64 = torch.float64
SHAPE, H, PML, ORDER, F0, NT, VP_MAX = (20, 28), (10.0, 10.0), 6, 8, 20.0, 120, 4700.0
R = ORDER // 2


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def smooth_field(gen, lo, hi):
    """A seeded random field, smoothed and scaled to [lo, hi] (float64)."""
    x = models.gaussian(torch.rand(SHAPE, generator=gen, dtype=F64), 2.0)
    return lo + (hi - lo) * (x - x.min()) / (x.max() - x.min())


def medium_and_models(seed):
    """(dt, (vp, vs, rho) at which the gradient is taken, the true model)."""
    gen = torch.Generator().manual_seed(seed)
    vp = smooth_field(gen, 2000.0, 4000.0)
    vs = vp / 1.9 * (1.0 + 0.05 * smooth_field(gen, -1.0, 1.0))
    rho = 310.0 * vp**0.25
    true = (vp * (1.0 + 0.03 * smooth_field(gen, -1.0, 1.0)), vs, rho)
    return reference_elastic.cfl_dt(H, VP_MAX, ORDER, 0.7), (vp, vs, rho), true


SRC = np.array([[[2, 6]], [[2, 21]]])
RCV = np.stack([np.full(7, 2), np.arange(4, 24, 3)], 1)


def survey(dt, dtype=F64):
    med = reference_elastic.Medium(SHAPE, H, PML, ORDER, dt, VP_MAX, F0, dtype=dtype)
    return reference_elastic.make_survey(med, SRC, np.repeat(RCV[None], 2, 0),
                                         reference.ricker(F0, dt, NT),
                                         reference.lowpass_response(NT, dt, 12.0))


def test_the_step_is_the_ports_cfl_step():
    from tpufwi_torch.propagators.elastic2d import elastic_cfl_dt

    for h in ((10.0, 12.0), H):
        assert reference_elastic.cfl_dt(h, 4700.0, 8, 0.7) == pytest.approx(
            elastic_cfl_dt(h, 4700.0, 8, safety=0.7), rel=1e-14)
    # the configuration's 4 s record at 10 m and 4700 m/s
    assert int(4.0 / reference_elastic.cfl_dt(H, VP_MAX, 8, 0.7)) == 4885


def test_reference_agrees_with_the_ports_exact_engine():
    """float64 on both sides: the reference's whole gradient arrays equal the
    port's, which masks its staggered cotangents to the same interior."""
    from tpufwi_torch.acquisition import Geometry
    from tpufwi_torch.filters import apply_response
    from tpufwi_torch.grid import Grid
    from tpufwi_torch.propagators.elastic2d import ElasticPropagator

    dt, m, true = medium_and_models(5)
    sv = survey(dt)
    d = reference_elastic.forward(sv, true)[0]
    J, g, seis = reference_elastic.value_and_grad(sv, m, reference.lowpass(d, sv.h2, 1),
                                                  segment=17)
    grid = Grid(shape=SHAPE, h=H, pml=PML, order=ORDER)
    prop = ElasticPropagator(grid, dt, F0, VP_MAX, dtype=F64, source_type="force_z",
                             record="v", impl="eager", device="cpu")
    assert prop.resolve_impl() == "eager"
    w, h2 = sv.wavelet, sv.h2
    inner = (slice(R + 1, SHAPE[0] - R - 1), slice(R + 1, SHAPE[1] - R - 1))
    for i in range(2):
        geom = Geometry.from_physical(grid, SRC[i], RCV, device="cpu")
        with torch.no_grad():
            d_p = prop(*true, geom, w)
        mi = tuple(f.clone().requires_grad_(True) for f in m)
        s = prop(*mi, geom, w)
        Ji = 0.5 * ((apply_response(s, h2) - apply_response(d_p, h2)) ** 2).sum()
        gi = torch.autograd.grad(Ji, mi)
        assert check.rel(d_p, d[i]) < 1e-12
        assert check.rel(s.detach(), seis[i]) < 1e-12
        assert abs(float(Ji.detach()) - float(J[i])) < 1e-11 * float(J[i])
        for a, b in zip(gi, g):
            assert float(b[i].abs().max()) > 0.0
            assert check.rel(a, b[i]) < 1e-11
            assert check.rel(a[inner], b[i][inner]) < 1e-11
            # zero on the first r rows and columns and on the last r - 1 (the
            # staggered cells sit half a cell towards the far end)
            for edge in (b[i][:R], b[i][:, :R], b[i][1 - R:], b[i][:, 1 - R:]):
                assert float(edge.abs().max()) == 0.0


def test_reference_forward_agrees_with_the_numpy_oracle():
    """The oracle's CPML speed is the model's largest vp: the reference is
    given the same."""
    from tpufwi.grid import Grid as JaxGrid
    from tpufwi.kernels.oracle_numpy import oracle_elastic_2d

    dt, _, true = medium_and_models(11)
    med = reference_elastic.Medium(SHAPE, H, PML, ORDER, dt, float(true[0].max()), F0, dtype=F64)
    w = reference.ricker(F0, dt, NT)
    sv = reference_elastic.make_survey(med, SRC, np.repeat(RCV[None], 2, 0), w,
                                       reference.lowpass_response(NT, dt, 12.0))
    d = reference_elastic.forward(sv, true)[0]
    grid = JaxGrid(shape=SHAPE, h=H, pml=PML, order=ORDER)
    for i in range(2):
        o, _ = oracle_elastic_2d(*(f.numpy() for f in true), grid, dt, w, SRC[i], RCV, F0,
                                 source_type="force_z", record_fields="v")
        assert float(np.abs(o).max()) > 0.0
        assert check.rel(torch.as_tensor(o), d[i]) < 1e-12


@pytest.mark.parametrize("direction", [0, 1])
def test_reference_gradient_matches_central_differences(direction):
    """<g, v> against (J(m + e v) - J(m - e v)) / 2e, v a seeded smooth
    direction in all three fields, zero outside the interior shrunk by r + 1
    (where the gradient is the exact one)."""
    dt, m, true = medium_and_models(23)
    sv = survey(dt)
    d_f = reference.lowpass(reference_elastic.forward(sv, true)[0], sv.h2, 1)
    J, g, _ = reference_elastic.value_and_grad(sv, m, d_f, segment=31)
    gen = torch.Generator().manual_seed(100 + direction)
    mask = torch.zeros(SHAPE, dtype=F64)
    mask[R + 1:SHAPE[0] - R - 1, R + 1:SHAPE[1] - R - 1] = 1.0
    v = [mask * smooth_field(gen, -1.0, 1.0) * s for s in (30.0, 15.0, 20.0)]
    slope = sum(float((gk.sum(0) * vk).sum()) for gk, vk in zip(g, v))
    eps = 1e-3

    def total(sign):
        mm = tuple(f + sign * eps * vk for f, vk in zip(m, v))
        return float(reference_elastic.misfit(sv, reference_elastic.forward(sv, mm)[0],
                                              d_f)[0].sum())

    fd = (total(1.0) - total(-1.0)) / (2 * eps)
    assert abs(slope) > 1e-6 * float(J.sum())
    assert fd == pytest.approx(slope, rel=1e-6)


# ------------------------------------------------------------ the tiny cell


def tiny_cell(tmp_path):
    """A cell of the elastic physics at the CPU tests' size, its files in
    ``tmp_path``; the physics and the land_line layout are the benchmark's."""
    cfg = spec.load_json(spec.HERE / "configs" / "marmousi2_elastic.json")
    cfg.update(nz=SHAPE[0], nx=SHAPE[1], nt=NT, pml=PML, f0_hz=F0, band_hz=10.0,
               survey=dict(cfg["survey"], shots=3, rcv_every=4),
               start=dict(cfg["start"], smooth_sigma=3.0))
    files = {"configs/tiny_land.json": cfg,
             "traffic/survey_grad.json": spec.load_json(spec.HERE / "traffic" / "survey_grad.json"),
             "checks/tiny_land.survey_grad.json": {
                 "sample_shots": 2, "evaluation": [1, 1], "segment": 17,
                 "limits": {"shots_missed": 0, "seis_err": 1e-4, "J_err": 1e-3,
                            "grad_err": 1e-3}}}
    for name, obj in files.items():
        (tmp_path / name).parent.mkdir(exist_ok=True)
        (tmp_path / name).write_text(json.dumps(obj))
    bench = dict(spec.load_json(spec.ROOT / "BENCHMARK.json"),
                 workloads=[dict(name="tiny_land.survey_grad", config="tiny_land",
                                 traffic="survey_grad", chips=1, why="test")])
    return spec.load_cell("tiny_land.survey_grad", bench=bench, base=tmp_path)


def run_tiny(cell):
    torch.manual_seed(0)
    return harness.run_cell(cell, 2**31 + 29, 0.0, False, torch.device("cpu"),
                            time.perf_counter(), log=lambda m: None)


def test_a_tiny_cell_of_the_elastic_physics_is_correct(tmp_path):
    cell = tiny_cell(tmp_path)
    assert cell.physics.__name__ == "fwibench_physics_elastic"
    assert cell.layout.__name__ == "fwibench_layouts_land_line"
    out = run_tiny(cell)
    assert out["correct"] is True, out["check"]
    assert out["failed"] == 0 and out["attempted"] % 3 == 0
    assert set(out["check"]) == {"shots_missed", "seis_err", "J_err", "grad_err"}


def test_seismograms_off_by_a_part_in_a_thousand_are_not_correct(tmp_path, monkeypatch):
    from tpufwi_torch.propagators.elastic2d import ElasticPropagator

    orig = ElasticPropagator.__call__
    monkeypatch.setattr(ElasticPropagator, "__call__",
                        lambda self, *args: orig(self, *args) * 1.001)
    out = run_tiny(tiny_cell(tmp_path))
    assert out["correct"] is False
    assert out["check"]["seis_err"]["value"] > out["check"]["seis_err"]["limit"]
