"""The benchmark's plain marine elastic reference
(``fwibench/reference_elastic_marine.py``), the marine cell's physics
(``fwibench/physics/elastic_marine.py``), its count and its image metric
on the CPU.

The reference, in float64, against the port's exact CPU engine
(``ElasticPropagator(impl="eager")`` on a free-surface grid, a pressure
source, pressure records, a water layer with vs = 0): seismograms, J and
the three gradients; its forward against the JAX package's numpy oracle
``oracle_elastic_2d``; its gradient against central differences along
seeded directions; the vs gradient exactly 0 in the water. Then the
cell's inputs keep vs = 0 in the water in every evaluation, the count
follows its formula, the ``fs_image_us_per_step`` reader reads stubbed
records, and a tiny marine cell runs through ``fwibench.harness.run_cell``:
correct, and not correct with every seismogram off by one part in a
thousand. Every test takes seconds on one thread: a 20 x 28 grid, order 8,
PML 6, nt 120, the top 5 rows water.
"""

from __future__ import annotations

import ast
import json
import time

import numpy as np
import pytest
import torch

from fwibench import (
    check,
    counts,
    counts_elastic,
    counts_elastic_marine,
    harness,
    models,
    reference,
    reference_elastic,
    reference_elastic_marine,
    spec,
    trace,
)

F64 = torch.float64
SHAPE, H, PML, ORDER, F0, NT, VP_MAX = (20, 28), (10.0, 10.0), 6, 8, 20.0, 120, 4700.0
R, WATER = ORDER // 2, 5
CELL = "marmousi2_elastic_marine.survey_grad"
SRC = np.array([[[2, 6]], [[2, 21]]])
RCV = np.stack([np.full(9, 2), np.arange(1, 28, 3)], 1)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def smooth_field(gen, lo, hi):
    """A seeded random field, smoothed and scaled to [lo, hi] (float64)."""
    x = models.gaussian(torch.rand(SHAPE, generator=gen, dtype=F64), 2.0)
    return lo + (hi - lo) * (x - x.min()) / (x.max() - x.min())


def with_water(vp, vs, rho):
    vp, vs, rho = vp.clone(), vs.clone(), rho.clone()
    vp[:WATER], vs[:WATER], rho[:WATER] = 1500.0, 0.0, 1000.0
    return vp, vs, rho


def medium_and_models(seed):
    """(dt, (vp, vs, rho) at which the gradient is taken, the true model),
    both with the water layer."""
    gen = torch.Generator().manual_seed(seed)
    vp = smooth_field(gen, 2000.0, 4000.0)
    vs = vp / 1.9 * (1.0 + 0.05 * smooth_field(gen, -1.0, 1.0))
    rho = 310.0 * vp**0.25
    true = with_water(vp * (1.0 + 0.03 * smooth_field(gen, -1.0, 1.0)), vs, rho)
    m = with_water(vp, vs, rho)
    return reference_elastic.cfl_dt(H, VP_MAX, ORDER, 0.7), m, true


def survey(dt, dtype=F64, vp_max=VP_MAX):
    ref = reference_elastic_marine
    med = ref.MarineMedium(SHAPE, H, PML, ORDER, dt, vp_max, F0, dtype=dtype)
    return reference_elastic.make_survey(med, SRC, np.repeat(RCV[None], 2, 0),
                                         reference.ricker(F0, dt, NT),
                                         reference.lowpass_response(NT, dt, 12.0))


def test_reference_agrees_with_the_ports_exact_engine():
    """float64 on both sides, the port's eager engine on a free-surface grid
    with a pressure source and pressure records: the reference's whole
    gradient arrays equal the port's, which masks its staggered cotangents
    to the same interior."""
    from tpufwi_torch.acquisition import Geometry
    from tpufwi_torch.filters import apply_response
    from tpufwi_torch.grid import Grid
    from tpufwi_torch.propagators.elastic2d import ElasticPropagator

    dt, m, true = medium_and_models(5)
    sv = survey(dt)
    ref = reference_elastic_marine
    d = ref.forward(sv, true)[0]
    J, g, seis = ref.value_and_grad(sv, m, reference.lowpass(d, sv.h2, 1), segment=17)
    grid = Grid(shape=SHAPE, h=H, pml=PML, order=ORDER, free_surface=True)
    prop = ElasticPropagator(grid, dt, F0, VP_MAX, dtype=F64, source_type="pressure",
                             record="p", impl="eager", device="cpu")
    assert prop.resolve_impl() == "eager"
    w, h2 = sv.wavelet, sv.h2
    for i in range(2):
        geom = Geometry.from_physical(grid, SRC[i], RCV, device="cpu")
        with torch.no_grad():
            d_p = prop(*true, geom, w)
        mi = tuple(f.clone().requires_grad_(True) for f in m)
        s = prop(*mi, geom, w)
        Ji = 0.5 * ((apply_response(s, h2) - apply_response(d_p, h2)) ** 2).sum()
        gi = torch.autograd.grad(Ji, mi)
        assert d_p.shape == (NT, len(RCV)) and float(d_p.abs().max()) > 0.0
        assert check.rel(d_p, d[i]) < 1e-12
        assert check.rel(s.detach(), seis[i]) < 1e-12
        assert abs(float(Ji.detach()) - float(J[i])) < 1e-11 * float(J[i])
        for a, b in zip(gi, g):
            assert float(b[i].abs().max()) > 0.0
            assert check.rel(a, b[i]) < 1e-11
        # mu = rho vs^2: nothing of the vs gradient in the water, on either side
        assert float(gi[1][:WATER].abs().max()) == 0.0
        assert float(g[1][i][:WATER].abs().max()) == 0.0
        assert float(g[1][i][WATER:].abs().max()) > 0.0


def test_reference_forward_agrees_with_the_numpy_oracle():
    """The oracle has the free surface and the pressure source; its CPML
    speed is the model's largest vp, which the reference is given too."""
    from tpufwi.grid import Grid as JaxGrid
    from tpufwi.kernels.oracle_numpy import oracle_elastic_2d

    dt, _, true = medium_and_models(11)
    sv = survey(dt, vp_max=float(true[0].max()))
    d = reference_elastic_marine.forward(sv, true)[0]
    w = sv.wavelet.numpy()
    grid = JaxGrid(shape=SHAPE, h=H, pml=PML, order=ORDER, free_surface=True)
    for i in range(2):
        o, _ = oracle_elastic_2d(*(f.numpy() for f in true), grid, dt, w, SRC[i], RCV, F0,
                                 source_type="pressure", record_fields="p")
        assert o.shape == (NT, len(RCV)) and float(np.abs(o).max()) > 0.0
        assert check.rel(torch.as_tensor(o), d[i]) < 1e-12


@pytest.mark.parametrize("direction", [0, 1])
def test_reference_gradient_matches_central_differences(direction):
    """<g, v> against (J(m + e v) - J(m - e v)) / 2e, v a seeded smooth
    direction in all three fields, zero outside the interior shrunk by r + 1
    (where the gradient is the exact one) and, for vs, in the water (vs
    stays 0 there)."""
    ref = reference_elastic_marine
    dt, m, true = medium_and_models(23)
    sv = survey(dt)
    d_f = reference.lowpass(ref.forward(sv, true)[0], sv.h2, 1)
    J, g, _ = ref.value_and_grad(sv, m, d_f, segment=31)
    gen = torch.Generator().manual_seed(100 + direction)
    mask = torch.zeros(SHAPE, dtype=F64)
    mask[R + 1:SHAPE[0] - R - 1, R + 1:SHAPE[1] - R - 1] = 1.0
    v = [mask * smooth_field(gen, -1.0, 1.0) * s for s in (30.0, 15.0, 20.0)]
    v[1][:WATER] = 0.0
    slope = sum(float((gk.sum(0) * vk).sum()) for gk, vk in zip(g, v))
    eps = 1e-3

    def total(sign):
        mm = tuple(f + sign * eps * vk for f, vk in zip(m, v))
        return float(ref.misfit(sv, ref.forward(sv, mm)[0], d_f)[0].sum())

    fd = (total(1.0) - total(-1.0)) / (2 * eps)
    assert abs(slope) > 1e-6 * float(J.sum())
    assert fd == pytest.approx(slope, rel=1e-6)


def test_the_reference_imports_nothing_of_the_program():
    for name in ("reference_elastic_marine.py", "physics/elastic_marine.py",
                 "counts_elastic_marine.py", "metrics/fs_image_us_per_step.py"):
        tree = ast.parse((spec.HERE / name).read_text())
        top = {a.name.partition(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
               for a in n.names}
        top |= {n.module.partition(".")[0] for n in ast.walk(tree)
                if isinstance(n, ast.ImportFrom) and n.module}
        if name.startswith("physics/"):  # the program, imported inside ``program`` alone
            top.discard("tpufwi_torch")
        assert not top & {"tpufwi_torch", "tpufwi", "jax", "jaxlib"}, (name, top)


# ------------------------------------------------------------------ the cell


def test_the_configuration_keeps_the_published_sizes():
    c = spec.load_cell(CELL)
    assert c.physics.__name__ == "fwibench_physics_elastic_marine"
    assert c.layout.__name__ == "fwibench_layouts_split_spread"
    cfg = c.config
    assert (c.shape, c.h, cfg["nt"], cfg["order"], cfg["pml"]) == (
        (351, 1701), (10.0, 10.0), 4885, 8, 20)
    assert cfg["free_surface"] is True and (cfg["source_type"], cfg["record"]) == ("pressure", "p")
    assert cfg["model"]["water_depth_m"] == 450.0 and cfg["model"]["water"]["vs"] == 0.0
    assert cfg["reduced"] == [] and "published" not in cfg and cfg["assumed"]
    assert c.gradient and c.tape == ("rings", "float32")
    src, rcv = spec.geometry(c)
    assert src.shape == (16, 1, 2) and rcv.shape == (851, 2)
    assert set(src[:, 0, 0]) == {2} and set(rcv[:, 0]) == {2}
    entry = {x["name"]: x for x in spec.load_json(spec.ROOT / "BENCHMARK.json")["configs"]}
    assert entry["marmousi2_elastic_marine"]["reduced"] == []
    assert {m["name"] for m in c.per_layer} == {
        "materials_ms_per_shot", "shot_roofline_pct", "fwd_us_per_step", "rev_us_per_step",
        "shot_overhead_ms", "host_syncs_per_shot", "peak_beyond_tape_gib", "launches_per_step",
        "device_idle_pct", "fs_image_us_per_step"}


def small_cell_inputs(seed=2**31 + 5):
    c = spec.load_cell(CELL)
    c.config = dict(c.config, nz=120, nx=100)
    return c, c.physics.inputs(c, seed, torch.device("cpu"))


def test_the_water_keeps_vs_zero_in_every_evaluation():
    c, inp = small_cell_inputs()
    nw = c.physics.water_rows(c.config)
    assert nw == 45
    vp, vs, rho = inp.m_true
    assert float(vs[:nw].abs().max()) == 0.0 and float(vs[nw:].min()) > 700.0
    assert set(vp[:nw].unique().tolist()) == {1500.0} and set(rho[:nw].unique().tolist()) == {1000.0}
    assert torch.equal(inp.m0[2], rho)  # rho kept at the truth
    for f0, f in zip(inp.m0[:2], inp.m_true[:2]):
        assert torch.equal(f0[:nw], f[:nw])  # the water restored
        assert not torch.equal(f0[nw:], f[nw:])  # the section below smoothed
    assert float(inp.m0[1][nw:].min()) > 700.0  # no water smeared below the seabed
    for e in range(6):
        m = c.physics.model(c, inp, 2**31 + 5, e)
        assert float(m[1][:nw].abs().max()) == 0.0
        assert float(m[2][:nw].min()) >= 995.0 and float(m[2][:nw].max()) <= 1005.0
        for f, f0, (lo, hi) in zip(m, inp.m0, c.config["bounds"]):
            assert float(f.min()) >= lo and float(f.max()) <= hi
            assert float((f - f0).abs().max()) <= 0.005 * float(f0.abs().max()) + 1e-3


@pytest.mark.parametrize("shape, pml, order, nrec, nsrc", [
    ((351, 1701), 20, 8, 851, 1), ((36, 60), 10, 4, 20, 2)])
def test_the_marine_count_follows_its_formula(shape, pml, order, nrec, nsrc):
    """counts_elastic's passes with one value a hydrophone, less the top
    strip's memories, plus the images' operations; the same bytes."""
    r, S = order // 2, pml + order // 2
    NZ, NX = (s + 2 * S for s in shape)
    cells = NZ * NX
    land = counts_elastic.passes(shape, order, pml, 4885, nsrc, nrec, ("rings", "float32"), True)
    ours = counts_elastic_marine.passes(shape, order, pml, 4885, nsrc, nrec,
                                        ("rings", "float32"), True)
    n_ring = counts.ring_cells(shape, r)
    fwd = cells * (16 * r + 20) + 12 * S * (NX + 2 * NZ) + 2 * nsrc + 2 * r * NX
    rev = cells * (32 * r + 60) + 20 * S * (NX + 2 * NZ) + 4 * nsrc + 6 * r * NX
    assert ours == {"forward": (fwd, (1 + nrec + 5 * n_ring) * 4, 40 * cells),
                    "reverse": (rev, (1 + nrec + nsrc + 5 * n_ring) * 4, 60 * cells)}
    assert {k: v[1:] for k, v in ours.items()} == {k: v[1:] for k, v in land.items()}
    assert counts_elastic_marine.passes(shape, order, pml, 4885, nsrc, nrec, None, False) == {
        "forward": (fwd, (1 + nrec) * 4, 40 * cells)}


def test_the_cells_bound_is_its_two_passes():
    """A marine shot's bound is the land shot's less a little: the top
    strip's memories outweigh the images."""
    c = spec.load_cell(CELL)
    inp = c.physics.Inputs(None, None, 0.0, 4700.0, 4885, *spec.geometry(c), None, None)
    bound = c.physics.shot_bound_s(c, inp)
    per_step = [counts.step_bound_s(p, 4885)[0] for p in counts_elastic_marine.passes(
        c.shape, 8, 20, 4885, 1, 851, c.tape, True).values()]
    land = counts_elastic.shot_bound_s(c.shape, 8, 20, 4885, 1, 851, c.tape, True)
    assert bound == pytest.approx(4885 * sum(per_step)) and 0.99 * land < bound < land


# -------------------------------------------------------------- the metric


class Ev:
    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, end):
        return end.ms - self.ms


def image_run(steps=2 * 4885, with_counter=True, ops=None):
    """A traced run's (Run, spans): one evaluation whose image counter rose
    by ``steps``, and a trace with two image kernels among others."""
    from tpufwi_torch import profiling

    c0 = dict.fromkeys(profiling.COUNTERS, 0)
    if not with_counter:  # a program from before the counter
        del c0["escan_image_steps"]
    ev = profiling.Span("objective.evaluation", 0, None, 0, {"kind": "grad", "shots": 2}, 0, c0)
    ev.counters1 = dict(c0, **({"escan_image_steps": steps} if with_counter else {}))
    if ops is None:
        ops = [["void (anonymous namespace)::er_s<4>(...)", 0.6],
               ["void (anonymous namespace)::er_image_mid<4>(...)", 0.03],
               ["void (anonymous namespace)::er_image_tail<4>(...)", 0.02],
               ["void (anonymous namespace)::ef_v<4>(...)", 0.2]]
    summary = trace.Summary(window_s=1.0, busy_s=0.99, kernels=100, device_ops=ops, idle_gaps=[])
    run = harness.Run(evaluations=2, shots=2, nt=4885, window_s=None, setup_s=1.0,
                      peak_bytes=None, trace=summary, traced_shots=2, shot_bound_s=1e-3)
    return run, [ev]


@pytest.mark.parametrize("case, expected", [
    ("images", 1e6 * 0.05 / (2 * 4885)), ("no counter", None), ("no trace", None),
    ("no image step", None), ("no image kernel", None), ("no records", None)])
def test_fs_image_reader(monkeypatch, case, expected):
    """The image kernels' device time over the counter's change; None on a
    program without the counter (the parent of this metric), without a
    trace, without a free-surface reverse, without an image kernel in the
    trace, or without records."""
    from tpufwi_torch import profiling

    run, spans = image_run(with_counter=case != "no counter",
                           steps=0 if case == "no image step" else 2 * 4885,
                           ops=[["ef_v", 0.2]] if case == "no image kernel" else None)
    if case == "no trace":
        run.trace = None
    monkeypatch.setattr(profiling, "spans", lambda: [] if case == "no records" else spans)
    got = spec.reader("fs_image_us_per_step")(run)
    assert got == (pytest.approx(expected) if expected is not None else None)


# ------------------------------------------------------------ the tiny cell


def tiny_cell(tmp_path):
    """A marine cell at the CPU tests' size, its files in ``tmp_path``; the
    physics and the split_spread layout are the benchmark's."""
    cfg = spec.load_json(spec.HERE / "configs" / "marmousi2_elastic_marine.json")
    cfg.update(nz=SHAPE[0], nx=SHAPE[1], h_m=H[0], nt=NT, pml=PML, f0_hz=F0, band_hz=10.0,
               model=dict(cfg["model"], water_depth_m=10.0 * WATER),
               survey=dict(cfg["survey"], shots=3, rcv_every=3),
               start=dict(cfg["start"], smooth_sigma=3.0))
    files = {"configs/tiny_marine.json": cfg,
             "traffic/survey_grad.json": spec.load_json(spec.HERE / "traffic" / "survey_grad.json"),
             "checks/tiny_marine.survey_grad.json": {
                 "sample_shots": 2, "evaluation": [1, 1], "segment": 17,
                 "limits": {"shots_missed": 0, "seis_err": 1e-4, "J_err": 1e-3,
                            "grad_err": 1e-3}}}
    for name, obj in files.items():
        (tmp_path / name).parent.mkdir(exist_ok=True)
        (tmp_path / name).write_text(json.dumps(obj))
    bench = dict(spec.load_json(spec.ROOT / "BENCHMARK.json"),
                 workloads=[dict(name="tiny_marine.survey_grad", config="tiny_marine",
                                 traffic="survey_grad", chips=1, why="test")])
    return spec.load_cell("tiny_marine.survey_grad", bench=bench, base=tmp_path)


def run_tiny(cell):
    torch.manual_seed(0)
    return harness.run_cell(cell, 2**31 + 29, 0.0, False, torch.device("cpu"),
                            time.perf_counter(), log=lambda m: None)


def test_a_tiny_marine_cell_is_correct(tmp_path):
    cell = tiny_cell(tmp_path)
    assert cell.physics.__name__ == "fwibench_physics_elastic_marine"
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


def test_the_3d_forward_cell_is_the_acoustic_forward():
    """``overthrust3d.survey_fwd``: the acoustic physics on the 3D
    configuration, loss only, one sampled shot, no gradient limit, the
    forward's per-layer metrics."""
    c = spec.load_cell("overthrust3d.survey_fwd")
    assert c.physics.__name__ == "fwibench_physics_acoustic" and not c.gradient
    assert c.shape == (400, 160, 560) and c.tape is None
    assert c.check["sample_shots"] == 1
    assert set(c.check["limits"]) == {"shots_missed", "seis_err", "J_err"}
    assert {m["name"] for m in c.per_layer} == {
        "device_idle_pct", "shot_roofline_pct", "launches_per_step", "fwd_us_per_step",
        "shot_overhead_ms", "host_syncs_per_shot"}
    inp = c.physics.Inputs(None, None, 0.0, 6000.0, 900, *spec.geometry(c), None, None)
    grad = spec.load_cell("overthrust3d.survey_grad")
    assert c.physics.shot_bound_s(c, inp) < 0.5 * grad.physics.shot_bound_s(grad, inp)
