"""CPU tests of the benchmark: its files are found by name, it refuses to
run without a card, its last line has the contract's keys, the copied
counts give the port's bounds, the reference agrees with the program's
exact CPU engine, the control and each fault the cells can have make
``correct`` false, and a configuration's physics is a module found by name.
The tiny cells under ``cells/`` drive whole runs on the CPU (the program's
``eager`` engines).

    python -m pytest fwibench/tests -q
"""

from __future__ import annotations

import json
import re
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from fwibench import check, counts, harness, reference, run, spec, trace

CELLS = Path(__file__).resolve().parent / "cells"
BENCH = spec.load_json(spec.ROOT / "BENCHMARK.json")
TINY = {"tiny2d.survey_grad": ("tiny2d", "survey_grad"),
        "tiny2d.survey_fwd": ("tiny2d", "survey_fwd"),
        "tiny3d.survey_grad": ("tiny3d", "survey_grad"),
        "tiny_elastic.survey_grad": ("tiny_elastic", "survey_grad")}
SEED = 2**31 + 17


def tiny(name, base=CELLS):
    bench = dict(BENCH, workloads=[dict(name=n, config=c, traffic=t, chips=1, why="test")
                                   for n, (c, t) in TINY.items()])
    return spec.load_cell(name, bench=bench, base=base)


def run_tiny(name, seed=SEED, trace_on=False, control=None):
    torch.manual_seed(0)
    return harness.run_cell(tiny(name), seed, 0.0, trace_on, torch.device("cpu"),
                            time.perf_counter(), log=lambda m: None, control=control)


# ------------------------------------------------------------------ files


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cells_found_by_name(cell):
    c = spec.load_cell(cell)
    assert c.config["source"] and c.traffic["objective"] in ("value_and_grad", "loss")
    src, rcv = spec.geometry(c)
    assert src.shape[0] >= c.check["sample_shots"] and rcv.shape[1] == len(c.shape)
    assert set(c.check["limits"]) == {"shots_missed", "seis_err", "J_err"} | (
        {"grad_err"} if c.gradient else set())
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.reader(m["name"]))
    assert Path(c.physics.__file__) == spec.HERE / "physics" / "acoustic.py"
    layout = c.config["survey"]["layout"]
    assert Path(c.layout.__file__) == spec.HERE / "layouts" / f"{layout}.py"


def test_benchmark_file_keeps_the_contract():
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert all(name.match(n) for n in names) and len(set(names)) == len(names)
    for c in BENCH["configs"]:
        cfg = spec.load_json(spec.ROOT / c["file"])
        assert c["file"].startswith("fwibench/") and cfg["source"]
        assert set(c["reduced"]) == set(cfg.get("published", {}))
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    assert all(m["moves"] in e2e for m in BENCH["per_layer"])
    # every per-layer metric names its cells, so that a cell added later need not read it
    cells = {w["name"] for w in BENCH["workloads"]}
    assert all(m["workloads"] and set(m["workloads"]) <= cells for m in BENCH["per_layer"])
    assert 1 <= BENCH["run_seconds"] <= 51


def test_readers_leave_out_what_the_run_cannot_read():
    r = harness.Run(evaluations=3, shots=16, nt=100, window_s=2.0, setup_s=1.0, peak_bytes=None,
                    trace=None, traced_shots=0, shot_bound_s=1e-3)
    assert spec.reader("shots_per_s")(r) == 24.0 and spec.reader("setup_s")(r) == 1.0
    for m in ("peak_mem_gib", "device_idle_pct", "shot_roofline_pct", "launches_per_step"):
        assert spec.reader(m)(r) is None
    r.trace = trace.Summary(window_s=1.0, busy_s=0.8, kernels=3200, device_ops=[], idle_gaps=[])
    r.traced_shots = 16
    assert spec.reader("device_idle_pct")(r) == pytest.approx(20.0)
    assert spec.reader("shot_roofline_pct")(r) == pytest.approx(2.0)
    assert spec.reader("launches_per_step")(r) == pytest.approx(2.0)


# ------------------------------------------------------------- the command


def test_no_card_fails_without_a_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", BENCH["workloads"][0]["name"], "--seed", str(SEED),
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_too_few_cards_fail_without_a_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    rc = run.main(["--workload", BENCH["workloads"][0]["name"], "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


@pytest.mark.parametrize("loaded", [None, "jax", "jaxlib.xla_client", "flax", "tpufwi.grid"])
def test_a_run_that_loaded_jax_prints_no_result(monkeypatch, capsys, loaded):
    """The port's name begins with the JAX package's: top-level names are
    compared whole, so ``tpufwi_torch`` alone lets the result through."""
    import types

    import tpufwi_torch.grid  # noqa: F401

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch, "set_num_threads", lambda n: None)
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: {"correct": True})
    for name in [n for n in sys.modules if n.partition(".")[0] in run.JAX_MODULES]:
        monkeypatch.delitem(sys.modules, name)
    if loaded:
        monkeypatch.setitem(sys.modules, loaded, types.ModuleType(loaded))
    rc = run.main(["--workload", BENCH["workloads"][0]["name"], "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    if loaded:
        assert rc != 0 and out.out == "" and loaded.partition(".")[0] in out.err
    else:
        assert rc == 0 and json.loads(out.out) == {"correct": True}


@pytest.mark.parametrize("name", sorted(TINY))
def test_a_run_is_correct_and_keeps_the_contract_keys(name):
    out = run_tiny(name)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "check"]
    assert out["correct"] is True, out["check"]
    assert set(out["metrics"]) == {"shots_per_s", "setup_s"}  # no device peak on the CPU
    assert out["attempted"] % len(spec.geometry(tiny(name))[0]) == 0 and out["failed"] == 0
    assert all(set(v) == {"value", "limit"} for v in out["check"].values())
    json.dumps(out)


def test_a_traced_run_keeps_the_contract_keys():
    out = run_tiny("tiny3d.survey_grad", trace_on=True)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                         "check"]
    assert {"busy_s", "window_s"} <= set(out["device"]) and out["correct"] is True


# ----------------------------------------------------------------- counts


@pytest.mark.parametrize("shape, pml, nrec, tape, pass_, ms", [
    ((351, 1701), 20, 851, ("snapshot", "bfloat16"), "forward", 0.00049),
    ((351, 1701), 20, 851, ("snapshot", "bfloat16"), "reverse", 0.00055),
    ((400, 160, 560), 10, 3420, ("rings", "float32"), "forward", 0.29134),
    ((400, 160, 560), 10, 3420, ("rings", "float32"), "reverse", 0.57381),
])
def test_counts_give_the_ports_bounds(shape, pml, nrec, tape, pass_, ms):
    nt = 512 if len(shape) == 2 else 64  # the shapes of PERF.md's rows 1, 2, 12, 15
    c = counts.passes(shape, 8, pml, nt, 1, nrec, tape, True)[pass_]
    assert round(1e3 * counts.step_bound_s(c, nt)[0], 5) == ms


def test_ring_cells_match_the_programs_tape():
    from tpufwi_torch.grid import Grid
    from tpufwi_torch.propagators.boundary import RingSpec

    for shape in ((351, 1701), (400, 160, 560), (30, 44)):
        g = Grid(shape=shape, h=(10.0,) * len(shape), pml=10, order=8)
        assert counts.ring_cells(shape, 4) == RingSpec.build(g).tape_bytes_per_step(1)


# -------------------------------------------------------------- reference


@pytest.mark.parametrize("shape", [(30, 44), (18, 22, 26)])
def test_reference_agrees_with_the_programs_exact_engine(shape):
    from tpufwi_torch.acquisition import Geometry
    from tpufwi_torch.filters import apply_response
    from tpufwi_torch.grid import Grid
    from tpufwi_torch.propagators.acoustic2d import AcousticPropagator

    gen = torch.Generator().manual_seed(3)
    nd, h, pml, order, cmax, f0, nt = len(shape), (10.0,) * len(shape), 6, 8, 3000.0, 15.0, 120
    dt = reference.cfl_dt(h, cmax, order, 0.7)
    vp, vt = ((2000 + 800 * torch.rand(shape, generator=gen, dtype=torch.float64)).float()
              for _ in range(2))
    if nd == 2:
        src, rcv = np.array([[[2, 10]], [[2, 30]]]), np.array([[3, x] for x in range(0, 44, 3)])
    else:
        src = np.array([[[5, 2, 8]], [[12, 2, 18]]])
        rcv = np.array([[y, 3, x] for y in range(0, 18, 4) for x in range(0, 26, 5)])
    w, h2 = reference.ricker(f0, dt, nt), reference.lowpass_response(nt, dt, 10.0)
    grid = Grid(shape=shape, h=h, pml=pml, order=order)
    prop = AcousticPropagator(grid, dt, f0, cmax, device="cpu")
    geoms = [Geometry.from_physical(grid, s, rcv, device="cpu") for s in src]
    wt, h2t = (torch.as_tensor(x, dtype=torch.float32) for x in (w, h2))
    sv = reference.make_survey(reference.Medium(shape, h, pml, order, dt, cmax, f0), src,
                               np.repeat(rcv[None], 2, 0), w, h2)
    d = reference.forward(sv, vt)[0]
    J, g, seis = reference.value_and_grad(sv, vp, reference.lowpass(d, sv.h2, 1), segment=17)
    d_p = torch.stack([prop(vt, gm, wt) for gm in geoms])
    assert check.rel(d_p, d) < 2e-6
    for i in range(2):
        v = vp.clone().requires_grad_(True)
        s = prop(v, geoms[i], wt)
        Ji = 0.5 * ((apply_response(s, h2t) - apply_response(d_p[i], h2t)) ** 2).sum()
        (gi,) = torch.autograd.grad(Ji, v)
        assert check.rel(s.detach(), seis[i]) < 2e-6
        assert abs(float(Ji.detach()) - float(J[i])) < 2e-5 * float(J[i])
        assert check.rel(gi, g[i]) < 2e-4


# ------------------------------------------- the control and the faults


def test_the_control_is_not_correct():
    out = run_tiny("tiny3d.survey_grad", control=torch.bfloat16)
    limits = tiny("tiny3d.survey_grad").check["limits"]
    assert out["correct"] is True
    assert not check.verdict(out["control"], limits), out["control"]


def stale(monkeypatch):
    """The objective hands back its first evaluation's result unchanged."""
    from tpufwi_torch.invert import FwiProblem

    orig = FwiProblem.stage_objectives

    def patched(self, fmax, wavelet=None):
        vg, loss = orig(self, fmax, wavelet)
        memo = {}

        def once(vp):
            if "out" not in memo:
                memo["out"] = vg(vp)
            return memo["out"]

        return once, loss

    monkeypatch.setattr(FwiProblem, "stage_objectives", patched)


def half_the_shots(monkeypatch):
    """Half the survey left out, the objective scaled up to the whole."""
    from tpufwi_torch.invert import FwiProblem

    orig = FwiProblem.stage_objectives
    monkeypatch.setattr(FwiProblem, "n_shots",
                        property(lambda self: max(1, int(self.d_obs.shape[0]) // 2)))

    def patched(self, fmax, wavelet=None):
        vg, loss = orig(self, fmax, wavelet)
        k = int(self.d_obs.shape[0]) / self.n_shots

        def scaled(vp):
            J, g = vg(vp)
            return J * k, g * k

        return scaled, loss

    monkeypatch.setattr(FwiProblem, "stage_objectives", patched)


def altered(monkeypatch):
    """Every seismogram off by one part in a thousand where it is made."""
    from tpufwi_torch.propagators.acoustic2d import AcousticPropagator

    orig = AcousticPropagator.__call__
    monkeypatch.setattr(AcousticPropagator, "__call__",
                        lambda self, vp, geom, w: orig(self, vp, geom, w) * 1.001)


@pytest.mark.parametrize("fault", [stale, half_the_shots, altered])
def test_each_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    out = run_tiny("tiny3d.survey_grad" if fault is not half_the_shots else "tiny2d.survey_grad")
    assert out["correct"] is False, out["check"]


# ------------------------------------------------------------------ trace


def test_busy_time_is_the_union_of_overlapping_kernels():
    kernels = [("a", 0, 10), ("b", 5, 15), ("a", 20, 30), ("c", 40, 45)]
    host = [("outer", 0, 100), ("sync", 15, 20), ("launch", 30, 40)]
    s = trace.summarize(kernels, host, 0, 50)
    assert s.busy_s == pytest.approx(30e-9) and s.window_s == pytest.approx(50e-9)
    assert s.kernels == 4 and s.device_ops[0] == ["a", pytest.approx(20e-9)]
    assert dict((k, v) for k, v in s.idle_gaps) == pytest.approx(
        {"sync": 5e-9, "launch": 10e-9, "outer": 5e-9})


# -------------------------------------------------------- the physics seam


def test_a_physics_is_found_by_the_name_its_configuration_gives():
    """The elastic test cell's physics and survey layout are files of the
    test tree alone: no file of the harness names them."""
    c = tiny("tiny_elastic.survey_grad")
    assert Path(c.physics.__file__) == CELLS / "physics" / "elastic_plumbing.py"
    assert Path(c.layout.__file__) == CELLS / "layouts" / "edge_spread.py"
    src, rcv = spec.geometry(c)
    assert src[:, 0, 1].tolist() == [6, 13, 21] and rcv[:, 1].tolist() == [4, 8, 12, 16, 20]
    acoustic = tiny("tiny2d.survey_grad")
    assert Path(acoustic.physics.__file__) == spec.HERE / "physics" / "acoustic.py"
    assert Path(acoustic.layout.__file__) == spec.HERE / "layouts" / "split_spread.py"
    outside = [p for p in spec.HERE.rglob("*.*") if "tests" not in p.relative_to(spec.HERE).parts]
    assert not [p for p in outside + [spec.ROOT / "BENCHMARK.json"] if p.suffix != ".pyc"
                and ("elastic_plumbing" in p.read_text() or "edge_spread" in p.read_text())]


@pytest.mark.parametrize("key", ["physics", "layout"])
def test_an_unknown_physics_fails_when_the_cell_is_loaded(tmp_path, key):
    """So does an unknown survey layout, each naming what it lacks."""
    for sub, name in (("configs", "tiny2d.json"), ("traffic", "survey_grad.json"),
                      ("checks", "tiny2d.survey_grad.json")):
        (tmp_path / sub).mkdir()
        text = (CELLS / sub / name).read_text()
        if sub == "configs":
            cfg = json.loads(text)
            if key == "physics":
                cfg["physics"] = "no_such_physics"
            else:
                cfg["survey"] = dict(cfg["survey"], layout="no_such_layout")
            text = json.dumps(cfg)
        (tmp_path / sub / name).write_text(text)
    with pytest.raises(FileNotFoundError, match=f"no_such_{key}"):
        tiny("tiny2d.survey_grad", base=tmp_path)


def test_a_reference_without_every_fields_gradient_fails_the_comparison():
    """``grad_err`` covers every field: a reference that leaves one out
    stops the comparison, it does not drop the field."""
    seis, g = torch.ones(2, 5, 3), (torch.ones(4), torch.ones(4), torch.ones(4))
    ref = (seis, torch.ones(2), tuple(torch.ones(2, 4) for _ in range(3)))
    assert check.readings(seis, 2.0, g, ref)["grad_err"] == pytest.approx(0.5)
    with pytest.raises(ValueError):
        check.readings(seis, 2.0, g, ref[:2] + (ref[2][:2],))


def test_one_fields_gradient_off_by_a_percent_is_not_correct(monkeypatch):
    """The harness's plumbing, not the physics (``cells/physics/
    elastic_plumbing.py`` is its own reference): a three-field model runs
    through ``run_cell`` with two-component seismograms and a gradient per
    field, and the evaluation's rho gradient scaled by 1.01 where it is
    captured fails ``grad_err``, which takes the worst field."""
    seen = []
    take = check.Captured.take

    def scaled(prog, sample):
        got = take(prog, sample)
        got.g[2].mul_(1.01)
        seen.append(got)
        return got

    monkeypatch.setattr(check.Captured, "take", staticmethod(scaled))
    out = run_tiny("tiny_elastic.survey_grad")
    (got,) = seen
    assert tuple(got.seis.shape) == (3, 120, 5, 2) and len(got.g) == len(got.grads) == 3
    assert all(tuple(g.shape) == (3, 20, 28) for g in got.grads)
    assert out["correct"] is False
    assert [k for k, v in out["check"].items() if v["value"] > v["limit"]] == ["grad_err"]
