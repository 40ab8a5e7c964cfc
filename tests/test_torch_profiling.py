"""The port's spans and counters (``tpufwi_torch/profiling.py``) on the CPU.

Over a small survey objective the spans nest as the layers do (evaluation,
shot, propagator call, engine forward and reverse), share their
evaluation's id and take counter changes; with neither a profiler nor
``recording()`` on a span records nothing and makes no CUDA event; while
a profiler records, the spans are host ranges in its trace. The counters
count the kernel wrappers' host syncs and the objectives' shots, and the
inversion's JSONL records split the shots into gradients and trials.
"""

import json
import os

import numpy as np
import pytest
import torch

import tpufwi_torch.invert as tinv
from tpufwi_torch import profiling
from tpufwi_torch.acquisition import Geometry
from tpufwi_torch.grid import Grid
from tpufwi_torch.kernels.acoustic2d_scanres import check_args, strip_profiles
from tpufwi_torch.propagators.acoustic2d import AcousticPropagator
from tpufwi_torch.wavelets import ricker


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    profiling.clear()
    yield
    profiling.clear()


def _problem(impl="eager", shots=2, nt=60):
    """A 20 x 28 two-layer survey on the CPU; ``impl`` a whole-scan engine
    runs its kernels' plain versions (the test lets it past the engine
    check)."""
    grid = Grid(shape=(20, 28), h=(10.0, 10.0), pml=6, order=4)
    dt = grid.cfl_dt(2600.0, safety=0.6)
    prop = AcousticPropagator(grid, dt, 12.0, 2600.0, impl=impl, device="cpu")
    src = [[[2, x]] for x in np.linspace(4, 23, shots).round().astype(int)]
    rcv = [[2, x] for x in range(0, 28, 3)]
    geoms = Geometry.stack([Geometry.from_physical(grid, s, rcv, device="cpu") for s in src])
    w = ricker(12.0, dt, nt, device="cpu")
    vp = torch.full(grid.shape, 2000.0)
    vp[10:] = 2400.0
    with torch.no_grad():
        d = torch.stack([prop(vp, geoms.shot(i), w) for i in range(shots)])
    problem = tinv.FwiProblem(prop=prop, geoms=geoms, d_obs=d, wavelet=w, dt=dt)
    return problem, torch.full(grid.shape, 2100.0)


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_span_tree_over_a_survey_objective(monkeypatch):
    monkeypatch.setattr(AcousticPropagator, "_check_engine", lambda self, impl: None)
    problem, vp0 = _problem("cuda_scansnap")
    vg, loss = problem.stage_objectives(8.0)
    with profiling.recording():
        vg(vp0)
        loss(vp0)
    spans = profiling.spans()
    ids = {s.id: s for s in spans}
    by = _by_name(spans)
    evals = by["objective.evaluation"]
    assert [(e.attrs["kind"], e.attrs["shots"]) for e in evals] == [("grad", 2), ("loss", 2)]
    assert all(e.parent is None and e.evaluation == e.id for e in evals)
    want_parent = {"objective.shot": "objective.evaluation", "propagator.call": "objective.shot",
                   "engine.forward": "propagator.call", "engine.reverse": "objective.shot"}
    for s in spans:
        if s.name in want_parent:
            p = ids[s.parent]
            assert p.name == want_parent[s.name]
            assert s.evaluation == p.evaluation
            assert p.t0_ns <= s.t0_ns <= s.t1_ns <= p.t1_ns
        assert s.device_s is None  # no CUDA event on the CPU
    for e in evals:
        mine = _by_name([s for s in spans if s.evaluation == e.id and s is not e])
        shots = mine["objective.shot"]
        assert [s.attrs["shot"] for s in shots] == [0, 1]
        assert len(mine["propagator.call"]) == len(mine["engine.forward"]) == 2
        assert {s.attrs["engine"] for s in mine["propagator.call"]} == {"cuda_scansnap"}
        assert len(mine.get("engine.reverse", [])) == (2 if e.attrs["kind"] == "grad" else 0)
    # the kernels' spans are the card's, the last two the elastic propagator's
    assert set(by) == set(profiling.SPANS) - {"kernels.forward", "kernels.reverse",
                                              "propagator.materials", "engine.finish"}


class _Event:
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        _Event.made += 1
        self.streams = []

    def record(self, stream=None):
        self.streams.append(stream)


def test_spans_off_record_nothing_and_make_no_event(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: "stream")
    monkeypatch.setattr(_Event, "made", 0)
    cuda = torch.device("cuda")
    assert not profiling.on()
    off = profiling.span("objective.shot", device=cuda, shot=0)
    assert off is profiling.span("kernels.forward", device=cuda)  # one shared no-op
    with off as s:
        assert s is None
    with profiling.span("no.such.span"):  # names are checked only while recording
        pass
    assert profiling.spans() == [] and _Event.made == 0
    with profiling.recording():
        assert profiling.on()
        with profiling.span("objective.shot", device=cuda, shot=3) as s:
            pass
        with pytest.raises(ValueError, match="unknown span"):
            profiling.span("no.such.span")
    assert profiling.spans() == [s] and s.attrs == {"shot": 3}
    assert _Event.made == 2 and [e.streams for e in s.events] == [["stream"], ["stream"]]
    assert not profiling.on()


def test_spans_are_host_ranges_while_a_profiler_records():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.on()
        with profiling.span("objective.evaluation", kind="loss", shots=1):
            with profiling.span("objective.shot", shot=0):
                torch.ones(4).sum()
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert "objective.evaluation" in names and "objective.shot" in names
    assert [s.name for s in profiling.spans()] == ["objective.shot", "objective.evaluation"]


def test_counter_changes_over_spans():
    with profiling.recording():
        with profiling.span("objective.evaluation", kind="grad", shots=2) as e:
            profiling.count("host_syncs", 3)
            with profiling.span("objective.shot", shot=0) as s:
                profiling.count("grad_shots")
                profiling.count("host_syncs")
    assert s.delta("grad_shots") == 1 and s.delta("host_syncs") == 1
    assert e.delta("grad_shots") == 1 and e.delta("host_syncs") == 4
    assert e.delta("loss_shots") == 0
    assert set(e.counters0) == set(profiling.COUNTERS)


def test_check_args_counts_its_host_syncs():
    grid = Grid(shape=(20, 28), h=(10.0, 10.0), pml=6, order=4)
    c2 = torch.full(grid.padded_shape, 0.1)
    prof = tuple(torch.as_tensor(p).contiguous()
                 for p in strip_profiles(grid, 1e-3, 2600.0, 12.0))
    src = torch.tensor([[8, 10]])
    rcv = torch.tensor([[8, x] for x in range(8, 30, 4)])
    before = profiling.counters()["host_syncs"]
    check_args("k", grid, c2, prof, (), src, rcv)
    assert profiling.counters()["host_syncs"] == before + 2
    check_args("k", grid, c2, prof, (), src, rcv, bounds=False)
    assert profiling.counters()["host_syncs"] == before + 2
    with pytest.raises(ValueError, match="outside the padded grid"):
        check_args("k", grid, c2, prof, (), src, rcv + 100)
    assert profiling.counters()["host_syncs"] == before + 4


def test_objectives_count_their_shots():
    problem, vp0 = _problem(shots=3, nt=40)
    vg, loss = problem.stage_objectives(8.0)
    c0 = profiling.counters()
    vg(vp0)
    loss(vp0)
    loss(vp0)
    c1 = profiling.counters()
    assert c1["grad_shots"] - c0["grad_shots"] == 3
    assert c1["loss_shots"] - c0["loss_shots"] == 6
    assert profiling.spans() == []  # counters are always on, spans are not


def test_invert_records_gradient_and_trial_shots(tmp_path, capsys):
    run_dir = str(tmp_path / "cli")
    tinv.main(["--device", "cpu", "model.nz=50", "model.nx=80", "acq.n_shots=2",
               "acq.t_max=0.8", "prop.pml=10", "prop.order=4",
               "precond.use_illumination=false", f"run_dir={run_dir}",
               'stages=[{"fmax": 6.0, "iterations": 2}]'])
    with open(os.path.join(run_dir, "log.jsonl")) as f:
        recs = [r for r in map(json.loads, f) if "event" not in r]
    assert [r["iter"] for r in recs] == [0, 1]
    # the start's gradient joins the first iteration's; each iteration then
    # takes its trials (evals - 1 of them) and one gradient at the accepted model
    assert [r["grad_shots"] for r in recs] == [4, 2]
    assert [r["trial_shots"] for r in recs] == [2 * (r["evals"] - 1) for r in recs]
    assert all(r["shots_per_sec"] > 0 for r in recs)  # the reference's field stays
    out = capsys.readouterr().out
    assert f"({recs[1]['grad_shots']} gradient, {recs[1]['trial_shots']} trial)" in out


def test_trace_writes_a_chrome_trace_with_the_spans(tmp_path):
    problem, vp0 = _problem(shots=1, nt=40)
    _, loss = problem.stage_objectives(8.0)
    with profiling.trace(str(tmp_path), "loss") as prof:
        loss(vp0)
    assert prof is not None
    with open(tmp_path / "profile" / "loss" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"objective.evaluation", "objective.shot", "propagator.call"} <= names
