"""CPU tests of the readers of the program's own spans and counters
(``fwibench/program_trace.py``): each reader on stubbed records, None
without records, None on a program without ``tpufwi_torch.profiling`` (as
at a commit before it), and the readers inside a traced run of a tiny cell.

    python -m pytest fwibench/tests -q
"""

from __future__ import annotations

import sys

import pytest

import tpufwi_torch
from fwibench import harness, spec
from fwibench.tests.test_fwibench import BENCH, run_tiny
from tpufwi_torch import profiling

NEW = ("fwd_us_per_step", "rev_us_per_step", "shot_overhead_ms", "host_syncs_per_shot",
       "peak_beyond_tape_gib")
GIB = 2**30


class Ev:
    """A CUDA event stand-in at ``ms`` on the device's clock."""

    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, end):
        return end.ms - self.ms


@pytest.fixture(autouse=True)
def _no_records_left():
    profiling.clear()
    yield
    profiling.clear()


def records(shots=2, nt=100, fwd_ms=1.0, rev_ms=2.0, gap_ms=0.5, tape=3 * GIB, syncs=4,
            device=True):
    """A traced gradient evaluation of ``shots`` shots: each shot a forward
    and a reverse kernel span and ``gap_ms`` outside them, ``syncs`` host
    syncs a shot."""
    out, ids, t, c = [], iter(range(1000)), 0.0, {k: 0 for k in profiling.COUNTERS}

    def span(name, parent, t0, t1, **attrs):
        s = profiling.Span(name, next(ids), parent, 0, attrs, 0, dict(c))
        s.events = (Ev(t0), Ev(t1)) if device else None
        return s

    ev = span("objective.evaluation", None, 0.0, 0.0, kind="grad", shots=shots)
    ev.events = None
    for i in range(shots):
        shot = span("objective.shot", ev.id, t, t + fwd_ms + rev_ms + gap_ms, shot=i)
        call = span("propagator.call", shot.id, 0, 0, engine="cuda_scansnap")
        call.events = None
        fwd = span("kernels.forward", call.id, t, t + fwd_ms, wrapper="w", variant="fused",
                   nt=nt, tape_bytes=tape)
        rev = span("kernels.reverse", shot.id, t + fwd_ms, t + fwd_ms + rev_ms, wrapper="w",
                   variant="fused", nt=nt, tape_bytes=0)
        c["host_syncs"] += syncs
        c["grad_shots"] += 1
        out += [fwd, call, rev, shot]
        t += fwd_ms + rev_ms + gap_ms
    ev.counters1 = dict(c)
    return out + [ev]


def run(peak=None):
    return harness.Run(evaluations=2, shots=2, nt=100, window_s=None, setup_s=1.0,
                       peak_bytes=peak, trace=None, traced_shots=2, shot_bound_s=1e-3)


def stub(monkeypatch, spans):
    monkeypatch.setattr(profiling, "spans", lambda: list(spans))


def test_each_reader_on_stubbed_records(monkeypatch):
    stub(monkeypatch, records())
    r = run(peak=int(4.25 * GIB))
    assert spec.reader("fwd_us_per_step")(r) == pytest.approx(10.0)  # 1 ms over 100 steps
    assert spec.reader("rev_us_per_step")(r) == pytest.approx(20.0)
    assert spec.reader("shot_overhead_ms")(r) == pytest.approx(0.5)
    assert spec.reader("host_syncs_per_shot")(r) == pytest.approx(4.0)
    assert spec.reader("peak_beyond_tape_gib")(r) == pytest.approx(1.25)


def test_a_forward_evaluation_reads_no_reverse_and_no_tape(monkeypatch):
    spans = [s for s in records(shots=3, tape=0, syncs=2, rev_ms=0.0)
             if s.name != "kernels.reverse"]
    stub(monkeypatch, spans)
    r = run(peak=GIB)
    assert spec.reader("fwd_us_per_step")(r) == pytest.approx(10.0)
    assert spec.reader("rev_us_per_step")(r) is None
    assert spec.reader("shot_overhead_ms")(r) == pytest.approx(0.5)
    assert spec.reader("host_syncs_per_shot")(r) == pytest.approx(2.0)
    assert spec.reader("peak_beyond_tape_gib")(r) is None


@pytest.mark.parametrize("case", ["no records", "host only", "no module"])
def test_readers_give_none_without_records(monkeypatch, case):
    if case == "no records":
        stub(monkeypatch, [])
    elif case == "host only":  # spans recorded on the CPU carry no device time
        stub(monkeypatch, [s for s in records(device=False)])
    else:  # a program that has no tpufwi_torch.profiling
        monkeypatch.delattr(tpufwi_torch, "profiling")
        monkeypatch.setitem(sys.modules, "tpufwi_torch.profiling", None)
    r = run(peak=4 * GIB)
    for name in NEW:
        got = spec.reader(name)(r)
        if case == "host only" and name in ("host_syncs_per_shot", "peak_beyond_tape_gib"):
            assert got is not None  # counters and attributes need no device
        else:
            assert got is None, name


def test_benchmark_lists_the_program_metrics():
    per = {m["name"]: m for m in BENCH["per_layer"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    grad = {c for c in cells if c.endswith(".survey_grad")}
    for name in NEW:
        m = per[name]
        assert m["source"] in ("program_span", "program_counter")
        assert set(m["workloads"]) == (grad if name in ("rev_us_per_step",
                                                         "peak_beyond_tape_gib") else cells)


def test_readers_inside_a_traced_run_of_a_tiny_cell(monkeypatch):
    """The cell's per-layer metrics without their lists of cells, so that the
    tiny cell reads them: on the CPU the program's spans carry no device
    time and its engine no index check, so only the sync count reads."""
    per_layer = [{k: v for k, v in m.items() if k != "workloads"} for m in BENCH["per_layer"]]
    monkeypatch.setitem(BENCH, "per_layer", per_layer)
    out = run_tiny("tiny2d.survey_fwd", trace_on=True)
    assert out["metrics"]["host_syncs_per_shot"]["value"] == 0.0
    assert not (set(NEW) - {"host_syncs_per_shot"}) & set(out["metrics"])
    shots = [s for s in profiling.spans() if s.name == "objective.shot"]
    assert shots and all(s.device_s is None for s in shots)
