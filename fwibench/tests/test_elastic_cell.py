"""CPU tests of the elastic cell's own files: the ``materials_ms_per_shot``
reader on stubbed spans (and None without them, as at a commit before the
spans), the ``land_line`` layout against the CLI's elastic survey, and
``counts_elastic`` against the port's ``chip_smoke.py::elastic_step_counts``.

    python -m pytest fwibench/tests -q
"""

from __future__ import annotations

import numpy as np
import pytest

import chip_smoke
from fwibench import counts, counts_elastic, spec
from fwibench.tests.test_program_metrics import Ev, records, run, stub
from tpufwi_torch import profiling

CELL = "marmousi2_elastic.survey_grad"


@pytest.fixture(autouse=True)
def _no_records_left():
    profiling.clear()
    yield
    profiling.clear()


def elastic_records(shots=2, materials_ms=0.25, finish_ms=0.125):
    """``records`` of a gradient evaluation, each shot with a material map
    under its propagator call and a gradient finish beside its reverse."""
    out = records(shots=shots)
    ids = iter(range(1000, 2000))
    for s in [s for s in out if s.name == "propagator.call"]:
        for name, ms in (("propagator.materials", materials_ms), ("engine.finish", finish_ms)):
            x = profiling.Span(name, next(ids), s.id, 0, {}, 0, {})
            x.events = (Ev(0.0), Ev(ms))
            out.append(x)
    return out


def test_materials_reader_on_stubbed_spans(monkeypatch):
    stub(monkeypatch, elastic_records(shots=3))
    assert spec.reader("materials_ms_per_shot")(run()) == pytest.approx(0.375)


@pytest.mark.parametrize("case", ["acoustic spans", "no records", "host only"])
def test_materials_reader_gives_none_without_its_spans(monkeypatch, case):
    if case == "acoustic spans":  # a program without the two spans
        spans = records()
    elif case == "no records":
        spans = []
    else:  # spans recorded on the CPU carry no device time
        spans = elastic_records()
        for s in spans:
            s.events = None
    stub(monkeypatch, spans)
    assert spec.reader("materials_ms_per_shot")(run()) is None


def test_land_line_is_the_clis_elastic_survey():
    """The layout's cells against ``build_synthetic_elastic_problem``'s
    geometry at a small size on the CPU."""
    from tpufwi_torch.config import FwiConfig
    from tpufwi_torch.invert import build_synthetic_elastic_problem

    cfg = FwiConfig().with_overrides(["model.nz=30", "model.nx=57", "acq.n_shots=3",
                                      "acq.t_max=0.05", "prop.order=4", "prop.pml=6"])
    problem, *_ = build_synthetic_elastic_problem(cfg, device="cpu", impl="eager")
    pad = problem.prop.grid.pad
    src, rcv = spec.find("layouts", "land_line").geometry(
        (30, 57), {"shots": 3, "src_depth": cfg.acq.src_z, "rcv_depth": cfg.acq.rcv_z,
                   "rcv_every": cfg.acq.rcv_dx})
    assert np.array_equal(problem.geoms.src_idx.numpy() - pad, src)
    assert all(np.array_equal(r.numpy() - pad, rcv) for r in problem.geoms.rcv_idx)
    c = spec.load_cell(CELL)
    assert c.layout.__name__ == "fwibench_layouts_land_line"
    src, rcv = spec.geometry(c)
    assert src.shape == (8, 1, 2) and rcv.shape == (847, 2)


@pytest.mark.parametrize("shape, pml, order, nrec, nsrc", [
    ((351, 1701), 20, 8, 847, 1), ((36, 60), 10, 4, 20, 2)])
def test_counts_elastic_are_the_ports(shape, pml, order, nrec, nsrc):
    from tpufwi_torch.grid import Grid

    grid = Grid(shape=shape, h=(10.0, 10.0), pml=pml, order=order)
    n_ring = counts.ring_cells(shape, order // 2)
    port = chip_smoke.elastic_step_counts(grid, 2 * nrec, nsrc, n_ring)
    ours = counts_elastic.passes(shape, order, pml, 4885, nsrc, 2 * nrec, ("rings", "float32"),
                                 True)
    assert ours == {"forward": port["escan_forward_rings"], "reverse": port["escan_reverse"]}
    assert counts_elastic.passes(shape, order, pml, 4885, nsrc, 2 * nrec, None, False) == {
        "forward": port["escan_forward"]}


def test_the_cells_bound_is_its_two_passes():
    """About 0.89 + 1.99 us a step (PERF.md rows 8-9), 14 ms a shot."""
    c = spec.load_cell(CELL)
    inp = c.physics.Inputs(None, None, 0.0, 4700.0, 4885, *spec.geometry(c), None, None)
    bound = c.physics.shot_bound_s(c, inp)
    per_step = [counts.step_bound_s(p, 4885)[0] for p in counts_elastic.passes(
        c.shape, 8, 20, 4885, 1, 2 * 847, c.tape, True).values()]
    assert [round(1e6 * t, 2) for t in per_step] == [0.89, 1.99]
    assert bound == pytest.approx(4885 * sum(per_step)) and 0.013 < bound < 0.015


def test_the_cell_reads_the_program_metrics():
    per = {m["name"] for m in spec.load_cell(CELL).per_layer}
    assert {"materials_ms_per_shot", "shot_roofline_pct", "fwd_us_per_step", "rev_us_per_step",
            "shot_overhead_ms", "host_syncs_per_shot", "peak_beyond_tape_gib", "launches_per_step",
            "device_idle_pct"} == per
