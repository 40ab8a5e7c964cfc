"""The 5 m acoustic cell (``marmousi2_acoustic_5m.survey_grad``) on the CPU:
the benchmark's plain reference (``fwibench/reference.py``) against the
rings engine's CPU twins, the configuration and the engine ``'auto'`` picks
for it, the streamed count (``fwibench/counts_streamed.py``), the
``rev_roofline_pct`` reader, and a tiny cell of its physics
(``fwibench/physics/acoustic_streamed.py``) through
``fwibench.harness.run_cell``.

The reference, in float64, against ``scanres_forward(tape="rings")`` then
``scanres_reverse`` on CPU tensors (the plain versions the CUDA kernels are
held against) and the engine's ``finish_gradient``: seismograms, J and the
gradient in vp, on a seeded random smooth vp, 24 x 40, order 8, PML 6, nt
150. The reference keeps its seismograms and its imaged gradient in fp32
whatever the fields' precision, so the tolerances are fp32's: 3e-7 for the
seismograms (read 3.4e-8), 2e-5 for J, whose residual is ~3% of the traces,
so that the traces' rounding grows ~30x in it (read 2.5e-7 and 2.7e-6), and
2e-5 for the gradient summed over 150 steps (read 8.7e-7 and 3.2e-6).
Every test takes seconds on one thread.
"""

from __future__ import annotations

import ast
import json
import time

import numpy as np
import pytest
import torch

from fwibench import check, counts, counts_streamed, harness, models, reference, spec

F64 = torch.float64
SHAPE, H, PML, ORDER, F0, NT, C_MAX = (24, 40), (10.0, 10.0), 6, 8, 15.0, 150, 3000.0
CELL = "marmousi2_acoustic_5m.survey_grad"
SRC = np.array([[[3, 8]], [[3, 30]]])
RCV = np.stack([np.full(13, 2), np.arange(1, 40, 3)], 1)
H100_80GB = 85_031_714_816  # total_memory of an NVIDIA H100 80GB HBM3


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def smooth_vp(gen, lo=2000.0, hi=2900.0):
    """A seeded random field, smoothed and scaled to [lo, hi] (float64)."""
    x = models.gaussian(torch.rand(SHAPE, generator=gen, dtype=F64), 2.0)
    return lo + (hi - lo) * (x - x.min()) / (x.max() - x.min())


def test_reference_agrees_with_the_rings_paths_cpu_twins():
    from tpufwi_torch.adjoint_scanres import finish_gradient
    from tpufwi_torch.filters import apply_response
    from tpufwi_torch.grid import Grid, pad_model
    from tpufwi_torch.kernels import acoustic2d_scanres as ks
    from tpufwi_torch.propagators.boundary import RingSpec

    gen = torch.Generator().manual_seed(7)
    vp = smooth_vp(gen)
    vt = vp * (1.0 + 0.03 * (smooth_vp(gen, -1.0, 1.0)))
    dt = reference.cfl_dt(H, C_MAX, ORDER, 0.7)
    med = reference.Medium(SHAPE, H, PML, ORDER, dt, C_MAX, F0, dtype=F64)
    sv = reference.make_survey(med, SRC, np.repeat(RCV[None], 2, 0),
                               reference.ricker(F0, dt, NT),
                               reference.lowpass_response(NT, dt, 10.0))
    d = reference.forward(sv, vt)[0]
    J, g, seis = reference.value_and_grad(sv, vp, reference.lowpass(d, sv.h2, 1),
                                          tape_dtype=F64, segment=17)

    grid = Grid(shape=SHAPE, h=H, pml=PML, order=ORDER)
    profiles = tuple(torch.as_tensor(p, dtype=F64).contiguous()
                     for p in ks.strip_profiles(grid, dt, C_MAX, F0, dtype=np.float64))
    w, h2 = sv.wavelet.to(F64), sv.h2
    rcv_idx = torch.as_tensor(RCV + grid.pad)
    interior = grid.interior
    for i in range(2):
        src_idx = torch.as_tensor(SRC[i] + grid.pad)
        c2t = (pad_model(vt, grid) * dt) ** 2
        d_p = ks.scanres_forward(grid, c2t, profiles, w, src_idx, rcv_idx)[0]
        c2 = (pad_model(vp, grid) * dt) ** 2
        s, tape, p_penult, p_last, _ = ks.scanres_forward(grid, c2, profiles, w, src_idx,
                                                           rcv_idx, tape="rings")
        assert tape.shape == (NT, RingSpec.build(grid).tape_bytes_per_step(1))
        sv_ = s.clone().requires_grad_(True)
        Ji = 0.5 * ((apply_response(sv_, h2) - apply_response(d_p, h2)) ** 2).sum()
        (ybar,) = torch.autograd.grad(Ji, sv_)
        gbar, lam_src = ks.scanres_reverse(grid, c2, profiles, w, ybar, tape, p_penult,
                                           p_last, src_idx, rcv_idx)
        g_c2, _ = finish_gradient(RingSpec.build(grid), gbar, lam_src, c2, w, src_idx)
        gi = g_c2[interior] * 2.0 * vp * dt * dt
        assert float(d_p.abs().max()) > 0.0 and check.rel(d_p, d[i]) < 3e-7
        assert check.rel(s, seis[i]) < 3e-7
        assert abs(float(Ji.detach()) - float(J[i])) < 2e-5 * float(J[i])
        assert float(g[i].abs().max()) > 0.0 and check.rel(gi, g[i]) < 2e-5


# ------------------------------------------------------------------ the cell


def test_the_configuration_keeps_its_stated_sizes():
    c = spec.load_cell(CELL)
    assert c.physics.__name__ == "fwibench_physics_acoustic_streamed"
    assert c.layout.__name__ == "fwibench_layouts_split_spread"
    cfg = c.config
    assert (c.shape, c.h, cfg["nt"], cfg["order"], cfg["pml"], cfg["cfl"]) == (
        (701, 3401), (5.0, 5.0), 9684, 8, 20, 0.7)
    assert (cfg["f0_hz"], cfg["band_hz"], cfg["c_max_mps"], cfg["bounds"]) == (
        24.0, 15.0, 4700.0, [1480.0, 4700.0])
    assert cfg["start"] == {"smooth_sigma": 24.0, "keep_water": True}
    assert cfg["model"] == {"generator": "marmousi_like"} and cfg["impl"] == "auto"
    # t_max 4 s at the CFL 0.7 step for 4700 m/s
    assert cfg["nt"] == int(4.0 / reference.cfl_dt(c.h, 4700.0, 8, 0.7))
    assert cfg["reduced"] == [] and "published" not in cfg and len(cfg["assumed"]) >= 4
    assert c.gradient and c.tape == ("rings", "float32")
    assert c.check["sample_shots"] == 2 and c.check["evaluation"] == [1, 1]
    src, rcv = spec.geometry(c)
    assert src.shape == (16, 1, 2) and rcv.shape == (1701, 2)
    assert set(src[:, 0, 0]) == {4} and set(rcv[:, 0]) == {4}
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    entry = {x["name"]: x for x in bench["configs"]}["marmousi2_acoustic_5m"]
    assert entry["reduced"] == [] and entry["source"] == cfg["source"]
    assert all(x["source"] != cfg["source"] for x in bench["configs"] if x is not entry)
    assert {m["name"] for m in c.per_layer} == {
        "device_idle_pct", "shot_roofline_pct", "launches_per_step", "fwd_us_per_step",
        "rev_us_per_step", "shot_overhead_ms", "host_syncs_per_shot", "peak_beyond_tape_gib",
        "rev_roofline_pct"}


@pytest.mark.parametrize("cell, nt, engine, tape_gib", [
    (CELL, 9684, "cuda_scanres", 46.6), ("marmousi2_acoustic.survey_grad", 4842,
                                         "cuda_scansnap", 6.3)])
def test_auto_resolves_the_engine_on_an_80_gb_card(monkeypatch, cell, nt, engine, tape_gib):
    """``resolve_impl``'s arithmetic for an H100 80GB: the bf16 snapshot
    tape against 0.8 of the card over 2 shots in flight (31.7 GiB)."""
    from tpufwi_torch.grid import Grid
    from tpufwi_torch.propagators.acoustic2d import AcousticPropagator

    class Props:
        total_memory = H100_80GB

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: Props)
    c = spec.load_cell(cell)
    cfg = c.config
    grid = Grid(shape=c.shape, h=c.h, pml=cfg["pml"], order=cfg["order"])
    dt = reference.cfl_dt(c.h, cfg["c_max_mps"], cfg["order"], cfg["cfl"])
    prop = AcousticPropagator(grid, dt, cfg["f0_hz"], cfg["c_max_mps"], device="cuda")
    NZ, NX = grid.padded_shape
    assert round(nt * NZ * NX * 2 / 2**30, 1) == tape_gib
    assert round(prop.snap_tape_budget_bytes() / 2**30, 1) == 31.7
    assert prop.resolve_impl(nt=nt) == engine
    if engine == "cuda_scanres":
        assert "snapshot ineligible" in prop.resolve_note
        assert "46.6 GiB exceeds the 31.7 GiB" in prop.resolve_note


# ----------------------------------------------------------------- the count

ACOUSTIC = ["marmousi2_acoustic.survey_grad", "marmousi2_acoustic.survey_fwd",
            "overthrust3d.survey_grad", "overthrust3d.survey_fwd"]


def cell_shots(name):
    c = spec.load_cell(name)
    cfg = c.config
    src, rcv = spec.geometry(c)
    return c, (c.shape, cfg["order"], cfg["pml"], int(cfg["nt"]), src.shape[1], len(rcv),
               c.tape, c.gradient)


@pytest.mark.parametrize("name", ACOUSTIC)
def test_the_streamed_count_keeps_every_earlier_cells_bound(name):
    """Every acoustic cell the benchmark held before the 5 m one: the same
    passes and the same shot bound, bit for bit."""
    c, args = cell_shots(name)
    assert counts_streamed.passes(*args) == counts.passes(*args)
    assert counts_streamed.shot_bound_s(*args) == counts.shot_bound_s(*args)
    inp = c.physics.Inputs(None, None, 0.0, 0.0, args[3], *spec.geometry(c), None, None)
    assert c.physics.shot_bound_s(c, inp) == counts.shot_bound_s(*args)


def test_the_5m_reverse_streams_and_its_forward_stays_in_l2():
    """The rings reverse moves 36 B a padded cell and 16 B a strip cell
    every step on top of its receivers, sources and ring row; the forward
    keeps ``counts.passes``' figures; a snapshot reverse would stream 24 B a
    cell."""
    c, args = cell_shots(CELL)
    shape, order, pml, nt, nsrc, nrec, tape, _ = args
    NZ, NX, S = 749, 3449, 24
    cells, strips = NZ * NX, 2 * S * (NZ + NX)
    plain, ours = counts.passes(*args), counts_streamed.passes(*args)
    assert ours["forward"] == plain["forward"]
    assert counts_streamed.field_bytes(shape, order, pml, "forward", tape) == (
        16 * cells + 16 * strips) < counts_streamed.L2_BYTES
    flops, per_step, per_shot = plain["reverse"]
    assert ours["reverse"] == (flops, per_step + 36 * cells + 16 * strips, per_shot)
    assert counts.step_bound_s(ours["reverse"], nt)[1] == "bytes"
    snap = ("snapshot", "bfloat16")
    s_plain = counts.passes(shape, order, pml, nt, nsrc, nrec, snap, True)["reverse"]
    s_ours = counts_streamed.passes(shape, order, pml, nt, nsrc, nrec, snap, True)["reverse"]
    assert s_ours == (s_plain[0], s_plain[1] + 24 * cells + 16 * strips, s_plain[2])
    # about 294 ms a shot streamed, 49 ms if the fields stayed in L2
    assert 0.29 < counts_streamed.shot_bound_s(*args) < 0.30
    assert 0.045 < counts.shot_bound_s(*args) < 0.05
    inp = c.physics.Inputs(None, None, 0.0, 0.0, nt, *spec.geometry(c), None, None)
    assert c.physics.shot_bound_s(c, inp) == counts_streamed.shot_bound_s(*args)


# ----------------------------------------------------------------- the metric


class Ev:
    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, end):
        return end.ms - self.ms


ATTRS = dict(wrapper="scanres_reverse", nt=9684, tape_bytes=0, NZ=749, NX=3449, radius=4,
             strip=24, nsrc=1, nrec=1701, tape="rings")


def reverse_spans(attrs, ms=(600.0, 620.0)):
    """Two traced shots, each with one ``kernels.reverse`` span of ``ms``
    milliseconds on the device, and a forward span."""
    from tpufwi_torch import profiling

    c0 = dict.fromkeys(profiling.COUNTERS, 0)
    out = []
    for i, t in enumerate(ms):
        shot = profiling.Span("objective.shot", 10 * i, None, 0, {"shot": i}, 0, c0)
        rev = profiling.Span("kernels.reverse", 10 * i + 1, 10 * i, 0, dict(attrs), 0, c0,
                             events=(Ev(0.0), Ev(t)))
        fwd = profiling.Span("kernels.forward", 10 * i + 2, 10 * i, 0,
                             dict(attrs, wrapper="scanres_forward"), 0, c0,
                             events=(Ev(0.0), Ev(300.0)))
        out += [rev, fwd, shot]
    return out


@pytest.mark.parametrize("case", ["rings", "snap", "no attributes", "no records",
                                  "no reverse", "host span"])
def test_rev_roofline_reader(monkeypatch, case):
    """The reverse spans' streamed bound at their attributes over their
    device time; None on a program whose spans lack the attributes (the
    parent of this metric), with no records, with no reverse in the traced
    shots, or with a span that timed no device."""
    from tpufwi_torch import profiling

    attrs = dict(ATTRS, tape=case) if case == "snap" else ATTRS
    if case == "no attributes":
        attrs = {k: ATTRS[k] for k in ("wrapper", "nt", "tape_bytes")}
    spans = reverse_spans(attrs)
    if case == "no reverse":
        spans = [s for s in spans if s.name != "kernels.reverse"]
    if case == "host span":
        spans[0].events = None
    monkeypatch.setattr(profiling, "spans", lambda: [] if case == "no records" else spans)
    got = spec.reader("rev_roofline_pct")(None)
    if case not in ("rings", "snap"):
        assert got is None
        return
    kind = ("rings", "float32") if case == "rings" else ("snapshot", "bfloat16")
    bound = counts_streamed.shot_bound_s((701, 3401), 8, 20, 9684, 1, 1701, kind, True) - (
        counts_streamed.shot_bound_s((701, 3401), 8, 20, 9684, 1, 1701, kind, False))
    assert got == pytest.approx(100.0 * 2 * bound / 1.22)
    assert 0.0 < got < 100.0


# ------------------------------------------------------------ the tiny cell


def tiny_cell(tmp_path):
    """The 5 m cell's configuration at the CPU tests' size, its files in
    ``tmp_path``; the physics and the split_spread layout are the
    benchmark's."""
    cfg = spec.load_json(spec.HERE / "configs" / "marmousi2_acoustic_5m.json")
    cfg.update(nz=56, nx=48, h_m=10.0, nt=150, pml=6, f0_hz=20.0, band_hz=12.0,
               survey=dict(cfg["survey"], shots=3, src_depth=2, rcv_depth=2, rcv_every=4),
               start=dict(cfg["start"], smooth_sigma=4.0))
    files = {"configs/tiny_5m.json": cfg,
             "traffic/survey_grad.json": spec.load_json(spec.HERE / "traffic" / "survey_grad.json"),
             "checks/tiny_5m.survey_grad.json": {
                 "sample_shots": 2, "evaluation": [1, 1], "segment": 16,
                 "limits": {"shots_missed": 0, "seis_err": 1e-4, "J_err": 1e-2,
                            "grad_err": 1e-2}}}
    for name, obj in files.items():
        (tmp_path / name).parent.mkdir(exist_ok=True)
        (tmp_path / name).write_text(json.dumps(obj))
    bench = dict(spec.load_json(spec.ROOT / "BENCHMARK.json"),
                 workloads=[dict(name="tiny_5m.survey_grad", config="tiny_5m",
                                 traffic="survey_grad", chips=1, why="test")])
    return spec.load_cell("tiny_5m.survey_grad", bench=bench, base=tmp_path)


def run_tiny(cell, logs=None):
    torch.manual_seed(0)
    return harness.run_cell(cell, 2**31 + 41, 0.0, False, torch.device("cpu"),
                            time.perf_counter(),
                            log=(lambda m: None) if logs is None else logs.append)


def test_a_tiny_streamed_cell_is_correct(tmp_path):
    cell = tiny_cell(tmp_path)
    assert cell.physics.__name__ == "fwibench_physics_acoustic_streamed"
    logs = []
    out = run_tiny(cell, logs)
    assert out["correct"] is True, out["check"]
    assert out["failed"] == 0 and out["attempted"] % 3 == 0
    assert set(out["check"]) == {"shots_missed", "seis_err", "J_err", "grad_err"}
    (setup,) = [m for m in logs if m.startswith("[setup]")]
    assert setup.endswith("engine eager (auto: CPU tensor -> exact eager engine)"), setup


def test_seismograms_off_by_a_part_in_a_thousand_are_not_correct(tmp_path, monkeypatch):
    from tpufwi_torch.propagators.acoustic2d import AcousticPropagator

    orig = AcousticPropagator.__call__
    monkeypatch.setattr(AcousticPropagator, "__call__",
                        lambda self, *args: orig(self, *args) * 1.001)
    out = run_tiny(tiny_cell(tmp_path))
    assert out["correct"] is False
    assert out["check"]["seis_err"]["value"] > out["check"]["seis_err"]["limit"]


def test_the_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "physics/acoustic_streamed.py", "counts_streamed.py",
                 "metrics/rev_roofline_pct.py"):
        tree = ast.parse((spec.HERE / name).read_text())
        top = {a.name.partition(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
               for a in n.names}
        top |= {n.module.partition(".")[0] for n in ast.walk(tree)
                if isinstance(n, ast.ImportFrom) and n.module}
        assert not top & {"tpufwi_torch", "tpufwi", "jax", "jaxlib"}, (name, top)
