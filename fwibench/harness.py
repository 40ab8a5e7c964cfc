"""One run of a cell: set-up, the measured window, and the comparison
with the plain reference that decides ``correct``.

The window drives the survey objective of ``tpufwi_torch.invert.FwiProblem``
(``stage_objectives(band)``: ``vg`` or ``loss``) in a closed loop, one
evaluation after another, each at the start model perturbed anew from the
seed, and ends at the first evaluation boundary after ``seconds`` with a
synchronize. One evaluation drawn from the seed (never the first, so that
state carried between evaluations shows) is captured as it is made: every
shot's seismogram and gradient, and the evaluation's J and gradient. After
the window the program's state is freed and the reference recomputes the
sampled shots of that evaluation from the same inputs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import time

import numpy as np
import torch
from torch.profiler import record_function

from . import check as checks
from . import counts, models, reference, spec
from .trace import Tracer


@dataclasses.dataclass
class Inputs:
    vp_true: torch.Tensor  # fp32, physical grid, on the device
    vp0: torch.Tensor
    dt: float
    c_max: float
    nt: int
    src: np.ndarray  # (nshot, 1, ndim) physical cells
    rcv: np.ndarray  # (nrec, ndim)
    wavelet: np.ndarray
    h2: np.ndarray  # the band's low-pass response


def make_inputs(cell: spec.Cell, seed: int, device) -> Inputs:
    c = cell.config
    vp_true = models.true_model(c, cell.shape, seed, device)
    c_max = c["c_max_mps"] if c["c_max_mps"] is not None else float(vp_true.max())
    dt = reference.cfl_dt(cell.h, c_max, c["order"], c["cfl"])
    nt = int(c["nt"])
    src, rcv = spec.geometry(cell)
    return Inputs(vp_true, models.start_model(c, vp_true), dt, c_max, nt, src, rcv,
                  reference.ricker(c["f0_hz"], dt, nt),
                  reference.lowpass_response(nt, dt, c["band_hz"]))


def model_of(cell, inp: Inputs, seed: int, e: int) -> torch.Tensor:
    """Evaluation e's model."""
    return models.perturbed(inp.vp0, seed, e, cell.traffic["perturbation"],
                            cell.config["bounds"])


class ShotTap:
    """The propagator as ``FwiProblem`` sees it. Every call goes through
    unchanged and is counted; while ``capturing``, each shot's seismogram
    and its gradient in vp (when one is taken) are copied to host memory
    as they are made, in the order of the calls."""

    def __init__(self, prop, n_shots, nt, nrec, shape, grads: bool, device):
        self.prop = prop
        self.calls = 0
        self.capturing = False
        pin = device.type == "cuda"
        self.seis = torch.empty((n_shots, nt, nrec), pin_memory=pin)
        self.grads = torch.empty((n_shots,) + tuple(shape), pin_memory=pin) if grads else None

    def __getattr__(self, name):
        return getattr(self.prop, name)

    def __call__(self, vp, geom, wavelet):
        k = self.calls
        self.calls += 1
        with record_function("fwibench.shot_forward"):
            seis = self.prop(vp, geom, wavelet)
        if self.capturing and k < self.seis.shape[0]:
            self.seis[k].copy_(seis.detach(), non_blocking=True)
            if self.grads is not None and vp.requires_grad:
                dst = self.grads[k]

                def keep(g):
                    dst.copy_(g, non_blocking=True)

                vp.register_hook(keep)
        return seis


class Program:
    """The system under test, set up for a cell: the propagator, the survey,
    the observed data, the stage objective, warmed on two shots."""

    def __init__(self, cell: spec.Cell, inp: Inputs, device, split: dict):
        from tpufwi_torch.acquisition import Geometry
        from tpufwi_torch.grid import Grid
        from tpufwi_torch.invert import FwiProblem
        from tpufwi_torch.propagators.acoustic2d import AcousticPropagator

        t0 = time.perf_counter()
        c = cell.config
        grid = Grid(shape=cell.shape, h=cell.h, pml=c["pml"], order=c["order"])
        prop = AcousticPropagator(grid, inp.dt, c["f0_hz"], inp.c_max, impl=c["impl"],
                                  device=device)
        geoms = Geometry.stack([Geometry.from_physical(grid, s, inp.rcv, device=device)
                                for s in inp.src])
        w = torch.as_tensor(inp.wavelet, dtype=torch.float32, device=device)
        n = len(inp.src)
        split["program"] = time.perf_counter() - t0
        d_obs, times = [], []
        with torch.no_grad():
            for i in range(n):
                t0 = time.perf_counter()
                d_obs.append(prop(inp.vp_true, geoms.shot(i), w))
                sync(device)
                times.append(time.perf_counter() - t0)
        # the first forward also loads (or builds) the kernels' library
        split["libraries"] = times[0] - (np.mean(times[1:]) if n > 1 else 0.0)
        split["observed_data"] = sum(times) - split["libraries"]
        self.d_obs = torch.stack(d_obs)
        del d_obs
        self.tap = ShotTap(prop, n, inp.nt, len(inp.rcv), cell.shape, cell.gradient, device)
        self.problem = FwiProblem(prop=self.tap, geoms=geoms, d_obs=self.d_obs, wavelet=w,
                                  dt=inp.dt)
        vg, loss = self.problem.stage_objectives(c["band_hz"])
        self.objective = vg if cell.gradient else loss
        pin = device.type == "cuda"
        self.J = torch.empty((), pin_memory=pin)
        self.g = torch.empty(cell.shape, pin_memory=pin) if cell.gradient else None
        t0 = time.perf_counter()
        k = min(2, n)
        warm = FwiProblem(prop=self.tap, geoms=Geometry(geoms.src_idx[:k], geoms.rcv_idx[:k]),
                          d_obs=self.d_obs[:k], wavelet=w, dt=inp.dt)
        wvg, wloss = warm.stage_objectives(c["band_hz"])
        (wvg if cell.gradient else wloss)(inp.vp0)
        sync(device)
        split["warm_shots"] = time.perf_counter() - t0
        self.engine = prop.impl

    def keep_totals(self, out):
        """Copy an evaluation's J (and gradient) to host memory."""
        J, g = out if isinstance(out, tuple) else (out, None)
        self.J.copy_(J.detach(), non_blocking=True)
        if g is not None:
            self.g.copy_(g, non_blocking=True)


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    evaluations: int
    shots: int
    nt: int
    window_s: float | None
    setup_s: float
    peak_bytes: int | None
    trace: object
    traced_shots: int
    shot_bound_s: float


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(prog: Program, model, seconds: float, e_capture: int, tracer, device):
    """Evaluations in a closed loop; returns (evaluations, window seconds,
    calls per evaluation). With a tracer: evaluations up to the captured
    one, then one more inside the profiler, and stop."""
    calls = []
    sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    e = 0
    while True:
        traced = tracer is not None and e == e_capture + 1
        if traced:
            tracer.start()
        with tracer.window() if traced else contextlib.nullcontext():
            m = model(e)
            prog.tap.calls = 0
            prog.tap.capturing = e == e_capture
            with record_function("fwibench.evaluation"):
                out = prog.objective(m)
            if e == e_capture:
                prog.keep_totals(out)
            prog.tap.capturing = False
            calls.append(prog.tap.calls)
            del out, m
            e += 1
            if traced:
                sync(device)
        if traced:
            tracer.stop()
            break
        if tracer is None and e > e_capture and time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    return e, time.perf_counter() - t0, calls


def draws(cell, seed: int):
    """(the captured evaluation, the sampled shots) drawn from the seed."""
    rng = np.random.default_rng([int(seed), 7])
    lo, hi = cell.check["evaluation"]
    n = len(spec.geometry(cell)[0])
    shots = np.sort(rng.choice(n, int(cell.check["sample_shots"]), replace=False))
    return int(rng.integers(lo, hi + 1)), shots


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             log=print, control=None):
    """One run; returns the result line's object. ``control`` (a dtype):
    also the control's numbers, under the key "control"."""
    split = {"imports": time.perf_counter() - t_start}
    t0 = time.perf_counter()
    inp = make_inputs(cell, seed, device)
    sync(device)
    split["models"] = time.perf_counter() - t0
    prog = Program(cell, inp, device, split)
    e_capture, sample = draws(cell, seed)
    n = len(inp.src)
    tracer = Tracer() if trace else None
    setup_s = time.perf_counter() - t_start
    log(f"[setup] {setup_s:.3f} s: " + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
        + f"; engine {prog.engine}")
    evals, window_s, calls = window(prog, lambda e: model_of(cell, inp, seed, e), seconds,
                                    e_capture, tracer, device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    log(f"[window] {evals} evaluations of {n} shots in {window_s:.3f} s; captured "
        f"evaluation {e_capture}, sampled shots {sample.tolist()}")
    got = checks.Captured.take(prog, sample)
    del prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    numbers, ctrl = checks.compare(cell, inp, got, model_of(cell, inp, seed, e_capture),
                                   sample, calls, device, control=control)
    log(f"[reference] {time.perf_counter() - t0:.3f} s")
    limits = cell.check["limits"]
    correct = checks.verdict(numbers, limits)
    nrec, nsrc = len(inp.rcv), inp.src.shape[1]
    bound = counts.shot_bound_s(cell.shape, cell.config["order"], cell.config["pml"], inp.nt,
                                nsrc, nrec, cell.tape, cell.gradient)
    run = Run(evaluations=evals, shots=n, nt=inp.nt, window_s=None if trace else window_s,
              setup_s=setup_s, peak_bytes=peak, trace=tracer.summary if trace else None,
              traced_shots=calls[-1] if trace else 0, shot_bound_s=bound)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": evals * n,
           "failed": int(sum(abs(c - n) for c in calls)), "metrics": metrics,
           "device": device_info}
    if trace:
        s = tracer.summary
        device_info.update(busy_s=s.busy_s, window_s=s.window_s)
        out["breakdown"] = {"device_ops": s.device_ops, "idle_gaps": s.idle_gaps}
    if ctrl is not None:
        out["control"] = ctrl
    out["check"] = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    for k, v in numbers.items():
        log(f"check {k} {v!r} limit {limits[k]!r}")
    return out
