"""One run of a cell: set-up, the measured window, and the comparison
with the plain reference that decides ``correct``.

What depends on the equations a configuration solves (its inputs, its
model's fields, the program, the reference, the misfit, a shot's bound)
is the configuration's physics, a module that ``spec.physics`` finds by
name (``physics/acoustic.py`` by default). The window drives the survey
objective that the physics set up (its value and gradient, or its loss)
in a closed loop, one evaluation after another, each at the start model
perturbed anew from the seed, and ends at the first evaluation boundary
after ``seconds`` with a synchronize. One evaluation drawn from the seed
(never the first, so that state carried between evaluations shows) is
captured as it is made: every shot's seismogram and gradients, and the
evaluation's J and gradients. After the window the program's state is
freed and the reference recomputes the sampled shots of that evaluation
from the same inputs.
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
from . import spec
from .trace import Tracer


class ShotTap:
    """The propagator as the program's objective sees it. Every call
    goes through unchanged and is counted; while ``capturing``, each shot's
    seismogram and its gradient in each model field (when one is taken) are
    copied to host memory as they are made, in the order of the calls."""

    def __init__(self, prop, seis_shape, field_shapes, device):
        """``seis_shape``: (shots, *one shot's seismogram); ``field_shapes``:
        a shape per model field whose gradients are kept, or None."""
        self.prop = prop
        self.calls = 0
        self.capturing = False
        pin = device.type == "cuda"
        self.seis = torch.empty(tuple(seis_shape), pin_memory=pin)
        self.grads = None if field_shapes is None else tuple(
            torch.empty((self.seis.shape[0],) + tuple(s), pin_memory=pin) for s in field_shapes)

    def __getattr__(self, name):
        return getattr(self.prop, name)

    def __call__(self, *args):
        """``(*fields, geom, wavelet)``, as the propagator takes them."""
        *fields, geom, wavelet = args
        k = self.calls
        self.calls += 1
        with record_function("fwibench.shot_forward"):
            seis = self.prop(*fields, geom, wavelet)
        if self.capturing and k < self.seis.shape[0]:
            self.seis[k].copy_(seis.detach(), non_blocking=True)
            if self.grads is not None:
                for f, grads in zip(fields, self.grads, strict=True):
                    if f.requires_grad:

                        def keep(g, dst=grads[k]):
                            dst.copy_(g, non_blocking=True)

                        f.register_hook(keep)
        return seis


class Program:
    """The system under test, as a physics' ``program`` sets it up for a
    cell: ``objective(model)`` (J, or (J, a gradient per field)) over the
    tap that sees every shot, the observed data, and host buffers for the
    captured evaluation's totals."""

    def __init__(self, tap: ShotTap, objective, d_obs, engine: str, device):
        self.tap, self.objective, self.d_obs, self.engine = tap, objective, d_obs, engine
        pin = device.type == "cuda"
        self.J = torch.empty((), pin_memory=pin)
        self.g = None if tap.grads is None else tuple(
            torch.empty(g.shape[1:], pin_memory=pin) for g in tap.grads)

    def keep_totals(self, out):
        """Copy an evaluation's J (and gradients) to host memory."""
        J, g = out if isinstance(out, tuple) else (out, None)
        self.J.copy_(J.detach(), non_blocking=True)
        if g is not None:
            for dst, gj in zip(self.g, g, strict=True):
                dst.copy_(gj, non_blocking=True)


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


def draws(cell, seed: int, n: int):
    """(the captured evaluation, the sampled shots of ``n``) drawn from the
    seed."""
    rng = np.random.default_rng([int(seed), 7])
    lo, hi = cell.check["evaluation"]
    shots = np.sort(rng.choice(n, int(cell.check["sample_shots"]), replace=False))
    return int(rng.integers(lo, hi + 1)), shots


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             log=print, control=None):
    """One run; returns the result line's object. ``control`` (a dtype):
    also the control's numbers, under the key "control"."""
    physics = cell.physics
    split = {"imports": time.perf_counter() - t_start}
    t0 = time.perf_counter()
    inp = physics.inputs(cell, seed, device)
    sync(device)
    split["models"] = time.perf_counter() - t0
    prog = physics.program(cell, inp, device, split)
    n = len(inp.src)
    e_capture, sample = draws(cell, seed, n)
    tracer = Tracer() if trace else None
    setup_s = time.perf_counter() - t_start
    log(f"[setup] {setup_s:.3f} s: " + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
        + f"; engine {prog.engine}")
    evals, window_s, calls = window(prog, lambda e: physics.model(cell, inp, seed, e), seconds,
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
    numbers, ctrl = checks.compare(cell, inp, got, physics.model(cell, inp, seed, e_capture),
                                   sample, calls, device, control=control)
    log(f"[reference] {time.perf_counter() - t0:.3f} s")
    limits = cell.check["limits"]
    correct = checks.verdict(numbers, limits)
    bound = physics.shot_bound_s(cell, inp)
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
