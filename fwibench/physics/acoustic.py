"""The acoustic physics: a configuration without a ``"physics"`` key runs
here. The model is one field, vp; the program is the port's
``AcousticPropagator`` under ``FwiProblem``; the reference is
``reference.py``; a shot's bound counts the acoustic passes of
``counts.py``. See ``spec.physics`` for what a physics provides.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from fwibench import counts, harness, models, reference, spec

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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


def inputs(cell: spec.Cell, seed: int, device) -> Inputs:
    c = cell.config
    vp_true = models.true_model(c, cell.shape, seed, device)
    c_max = c["c_max_mps"] if c["c_max_mps"] is not None else float(vp_true.max())
    dt = reference.cfl_dt(cell.h, c_max, c["order"], c["cfl"])
    nt = int(c["nt"])
    src, rcv = spec.geometry(cell)
    return Inputs(vp_true, models.start_model(c, vp_true), dt, c_max, nt, src, rcv,
                  reference.ricker(c["f0_hz"], dt, nt),
                  reference.lowpass_response(nt, dt, c["band_hz"]))


def model(cell, inp: Inputs, seed: int, e: int) -> tuple:
    """Evaluation e's model, (vp,)."""
    return (models.perturbed(inp.vp0, seed, e, cell.traffic["perturbation"],
                             cell.config["bounds"]),)


def program(cell: spec.Cell, inp: Inputs, device, split: dict) -> harness.Program:
    """The propagator, the survey, the observed data, the stage objective,
    warmed on two shots."""
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
            harness.sync(device)
            times.append(time.perf_counter() - t0)
    # the first forward also loads (or builds) the kernels' library
    split["libraries"] = times[0] - (np.mean(times[1:]) if n > 1 else 0.0)
    split["observed_data"] = sum(times) - split["libraries"]
    d_obs = torch.stack(d_obs)
    tap = harness.ShotTap(prop, d_obs.shape, [cell.shape] if cell.gradient else None, device)
    problem = FwiProblem(prop=tap, geoms=geoms, d_obs=d_obs, wavelet=w, dt=inp.dt)
    vg, loss = problem.stage_objectives(c["band_hz"])
    t0 = time.perf_counter()
    k = min(2, n)
    warm = FwiProblem(prop=tap, geoms=Geometry(geoms.src_idx[:k], geoms.rcv_idx[:k]),
                      d_obs=d_obs[:k], wavelet=w, dt=inp.dt)
    wvg, wloss = warm.stage_objectives(c["band_hz"])
    (wvg if cell.gradient else wloss)(inp.vp0)
    harness.sync(device)
    split["warm_shots"] = time.perf_counter() - t0

    def value_and_grad(m):
        J, g = vg(*m)
        return J, (g,)

    return harness.Program(tap, value_and_grad if cell.gradient else lambda m: loss(*m),
                           d_obs, prop.impl, device)


def reference_outputs(cell, inp: Inputs, m, sample, device, dtype=torch.float32):
    """(seis (k, nt, nrec), J (k,), (gradient (k, *shape),) or None) of the
    sampled shots at model ``m`` = (vp,), observed data from the true model,
    all computed by the reference with fields of ``dtype``."""
    (vp,) = m
    c = cell.config
    med = reference.Medium(cell.shape, cell.h, c["pml"], c["order"], inp.dt, inp.c_max,
                           c["f0_hz"], dtype=dtype, device=device)
    k = len(sample)
    sv = reference.make_survey(med, inp.src[sample], np.repeat(inp.rcv[None], k, 0),
                               inp.wavelet, inp.h2)
    d_f = reference.lowpass(reference.forward(sv, inp.vp_true)[0], sv.h2, axis=1)
    if cell.gradient:
        J, g, seis = reference.value_and_grad(sv, vp, d_f, tape_dtype=DTYPES[cell.tape[1]],
                                              segment=int(cell.check["segment"]))
        return seis, J, (g,)
    seis = reference.forward(sv, vp)[0]
    return seis, reference.misfit(sv, seis, d_f)[0], None


def misfit(cell, inp: Inputs, seis, d_obs) -> float:
    """J of the shots (k, nt, nrec): 0.5 ||lowpass(seis) - lowpass(d_obs)||^2."""
    h2 = torch.as_tensor(inp.h2, dtype=torch.float32, device=seis.device)
    r = reference.lowpass(seis, h2, 1) - reference.lowpass(d_obs, h2, 1)
    return float(0.5 * (r.double() ** 2).sum())


def shot_bound_s(cell, inp: Inputs) -> float:
    """``counts.shot_bound_s`` of one shot of the cell."""
    return counts.shot_bound_s(cell.shape, cell.config["order"], cell.config["pml"], inp.nt,
                               inp.src.shape[1], len(inp.rcv), cell.tape, cell.gradient)
