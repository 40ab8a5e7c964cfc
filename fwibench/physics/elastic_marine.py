"""The marine elastic P-SV physics: a configuration with ``"physics":
"elastic_marine"`` runs here. The model is three fields, (vp, vs, rho): the
configuration's generator with its water layer, vs = vp / 1.9 and Gardner's
rho = 310 vp^0.25 below the seabed, the water's (vp, 0, rho) above it; the
start smooths vp and vs over the section below the seabed alone and keeps
the water and rho. The program is the port's ``ElasticPropagator`` on a
``Grid(free_surface=True)`` with a pressure source and pressure records,
under ``ElasticFwiProblem``; the reference is ``reference_elastic_marine.py``;
a shot's bound counts ``counts_elastic_marine.py``. Each evaluation's
model is perturbed as ``physics/elastic.py``'s, so vs stays exactly 0 in
the water (0 times the perturbation, clipped at the bound 0). See
``spec.physics`` for what a physics provides.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from fwibench import (
    counts_elastic_marine,
    harness,
    models,
    reference,
    reference_elastic,
    reference_elastic_marine,
    spec,
)

elastic = spec.find("physics", "elastic")
Inputs, misfit, model = elastic.Inputs, elastic.misfit, elastic.model


def water_rows(cfg: dict) -> int:
    """Rows of the water layer: the generator's flat seabed."""
    return int(cfg["model"]["water_depth_m"] / cfg["h_m"])


def true_model(cfg: dict, shape, seed: int, device) -> tuple:
    """(vp, vs, rho) fp32: the land fields of ``physics/elastic.py`` below
    the seabed, the water's materials above it."""
    fields = [f.clone() for f in elastic.true_model(cfg, shape, seed, device)]
    nw, water = water_rows(cfg), cfg["model"]["water"]
    for f, name in zip(fields, reference_elastic.FIELDS):
        f[:nw] = water[name]
    return tuple(fields)


def start_model(cfg: dict, m_true) -> tuple:
    """vp and vs smoothed over the rows below the seabed (reflected at the
    seabed, so no water enters), the water and rho kept, each clipped to
    its bounds."""
    start, nw = cfg["start"], water_rows(cfg)
    out = []
    for name, f, b in zip(reference_elastic.FIELDS, m_true, cfg["bounds"]):
        f = f.double()
        if name not in start["keep_true"]:
            f = torch.cat([f[:nw], models.gaussian(f[nw:], float(start["smooth_sigma"]))])
        out.append(f.clamp(*b).float())
    return tuple(out)


def inputs(cell: spec.Cell, seed: int, device) -> Inputs:
    c = cell.config
    m_true = true_model(c, cell.shape, seed, device)
    vp_max = float(c["vp_max_mps"])
    dt = reference_elastic.cfl_dt(cell.h, vp_max, c["order"], c["cfl"])
    nt = int(c["nt"])
    src, rcv = spec.geometry(cell)
    return Inputs(m_true, start_model(c, m_true), dt, vp_max, nt, src, rcv,
                  reference.ricker(c["f0_hz"], dt, nt),
                  reference.lowpass_response(nt, dt, c["band_hz"]))


def program(cell: spec.Cell, inp: Inputs, device, split: dict) -> harness.Program:
    """The propagator on the free-surface grid, the survey, the observed
    pressure data from the true model, the stage objective, warmed on two
    shots."""
    from tpufwi_torch.acquisition import Geometry
    from tpufwi_torch.grid import Grid
    from tpufwi_torch.invert import ElasticFwiProblem
    from tpufwi_torch.propagators.elastic2d import ElasticPropagator

    t0 = time.perf_counter()
    c = cell.config
    grid = Grid(shape=cell.shape, h=cell.h, pml=c["pml"], order=c["order"],
                free_surface=bool(c["free_surface"]))
    prop = ElasticPropagator(grid, inp.dt, c["f0_hz"], inp.vp_max, source_type=c["source_type"],
                             record=c["record"], impl=c["impl"], device=device)
    geoms = Geometry.stack([Geometry.from_physical(grid, s, inp.rcv, device=device)
                            for s in inp.src])
    w = torch.as_tensor(inp.wavelet, dtype=torch.float32, device=device)
    n = len(inp.src)
    split["program"] = time.perf_counter() - t0
    d_obs, times = [], []
    with torch.no_grad():
        for i in range(n):
            t0 = time.perf_counter()
            d_obs.append(prop(*inp.m_true, geoms.shot(i), w))
            harness.sync(device)
            times.append(time.perf_counter() - t0)
    # the first forward also loads (or builds) the kernels' library
    split["libraries"] = times[0] - (np.mean(times[1:]) if n > 1 else 0.0)
    split["observed_data"] = sum(times) - split["libraries"]
    d_obs = torch.stack(d_obs)
    tap = harness.ShotTap(prop, d_obs.shape, [cell.shape] * 3 if cell.gradient else None,
                          device)
    problem = ElasticFwiProblem(prop=tap, geoms=geoms, d_obs=d_obs, wavelet=w, dt=inp.dt)
    vg, loss = problem.stage_objectives(c["band_hz"])
    t0 = time.perf_counter()
    k = min(2, n)
    warm = ElasticFwiProblem(prop=tap, geoms=Geometry(geoms.src_idx[:k], geoms.rcv_idx[:k]),
                             d_obs=d_obs[:k], wavelet=w, dt=inp.dt)
    wvg, wloss = warm.stage_objectives(c["band_hz"])
    (wvg if cell.gradient else wloss)(inp.m0)
    harness.sync(device)
    split["warm_shots"] = time.perf_counter() - t0
    return harness.Program(tap, vg if cell.gradient else loss, d_obs, prop.impl, device)


def reference_outputs(cell, inp: Inputs, m, sample, device, dtype=torch.float32):
    """(seis (k, nt, nrec), J (k,), (gradient (k, *shape) in vp, vs, rho)
    or None) of the sampled shots at model ``m``, observed data from the
    true model, all computed by the marine reference with fields of
    ``dtype``."""
    c = cell.config
    ref = reference_elastic_marine
    med = ref.MarineMedium(cell.shape, cell.h, c["pml"], c["order"], inp.dt, inp.vp_max,
                           c["f0_hz"], dtype=dtype, device=device)
    k = len(sample)
    sv = reference_elastic.make_survey(med, inp.src[sample], np.repeat(inp.rcv[None], k, 0),
                                       inp.wavelet, inp.h2)
    d_f = reference.lowpass(ref.forward(sv, inp.m_true)[0], sv.h2, axis=1)
    if cell.gradient:
        J, g, seis = ref.value_and_grad(sv, m, d_f, segment=int(cell.check["segment"]))
        return seis, J, g
    seis = ref.forward(sv, m)[0]
    return seis, ref.misfit(sv, seis, d_f)[0], None


def shot_bound_s(cell, inp: Inputs) -> float:
    """``counts_elastic_marine.shot_bound_s`` of one shot of the cell: one
    recorded value a hydrophone."""
    c = cell.config
    return counts_elastic_marine.shot_bound_s(cell.shape, c["order"], c["pml"], inp.nt,
                                              inp.src.shape[1], len(inp.rcv), cell.tape,
                                              cell.gradient)
