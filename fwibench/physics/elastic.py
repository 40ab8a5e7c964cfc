"""The elastic P-SV physics: a configuration with ``"physics": "elastic"``
runs here. The model is three fields, (vp, vs, rho): the land variant of
``models.marmousi_like`` (no water, so mu > 0 everywhere), vs = vp / 1.9 and
Gardner's rho = 310 vp^0.25, as ``tpufwi_torch.invert.
build_synthetic_elastic_problem`` makes them, and its start (vp and vs
smoothed, rho the truth). The program is the port's
``ElasticPropagator`` (a vertical force, (vz, vx) records) under
``ElasticFwiProblem``; the reference is ``reference_elastic.py``; a shot's
bound counts the elastic passes of ``counts_elastic.py``. See
``spec.physics`` for what a physics provides.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from fwibench import counts_elastic, harness, models, reference, reference_elastic, spec


@dataclasses.dataclass
class Inputs:
    m_true: tuple  # (vp, vs, rho) fp32, physical grid, on the device
    m0: tuple
    dt: float
    vp_max: float  # the CPML's and the step's speed
    nt: int
    src: np.ndarray  # (nshot, 1, 2) physical cells
    rcv: np.ndarray  # (nrec, 2)
    wavelet: np.ndarray
    h2: np.ndarray  # the band's low-pass response


def true_model(cfg: dict, shape, seed: int, device) -> tuple:
    """(vp, vs, rho) fp32 from the configuration's generator, the ratio
    vp / vs and Gardner's law rho = a vp^b."""
    m = cfg["model"]
    vp = models.GENERATORS[m["generator"]](shape, cfg["h_m"], seed, device,
                                           water_depth_m=m["water_depth_m"])
    a, b = m["gardner"]
    return tuple(f.float() for f in (vp, vp / m["vp_over_vs"], a * vp**b))


def inputs(cell: spec.Cell, seed: int, device) -> Inputs:
    c = cell.config
    m_true = true_model(c, cell.shape, seed, device)
    start = c["start"]
    m0 = tuple((f.double() if name in start["keep_true"]
                else models.gaussian(f.double(), float(start["smooth_sigma"]))).clamp(*b).float()
               for name, f, b in zip(reference_elastic.FIELDS, m_true, c["bounds"]))
    vp_max = float(c["vp_max_mps"])
    dt = reference_elastic.cfl_dt(cell.h, vp_max, c["order"], c["cfl"])
    nt = int(c["nt"])
    src, rcv = spec.geometry(cell)
    return Inputs(m_true, m0, dt, vp_max, nt, src, rcv, reference.ricker(c["f0_hz"], dt, nt),
                  reference.lowpass_response(nt, dt, c["band_hz"]))


def model(cell, inp: Inputs, seed: int, e: int) -> tuple:
    """Evaluation e's model: each field k perturbed by ``models.perturbed``
    from the stream 3 e + k of the seed, within its bounds."""
    n = len(reference_elastic.FIELDS)
    return tuple(models.perturbed(f, seed, n * e + k, cell.traffic["perturbation"], b)
                 for k, (f, b) in enumerate(zip(inp.m0, cell.config["bounds"])))


def program(cell: spec.Cell, inp: Inputs, device, split: dict) -> harness.Program:
    """The propagator, the survey, the observed data from the true model,
    the stage objective, warmed on two shots."""
    from tpufwi_torch.acquisition import Geometry
    from tpufwi_torch.grid import Grid
    from tpufwi_torch.invert import ElasticFwiProblem
    from tpufwi_torch.propagators.elastic2d import ElasticPropagator

    t0 = time.perf_counter()
    c = cell.config
    grid = Grid(shape=cell.shape, h=cell.h, pml=c["pml"], order=c["order"])
    prop = ElasticPropagator(grid, inp.dt, c["f0_hz"], inp.vp_max, source_type="force_z",
                             record="v", impl=c["impl"], device=device)
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
    """(seis (k, nt, nrec, 2), J (k,), (gradient (k, *shape) in vp, vs,
    rho) or None) of the sampled shots at model ``m``, observed data from
    the true model, all computed by the reference with fields of ``dtype``."""
    c = cell.config
    med = reference_elastic.Medium(cell.shape, cell.h, c["pml"], c["order"], inp.dt,
                                   inp.vp_max, c["f0_hz"], dtype=dtype, device=device)
    k = len(sample)
    sv = reference_elastic.make_survey(med, inp.src[sample], np.repeat(inp.rcv[None], k, 0),
                                       inp.wavelet, inp.h2)
    d_f = reference.lowpass(reference_elastic.forward(sv, inp.m_true)[0], sv.h2, axis=1)
    if cell.gradient:
        J, g, seis = reference_elastic.value_and_grad(sv, m, d_f,
                                                      segment=int(cell.check["segment"]))
        return seis, J, g
    seis = reference_elastic.forward(sv, m)[0]
    return seis, reference_elastic.misfit(sv, seis, d_f)[0], None


def misfit(cell, inp: Inputs, seis, d_obs) -> float:
    """J of the shots (k, nt, nrec, 2): 0.5 ||lowpass(seis) - lowpass(d_obs)||^2."""
    h2 = torch.as_tensor(inp.h2, dtype=torch.float32, device=seis.device)
    r = reference.lowpass(seis, h2, 1) - reference.lowpass(d_obs, h2, 1)
    return float(0.5 * (r.double() ** 2).sum())


def shot_bound_s(cell, inp: Inputs) -> float:
    """``counts_elastic.shot_bound_s`` of one shot of the cell: two recorded
    components a receiver."""
    c = cell.config
    return counts_elastic.shot_bound_s(cell.shape, c["order"], c["pml"], inp.nt,
                                       inp.src.shape[1], 2 * len(inp.rcv), cell.tape,
                                       cell.gradient)
