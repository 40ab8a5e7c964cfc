"""A physics for the tests of the harness's plumbing, not of the physics:
a three-field model (vp, vs, rho), two-component seismograms (nt, nrec, 2)
and three gradients, on the program's eager elastic engine
(``ElasticPropagator(impl="eager")`` under ``ElasticFwiProblem``) on the
CPU. Its "reference" is that same engine, so it agrees with the program by
construction; the elastic cell's own physics brings a plain reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fwibench import harness, models, reference, spec


@dataclasses.dataclass
class Inputs:
    m_true: tuple  # (vp, vs, rho) fp32, physical grid
    m0: tuple
    dt: float
    vp_max: float
    nt: int
    src: np.ndarray  # (nshot, 1, 2) physical cells
    rcv: np.ndarray  # (nrec, 2)
    wavelet: np.ndarray
    h2: np.ndarray


def inputs(cell, seed: int, device) -> Inputs:
    from tpufwi_torch.propagators.elastic2d import elastic_cfl_dt

    c = cell.config
    vp = models.marmousi_like(cell.shape, c["h_m"], seed, device, water_depth_m=0.0)
    m_true = tuple(f.float() for f in (vp, vp / 1.9, 310.0 * vp**0.25))  # Gardner's rho
    m0 = tuple(models.gaussian(f.double(), c["start"]["smooth_sigma"]).float() for f in m_true)
    vp_max = float(m_true[0].max())
    dt = elastic_cfl_dt(cell.h, vp_max, c["order"], safety=c["cfl"])
    nt = int(c["nt"])
    src, rcv = spec.geometry(cell)
    return Inputs(m_true, m0, dt, vp_max, nt, src, rcv, reference.ricker(c["f0_hz"], dt, nt),
                  reference.lowpass_response(nt, dt, c["band_hz"]))


def model(cell, inp: Inputs, seed: int, e: int) -> tuple:
    return tuple(models.perturbed(f, seed, e, cell.traffic["perturbation"], b)
                 for f, b in zip(inp.m0, cell.config["bounds"]))


def survey(cell, inp: Inputs, device, dtype=torch.float32):
    """(the eager propagator, the shots' geometries, the wavelet)."""
    from tpufwi_torch.acquisition import Geometry
    from tpufwi_torch.grid import Grid
    from tpufwi_torch.propagators.elastic2d import ElasticPropagator

    c = cell.config
    grid = Grid(shape=cell.shape, h=cell.h, pml=c["pml"], order=c["order"])
    prop = ElasticPropagator(grid, inp.dt, c["f0_hz"], inp.vp_max, dtype=dtype, record="v",
                             source_type="force_z", impl="eager", device=device)
    geoms = Geometry.stack([Geometry.from_physical(grid, s, inp.rcv, device=device)
                            for s in inp.src])
    return prop, geoms, torch.as_tensor(inp.wavelet, dtype=dtype, device=device)


def program(cell, inp: Inputs, device, split: dict) -> harness.Program:
    from tpufwi_torch.invert import ElasticFwiProblem

    prop, geoms, w = survey(cell, inp, device)
    with torch.no_grad():
        d_obs = torch.stack([prop(*inp.m_true, geoms.shot(i), w) for i in range(len(inp.src))])
    tap = harness.ShotTap(prop, d_obs.shape, [cell.shape] * 3 if cell.gradient else None, device)
    problem = ElasticFwiProblem(prop=tap, geoms=geoms, d_obs=d_obs, wavelet=w, dt=inp.dt)
    vg, loss = problem.stage_objectives(cell.config["band_hz"])
    return harness.Program(tap, vg if cell.gradient else loss, d_obs, prop.impl, device)


def reference_outputs(cell, inp: Inputs, m, sample, device, dtype=torch.float32):
    """The sampled shots on the same eager engine, with fields of ``dtype``
    (float32 or float64): each shot's L2 misfit of low-passed traces and
    its gradient by autograd."""
    prop, geoms, w = survey(cell, inp, device, dtype)
    h2 = torch.as_tensor(inp.h2, dtype=dtype, device=device)
    seis, J, grads = [], [], []
    for i in sample:
        geom = geoms.shot(int(i))
        with torch.no_grad():
            d_f = reference.lowpass(prop(*(f.to(dtype) for f in inp.m_true), geom, w), h2, 0)
        mi = tuple(f.detach().to(dtype).requires_grad_(True) for f in m)
        s = prop(*mi, geom, w)
        Ji = 0.5 * ((reference.lowpass(s, h2, 0) - d_f).double() ** 2).sum()
        grads.append(torch.autograd.grad(Ji, mi) if cell.gradient else ())
        seis.append(s.detach().float())
        J.append(Ji.detach())
    g = tuple(torch.stack(gs).float() for gs in zip(*grads)) if cell.gradient else None
    return torch.stack(seis), torch.stack(J), g


def misfit(cell, inp: Inputs, seis, d_obs) -> float:
    """J of the shots (k, nt, nrec, 2): 0.5 ||lowpass(seis) - lowpass(d_obs)||^2."""
    h2 = torch.as_tensor(inp.h2, dtype=torch.float32, device=seis.device)
    r = reference.lowpass(seis, h2, 1) - reference.lowpass(d_obs, h2, 1)
    return float(0.5 * (r.double() ** 2).sum())


def shot_bound_s(cell, inp: Inputs) -> float:
    """No pass counts: this physics never runs on the card, where alone a
    traced run reads the roofline."""
    return 0.0
