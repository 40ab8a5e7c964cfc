"""The comparison that decides ``correct``: what the timed path produced in
the captured evaluation against the plain reference (``reference.py``) on
the sampled shots, at the same inputs and sizes.

The numbers compared, each against its limit in ``checks/<cell>.json``:

- ``shots_missed``: over the window's evaluations, the shots the objective
  did not send through the propagator (exact: limit 0);
- ``seis_err``: the worst sampled shot's ||seis - ref|| / ||ref||, the
  seismogram the engine returned (the propagator, the engine's forward and
  its kernels);
- ``J_err``: the survey objective J the evaluation returned, less the
  misfits of the shots not sampled (the reference's misfit on the
  program's own seismograms and observed data), against the sampled
  shots' reference J, relative (the objective: data, low-pass, misfit,
  the sum over the survey);
- ``grad_err``: the evaluation's gradient less the captured gradients of
  the shots not sampled, against the sampled shots' reference gradient,
  ||.|| relative (the reverse: the misfit's adjoint source, the engine's
  reverse and its kernels, the sum).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import reference

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class Captured:
    seis: torch.Tensor  # (nshot, nt, nrec), host
    grads: torch.Tensor | None  # (nshot, *shape), host
    J: float
    g: torch.Tensor | None  # (*shape), host
    d_other: torch.Tensor  # the program's observed data of the shots not sampled, host
    other: list

    @staticmethod
    def take(prog, sample):
        sampled = set(sample.tolist())
        other = [i for i in range(prog.d_obs.shape[0]) if i not in sampled]
        return Captured(prog.tap.seis, prog.tap.grads, float(prog.J), prog.g,
                        prog.d_obs[other].cpu(), other)


def reference_outputs(cell, inp, vp, sample, device, dtype=torch.float32):
    """(seis (k, nt, nrec), J (k,), gradient (k, *shape) or None) of the
    sampled shots at model ``vp``, observed data from the true model, all
    computed by the reference with fields of ``dtype``."""
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
        return seis, J, g
    seis = reference.forward(sv, vp)[0]
    return seis, reference.misfit(sv, seis, d_f)[0], None


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def readings(seis, J_sampled, g_sampled, ref) -> dict:
    """The numbers of sampled shots' seismograms (k, nt, nrec), their
    summed J and summed gradient (or None), against the reference's."""
    seis_r, J_r, g_r = ref
    out = {"seis_err": max(rel(seis[i], seis_r[i]) for i in range(seis_r.shape[0])),
           "J_err": abs(float(J_sampled) - float(J_r.sum())) / float(J_r.sum())}
    if g_r is not None:
        out["grad_err"] = rel(g_sampled, g_r.sum(0))
    return out


def compare(cell, inp, got: Captured, vp, sample, calls, device, control=None):
    """The numbers of one run (see the module's docstring), and with
    ``control`` (a dtype) those of the control: the reference in that
    precision put in the program's place, on the same shots and inputs."""
    n = len(inp.src)
    ref = reference_outputs(cell, inp, vp, sample, device)
    ctrl = None
    if control is not None:
        seis_c, J_c, g_c = reference_outputs(cell, inp, vp, sample, device, dtype=control)
        ctrl = {"shots_missed": 0}
        ctrl.update(readings(seis_c, J_c.sum(), None if g_c is None else g_c.sum(0), ref))
        del seis_c, g_c
    h2 = torch.as_tensor(inp.h2, dtype=torch.float32, device=device)
    J_other = 0.0
    if got.other:
        seis_o = got.seis[got.other].to(device)
        r = reference.lowpass(seis_o, h2, 1) - reference.lowpass(got.d_other.to(device), h2, 1)
        J_other = float(0.5 * (r.double() ** 2).sum())
        del seis_o, r
    g_sampled = None
    if cell.gradient:
        g_sampled = got.g.to(device).double()
        for i in got.other:
            g_sampled -= got.grads[i].to(device)
    out = {"shots_missed": int(sum(abs(c - n) for c in calls))}
    out.update(readings(got.seis[sample].to(device), got.J - J_other, g_sampled, ref))
    return out, ctrl


def verdict(numbers: dict, limits: dict) -> bool:
    return all(math.isfinite(v) and v <= limits[k] for k, v in numbers.items())
