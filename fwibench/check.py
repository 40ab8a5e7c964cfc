"""The comparison that decides ``correct``: what the timed path produced in
the captured evaluation against the plain reference of the cell's physics
(``physics/<name>.py``'s ``reference_outputs``; acoustic: ``reference.py``)
on the sampled shots, at the same inputs and sizes.

The numbers compared, each against its limit in ``checks/<cell>.json``:

- ``shots_missed``: over the window's evaluations, the shots the objective
  did not send through the propagator (exact: limit 0);
- ``seis_err``: the worst sampled shot's ||seis - ref|| / ||ref||, the
  seismogram the engine returned (the propagator, the engine's forward and
  its kernels);
- ``J_err``: the survey objective J the evaluation returned, less the
  misfit of the shots not sampled (the physics' ``misfit`` on the
  program's own seismograms and observed data), against the sampled
  shots' reference J, relative (the objective: data, low-pass, misfit,
  the sum over the survey);
- ``grad_err``: the evaluation's gradient less the captured gradients of
  the shots not sampled, against the sampled shots' reference gradient,
  ||.|| relative, the largest over the model's fields: the reference
  gives one for every field, or the comparison fails (the reverse: the
  misfit's adjoint source, the engine's reverse and its kernels, the
  sum).
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass
class Captured:
    seis: torch.Tensor  # (nshot, nt, ...), host
    grads: tuple | None  # a (nshot, *shape) tensor per field, host
    J: float
    g: tuple | None  # a (*shape) tensor per field, host
    d_other: torch.Tensor  # the program's observed data of the shots not sampled, host
    other: list

    @staticmethod
    def take(prog, sample):
        sampled = set(sample.tolist())
        other = [i for i in range(prog.d_obs.shape[0]) if i not in sampled]
        return Captured(prog.tap.seis, prog.tap.grads, float(prog.J), prog.g,
                        prog.d_obs[other].cpu(), other)


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def readings(seis, J_sampled, g_sampled, ref) -> dict:
    """The numbers of sampled shots' seismograms (k, nt, ...), their
    summed J and summed gradient per field (or None), against the
    reference's, which has one for every field."""
    seis_r, J_r, g_r = ref
    out = {"seis_err": max(rel(seis[i], seis_r[i]) for i in range(seis_r.shape[0])),
           "J_err": abs(float(J_sampled) - float(J_r.sum())) / float(J_r.sum())}
    if g_r is not None:
        out["grad_err"] = max(rel(g, r.sum(0)) for g, r in zip(g_sampled, g_r, strict=True))
    return out


def compare(cell, inp, got: Captured, m, sample, calls, device, control=None):
    """The numbers of one run at the captured evaluation's model ``m`` (see
    the module's docstring), and with ``control`` (a dtype) those of the
    control: the reference in that precision put in the program's place, on
    the same shots and inputs."""
    n = len(inp.src)
    ref = cell.physics.reference_outputs(cell, inp, m, sample, device, torch.float32)
    ctrl = None
    if control is not None:
        seis_c, J_c, g_c = cell.physics.reference_outputs(cell, inp, m, sample, device, control)
        ctrl = {"shots_missed": 0}
        ctrl.update(readings(seis_c, J_c.sum(), None if g_c is None else tuple(
            g.sum(0) for g in g_c), ref))
        del seis_c, g_c
    J_other = 0.0
    if got.other:
        J_other = cell.physics.misfit(cell, inp, got.seis[got.other].to(device),
                                      got.d_other.to(device))
    g_sampled = None
    if cell.gradient:
        g_sampled = []
        for g, grads in zip(got.g, got.grads, strict=True):
            g = g.to(device).double()
            for i in got.other:
                g -= grads[i].to(device)
            g_sampled.append(g)
    out = {"shots_missed": int(sum(abs(c - n) for c in calls))}
    out.update(readings(got.seis[sample].to(device), got.J - J_other, g_sampled, ref))
    return out, ctrl


def verdict(numbers: dict, limits: dict) -> bool:
    return all(math.isfinite(v) and v <= limits[k] for k, v in numbers.items())
