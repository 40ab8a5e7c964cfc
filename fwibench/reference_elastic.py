"""Plain torch reference of the elastic P-SV survey objective: the forward
modelling of a vertical force recorded as two-component particle velocity,
the L2 misfit of low-passed traces and its gradient in (vp, vs, rho).

It imports nothing of the program under test (neither ``tpufwi_torch`` nor
the JAX package). It follows the published scheme the configuration states,
the velocity-stress staggered grid of Virieux (1986) and Levander (1988),
written from the equations. Staggering, z the first axis and x the second:

    sxx, szz at (i, j);  sxz at (i+1/2, j+1/2);  vx at (i, j+1/2);  vz at (i+1/2, j)

with the order-8 staggered first differences, zero outside the padded grid:

    D+ f[i] = sum_k c_k (f[i+1+k] - f[i-k]) / h     (integer -> half positions)
    D- f[i] = sum_k c_k (f[i+k] - f[i-1-k]) / h     (half -> integer positions)
    c = (1225/1024, -245/3072, 49/5120, -5/7168)

and a CPML memory variable on each of the eight derivative terms
(Komatitsch & Martin 2007, kappa = 1): m' = b m + a D f, the term D f + m'.
One step, in the order of the program's contract:

    vx  += dt bx (D+x sxx + D-z sxz)        (each derivative with its memory)
    vz  += dt bz (D-x sxz + D+z szz)
    exx  = D-x vx,  ezz = D-z vz            (of the new velocities)
    sxx += dt ((lam + 2 mu) exx + lam ezz);  szz += dt ((lam + 2 mu) ezz + lam exx)
    sxz += dt mu_xz (D+z vx + D+x vz)
    vz[src] += dt bz[src] w_t               (the force, after the stress update)
    record (vz, vx) at the receivers        (after the force)

The materials live on the grid padded by pml + r cells a side with edge
values: mu = rho vs^2, lam = rho vp^2 - 2 mu, mu_xz the mean of mu over the
four cells (i, j), (i+1, j), (i, j+1), (i+1, j+1), bx and bz the means of
1/rho over (i, j), (i, j+1) and over (i, j), (i+1, j), each edge extended.
The CPML profiles are those of ``reference.cpml_ab`` with c_max the
configuration's vp bound.

Where it departs from the published scheme, as the program's contract does:

- the profiles (a, b) are evaluated at the integer cells and used at the
  half positions too (no half-cell shift of the layer);
- the memory variables cover the whole grid (zero where the profiles are);
- it has no free surface (the configuration has none) and no pressure
  source; the force is the only source.

The gradient is the exact gradient of that discrete recursion, by torch
autograd over segments of ``segment`` steps, each recomputed from the state
the forward kept at its start, so memory is O(nt / K + K) fields. Its
definition, the configuration's: the cotangents of the five staggered
material fields (lam, lam + 2 mu, mu_xz, bx, bz) are zeroed outside the
physical interior shrunk by r (the ring the program's boundary-saving
reverse re-imposes from its tape), then chained to (vp, vs, rho) through
the averaging above. So the gradient is the exact gradient of J on the
interior shrunk by r + 1 (each physical cell reaches the staggered cells
one cell away), zero on the first r and the last r - 1 rows and columns,
and on the row between at each side the chain of the cotangents kept.

``Medium(dtype=)`` runs the whole recursion in another precision (the
control: bfloat16); the materials and the final chain are computed in
float32 (float64 for a float64 medium), and seismograms, J and gradients
are returned in float32 (float64). No matrix product or convolution is
used; TF32 is off while the reference runs all the same. Every field
carries a leading shot axis; the shots of one call share the model.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import numpy as np
import torch

from fwibench.reference import cpml_ab, flat_index, lowpass

# staggered first-derivative weights c_k of D+ and D- (Levander 1988)
D1_STAGGERED = {8: (1225.0 / 1024, -245.0 / 3072, 49.0 / 5120, -5.0 / 7168)}
FIELDS = ("vp", "vs", "rho")
# the state: five wavefields, then the memories of (sxx_x, sxz_z, sxz_x,
# szz_z) of the velocity half-step and (vx_x, vz_z, vx_z, vz_x) of the stress one
STATE = 13


def cfl_dt(h, vp_max: float, order: int, safety: float) -> float:
    """The staggered grid's stable step (Levander 1988), h / (sqrt(2) vp_max
    sum |c_k|) for square cells, harmonic in 1/h^2, times ``safety``."""
    s = sum(abs(c) for c in D1_STAGGERED[order])
    return float(safety / (vp_max * s * math.sqrt(sum(1.0 / float(x) ** 2 for x in h))))


@contextlib.contextmanager
def no_tf32():
    """TF32 off for matrix products and cuDNN inside the block."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def staggered(f: torch.Tensor, taps, axis: int, plus: bool) -> torch.Tensor:
    """D+ (``plus``) or D- of ``f`` along ``axis`` (-2: z, -1: x), the 1/h
    in ``taps``, zero outside."""
    r, n = len(taps), f.shape[axis]
    pad = (r, r, 0, 0) if axis == -1 else (0, 0, r, r)
    fp = torch.nn.functional.pad(f, pad)
    out = None
    for k, c in enumerate(taps):
        hi, lo = (r + 1 + k, r - k) if plus else (r + k, r - 1 - k)
        term = fp.narrow(axis, hi, n) - fp.narrow(axis, lo, n)
        if out is None:
            out = term.mul_(c)
        else:
            out.add_(term, alpha=c)
    return out


def next_edge(f: torch.Tensor, axis: int) -> torch.Tensor:
    """out[i] = f[i + 1] along ``axis``, the last value repeated."""
    n = f.shape[axis]
    return torch.cat([f.narrow(axis, 1, n - 1), f.narrow(axis, n - 1, 1)], dim=axis)


class Medium:
    """One survey's discretisation on a device: the padded shape, the scaled
    taps, the CPML profiles; ``dtype`` the fields' precision."""

    def __init__(self, shape, h, pml: int, order: int, dt: float, vp_max: float, f0: float,
                 dtype=torch.float32, device="cpu"):
        self.shape = tuple(int(s) for s in shape)
        self.r = order // 2
        self.pad = pml + self.r
        self.padded = tuple(s + 2 * self.pad for s in self.shape)
        self.dt, self.dtype, self.device = float(dt), dtype, torch.device(device)
        # materials, the chain and the outputs: float64 for a float64 medium
        self.wide = torch.float64 if dtype == torch.float64 else torch.float32
        self.tz, self.tx = (tuple(c / float(hd) for c in D1_STAGGERED[order]) for hd in h)
        profiles = []
        for n, hd, view in zip(self.shape, h, ((-1, 1), (1, -1))):
            profiles += [torch.as_tensor(v, dtype=self.wide, device=self.device).to(dtype)
                         .reshape(view) for v in cpml_ab(n, pml, self.r, float(hd), dt, vp_max, f0)]
        self.az, self.bz, self.ax, self.bx = profiles

    def materials(self, vp, vs, rho):
        """(lam, lam + 2 mu, mu_xz, bx, bz) on the padded grid, in the
        medium's wide precision, differentiable; the fields (..., nz, nx)."""
        p = self.pad

        def edge(f):
            f = f.to(self.wide)
            flat = f.ndim == 2
            out = torch.nn.functional.pad(f[None] if flat else f, (p, p, p, p), mode="replicate")
            return out[0] if flat else out

        vp, vs, rho = edge(vp), edge(vs), edge(rho)
        mu = rho * vs**2
        lam2mu = rho * vp**2
        lam = lam2mu - 2.0 * mu
        mu_z = next_edge(mu, -2)
        mu_xz = 0.25 * (mu + mu_z + next_edge(mu, -1) + next_edge(mu_z, -1))
        b = 1.0 / rho
        return lam, lam2mu, mu_xz, 0.5 * (b + next_edge(b, -1)), 0.5 * (b + next_edge(b, -2))

    def zero_state(self, nb: int) -> list:
        z = torch.zeros((nb,) + self.padded, dtype=self.dtype, device=self.device)
        return [z] * STATE

    def step(self, state, M, w_t, src, rcv):
        """One step from ``state`` (a list of ``STATE`` fields, not changed);
        ``M`` the materials times dt in the fields' precision, (dt lam, dt
        (lam + 2 mu), dt mu_xz, dt bx, dt bz). Returns (the new state, the
        record (nb, nrec, 2) of (vz, vx))."""
        vx, vz, sxx, szz, sxz, *m = state
        dlam, dl2m, dmxz, dbx, dbz = M
        az, bz, ax, bx, tz, tx = self.az, self.bz, self.ax, self.bx, self.tz, self.tx

        def cpml(mem, a, b, d):
            mem = torch.addcmul(b * mem, a, d)
            return d + mem, mem

        e0, m0 = cpml(m[0], ax, bx, staggered(sxx, tx, -1, True))
        e1, m1 = cpml(m[1], az, bz, staggered(sxz, tz, -2, False))
        e2, m2 = cpml(m[2], ax, bx, staggered(sxz, tx, -1, False))
        e3, m3 = cpml(m[3], az, bz, staggered(szz, tz, -2, True))
        vx = vx + dbx * (e0 + e1)
        vz = vz + dbz * (e2 + e3)
        exx, m4 = cpml(m[4], ax, bx, staggered(vx, tx, -1, False))
        ezz, m5 = cpml(m[5], az, bz, staggered(vz, tz, -2, False))
        e6, m6 = cpml(m[6], az, bz, staggered(vx, tz, -2, True))
        e7, m7 = cpml(m[7], ax, bx, staggered(vz, tx, -1, True))
        sxx = sxx + (dl2m * exx + dlam * ezz)
        szz = szz + (dl2m * ezz + dlam * exx)
        sxz = sxz + dmxz * (e6 + e7)
        nb = vz.shape[0]
        force = dbz.reshape(dbz.shape[:-2] + (-1,)).expand(nb, -1).gather(1, src) * w_t
        vz = vz.reshape(nb, -1).scatter_add(1, src, force).view_as(vz)
        rec = torch.stack([vz.reshape(nb, -1).gather(1, rcv), vx.reshape(nb, -1).gather(1, rcv)],
                          dim=-1)
        return [vx, vz, sxx, szz, sxz, m0, m1, m2, m3, m4, m5, m6, m7], rec

    def scaled(self, mats):
        """The materials times dt, in the fields' precision."""
        return [(self.dt * x).to(self.dtype) for x in mats]

    def valid(self, g):
        """``g`` (..., NZ, NX) zeroed outside the physical interior shrunk by r."""
        out = torch.zeros_like(g)
        sl = (Ellipsis,) + tuple(slice(self.pad + self.r, self.pad + n - self.r)
                                 for n in self.shape)
        out[sl] = g[sl]
        return out


class Survey(NamedTuple):
    """Shots that share a model: their sources (nb, nsrc) and receivers
    (nb, nrec) as flat indices of the padded grid, the wavelet (nt,) in the
    fields' precision and the low-pass response in the wide one."""

    medium: Medium
    src: torch.Tensor
    rcv: torch.Tensor
    wavelet: torch.Tensor
    h2: torch.Tensor


def make_survey(medium: Medium, src, rcv, wavelet, h2) -> Survey:
    """From physical cells: sources (nb, nsrc, 2), receivers (nb, nrec, 2)."""
    dev = medium.device
    return Survey(medium, flat_index(src, medium.padded, medium.pad, dev),
                  flat_index(rcv, medium.padded, medium.pad, dev),
                  torch.as_tensor(np.asarray(wavelet), dtype=medium.wide, device=dev)
                  .to(medium.dtype),
                  torch.as_tensor(np.asarray(h2), dtype=medium.wide, device=dev))


def forward(sv: Survey, m, every: int = 0):
    """Seismograms (nb, nt, nrec, 2) of (vz, vx) at ``m`` = (vp, vs, rho),
    in the wide precision; with ``every`` > 0 also the state at every
    ``every``-th step (before the step)."""
    med = sv.medium
    nb, nt = sv.src.shape[0], sv.wavelet.shape[0]
    seis = torch.empty((nb, nt, sv.rcv.shape[1], 2), dtype=med.wide, device=med.device)
    ckpts = {}
    with torch.no_grad(), no_tf32():
        M = med.scaled(med.materials(*m))
        state = med.zero_state(nb)
        for t in range(nt):
            if every and t % every == 0:
                ckpts[t] = state  # a step makes new fields, so this one stays as it is
            state, rec = med.step(state, M, sv.wavelet[t], sv.src, sv.rcv)
            seis[:, t] = rec
    return seis, ckpts


def misfit(sv: Survey, seis: torch.Tensor, d_filtered: torch.Tensor):
    """Per shot 0.5 ||lowpass(seis) - d_filtered||^2 (float64) and the
    residual cotangent lowpass(lowpass(seis) - d_filtered)."""
    r = lowpass(seis, sv.h2, axis=1) - d_filtered
    J = 0.5 * (r.double() ** 2).sum(dim=(1, 2, 3))
    return J, lowpass(r, sv.h2, axis=1)


def value_and_grad(sv: Survey, m, d_filtered: torch.Tensor, segment: int = 64):
    """(J per shot (nb,) float64, the gradient in each of (vp, vs, rho) per
    shot, (nb, nz, nx) each, seismograms (nb, nt, nrec, 2)) of the misfit
    against the low-passed data, in the wide precision."""
    med = sv.medium
    nb, nt = sv.src.shape[0], sv.wavelet.shape[0]
    seis, ckpts = forward(sv, m, every=segment)
    J, ybar = misfit(sv, seis, d_filtered)
    ybar = ybar.to(med.dtype)
    with torch.no_grad():
        leaves = [x.expand((nb,) + x.shape).clone().requires_grad_(True)
                  for x in med.materials(*m)]
    gmats = [torch.zeros_like(x) for x in leaves]
    cot = None
    with no_tf32():
        for t0 in sorted(ckpts, reverse=True):
            t1 = min(t0 + segment, nt)
            with torch.enable_grad():
                start = [x.detach().requires_grad_(True) for x in ckpts.pop(t0)]
                M = med.scaled(leaves)
                state, recs = start, []
                for t in range(t0, t1):
                    state, rec = med.step(state, M, sv.wavelet[t], sv.src, sv.rcv)
                    recs.append(rec)
                outs = state + [torch.stack(recs, dim=1)]
                cots = (cot if cot is not None else [torch.zeros_like(x) for x in state])
                grads = torch.autograd.grad(outs, start + leaves, cots + [ybar[:, t0:t1]])
            cot = list(grads[:STATE])
            for acc, g in zip(gmats, grads[STATE:]):
                acc.add_(g)
        # the configuration's gradient: the staggered cotangents kept on the
        # interior shrunk by r, chained through the averaging
        with torch.enable_grad():
            phys = [f.detach().to(med.wide).expand((nb,) + tuple(f.shape)).clone()
                    .requires_grad_(True) for f in m]
            g = torch.autograd.grad(med.materials(*phys), phys, [med.valid(x) for x in gmats])
    return J, tuple(x.detach() for x in g), seis
