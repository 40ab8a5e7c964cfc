"""Plain torch reference of the marine elastic P-SV survey objective: a
pressure (explosive) source in a water layer under a pressure-release sea
surface, recorded by hydrophones as pressure, the L2 misfit of low-passed
traces and its gradient in (vp, vs, rho).

It imports nothing of the program under test (neither ``tpufwi_torch`` nor
the JAX package) and builds on ``reference_elastic.py``: the same
velocity-stress staggered grid of Virieux (1986), the same order-8
staggered differences, materials and CPML memories, in the same padded
grid; a survey is ``reference_elastic.make_survey`` of a ``MarineMedium``.
What it adds, as the program's contract states it:

- the sea surface on the first physical row fs = pml + r (Levander 1988's
  stress image), with no CPML memory on the top side (its profiles are
  zero above fs). After the velocity update the ghost rows take the even
  image of the velocities, and after the sources the stresses their odd
  image, k = 1..r:

      vx(fs - k) = vx(fs + k)          vz(fs - k) = vz(fs + k - 1)
      szz(fs) = 0;  szz(fs - k) = -szz(fs + k);  sxz(fs - k) = -sxz(fs + k - 1)

  (vz and sxz sit half a cell below their row, so their mirror is the row
  k - 1 below fs);
- the pressure source: dt w_t added to sxx and szz at the source cell,
  after the stress update and before the stress image;
- the pressure record -(sxx + szz) / 2 at the receivers, after the image;
- the fluid layer, which is mu = 0 (vs = 0) in the same equations: its
  stresses are isotropic, sxz stays zero inside it, and the averaged
  mu_xz carries the seabed's shear coupling.

Where it departs from the published schemes, as the program's contract
does:

- Levander (1988) images the stresses alone and updates the velocities
  above the surface from them; here the velocities' ghost rows are set by
  the even image between the two half-steps (the stress image alone grows
  without bound in a half-space at this order), and sxx on the surface row
  is left to the update;
- the rows above the ghost rows are kept and updated with no damping; no
  stencil of a physical cell reaches them;
- Virieux (1986) defines mu at the shear-stress points without saying how
  it is averaged; here it is the arithmetic mean of the four cells, so on
  the seabed it is a quarter or a half of the solid's (harmonic averaging
  would give 0 there);
- the departures of ``reference_elastic.py`` (the CPML profiles at the
  integer cells, memories over the whole grid).

The gradient keeps ``reference_elastic``'s definition: the exact gradient
of this discrete recursion by autograd over segments of ``segment`` steps,
the five staggered cotangents zeroed outside the physical interior shrunk
by r, chained to (vp, vs, rho). mu = rho vs^2, so the vs gradient is
exactly 0 wherever vs is 0: in the water. ``MarineMedium(dtype=)`` runs the
recursion in another precision (the control: bfloat16), as
``reference_elastic.Medium``.
"""

from __future__ import annotations

import torch

from fwibench.reference import lowpass
from fwibench.reference_elastic import STATE, Medium, no_tf32, staggered


class MarineMedium(Medium):
    """``reference_elastic.Medium`` with the sea surface on the first
    physical row, a pressure source and a pressure record."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.fs = self.pad
        # no absorbing layer above the free surface
        self.az, self.bz = (p.clone() for p in (self.az, self.bz))
        self.az[: self.fs] = 0.0
        self.bz[: self.fs] = 0.0

    def image_v(self, vx, vz):
        """The velocities' even image into the r ghost rows above fs."""
        fs, r = self.fs, self.r
        vx = torch.cat([vx[..., : fs - r, :], vx[..., fs + 1 : fs + r + 1, :].flip(-2),
                        vx[..., fs:, :]], dim=-2)
        vz = torch.cat([vz[..., : fs - r, :], vz[..., fs : fs + r, :].flip(-2),
                        vz[..., fs:, :]], dim=-2)
        return vx, vz

    def image_s(self, szz, sxz):
        """szz zero on the surface row; szz and sxz odd into the ghost rows."""
        fs, r = self.fs, self.r
        szz = torch.cat([szz[..., : fs - r, :], -szz[..., fs + 1 : fs + r + 1, :].flip(-2),
                         torch.zeros_like(szz[..., fs : fs + 1, :]), szz[..., fs + 1 :, :]],
                        dim=-2)
        sxz = torch.cat([sxz[..., : fs - r, :], -sxz[..., fs : fs + r, :].flip(-2),
                         sxz[..., fs:, :]], dim=-2)
        return szz, sxz

    def step(self, state, M, w_t, src, rcv):
        """One step from ``state`` (not changed), ``M`` the materials times
        dt as ``Medium.step`` takes them. Returns (the new state, the
        pressure record (nb, nrec))."""
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
        vx, vz = self.image_v(vx + dbx * (e0 + e1), vz + dbz * (e2 + e3))
        exx, m4 = cpml(m[4], ax, bx, staggered(vx, tx, -1, False))
        ezz, m5 = cpml(m[5], az, bz, staggered(vz, tz, -2, False))
        e6, m6 = cpml(m[6], az, bz, staggered(vx, tz, -2, True))
        e7, m7 = cpml(m[7], ax, bx, staggered(vz, tx, -1, True))
        sxx = sxx + (dl2m * exx + dlam * ezz)
        szz = szz + (dl2m * ezz + dlam * exx)
        sxz = sxz + dmxz * (e6 + e7)
        nb = sxx.shape[0]
        amp = (self.dt * w_t).expand(nb, src.shape[1])
        sxx = sxx.reshape(nb, -1).scatter_add(1, src, amp).view_as(sxx)
        szz = szz.reshape(nb, -1).scatter_add(1, src, amp).view_as(szz)
        szz, sxz = self.image_s(szz, sxz)
        rec = -(sxx.reshape(nb, -1).gather(1, rcv) + szz.reshape(nb, -1).gather(1, rcv)) / 2.0
        return [vx, vz, sxx, szz, sxz, m0, m1, m2, m3, m4, m5, m6, m7], rec


def forward(sv, m, every: int = 0):
    """Pressure seismograms (nb, nt, nrec) at ``m`` = (vp, vs, rho), in the
    wide precision; with ``every`` > 0 also the state at every
    ``every``-th step (before the step)."""
    med = sv.medium
    nb, nt = sv.src.shape[0], sv.wavelet.shape[0]
    seis = torch.empty((nb, nt, sv.rcv.shape[1]), dtype=med.wide, device=med.device)
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


def misfit(sv, seis: torch.Tensor, d_filtered: torch.Tensor):
    """Per shot 0.5 ||lowpass(seis) - d_filtered||^2 (float64) and the
    residual cotangent lowpass(lowpass(seis) - d_filtered)."""
    r = lowpass(seis, sv.h2, axis=1) - d_filtered
    J = 0.5 * (r.double() ** 2).sum(dim=(1, 2))
    return J, lowpass(r, sv.h2, axis=1)


def value_and_grad(sv, m, d_filtered: torch.Tensor, segment: int = 64):
    """(J per shot (nb,) float64, the gradient in each of (vp, vs, rho) per
    shot, (nb, nz, nx) each, seismograms (nb, nt, nrec)) of the misfit
    against the low-passed data, in the wide precision:
    ``reference_elastic.value_and_grad`` with the marine step."""
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
        with torch.enable_grad():
            phys = [f.detach().to(med.wide).expand((nb,) + tuple(f.shape)).clone()
                    .requires_grad_(True) for f in m]
            g = torch.autograd.grad(med.materials(*phys), phys, [med.valid(x) for x in gmats])
    return J, tuple(x.detach() for x in g), seis
