"""Plain torch reference of the acoustic survey objective: the forward
modelling, the L2 misfit of low-passed traces and its gradient in vp.

It imports nothing of the program under test. It follows the published
scheme the configurations state (second-order-in-time leapfrog, centred
order-8 space derivatives, the CPML of Komatitsch & Martin 2007 in its
second-order form, kappa = 1), written from the equations:

    per axis d:  phi_d' = b_d phi_d + a_d D1_d(p)
                 v_d    = D2_d(p) + D1_d(phi_d')
                 psi_d' = b_d psi_d + a_d v_d
    L   = sum_d (v_d + psi_d')
    p+  = 2 p - p_prev + C L ;  p+[src] += C[src] w_t ;  rec_t = p+[rcv]

with C = (vp dt)^2 on the grid padded by pml + r cells a side (edge
values), zero outside it. The memory variables live on slabs of width
pml + 2r at each end of their axis, around the cells where the profiles
are not zero.

The gradient is the exact transpose of that recursion, written out by hand
(D1 has antisymmetric taps, so its transpose is -D1; D2's is D2), run
backwards over segments that are recomputed from checkpoints of the state,
so memory is O(nt / K + K) fields. It images with the D2-only laplacian of
the field each step starts from, kept in the configuration's tape
precision, and is zero outside the interior shrunk by r, as the
configurations define it. ``Medium(dtype=)`` runs the whole recursion in
another precision (the control: bfloat16).

Every tensor carries a leading shot axis; the shots of one call share the
model.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

# centred finite-difference weights (Fornberg 1988), full symmetric taps
D2_COEFFS = {
    2: (1.0, -2.0, 1.0),
    4: (-1.0 / 12, 4.0 / 3, -5.0 / 2, 4.0 / 3, -1.0 / 12),
    8: (-1.0 / 560, 8.0 / 315, -1.0 / 5, 8.0 / 5, -205.0 / 72, 8.0 / 5, -1.0 / 5, 8.0 / 315,
        -1.0 / 560),
}
D1_COEFFS = {
    2: (-0.5, 0.0, 0.5),
    4: (1.0 / 12, -2.0 / 3, 0.0, 2.0 / 3, -1.0 / 12),
    8: (1.0 / 280, -4.0 / 105, 1.0 / 5, -4.0 / 5, 0.0, 4.0 / 5, -1.0 / 5, 4.0 / 105,
        -1.0 / 280),
}


def cfl_dt(h, c_max: float, order: int, safety: float) -> float:
    """The leapfrog's stable step, 2 / (c_max sqrt(S sum 1/h^2)) with S the
    sum of |D2 weights|, times ``safety``."""
    s = sum(abs(c) for c in D2_COEFFS[order])
    return float(safety * 2.0 / (c_max * math.sqrt(s * sum(1.0 / float(x) ** 2 for x in h))))


def ricker(f0: float, dt: float, nt: int) -> np.ndarray:
    """(1 - 2 (pi f0 tau)^2) exp(-(pi f0 tau)^2), tau = t - 1.5 / f0."""
    t = np.arange(nt) * dt - 1.5 / f0
    arg = (np.pi * f0 * t) ** 2
    return (1.0 - 2.0 * arg) * np.exp(-arg)


def cpml_ab(n: int, pml: int, r: int, h: float, dt: float, c_max: float, f0: float,
            p: float = 2.0, r0: float = 1e-6):
    """CPML (a, b) along one padded axis of physical size n (float64):
    d = d0 (l/L)^p, d0 = -(p+1) c_max ln(R0) / (2L), alpha = pi f0 (1 - l/L),
    b = exp(-(d + alpha) dt), a = d (b - 1) / (d + alpha); zero where l = 0."""
    n_pad = n + 2 * (pml + r)
    L = pml * h
    d0 = -(p + 1.0) * c_max * np.log(r0) / (2.0 * L)
    idx = np.arange(n_pad, dtype=np.float64)
    lo, hi = pml + r, pml + r + n - 1
    depth = np.where(idx < lo, np.clip((lo - idx) * h, 0.0, L), 0.0)
    depth = np.where(idx > hi, np.clip((idx - hi) * h, 0.0, L), depth)
    x = depth / L
    d = d0 * x**p
    alpha = np.pi * f0 * (1.0 - x)
    b = np.exp(-(d + alpha) * dt)
    denom = d + alpha
    a = np.where(denom > 0.0, d * (b - 1.0) / np.where(denom > 0, denom, 1.0), 0.0)
    inside = x > 0.0
    return np.where(inside, a, 0.0), np.where(inside, b, 0.0)


def lowpass_response(nt: int, dt: float, fmax: float, order: int = 6) -> np.ndarray:
    """|H(f)|^2 of an order-6 Butterworth low-pass at the rfft frequencies
    of the 2 nt zero-padded trace."""
    f = np.fft.rfftfreq(2 * nt, float(dt))
    return 1.0 / (1.0 + (f / float(fmax)) ** (2 * order))


def lowpass(x: torch.Tensor, h2: torch.Tensor, axis: int) -> torch.Tensor:
    """Zero-phase filter as a linear convolution (2x zero padding) along
    ``axis``; its own transpose."""
    nt = x.shape[axis]
    shape = [1] * x.ndim
    shape[axis] = h2.shape[0]
    X = torch.fft.rfft(x, n=2 * nt, dim=axis) * h2.reshape(shape)
    return torch.fft.irfft(X, n=2 * nt, dim=axis).to(x.dtype).narrow(axis, 0, nt)


def shift_add(out, f, axis: int, o: int, c: float) -> None:
    """out[i] += c f[i + o] along ``axis``, f zero outside."""
    n = f.shape[axis]
    if o >= 0:
        out.narrow(axis, 0, n - o).add_(f.narrow(axis, o, n - o), alpha=c)
    else:
        out.narrow(axis, -o, n + o).add_(f.narrow(axis, 0, n + o), alpha=c)


def d2(f, taps, axis: int, out=None):
    """sum_k taps[k] f[i + k - r] along ``axis`` (symmetric taps), added
    into ``out`` when given."""
    r = len(taps) // 2
    if out is None:
        out = f * taps[r]
    else:
        out.add_(f, alpha=taps[r])
    for k in range(1, r + 1):
        shift_add(out, f, axis, k, taps[r + k])
        shift_add(out, f, axis, -k, taps[r - k])
    return out


def d1(f, taps, axis: int, sign: float = 1.0):
    """sign * sum_k taps[k] f[i + k - r] along ``axis`` (antisymmetric taps:
    sign -1 is the transpose)."""
    r = len(taps) // 2
    out = torch.zeros_like(f)
    for k in range(1, r + 1):
        shift_add(out, f, axis, k, sign * taps[r + k])
        shift_add(out, f, axis, -k, sign * taps[r - k])
    return out


class Slab(NamedTuple):
    """One axis's two CPML slabs, the low and the high end side by side:
    no cell of either strip reaches across the join with its stencils."""

    axis: int  # tensor axis (the shot axis is 0)
    width: int  # of each end
    a: torch.Tensor  # broadcast along the axis, 2 * width long
    b: torch.Tensor

    def take(self, f):
        n = f.shape[self.axis]
        return torch.cat([f.narrow(self.axis, 0, self.width),
                          f.narrow(self.axis, n - self.width, self.width)], dim=self.axis)

    def add_into(self, f, slab):
        n, w = f.shape[self.axis], self.width
        f.narrow(self.axis, 0, w).add_(slab.narrow(self.axis, 0, w))
        f.narrow(self.axis, n - w, w).add_(slab.narrow(self.axis, w, w))


class Medium:
    """One survey's discretisation on a device: the padded shape, the
    scaled taps, the CPML slabs; ``dtype`` the fields' precision."""

    def __init__(self, shape, h, pml: int, order: int, dt: float, c_max: float, f0: float,
                 dtype=torch.float32, device="cpu"):
        self.shape = tuple(int(s) for s in shape)
        self.ndim = len(self.shape)
        self.r = order // 2
        self.pad = pml + self.r
        self.padded = tuple(s + 2 * self.pad for s in self.shape)
        self.dt, self.dtype, self.device = float(dt), dtype, torch.device(device)
        self.t2 = [tuple(c / float(hd) ** 2 for c in D2_COEFFS[order]) for hd in h]
        self.t1 = [tuple(c / float(hd) for c in D1_COEFFS[order]) for hd in h]
        width = pml + 2 * self.r
        self.slabs = []
        for d, n in enumerate(self.shape):
            view = [1] * (self.ndim + 1)
            view[d + 1] = 2 * width

            def on(v):
                v = np.concatenate([v[:width], v[len(v) - width:]])
                return torch.as_tensor(v, dtype=torch.float32,
                                       device=self.device).to(dtype).reshape(view)

            a, b = cpml_ab(n, pml, self.r, float(h[d]), dt, c_max, f0)
            self.slabs.append(Slab(d + 1, width, on(a), on(b)))

    def c2dt2(self, vp: torch.Tensor) -> torch.Tensor:
        """(vp dt)^2 on the padded grid (edge values), fp32 from ``vp``."""
        lead = (None,) * (self.ndim - 1)  # replicate padding wants leading dims
        padded = torch.nn.functional.pad(vp.to(torch.float32)[lead],
                                         (self.pad,) * (2 * self.ndim), mode="replicate")
        padded = padded[(0,) * len(lead)]
        return (padded * self.dt) ** 2

    def zero_state(self, nb: int):
        def z(shape):
            return torch.zeros((nb,) + shape, dtype=self.dtype, device=self.device)

        mem = []
        for s in self.slabs:
            sh = list(self.padded)
            sh[s.axis - 1] = 2 * s.width
            mem.append(z(tuple(sh)))
        return [z(self.padded), z(self.padded), mem, [torch.zeros_like(m) for m in mem]]

    def laplacian(self, p):
        """The D2-only laplacian over every axis."""
        out = None
        for d in range(self.ndim):
            out = d2(p, self.t2[d], d + 1, out)
        return out

    def step(self, state, C, w_t, src, rcv, image_dtype=None):
        """One step in place of ``state`` = [p_prev, p, phi, psi]; returns
        (rec (nb, nrec), the D2 laplacian of the field the step started
        from in ``image_dtype``, or None)."""
        q, p, phi, psi = state
        L = self.laplacian(p)
        image = None if image_dtype is None else L.to(image_dtype, copy=True)
        for i, s in enumerate(self.slabs):
            P = s.take(p)
            ph = s.b * phi[i] + s.a * d1(P, self.t1[s.axis - 1], s.axis)
            dph = d1(ph, self.t1[s.axis - 1], s.axis)
            v = d2(P, self.t2[s.axis - 1], s.axis) + dph
            ps = s.b * psi[i] + s.a * v
            s.add_into(L, dph + ps)
            phi[i], psi[i] = ph, ps
        p_next = 2.0 * p - q + C * L
        flat = p_next.view(p_next.shape[0], -1)
        Cf = C.reshape(-1)
        flat.scatter_add_(1, src, Cf[src] * w_t)
        state[0], state[1] = p, p_next
        return flat.gather(1, rcv), image

    def step_transpose(self, cot, C, ybar_t, rcv):
        """The transposed step in place of ``cot`` = cotangents of the state
        after the step [A (p_prev slot), B (p slot), phi, psi], given the
        residual row; returns lambda, the cotangent of p+."""
        A, B, phib, psib = cot
        lam = B.clone()
        lam.view(lam.shape[0], -1).scatter_add_(1, rcv, ybar_t)
        Lb = C * lam
        pb = self.laplacian(Lb)
        pb.add_(lam, alpha=2.0).add_(A)
        for i, s in enumerate(self.slabs):
            ax, t1 = s.axis, self.t1[s.axis - 1]
            Ls = s.take(Lb)
            psb = Ls + psib[i]
            ub = s.a * psb
            phb = phib[i] + d1(Ls + ub, t1, ax, sign=-1.0)
            slab = d2(ub, self.t2[ax - 1], ax)
            slab.add_(d1(s.a * phb, t1, ax, sign=-1.0))
            s.add_into(pb, slab)
            phib[i], psib[i] = s.b * phb, s.b * psb
        cot[0], cot[1] = -lam, pb
        return lam

    def valid(self, g):
        """``g`` (nb, *shape) zeroed outside the interior shrunk by r."""
        out = torch.zeros_like(g)
        sl = (slice(None),) + tuple(slice(self.r, n - self.r) for n in self.shape)
        out[sl] = g[sl]
        return out


def flat_index(idx: np.ndarray, padded, pad: int, device) -> torch.Tensor:
    """(nb, n, ndim) physical cells -> (nb, n) flat padded indices."""
    idx = np.asarray(idx, np.int64) + pad
    strides = np.cumprod((1,) + tuple(padded[::-1]))[:-1][::-1]
    return torch.as_tensor((idx * strides).sum(-1), device=device)


class Survey(NamedTuple):
    """Shots that share a model: their sources (nb, nsrc) and receivers
    (nb, nrec) as flat indices of the padded grid, the wavelet (nt,) and
    the low-pass response."""

    medium: Medium
    src: torch.Tensor
    rcv: torch.Tensor
    wavelet: torch.Tensor  # fp32
    h2: torch.Tensor  # fp32 low-pass response (nt + 1,)


def make_survey(medium: Medium, src, rcv, wavelet, h2) -> Survey:
    """From physical cells: sources (nb, nsrc, ndim), receivers (nb, nrec,
    ndim)."""
    dev = medium.device
    return Survey(medium, flat_index(src, medium.padded, medium.pad, dev),
                  flat_index(rcv, medium.padded, medium.pad, dev),
                  torch.as_tensor(wavelet, dtype=torch.float32, device=dev),
                  torch.as_tensor(h2, dtype=torch.float32, device=dev))


def forward(sv: Survey, vp: torch.Tensor, every: int = 0):
    """Seismograms (nb, nt, nrec) fp32 at ``vp``; with ``every`` > 0 also
    the state at every ``every``-th step (checkpoints, before the step)."""
    m = sv.medium
    C = m.c2dt2(vp).to(m.dtype)
    nb = sv.src.shape[0]
    state = m.zero_state(nb)
    w = sv.wavelet.to(m.dtype)
    nt = w.shape[0]
    seis = torch.empty((nb, nt, sv.rcv.shape[1]), dtype=torch.float32, device=m.device)
    ckpts = {}
    with torch.no_grad():
        for t in range(nt):
            if every and t % every == 0:
                ckpts[t] = [state[0].clone(), state[1].clone(), [x.clone() for x in state[2]],
                            [x.clone() for x in state[3]]]
            rec, _ = m.step(state, C, w[t], sv.src, sv.rcv)
            seis[:, t] = rec.float()
    return seis, ckpts


def misfit(sv: Survey, seis: torch.Tensor, d_filtered: torch.Tensor):
    """Per shot 0.5 ||lowpass(seis) - d_filtered||^2 (float64) and the
    residual cotangent lowpass(lowpass(seis) - d_filtered) (fp32)."""
    r = lowpass(seis, sv.h2, axis=1) - d_filtered
    J = 0.5 * (r.double() ** 2).sum(dim=(1, 2))
    return J, lowpass(r, sv.h2, axis=1)


def value_and_grad(sv: Survey, vp: torch.Tensor, d_filtered: torch.Tensor,
                   tape_dtype=torch.float32, segment: int = 64):
    """(J per shot (nb,) float64, gradient in vp per shot (nb, *shape) fp32,
    seismograms (nb, nt, nrec)) of the misfit against the low-passed data."""
    m = sv.medium
    seis, ckpts = forward(sv, vp, every=segment)
    J, ybar = misfit(sv, seis, d_filtered)
    C = m.c2dt2(vp).to(m.dtype)
    w = sv.wavelet.to(m.dtype)
    nt, nb = w.shape[0], sv.src.shape[0]
    ybar = ybar.to(m.dtype)
    cot = m.zero_state(nb)
    gC = torch.zeros((nb,) + m.padded, dtype=torch.float32, device=m.device)
    lam_src = torch.zeros((nb, nt, sv.src.shape[1]), dtype=torch.float32, device=m.device)
    with torch.no_grad():
        for t0 in sorted(ckpts, reverse=True):
            t1 = min(t0 + segment, nt)
            state = ckpts.pop(t0)
            images = []
            for t in range(t0, t1):
                images.append(m.step(state, C, w[t], sv.src, sv.rcv, image_dtype=tape_dtype)[1])
            del state
            for t in reversed(range(t0, t1)):
                lam = m.step_transpose(cot, C, ybar[:, t], sv.rcv)
                gC.add_(lam.float() * images.pop().float())
                lam_src[:, t] = lam.view(nb, -1).gather(1, sv.src).float()
    # the source term: p+[src] += C[src] w_t
    gsrc = (lam_src * sv.wavelet[None, :, None]).sum(1)
    gC.view(nb, -1).scatter_add_(1, sv.src, gsrc)
    interior = (slice(None),) + tuple(slice(m.pad, m.pad + n) for n in m.shape)
    vp32 = vp.to(torch.float32)
    g = m.valid(gC[interior] * (2.0 * m.dt * m.dt) * vp32)
    return J, g, seis
