"""Acoustic leapfrog + CPML time step in plain torch: the step twin
(counterpart of ``tpufwi/kernels/acoustic2d_jnp.py``).

The exact CPU engine (``adjoint.make_simulator``) and the plain versions of
the CUDA kernels are loops of this step, and the propagator's
``illumination`` runs it on the card. The step is affine in the wavefield
state, which the reverse passes use to transpose it with
``torch.func.vjp``; ``make_reverse_reconstruct_step`` runs the interior
leapfrog backwards for the boundary-saving reverse.

Discrete scheme (kappa = 1 CPML, second-order form):

    per axis d:  phi_d' = b_d phi_d + a_d D1_d(p)
                 v_d    = D2_d(p) + D1_d(phi_d')
                 psi_d' = b_d psi_d + a_d v_d
                 lap   += v_d + psi_d'
    p+ = 2 p - p_prev + (c dt)^2 lap ;  p+[src] += (c dt)^2[src] w[t]
    rec = p+[rcv]
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..grid import D1_COEFFS, D2_COEFFS, Grid
from .stencils import apply_stencil, scaled_taps


class AcousticState(NamedTuple):
    """Leapfrog + CPML state; phi/psi are per-axis memory variables."""

    p_prev: torch.Tensor
    p: torch.Tensor
    phi: Tuple[torch.Tensor, ...]
    psi: Tuple[torch.Tensor, ...]


class AcousticParams(NamedTuple):
    """Step inputs; profile tensors are broadcast-shaped per axis."""

    c2dt2: torch.Tensor  # (c*dt)^2 on the padded grid
    a: Tuple[torch.Tensor, ...]
    b: Tuple[torch.Tensor, ...]
    src_idx: torch.Tensor  # (nsrc, ndim) padded indices
    rcv_idx: torch.Tensor  # (nrec, ndim) padded indices


def zero_state(shape, ndim: int, dtype, device="cpu") -> AcousticState:
    z = torch.zeros(shape, dtype=dtype, device=device)
    return AcousticState(
        p_prev=z, p=z, phi=tuple(z for _ in range(ndim)), psi=tuple(z for _ in range(ndim))
    )


def make_acoustic_step(grid: Grid):
    """``step(state, params, w_t) -> (state', rec)`` for this grid. With
    ``grid.free_surface`` the pressure is pinned to zero on the physical
    surface row after the source is added (a linear constraint)."""
    d1 = [scaled_taps(D1_COEFFS[grid.order], h, 1) for h in grid.h]
    d2 = [scaled_taps(D2_COEFFS[grid.order], h, 2) for h in grid.h]
    ndim = grid.ndim
    fs_row = grid.pad if grid.free_surface else None
    z_axis = 0 if ndim == 2 else 1

    def step(state: AcousticState, params: AcousticParams, w_t):
        p = state.p
        lap = None
        phi_new, psi_new = [], []
        for ax in range(ndim):
            a, b = params.a[ax], params.b[ax]
            ph = b * state.phi[ax] + a * apply_stencil(p, d1[ax], ax)
            v = apply_stencil(p, d2[ax], ax) + apply_stencil(ph, d1[ax], ax)
            ps = b * state.psi[ax] + a * v
            contrib = v + ps
            lap = contrib if lap is None else lap + contrib
            phi_new.append(ph)
            psi_new.append(ps)
        p_next = 2.0 * p - state.p_prev + params.c2dt2 * lap
        src = tuple(params.src_idx[..., d] for d in range(ndim))
        p_next = p_next.index_put(src, params.c2dt2[src] * w_t, accumulate=True)
        if fs_row is not None:
            p_next = p_next.index_fill(
                z_axis, torch.tensor([fs_row], device=p.device), 0.0
            )
        rec = p_next[tuple(params.rcv_idx[..., d] for d in range(ndim))]
        return AcousticState(p, p_next, tuple(phi_new), tuple(psi_new)), rec

    return step


def make_reverse_reconstruct_step(grid: Grid):
    """``recon(p_t, p_tp1, c2dt2, src_idx, w_t) -> p_tm1``: the interior
    leapfrog inverted, ``p[t-1] = 2 p[t] - p[t+1] + (c dt)^2 (Lap p[t] +
    src_t)``. Exact wherever the forward update had no CPML contribution;
    the adjoint engines re-impose the saved boundary rings on the result.
    With ``grid.free_surface`` the surface row is pinned again, as the
    forward pinned it (a source on that row is thereby dropped)."""
    d2 = [scaled_taps(D2_COEFFS[grid.order], h, 2) for h in grid.h]
    ndim = grid.ndim
    fs_row = grid.pad if grid.free_surface else None
    z_axis = 0 if ndim == 2 else 1

    def recon(p_t, p_tp1, c2dt2, src_idx, w_t):
        lap = None
        for ax in range(ndim):
            v = apply_stencil(p_t, d2[ax], ax)
            lap = v if lap is None else lap + v
        p_tm1 = 2.0 * p_t - p_tp1 + c2dt2 * lap
        src = tuple(src_idx[..., d] for d in range(ndim))
        p_tm1 = p_tm1.index_put(src, c2dt2[src] * w_t, accumulate=True)
        if fs_row is not None:
            p_tm1 = p_tm1.index_fill(z_axis, torch.tensor([fs_row], device=p_t.device), 0.0)
        return p_tm1

    return recon
