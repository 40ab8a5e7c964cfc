"""Single-step boundary-saving adjoint engine (``cuda_step``; counterpart of
``tpufwi/adjoint_pallas.py::make_simulator_pallas``).

Same contract and math as ``adjoint.make_simulator``, with every full-grid
operation one of the three single-step kernels
(``kernels/acoustic2d_step.py``), called from a Python loop over steps:

  forward:  fused_forward_step  (leapfrog, CPML, sources, receivers and the
                                 ring row of the post-source field)
  backward: recon_step          (reverse leapfrog, sources, ring imposition,
                                 Lap(p_t)), then
            fused_adjoint_step  (receiver injection, transposed CPML step,
                                 imaging with that Lap(p_t))

in the reference engine's order of operations. The whole-scan engine
``cuda_scanres`` does the same arithmetic in one C call per propagation;
this one pays a Python and ctypes call per kernel and step. ``impl='auto'``
never picks it: it is an explicit engine, as ``impl='pallas'`` is in the
reference. On CPU tensors the same loop runs the kernels' plain versions.
"""

from __future__ import annotations

import torch

from .adjoint_scanres import finish_gradient, profile_source
from .grid import Grid
from .kernels.acoustic2d_scanres import check_args, ring_plan
from .kernels.acoustic2d_step import (
    ADJ_PLANES,
    fused_adjoint_step,
    fused_forward_step,
    recon_step,
)
from .propagators.boundary import RingSpec


def make_simulator_step(grid: Grid, dt: float, f0: float, c_max: float):
    """``simulate(c2dt2, wavelet, src_idx, rcv_idx) -> seis (nt, nrec)``,
    differentiable in ``c2dt2`` and ``wavelet``."""
    if grid.ndim != 2:
        raise ValueError("the single-step engine is 2D")
    profiles_for = profile_source(grid, dt, f0, c_max)
    rings = RingSpec.build(grid)
    NZ, NX = grid.padded_shape
    halo = (NZ + 2 * grid.radius, NX + 2 * grid.radius)

    def run_forward(c2dt2, wavelet, src_idx, rcv_idx, with_tape):
        """(seis, ring tape or None, P_{nt-2}, P_{nt-1}); fields in the
        kernels' halo layout."""
        prof = profiles_for(c2dt2)
        if c2dt2.device.type == "cuda":  # index bounds: one host sync per propagation
            check_args("cuda_step", grid, c2dt2, prof, (wavelet,), src_idx, rcv_idx)
        nt = wavelet.shape[0]
        new = dict(dtype=c2dt2.dtype, device=c2dt2.device)
        fields = torch.zeros((2, *halo), **new)
        cpml = torch.zeros((4, *halo), **new)
        seis = torch.empty((nt, rcv_idx.shape[0]), **new)
        n_ring = ring_plan(grid, c2dt2.device)[0].shape[0]
        tape = torch.empty((nt, n_ring), **new) if with_tape else None
        cur, prev = fields[1], fields[0]
        for t in range(nt):
            fused_forward_step(grid, c2dt2, prof, cur, prev, cpml, wavelet, t, src_idx,
                               rcv_idx, seis, None if tape is None else tape[t])
            cur, prev = prev, cur
        return seis, tape, prev, cur

    class Simulate(torch.autograd.Function):
        @staticmethod
        def forward(ctx, c2dt2, wavelet, src_idx, rcv_idx):
            seis, tape, ppen, plast = run_forward(c2dt2, wavelet, src_idx, rcv_idx, True)
            ctx.save_for_backward(c2dt2, wavelet, src_idx, rcv_idx, tape, ppen, plast)
            return seis

        @staticmethod
        def backward(ctx, seis_bar):
            c2dt2, wavelet, src_idx, rcv_idx, tape, ppen, plast = ctx.saved_tensors
            p_t, p_tp1 = ppen.clone(), plast.clone()  # rewritten in place below
            prof = profiles_for(c2dt2)
            ybar = seis_bar.contiguous()
            nt = wavelet.shape[0]
            new = dict(dtype=c2dt2.dtype, device=c2dt2.device)
            q, q_other = torch.zeros((2, *halo), **new)
            adj = torch.zeros((ADJ_PLANES, *halo), **new)
            lapw = torch.empty((NZ, NX), **new)
            gbar = torch.zeros((NZ, NX), **new)
            lam_src = torch.empty((nt, src_idx.shape[0]), **new)
            chain = torch.empty(2 * rcv_idx.shape[0], dtype=torch.int32, device=c2dt2.device)
            for t in reversed(range(nt)):
                # P_{t-2} over p_tp1 (ring row t-2 imposed, zeros for t < 2)
                # and lapw = Lap(P_{t-1}), then the transposed step
                recon_step(grid, c2dt2, p_t, p_tp1, lapw, wavelet, t, src_idx,
                           tape[t - 2] if t >= 2 else None)
                fused_adjoint_step(grid, c2dt2, prof, q, q_other, adj, lapw, gbar, ybar, t,
                                   src_idx, rcv_idx, lam_src, chain, init_chain=t == nt - 1)
                p_t, p_tp1 = p_tp1, p_t
                q, q_other = q_other, q
            gbar, wbar = finish_gradient(rings, gbar, lam_src, c2dt2, wavelet, src_idx)
            return gbar, wbar, None, None

    def simulate(c2dt2, wavelet, src_idx, rcv_idx):
        c2dt2, wavelet = c2dt2.contiguous(), wavelet.contiguous()
        src_idx, rcv_idx = src_idx.contiguous(), rcv_idx.contiguous()
        if torch.is_grad_enabled() and (c2dt2.requires_grad or wavelet.requires_grad):
            return Simulate.apply(c2dt2, wavelet, src_idx, rcv_idx)
        return run_forward(c2dt2, wavelet, src_idx, rcv_idx, False)[0]

    simulate.rings = rings
    return simulate
