"""Single-step boundary-saving adjoint engine (``cuda_step``; counterpart of
``tpufwi/adjoint_pallas.py::make_simulator_pallas``).

Same contract and math as ``adjoint.make_simulator``, with every full-grid
operation one of the single-step kernels (``kernels/acoustic2d_step.py``),
called from a Python loop over steps:

  forward:  fused_forward_step  (leapfrog, CPML, sources, receivers and the
                                 ring row of the post-source field)
  backward: recon_step          (reverse leapfrog, sources, ring imposition,
                                 Lap(p_t)), then
            fused_adjoint_step  (receiver injection, transposed CPML step,
                                 imaging with that Lap(p_t))
            or, with ``merged_reverse``, the two in one call:
            fused_reverse_step

in the reference engine's order of operations. The whole-scan engine
``cuda_scanres`` does the same arithmetic in one C call per propagation;
this one pays a Python and ctypes call per kernel and step. ``impl='auto'``
never picks it: it is an explicit engine, as ``impl='pallas'`` is in the
reference, whose single-step engine builds the merged reverse step and
takes the two-call form; so does this one unless asked. On CPU tensors the
same loop runs the kernels' plain versions.

``step_simulator`` is the autograd frame the K-step engine
(``adjoint_kstep.py``) shares: a forward loop and a reverse loop of
in-place kernel calls on the halo-laid state.
"""

from __future__ import annotations

import torch

from .adjoint_scanres import finish_gradient, make_illumination, profile_source
from .grid import Grid
from .kernels.acoustic2d_scanres import check_args, ring_plan
from .kernels.acoustic2d_step import (
    ADJ_PLANES,
    fused_adjoint_step,
    fused_forward_step,
    fused_reverse_step,
    recon_step,
)
from .propagators.boundary import RingSpec


def step_simulator(grid: Grid, dt: float, f0: float, c_max: float, name: str, forward_loop,
                   reverse_loop):
    """``simulate(c2dt2, wavelet, src_idx, rcv_idx) -> seis (nt, nrec)``,
    differentiable in ``c2dt2`` and ``wavelet``, over

      forward_loop(c2dt2, prof, wavelet, src_idx, rcv_idx, cur, prev, cpml,
                   seis, tape) -> (P_{nt-2}, P_{nt-1})
      reverse_loop(c2dt2, prof, wavelet, ybar, src_idx, rcv_idx, p_t, p_tp1,
                   q, q_other, adj, gbar, lam_src, tape, chain)

    on zeroed halo-laid state (``cur`` = P_{-1}, ``prev`` = P_{-2}; ``p_t``
    = P_{nt-2}, ``p_tp1`` = P_{nt-1}); ``tape`` is the (nt, n_ring) ring
    tape, None in a forward without grad. ``name`` labels the index-bound
    check. ``simulate.illumination`` is the whole-scan forward kernel's
    (``adjoint_scanres.make_illumination``): it is forward-only, and the
    engines agree on the forward."""
    if grid.ndim != 2:
        raise ValueError(f"the {name} engine is 2D")
    profiles_for = profile_source(grid, dt, f0, c_max)
    rings = RingSpec.build(grid)
    NZ, NX = grid.padded_shape
    halo = (NZ + 2 * grid.radius, NX + 2 * grid.radius)

    def run_forward(c2dt2, wavelet, src_idx, rcv_idx, with_tape):
        """(seis, ring tape or None, P_{nt-2}, P_{nt-1}); fields in the
        kernels' halo layout."""
        prof = profiles_for(c2dt2)
        if c2dt2.device.type == "cuda":  # index bounds: one host sync per propagation
            check_args(name, grid, c2dt2, prof, (wavelet,), src_idx, rcv_idx)
        nt = wavelet.shape[0]
        new = dict(dtype=c2dt2.dtype, device=c2dt2.device)
        fields = torch.zeros((2, *halo), **new)
        cpml = torch.zeros((4, *halo), **new)
        seis = torch.empty((nt, rcv_idx.shape[0]), **new)
        n_ring = ring_plan(grid, c2dt2.device)[0].shape[0]
        tape = torch.empty((nt, n_ring), **new) if with_tape else None
        ppen, plast = forward_loop(c2dt2, prof, wavelet, src_idx, rcv_idx, fields[1], fields[0],
                                   cpml, seis, tape)
        return seis, tape, ppen, plast

    class Simulate(torch.autograd.Function):
        @staticmethod
        def forward(ctx, c2dt2, wavelet, src_idx, rcv_idx):
            seis, tape, ppen, plast = run_forward(c2dt2, wavelet, src_idx, rcv_idx, True)
            ctx.save_for_backward(c2dt2, wavelet, src_idx, rcv_idx, tape, ppen, plast)
            return seis

        @staticmethod
        def backward(ctx, seis_bar):
            c2dt2, wavelet, src_idx, rcv_idx, tape, ppen, plast = ctx.saved_tensors
            new = dict(dtype=c2dt2.dtype, device=c2dt2.device)
            q, q_other = torch.zeros((2, *halo), **new)
            adj = torch.zeros((ADJ_PLANES, *halo), **new)
            gbar = torch.zeros((NZ, NX), **new)
            lam_src = torch.empty((wavelet.shape[0], src_idx.shape[0]), **new)
            chain = torch.empty(2 * rcv_idx.shape[0], dtype=torch.int32, device=c2dt2.device)
            # P_{nt-2}, P_{nt-1}: rewritten in place by the reconstruction
            reverse_loop(c2dt2, profiles_for(c2dt2), wavelet, seis_bar.contiguous(), src_idx,
                         rcv_idx, ppen.clone(), plast.clone(), q, q_other, adj, gbar, lam_src,
                         tape, chain)
            gbar, wbar = finish_gradient(rings, gbar, lam_src, c2dt2, wavelet, src_idx)
            return gbar, wbar, None, None

    def simulate(c2dt2, wavelet, src_idx, rcv_idx):
        c2dt2, wavelet = c2dt2.contiguous(), wavelet.contiguous()
        src_idx, rcv_idx = src_idx.contiguous(), rcv_idx.contiguous()
        if torch.is_grad_enabled() and (c2dt2.requires_grad or wavelet.requires_grad):
            return Simulate.apply(c2dt2, wavelet, src_idx, rcv_idx)
        return run_forward(c2dt2, wavelet, src_idx, rcv_idx, False)[0]

    simulate.rings = rings
    simulate.illumination = make_illumination(grid, profiles_for)
    return simulate


def make_simulator_step(grid: Grid, dt: float, f0: float, c_max: float,
                        merged_reverse: bool = False):
    """``simulate(c2dt2, wavelet, src_idx, rcv_idx) -> seis (nt, nrec)``,
    differentiable in ``c2dt2`` and ``wavelet``; ``merged_reverse`` takes
    one ``fused_reverse_step`` call per reverse step in place of
    ``recon_step`` and ``fused_adjoint_step``. The two-call form stays the
    default: the merged step is held against it, and it is the one path
    that runs those two kernels."""

    def forward_loop(c2dt2, prof, wavelet, src_idx, rcv_idx, cur, prev, cpml, seis, tape):
        for t in range(wavelet.shape[0]):
            fused_forward_step(grid, c2dt2, prof, cur, prev, cpml, wavelet, t, src_idx, rcv_idx,
                               seis, None if tape is None else tape[t])
            cur, prev = prev, cur
        return prev, cur

    def reverse_loop(c2dt2, prof, wavelet, ybar, src_idx, rcv_idx, p_t, p_tp1, q, q_other, adj,
                     gbar, lam_src, tape, chain):
        nt = wavelet.shape[0]
        lapw = None if merged_reverse else torch.empty_like(gbar)
        for t in reversed(range(nt)):
            # P_{t-2} over p_tp1 (ring row t-2 imposed, zeros for t < 2)
            # and Lap(P_{t-1}), then the transposed step imaging with it
            row = tape[t - 2] if t >= 2 else None
            if merged_reverse:
                fused_reverse_step(grid, c2dt2, prof, p_t, p_tp1, q, q_other, adj, gbar,
                                   wavelet, ybar, t, src_idx, rcv_idx, lam_src, row, chain,
                                   init_chain=t == nt - 1)
            else:
                recon_step(grid, c2dt2, p_t, p_tp1, lapw, wavelet, t, src_idx, row)
                fused_adjoint_step(grid, c2dt2, prof, q, q_other, adj, lapw, gbar, ybar, t,
                                   src_idx, rcv_idx, lam_src, chain, init_chain=t == nt - 1)
            p_t, p_tp1 = p_tp1, p_t
            q, q_other = q_other, q

    return step_simulator(grid, dt, f0, c_max, "cuda_step", forward_loop, reverse_loop)
