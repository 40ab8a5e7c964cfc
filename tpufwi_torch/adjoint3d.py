"""The fused 3D adjoint engine: ``torch.autograd.Function`` around the 3D
kernels (counterpart of ``tpufwi/adjoint3d_pallas.py``).

    simulate(c2dt2, wavelet, src_idx, rcv_idx) -> seis (nt, nrec)

``c2dt2`` is (c*dt)^2 on the padded (y, z, x) grid, fp32. The forward kernel
emits the seismogram and the boundary-ring tape (fp32, or bf16 with
``tape_dtype=torch.bfloat16``) and keeps the last two fields; the reverse
kernel reconstructs the field backwards while it runs the exact transposed
step and images. The gradient is the exact discrete adjoint masked to the
valid region (``rings.mask_valid``), as the CPU engine's.

Contract changes against the reference, which tiles for the TPU: the tape
row t holds rings(P_t) as ``RingSpec`` cuts them (the reference emits the
block-aligned slabs of rings(P_{t-1})), and the fields live on the padded
grid as it is (no ``extend_yz`` block extension). Sources and receivers on
the free-surface row are pinned away in both (the port pins after
injection, the reference drops them), so the seismogram and gradient are the
reference's. ``simulate.illumination(c2dt2, wavelet, src_idx)`` is the
forward kernel's ``sum_t P_t^2`` on the physical grid.
"""

from __future__ import annotations

import torch

from . import profiling
from .adjoint_scanres import finish_gradient, profile_source
from .grid import Grid
from .kernels.acoustic3d_scan import a3d_forward, a3d_reverse
from .propagators.boundary import RingSpec


def make_simulator3d(grid: Grid, dt: float, f0: float, c_max: float, tape_dtype=None):
    """``simulate(c2dt2, wavelet, src_idx, rcv_idx) -> seis (nt, nrec)``,
    differentiable in ``c2dt2`` and ``wavelet``; ``tape_dtype`` None (the
    field's type: fp32 on the card) or ``torch.bfloat16``."""
    if grid.ndim != 3:
        raise ValueError("make_simulator3d needs a 3D grid")
    if tape_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"tape_dtype must be fp32 or bf16, not {tape_dtype}")
    profiles_for = profile_source(grid, dt, f0, c_max)
    rings = RingSpec.build(grid)

    class Simulate(torch.autograd.Function):
        @staticmethod
        def forward(ctx, c2dt2, wavelet, src_idx, rcv_idx):
            with profiling.span("engine.forward"):
                seis, tape, ppen, plast, _ = a3d_forward(
                    grid, c2dt2, profiles_for(c2dt2), wavelet, src_idx, rcv_idx,
                    tape_dtype=tape_dtype or c2dt2.dtype)
                ctx.save_for_backward(c2dt2, wavelet, src_idx, rcv_idx, tape, ppen, plast)
                return seis

        @staticmethod
        def backward(ctx, seis_bar):
            with profiling.span("engine.reverse"):
                c2dt2, wavelet, src_idx, rcv_idx, tape, ppen, plast = ctx.saved_tensors
                gbar, lam_src = a3d_reverse(grid, c2dt2, profiles_for(c2dt2), wavelet,
                                            seis_bar.contiguous(), tape, ppen, plast, src_idx,
                                            rcv_idx)
                gbar, wbar = finish_gradient(rings, gbar, lam_src, c2dt2, wavelet, src_idx)
                return gbar, wbar, None, None

    def simulate(c2dt2, wavelet, src_idx, rcv_idx):
        c2dt2, wavelet = c2dt2.contiguous(), wavelet.contiguous()
        src_idx, rcv_idx = src_idx.contiguous(), rcv_idx.contiguous()
        if torch.is_grad_enabled() and (c2dt2.requires_grad or wavelet.requires_grad):
            return Simulate.apply(c2dt2, wavelet, src_idx, rcv_idx)
        with profiling.span("engine.forward"):
            return a3d_forward(grid, c2dt2, profiles_for(c2dt2), wavelet, src_idx,
                               rcv_idx)[0]

    @torch.no_grad()
    def illumination(c2dt2, wavelet, src_idx):
        """sum_t P_t^2 on the physical grid, from the forward kernel."""
        c2dt2 = c2dt2.contiguous()
        no_rcv = src_idx.new_zeros((0, 3))
        acc = a3d_forward(grid, c2dt2, profiles_for(c2dt2), wavelet.contiguous(),
                          src_idx.contiguous(), no_rcv, illum=True)[4]
        return acc[grid.interior]

    simulate.rings = rings
    simulate.illumination = illumination
    return simulate
