"""Snapshot adjoint engine: ``torch.autograd.Function`` around the two
scanres kernels (counterpart of ``tpufwi/adjoint_pallas_scanres.py``,
``tape_mode="snap"``).

Forward with grad: the forward kernel emits the seismogram and the bf16
tape of the D2 laplacian (nt * NZ * NX * 2 bytes). Backward: the reverse
kernel images the gradient over that tape with no reconstruction sweep;
the source-cell term, the wavelet cotangent and the valid-region mask are
plain torch. Forward without grad (line-search losses, observed data)
records no tape.

Receivers are gathered by index, so there is no receiver-slab contract and
no NaN-poisoning of out-of-slab receivers (ROADMAP Queue C). Indices are
grid-padded. Runs fp32 on CUDA, fp32 or fp64 on the CPU plain versions.
"""

from __future__ import annotations

import torch

from .grid import Grid
from .kernels.acoustic2d_scanres import scanres_forward, scanres_reverse_snap, strip_profiles
from .propagators.boundary import RingSpec


def make_simulator_scanres(grid: Grid, dt: float, f0: float, c_max: float):
    """``simulate(c2dt2, wavelet, src_idx, rcv_idx) -> seis (nt, nrec)``,
    differentiable in ``c2dt2`` and ``wavelet``."""
    if grid.ndim != 2:
        raise ValueError("the scanres engine is 2D")
    profiles_np = strip_profiles(grid, dt, c_max, f0)
    rings = RingSpec.build(grid)
    profile_cache = {}

    def profiles_for(c2):
        key = (c2.dtype, c2.device)
        if key not in profile_cache:
            profile_cache[key] = tuple(
                torch.as_tensor(p, dtype=c2.dtype, device=c2.device).contiguous()
                for p in profiles_np
            )
        return profile_cache[key]

    class Simulate(torch.autograd.Function):
        @staticmethod
        def forward(ctx, c2dt2, wavelet, src_idx, rcv_idx):
            seis, tape, _, _ = scanres_forward(
                grid, c2dt2, profiles_for(c2dt2), wavelet, src_idx, rcv_idx, with_tape=True
            )
            ctx.save_for_backward(c2dt2, wavelet, src_idx, rcv_idx, tape)
            return seis

        @staticmethod
        def backward(ctx, seis_bar):
            c2dt2, wavelet, src_idx, rcv_idx, tape = ctx.saved_tensors
            gbar, lam_src = scanres_reverse_snap(
                grid, c2dt2, profiles_for(c2dt2), seis_bar.contiguous(), tape,
                src_idx, rcv_idx,
            )
            sz, sx = src_idx[:, 0], src_idx[:, 1]
            wbar = (lam_src * c2dt2[sz, sx][None, :]).sum(-1)
            gsrc = (lam_src * wavelet[:, None]).sum(0)
            gbar = rings.mask_valid(gbar.index_put((sz, sx), gsrc, accumulate=True))
            return gbar, wbar, None, None

    def simulate(c2dt2, wavelet, src_idx, rcv_idx):
        c2dt2, wavelet = c2dt2.contiguous(), wavelet.contiguous()
        src_idx, rcv_idx = src_idx.contiguous(), rcv_idx.contiguous()
        if torch.is_grad_enabled() and (c2dt2.requires_grad or wavelet.requires_grad):
            return Simulate.apply(c2dt2, wavelet, src_idx, rcv_idx)
        return scanres_forward(
            grid, c2dt2, profiles_for(c2dt2), wavelet, src_idx, rcv_idx, with_tape=False
        )[0]

    return simulate
