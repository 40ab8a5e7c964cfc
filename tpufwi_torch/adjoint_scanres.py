"""Whole-scan adjoint engines: ``torch.autograd.Function`` around the
scanres kernels (counterpart of ``tpufwi/adjoint_pallas_scanres.py``).

Two tape modes, as in the reference:

- ``tape_mode="snap"`` (``cuda_scansnap``): the forward kernel emits the
  seismogram and the bf16 tape of the D2 laplacian (nt * NZ * NX * 2
  bytes); the reverse kernel images over it with no reconstruction: two
  propagation sweeps per gradient, at the bf16 tape's rounding.
- ``tape_mode="rings"`` (``cuda_scanres``): the forward kernel emits the
  fp32 boundary-ring tape (O(nt * perimeter * radius)) and keeps the last
  two fields; the reverse kernel reconstructs the source field backwards
  while it runs the transposed step: three sweeps, no tape rounding.

The source-cell term, the wavelet cotangent and the valid-region mask are
plain torch. Forward without grad (line-search losses, observed data)
records no tape. Receivers are gathered by index, so there is no
receiver-slab contract and no NaN-poisoning of out-of-slab receivers
(ROADMAP Queue C). Indices are grid-padded. Runs fp32 on CUDA, fp32 or
fp64 on the CPU plain versions.
"""

from __future__ import annotations

import torch

from .grid import Grid
from .kernels.acoustic2d_scanres import (
    scanres_forward,
    scanres_reverse,
    scanres_reverse_snap,
    strip_profiles,
)
from .propagators.boundary import RingSpec


def profile_source(grid: Grid, dt: float, f0: float, c_max: float):
    """``profiles_for(c2)``: the strip profiles as contiguous tensors of
    ``c2``'s dtype and device, made once for each."""
    profiles_np = strip_profiles(grid, dt, c_max, f0)
    cache = {}

    def profiles_for(c2):
        key = (c2.dtype, c2.device)
        if key not in cache:
            cache[key] = tuple(
                torch.as_tensor(p, dtype=c2.dtype, device=c2.device).contiguous()
                for p in profiles_np)
        return cache[key]

    return profiles_for


def finish_gradient(rings: RingSpec, gbar, lam_src, c2dt2, wavelet, src_idx):
    """(model, wavelet) cotangents from the reverse's imaged ``gbar`` and
    lambda at the sources: the source-cell term, then the valid mask."""
    sz, sx = src_idx[:, 0], src_idx[:, 1]
    wbar = (lam_src * c2dt2[sz, sx][None, :]).sum(-1)
    gsrc = (lam_src * wavelet[:, None]).sum(0)
    return rings.mask_valid(gbar.index_put((sz, sx), gsrc, accumulate=True)), wbar


def make_simulator_scanres(grid: Grid, dt: float, f0: float, c_max: float,
                           tape_mode: str = "snap"):
    """``simulate(c2dt2, wavelet, src_idx, rcv_idx) -> seis (nt, nrec)``,
    differentiable in ``c2dt2`` and ``wavelet``."""
    if grid.ndim != 2:
        raise ValueError("the scanres engine is 2D")
    if tape_mode not in ("snap", "rings"):
        raise ValueError(f"unknown tape_mode {tape_mode!r}")
    profiles_for = profile_source(grid, dt, f0, c_max)
    rings = RingSpec.build(grid)

    class Simulate(torch.autograd.Function):
        @staticmethod
        def forward(ctx, c2dt2, wavelet, src_idx, rcv_idx):
            seis, tape, ppen, plast = scanres_forward(
                grid, c2dt2, profiles_for(c2dt2), wavelet, src_idx, rcv_idx, tape=tape_mode)
            if tape_mode == "snap":  # the last fields are not needed
                ppen = plast = None
            ctx.save_for_backward(c2dt2, wavelet, src_idx, rcv_idx, tape, ppen, plast)
            return seis

        @staticmethod
        def backward(ctx, seis_bar):
            c2dt2, wavelet, src_idx, rcv_idx, tape, ppen, plast = ctx.saved_tensors
            prof = profiles_for(c2dt2)
            if tape_mode == "snap":
                gbar, lam_src = scanres_reverse_snap(
                    grid, c2dt2, prof, seis_bar.contiguous(), tape, src_idx, rcv_idx)
            else:
                gbar, lam_src = scanres_reverse(
                    grid, c2dt2, prof, wavelet, seis_bar.contiguous(), tape, ppen, plast,
                    src_idx, rcv_idx)
            gbar, wbar = finish_gradient(rings, gbar, lam_src, c2dt2, wavelet, src_idx)
            return gbar, wbar, None, None

    def simulate(c2dt2, wavelet, src_idx, rcv_idx):
        c2dt2, wavelet = c2dt2.contiguous(), wavelet.contiguous()
        src_idx, rcv_idx = src_idx.contiguous(), rcv_idx.contiguous()
        if torch.is_grad_enabled() and (c2dt2.requires_grad or wavelet.requires_grad):
            return Simulate.apply(c2dt2, wavelet, src_idx, rcv_idx)
        return scanres_forward(
            grid, c2dt2, profiles_for(c2dt2), wavelet, src_idx, rcv_idx, tape=None)[0]

    simulate.rings = rings
    return simulate
