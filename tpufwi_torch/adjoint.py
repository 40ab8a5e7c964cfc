"""Adjoint-state gradient engine: the exact discrete adjoint with
boundary-saving wavefield reconstruction (counterpart of
``tpufwi/adjoint.py::make_simulator``, the constant-density acoustic part).

The acoustic step is affine in the wavefield state (p, phi, psi) for a
fixed model, so ``torch.func.vjp`` of the step at any state gives the exact
transposed step, with the CPML recursion transposed too. The primal field
enters the reverse pass only through the imaging term of the model
cotangent, and it is recovered by reverse time-stepping of the lossless
interior leapfrog while the saved boundary rings are re-imposed every step:
memory O(nt * perimeter * radius) for the tape, no full-wavefield
checkpoints.

The gradient is the exact discrete transpose on the interior shrunk by one
stencil radius and zero on the outermost radius-wide frame
(``propagators/boundary.py``). This is the port's exact engine on the CPU
(``impl="eager"``), fp32 or fp64, and the ground truth of the CUDA engines'
tests.
"""

from __future__ import annotations

import numpy as np
import torch

from .cpml import build_profiles
from .grid import Grid
from .kernels.acoustic2d_eager import (
    AcousticParams,
    AcousticState,
    make_acoustic_step,
    make_reverse_reconstruct_step,
    zero_state,
)
from .propagators.boundary import RingSpec


def make_simulator(grid: Grid, dt: float, f0: float, c_max: float,
                   gradient: str = "rings", tape_dtype=None):
    """``simulate(c2dt2, wavelet, src_idx, rcv_idx) -> seis (nt, nrec)``,
    differentiable in ``c2dt2`` (the padded (c*dt)^2 field) and ``wavelet``.

    ``gradient``: "rings" (default), the boundary-saving reverse described
    above; "full", plain autograd through the time loop (O(nt * grid)
    memory: the ground truth on tiny problems). ``tape_dtype`` (rings only,
    e.g. ``torch.bfloat16``) stores the ring tape compressed.
    ``simulate.rings`` is the ``RingSpec`` of the tape."""
    if gradient == "remat":
        raise NotImplementedError(
            'gradient="remat" (checkpointed scan, propagators/remat.py) is not '
            "ported yet (reference: tpufwi/propagators/remat.py)")
    if gradient not in ("rings", "full"):
        raise ValueError(f"unknown gradient mode {gradient!r}")
    profs = build_profiles(grid, dt, c_max, f0, dtype=np.float64)
    step = make_acoustic_step(grid)
    recon = make_reverse_reconstruct_step(grid)
    rings = RingSpec.build(grid, tape_dtype=tape_dtype)
    ndim = grid.ndim
    shape = grid.padded_shape
    profile_cache = {}

    def _params(c2dt2, src_idx, rcv_idx):
        key = (c2dt2.dtype, c2dt2.device)
        if key not in profile_cache:
            profile_cache[key] = tuple(
                tuple(torch.as_tensor(p[i], dtype=c2dt2.dtype, device=c2dt2.device)
                      for p in profs) for i in (0, 1))
        a, b = profile_cache[key]
        return AcousticParams(c2dt2=c2dt2, a=a, b=b, src_idx=src_idx, rcv_idx=rcv_idx)

    def run_forward(c2dt2, wavelet, src_idx, rcv_idx, with_tape):
        params = _params(c2dt2, src_idx, rcv_idx)
        s = zero_state(shape, ndim, c2dt2.dtype, c2dt2.device)
        seis, tape = [], []
        for t in range(wavelet.shape[0]):
            s, rec = step(s, params, wavelet[t])
            seis.append(rec)
            if with_tape:
                tape.append(rings.extract(s.p))
        return torch.stack(seis), tape, s

    def simulate_plain(c2dt2, wavelet, src_idx, rcv_idx):
        return run_forward(c2dt2, wavelet, src_idx, rcv_idx, False)[0]

    if gradient == "full":
        simulate_plain.rings = rings
        return simulate_plain

    class Simulate(torch.autograd.Function):
        @staticmethod
        def forward(ctx, c2dt2, wavelet, src_idx, rcv_idx):
            seis, tape, final = run_forward(c2dt2, wavelet, src_idx, rcv_idx, True)
            # tape[k] holds rings(p after step k), slab by slab
            slabs = tuple(torch.stack(col) for col in zip(*tape))
            ctx.save_for_backward(c2dt2, wavelet, src_idx, rcv_idx, final.p_prev, final.p,
                                  *slabs)
            return seis

        @staticmethod
        def backward(ctx, seis_bar):
            c2dt2, wavelet, src_idx, rcv_idx, p_t, p_tp1, *slabs = ctx.saved_tensors
            dtype, dev = c2dt2.dtype, c2dt2.device
            no_ring = rings.zeros_like_rings(shape, dtype, dev)
            z = torch.zeros(shape, dtype=dtype, device=dev)
            zeros = tuple(z for _ in range(ndim))

            def step_sc(s, c2, w_t):
                return step(s, _params(c2, src_idx, rcv_idx), w_t)

            sbar = zero_state(shape, ndim, dtype, dev)
            c2bar = torch.zeros_like(c2dt2)
            wbar = torch.empty_like(wavelet)
            for t in reversed(range(wavelet.shape[0])):
                # 1. reconstruct p_{t-1} and re-impose rings(p_{t-1}) =
                #    tape[t-2] (zeros for t < 2)
                p_tm1 = recon(p_t, p_tp1, c2dt2, src_idx, wavelet[t])
                p_tm1 = rings.impose(
                    p_tm1, tuple(T[t - 2] for T in slabs) if t >= 2 else no_ring)
                # 2. exact transposed step: vjp of the affine forward step
                s_primal = AcousticState(p_prev=p_tm1, p=p_t, phi=zeros, psi=zeros)
                _, pullback = torch.func.vjp(step_sc, s_primal, c2dt2, wavelet[t])
                sbar, c2_inc, w_inc = pullback((sbar, seis_bar[t]))
                c2bar += c2_inc
                wbar[t] = w_inc
                p_t, p_tp1 = p_tm1, p_t
            # the gradient is exact (and defined) only on the valid region
            return rings.mask_valid(c2bar), wbar, None, None

    def simulate(c2dt2, wavelet, src_idx, rcv_idx):
        if torch.is_grad_enabled() and (c2dt2.requires_grad or wavelet.requires_grad):
            return Simulate.apply(c2dt2, wavelet, src_idx, rcv_idx)
        return simulate_plain(c2dt2, wavelet, src_idx, rcv_idx)

    simulate.rings = rings
    return simulate
