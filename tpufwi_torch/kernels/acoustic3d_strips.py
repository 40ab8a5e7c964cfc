"""The six-face CPML strip update of the per-step 3D forward: its CUDA
wrapper, plain torch version and launch counter, and the fused step
(counterpart of ``tpufwi/kernels/acoustic3d_strips_pallas.py``).

``strip3d(grid, p, p_next, strips, prof, c2)`` updates, for each axis d in
the reference's order y, z, x, both faces' absorbing strips (depth S = pml +
R) in place:

    phi' = b phi + a D1_d p
    corr = D1_d phi'                 (phi' zero outside the strips), over the
                                     strips and R cells inward
    psi' = b psi + a (D2_d p + corr) on the strips
    p_next += c2 corr ; p_next += c2 psi'

which is TPU kernels ``make_strip3d_y``, ``make_strip3d_z`` and
``make_strip3d_x`` (one per axis and face there) in one entry point. Their
band matrices (``_band``, ``_taps_axis``) are the TPU's MXU layout and have
no counterpart: the derivatives are gathers in fp32 FMA on the card and
shifted sums (``stencils.apply_stencil``) in the plain version, never a
matmul or conv (TF32). The CUDA source is ``csrc/acoustic3d_step.cu``
(``tpufwi_strip3d``, in the 3D library of ``kernels/acoustic3d_scan.py``).

State layout. ``strips`` is one flat fp32 tensor: phi then psi, each the
three axes' strip arrays y, z, x, each holding 2S cells along its axis (low
face, then high) by the padded grid's extent on the other two: the
whole-scan engine's packed layout (``csrc/acoustic3d_kernels.cuh``), where
the reference keeps four separate slabs per axis on its block-extended
arrays (``interop.strips3d_from_reference`` converts). ``prof`` is the
six ``strip_profiles`` packed as ``acoustic3d_scan.packed_profiles`` packs
them (``strip_prof_source``).

``make_acoustic3d_fused_step`` is the reference's fused step: the leapfrog
(``acoustic3d_step.leapfrog3d``) then ``strip3d``. The wrapper takes its
plain version for CPU tensors only, and counts one launch per call on
CUDA (a call is four ordered kernel launches).
"""

from __future__ import annotations

import numpy as np
import torch

from ..grid import D1_COEFFS, D2_COEFFS, Grid
from .acoustic2d_scanres import raise_on, require_cuda, strip_depth, strip_profiles
from .acoustic3d_scan import LIBRARY, strip_cells, taps_arg
from .acoustic3d_step import check_fields3d, leapfrog3d
from .stencils import apply_stencil, scaled_taps


def strip_views(grid: Grid, strips):
    """(phi, psi) of the packed ``strips``, each a triple of views: y (2S,
    NZ, NX), z (NY, 2S, NX), x (NY, NZ, 2S); the low face's S cells along
    the axis, then the high face's."""
    NY, NZ, NX = grid.padded_shape
    S2 = 2 * strip_depth(grid)
    shapes = ((S2, NZ, NX), (NY, S2, NX), (NY, NZ, S2))
    out, off = [], 0
    for _ in range(2):
        views = []
        for shape in shapes:
            n = shape[0] * shape[1] * shape[2]
            views.append(strips[off:off + n].view(shape))
            off += n
        out.append(tuple(views))
    return tuple(out)


def zero_strip_state(grid: Grid, device="cuda"):
    """(p_prev, p, strips) all zero, fp32, on ``device``."""
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)  # noqa: E731
    return z(*grid.padded_shape), z(*grid.padded_shape), z(2 * strip_cells(grid))


def strip_prof_source(grid: Grid, dt: float, f0: float, c_max: float):
    """``prof_for(c2)``: the packed strip profiles on ``c2``'s device, made
    once for each. The reference's per-step 3D steps have no free surface,
    and neither have these."""
    if grid.ndim != 3:
        raise ValueError("the strip steps need a 3D grid")
    if grid.free_surface:
        raise ValueError("the per-step 3D steps have no free surface, as the reference's")
    prof = np.concatenate([a.reshape(-1) for a in strip_profiles(grid, dt, c_max, f0)])
    cache = {}

    def prof_for(c2):
        if c2.device not in cache:
            cache[c2.device] = torch.as_tensor(prof, dtype=torch.float32, device=c2.device)
        return cache[c2.device]

    return prof_for


def _pad_axis(f, ax, lo, hi):
    """Zeros before (``lo``) and after (``hi``) ``f`` along ``ax``."""
    pad = [0, 0] * f.ndim
    pad[2 * (f.ndim - 1 - ax)] = lo  # F.pad lists the last axis first
    pad[2 * (f.ndim - 1 - ax) + 1] = hi
    return torch.nn.functional.pad(f, pad)


# ------------------------------------------------------------ plain version


def strip3d_plain(grid, p, p_next, strips, prof, c2):
    """``strip3d``'s algebra in torch ops on slabs of the fields (any
    device, fp32 or fp64), in the reference's order: per axis y, z, x, the
    low face then the high, each adding c2 corr and then c2 psi'."""
    R, S = grid.radius, strip_depth(grid)
    phis, psis = strip_views(grid, strips)
    for ax in range(3):
        n = grid.padded_shape[ax]
        d1 = scaled_taps(D1_COEFFS[grid.order], grid.h[ax], 1)
        d2 = scaled_taps(D2_COEFFS[grid.order], grid.h[ax], 2)
        shape = [1, 1, 1]
        shape[ax] = S
        a_ax = prof[4 * S * ax:4 * S * ax + 2 * S]
        b_ax = prof[4 * S * ax + 2 * S:4 * S * (ax + 1)]
        for side in (0, 1):
            # the strip's cells [c0, c0 + S) and the band [e0, e0 + S + R)
            # that its D1 phi' reaches; the strip sits at offset `inner` in it
            c0, e0, inner = (0, 0, 0) if side == 0 else (n - S, n - S - R, R)
            a = a_ax[side * S:(side + 1) * S].reshape(shape)
            b = b_ax[side * S:(side + 1) * S].reshape(shape)
            phi = phis[ax].narrow(ax, side * S, S)
            psi = psis[ax].narrow(ax, side * S, S)
            # stencils on the strip's cells read only the band (zero past
            # the grid's edge, as the kernels' Dirichlet border)
            pseg = p.narrow(ax, e0, S + R)
            d1p = apply_stencil(pseg, d1, ax).narrow(ax, inner, S)
            d2p = apply_stencil(pseg, d2, ax).narrow(ax, inner, S)
            ph = b * phi + a * d1p
            corr = apply_stencil(_pad_axis(ph, ax, inner, R - inner), d1, ax)
            ps = b * psi + a * (d2p + corr.narrow(ax, inner, S))
            p_next.narrow(ax, e0, S + R).add_(c2.narrow(ax, e0, S + R) * corr)
            p_next.narrow(ax, c0, S).add_(c2.narrow(ax, c0, S) * ps)
            phi.copy_(ph)
            psi.copy_(ps)
    return p_next


# ----------------------------------------------------------------- wrapper


def strip3d(grid, p, p_next, strips, prof, c2):
    """The six-face strip update in place on ``p_next`` and ``strips`` (see
    the module docstring); returns ``p_next``."""
    if c2.device.type == "cpu":
        return strip3d_plain(grid, p, p_next, strips, prof, c2)
    require_cuda("strip3d", c2)
    check_fields3d("strip3d", grid, (c2, p, p_next))
    R, S = grid.radius, strip_depth(grid)
    for v, n in ((strips, 2 * strip_cells(grid)), (prof, 12 * S)):
        if (v.device != c2.device or v.dtype != torch.float32 or not v.is_contiguous()
                or v.ndim != 1 or v.numel() != n):
            raise ValueError(f"strip3d: strips and prof must be contiguous fp32 (n,) on "
                             f"{c2.device}, n = {2 * strip_cells(grid)} and {12 * S}")
    if min(grid.padded_shape) < 2 * (S + R):
        raise ValueError(f"strip3d: every axis needs at least 2 (S + R) = {2 * (S + R)} cells")
    if p.data_ptr() == p_next.data_ptr():
        raise ValueError("strip3d: p and p_next must be distinct fields")
    lib = LIBRARY.load()
    NY, NZ, NX = grid.padded_shape
    with torch.cuda.device(c2.device):
        err = lib.tpufwi_strip3d(p.data_ptr(), p_next.data_ptr(), c2.data_ptr(),
                                 strips.data_ptr(), prof.data_ptr(), NY, NZ, NX, S, R,
                                 taps_arg(grid), torch.cuda.current_stream().cuda_stream)
    raise_on(lib, "strip3d", err)
    strip3d.launches += 1
    return p_next


strip3d.launches = 0


# -------------------------------------------------------------------- step


def make_acoustic3d_fused_step(grid: Grid, dt: float, f0: float, c_max: float):
    """``(step, zero_state)``: ``step((p_prev, p, strips), c2dt2) -> (p,
    p_next, strips)``, ``leapfrog3d`` (p_next over ``p_prev``) then
    ``strip3d`` (``strips`` in place); ``zero_state(device)``: zero fields
    and strips. Every call on CUDA tensors launches the two kernels."""
    prof_for = strip_prof_source(grid, dt, f0, c_max)

    def step(state, c2dt2):
        p_prev, p, strips = state
        p_next = leapfrog3d(grid, p_prev, p, c2dt2)
        strip3d(grid, p, p_next, strips, prof_for(c2dt2), c2dt2)
        return p, p_next, strips

    return step, lambda device="cuda": zero_strip_state(grid, device)
