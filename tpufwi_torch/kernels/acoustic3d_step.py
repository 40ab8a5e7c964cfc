"""The per-step 3D leapfrog: its CUDA wrapper, plain torch version and
launch counter, and the two steps the reference builds around it
(counterpart of ``tpufwi/kernels/acoustic3d_pallas.py``).

``leapfrog3d(grid, p_prev, p, c2)`` computes

    p_next = 2 p - p_prev + c2 Lap3d(p)     (zero Dirichlet borders)

on the padded (y, z, x) grid and writes it over ``p_prev`` (the reference
aliases the two), returning it. It is TPU kernels ``make_leapfrog3d_kernel``
and ``make_leapfrog3d_zsplit`` in one: the two compute this function and
differ only in how they tile it for VMEM, so their layout helpers
(``y_extended``, ``extend_yz``, ``crop_y``, ...) and block sizes (``by``,
``bz``, ``xs``) have no counterpart: the port's fields have
``grid.padded_shape``. The CUDA source is ``csrc/acoustic3d_step.cu``
(``tpufwi_leap3d``, in the 3D library of ``kernels/acoustic3d_scan.py``).

Around it, as in the reference (neither has a free surface):

- ``make_acoustic3d_step``: the leapfrog plus the CPML corrections on
  full-array phi/psi memories in torch ops;
- ``make_acoustic3d_strip_step``: the leapfrog plus the CPML on the six
  absorbing strips in torch ops (``acoustic3d_strips.strip3d_plain``); its
  fused counterpart, with the strips' CUDA kernel, is
  ``acoustic3d_strips.make_acoustic3d_fused_step``.

The wrapper takes its plain version for CPU tensors only, and counts one
launch per call on CUDA.
"""

from __future__ import annotations

import torch

from ..grid import D1_COEFFS, D2_COEFFS, Grid
from .acoustic2d_scanres import interior_lap, raise_on, require_cuda
from .acoustic3d_scan import LIBRARY, taps_arg
from .stencils import apply_stencil, scaled_taps


def check_fields3d(name, grid: Grid, fields):
    """Raise on what the per-step 3D kernels do not take: fields must be
    contiguous fp32 on one CUDA device with the padded grid's shape."""
    if grid.ndim != 3:
        raise ValueError(f"{name}: the kernel is 3D")
    if grid.radius not in (1, 2, 4):
        raise ValueError(f"{name}: unsupported order {grid.order}")
    shape = grid.padded_shape
    if torch.Size(shape).numel() >= 2**31:
        raise ValueError(f"{name}: {shape} exceeds the kernels' int32 indexing")
    dev = fields[0].device
    for f in fields:
        if (f.device != dev or f.dtype != torch.float32 or not f.is_contiguous()
                or tuple(f.shape) != shape):
            raise ValueError(f"{name}: fields must be contiguous fp32 {shape} on {dev}")


# ------------------------------------------------------------ plain version


def leapfrog3d_plain(grid, p_prev, p, c2):
    """``p_prev`` <- 2 p - p_prev + c2 Lap3d(p), the laplacian a sum of
    shifted copies (``stencils.apply_stencil``), never a matmul or conv."""
    p_prev.copy_(2.0 * p - p_prev + c2 * interior_lap(grid, p))
    return p_prev


# ----------------------------------------------------------------- wrapper


def leapfrog3d(grid, p_prev, p, c2):
    """The 3D leapfrog written over ``p_prev`` (see the module docstring);
    returns ``p_prev``, now p_next."""
    if c2.device.type == "cpu":
        return leapfrog3d_plain(grid, p_prev, p, c2)
    require_cuda("leapfrog3d", c2)
    check_fields3d("leapfrog3d", grid, (c2, p_prev, p))
    if p_prev.data_ptr() == p.data_ptr():
        raise ValueError("leapfrog3d: p_prev and p must be distinct fields")
    lib = LIBRARY.load()
    NY, NZ, NX = grid.padded_shape
    with torch.cuda.device(c2.device):
        err = lib.tpufwi_leap3d(p_prev.data_ptr(), p.data_ptr(), c2.data_ptr(), NY, NZ, NX,
                                grid.radius, taps_arg(grid),
                                torch.cuda.current_stream().cuda_stream)
    raise_on(lib, "leapfrog3d", err)
    leapfrog3d.launches += 1
    return p_prev


leapfrog3d.launches = 0


# ------------------------------------------------------------------- steps


def make_acoustic3d_step(grid: Grid, dt: float, f0: float, c_max: float):
    """``step((p_prev, p, phi, psi), c2dt2, a3, b3) -> (p, p_next, phi',
    psi')``: the leapfrog plus the CPML corrections on full-array memories
    (phi, psi: a triple of padded-grid fields each; a3, b3: each axis's
    profile, broadcast along it, as ``cpml.build_profiles`` gives them).
    The leapfrog writes p_next over ``p_prev``."""
    if grid.ndim != 3:
        raise ValueError("make_acoustic3d_step needs a 3D grid")
    d1 = [scaled_taps(D1_COEFFS[grid.order], h, 1) for h in grid.h]
    d2 = [scaled_taps(D2_COEFFS[grid.order], h, 2) for h in grid.h]

    def step(state, c2dt2, a3, b3):
        p_prev, p, phi, psi = state
        p_next = leapfrog3d(grid, p_prev, p, c2dt2)
        phi_new, psi_new, corr = [], [], None
        for ax in range(3):
            a, b = a3[ax], b3[ax]
            ph = b * phi[ax] + a * apply_stencil(p, d1[ax], ax)
            v_corr = apply_stencil(ph, d1[ax], ax)
            ps = b * psi[ax] + a * (apply_stencil(p, d2[ax], ax) + v_corr)
            term = v_corr + ps
            corr = term if corr is None else corr + term
            phi_new.append(ph)
            psi_new.append(ps)
        p_next += c2dt2 * corr
        return p, p_next, tuple(phi_new), tuple(psi_new)

    return step


def make_acoustic3d_strip_step(grid: Grid, dt: float, f0: float, c_max: float):
    """``(step, zero_state)``: ``step((p_prev, p, strips), c2dt2) -> (p,
    p_next, strips)``, the leapfrog plus the CPML memories on the six
    absorbing strips only, in torch ops (``acoustic3d_strips.strip3d_plain``;
    ``strips`` is the packed state of ``acoustic3d_strips.strip_views``,
    updated in place). ``zero_state(device)``: zero fields and strips."""
    from .acoustic3d_strips import strip_prof_source, strip3d_plain, zero_strip_state

    prof_for = strip_prof_source(grid, dt, f0, c_max)

    def step(state, c2dt2):
        p_prev, p, strips = state
        p_next = leapfrog3d(grid, p_prev, p, c2dt2)
        strip3d_plain(grid, p, p_next, strips, prof_for(c2dt2), c2dt2)
        return p, p_next, strips

    return step, lambda device="cuda": zero_strip_state(grid, device)
