"""The single-step engine's three kernels: CUDA wrappers, their plain torch
versions and their launch counters (counterpart of
``tpufwi/kernels/acoustic2d_pallas.py::make_fused_forward_step`` and
``tpufwi/kernels/acoustic2d_pallas_bwd.py::make_recon_kernel`` /
``make_fused_adjoint_step``).

Each call is one time step and updates the caller's state in place. Fields
are laid out as the CUDA kernels keep them: (NZ + 2R, NX + 2R) with a zero
halo of R cells around the padded grid, which the kernels never write.

- ``fused_forward_step``: ``prev`` (P_{t-2}) <- P_t from ``cur`` (P_{t-1}),
  the CPML planes ``cpml`` (phi_z, psi_z, phi_x, psi_x) updated, the
  sources added, ``seis[t]`` <- P_t at the receivers and, when given,
  ``ring_row`` <- the ring cells of P_t.
- ``recon_step``: ``p_tp1`` (P_t) <- P_{t-2}, reconstructed from ``p_t``
  (P_{t-1}) with the sources added before the ring cells are imposed from
  ``ring_row`` (zeros when None); ``lapw`` <- the D2 laplacian of P_{t-1}.
- ``fused_adjoint_step``: ``q`` holds lambda_t before its receiver
  injection and ``q_other`` lambda_{t+1}; afterwards ``q`` holds lambda_t
  and ``q_other`` lambda_{t-1} before injection (the caller swaps them).
  ``adj`` holds 9 planes (u, then psibar, w, phibar, y for z and for x: the
  cotangents of psi and phi and their scratch), ``gacc += lambda_t * lapw``
  and ``lam_src[t]`` <- lambda_t at the sources.

The plain versions run the step twin on views of the same tensors; the
adjoint's is ``torch.func.vjp`` of the twin step, whose cotangent state
maps onto the kernel's as (p_prev, p, phi, psi) = (-q_other, q, phibar,
psibar). The CUDA source is ``csrc/acoustic2d_step.cu``. Each wrapper
takes its plain version for CPU tensors only and counts one launch per
call on CUDA. The per-call checks skip the index bounds (one host sync):
the engine checks those once per propagation with ``check_args``.
"""

from __future__ import annotations

import torch

from .acoustic2d_eager import (
    AcousticParams,
    AcousticState,
    make_acoustic_step,
    make_reverse_reconstruct_step,
)
from .acoustic2d_scanres import (
    check_args,
    full_profiles,
    impose_ring,
    interior_lap,
    load_library,
    raise_on,
    require_cuda,
    ring_plan,
    strip_depth,
    surface_row,
    taps_arg,
)

ADJ_PLANES = 9


def _inner(grid, x):
    R = grid.radius
    return x[..., R:-R, R:-R]


def _check_fields(name, grid, fields, n_planes=()):
    NZ, NX = grid.padded_shape
    R = grid.radius
    for f, planes in zip(fields, n_planes):
        shape = (NZ + 2 * R, NX + 2 * R) if planes is None else (planes, NZ + 2 * R, NX + 2 * R)
        if tuple(f.shape) != shape or f.dtype != torch.float32 or not f.is_contiguous():
            raise ValueError(f"{name}: fields must be contiguous fp32 {shape} halo planes")


# ------------------------------------------------------------ plain versions


def fused_forward_step_plain(grid, c2, profiles, cur, prev, cpml, wavelet, t, src_idx,
                             rcv_idx, seis, ring_row=None):
    a, b = full_profiles(grid, profiles)
    step = make_acoustic_step(grid)
    ic = _inner(grid, cpml)
    state = AcousticState(_inner(grid, prev), _inner(grid, cur), (ic[0], ic[2]), (ic[1], ic[3]))
    new, rec = step(state, AcousticParams(c2, a, b, src_idx, rcv_idx), wavelet[t])
    _inner(grid, prev).copy_(new.p)
    for plane, val in zip(ic, (new.phi[0], new.psi[0], new.phi[1], new.psi[1])):
        plane.copy_(val)
    seis[t] = rec
    if ring_row is not None:
        ring_row.copy_(new.p.reshape(-1)[ring_plan(grid, c2.device)[0]])


def recon_step_plain(grid, c2, p_t, p_tp1, lapw, wavelet, t, src_idx, ring_row=None):
    recon = make_reverse_reconstruct_step(grid)
    pt = _inner(grid, p_t)
    p_tm1 = recon(pt, _inner(grid, p_tp1), c2, src_idx, wavelet[t])
    lapw.copy_(interior_lap(grid, pt))
    _inner(grid, p_tp1).copy_(impose_ring(p_tm1, ring_plan(grid, c2.device)[0], ring_row))


def fused_adjoint_step_plain(grid, c2, profiles, q, q_other, adj, lapw, gacc, ybar, t,
                             src_idx, rcv_idx, lam_src, chain=None, init_chain=False):
    a, b = full_profiles(grid, profiles)
    params = AcousticParams(c2, a, b, src_idx, rcv_idx)
    step = make_acoustic_step(grid)
    iq, io, ia = _inner(grid, q), _inner(grid, q_other), _inner(grid, adj)
    zero = torch.zeros_like(iq)
    _, step_t = torch.func.vjp(
        lambda s: step(s, params, 0.0),
        AcousticState(zero, zero, (zero, zero), (zero, zero)))
    # cotangent of the state after step t
    sbar = AcousticState(-io, iq, (ia[3], ia[7]), (ia[1], ia[5]))
    lam = iq.index_put((rcv_idx[:, 0], rcv_idx[:, 1]), ybar[t], accumulate=True)
    if grid.free_surface:
        lam = lam.index_fill(0, torch.tensor([grid.pad], device=c2.device), 0.0)
    lam_src[t] = lam[src_idx[:, 0], src_idx[:, 1]]
    gacc += lam * lapw
    (new,) = step_t((sbar, ybar[t]))
    iq.copy_(-new.p_prev)  # lambda_t, the surface row masked
    io.copy_(new.p)
    for k, val in ((3, new.phi[0]), (7, new.phi[1]), (1, new.psi[0]), (5, new.psi[1])):
        ia[k].copy_(val)


# ---------------------------------------------------------------- wrappers


def fused_forward_step(grid, c2, profiles, cur, prev, cpml, wavelet, t, src_idx, rcv_idx,
                       seis, ring_row=None):
    """One forward step in place (see the module docstring)."""
    if c2.device.type == "cpu":
        return fused_forward_step_plain(grid, c2, profiles, cur, prev, cpml, wavelet, t,
                                        src_idx, rcv_idx, seis, ring_row)
    require_cuda("fused_forward_step", c2)
    check_args("fused_forward_step", grid, c2, profiles, (wavelet, seis), src_idx, rcv_idx,
               bounds=False)
    _check_fields("fused_forward_step", grid, (cur, prev, cpml), (None, None, 4))
    _, ring, _ = ring_plan(grid, c2.device)
    if ring_row is not None and (tuple(ring_row.shape) != tuple(ring.shape)
                                 or ring_row.dtype != torch.float32):
        raise ValueError(f"fused_forward_step: ring_row must be fp32 {tuple(ring.shape)}")
    if not 0 <= t < wavelet.shape[0] or seis.shape != (wavelet.shape[0], rcv_idx.shape[0]):
        raise ValueError("fused_forward_step: t outside the wavelet, or seis not (nt, nrec)")
    lib = load_library()
    NZ, NX = grid.padded_shape
    err = lib.tpufwi_step_forward(
        c2.data_ptr(), *(p.data_ptr() for p in profiles), wavelet.data_ptr(),
        src_idx.data_ptr(), rcv_idx.data_ptr(), seis.data_ptr(), ring.data_ptr(),
        None if ring_row is None else ring_row.data_ptr(), cur.data_ptr(), prev.data_ptr(),
        cpml.data_ptr(), t, ring.shape[0], NZ, NX, strip_depth(grid), grid.radius,
        src_idx.shape[0], rcv_idx.shape[0], surface_row(grid), taps_arg(grid),
        torch.cuda.current_stream(c2.device).cuda_stream,
    )
    raise_on(lib, "fused_forward_step", err)
    fused_forward_step.launches += 1


fused_forward_step.launches = 0


def recon_step(grid, c2, p_t, p_tp1, lapw, wavelet, t, src_idx, ring_row=None):
    """One reconstruction step in place (see the module docstring)."""
    if c2.device.type == "cpu":
        return recon_step_plain(grid, c2, p_t, p_tp1, lapw, wavelet, t, src_idx, ring_row)
    require_cuda("recon_step", c2)
    NZ, NX = grid.padded_shape
    for v in (c2, lapw, wavelet):
        if v.device != c2.device or v.dtype != torch.float32 or not v.is_contiguous():
            raise ValueError(f"recon_step: float tensors must be contiguous fp32 on {c2.device}")
    if tuple(c2.shape) != (NZ, NX) or tuple(lapw.shape) != (NZ, NX):
        raise ValueError(f"recon_step: c2 and lapw must be {(NZ, NX)}")
    _check_fields("recon_step", grid, (p_t, p_tp1), (None, None))
    if src_idx.dtype != torch.int64 or not src_idx.is_contiguous() or src_idx.shape[-1] != 2:
        raise ValueError("recon_step: src_idx must be contiguous (nsrc, 2) int64")
    _, ring, (z0, z1, x0, x1, rw) = ring_plan(grid, c2.device)
    if ring_row is not None and (tuple(ring_row.shape) != tuple(ring.shape)
                                 or ring_row.dtype != torch.float32):
        raise ValueError(f"recon_step: ring_row must be fp32 {tuple(ring.shape)}")
    if not 0 <= t < wavelet.shape[0]:
        raise ValueError("recon_step: t outside the wavelet")
    lib = load_library()
    err = lib.tpufwi_step_recon(
        c2.data_ptr(), wavelet.data_ptr(), src_idx.data_ptr(), ring.data_ptr(),
        None if ring_row is None else ring_row.data_ptr(), p_t.data_ptr(), p_tp1.data_ptr(),
        lapw.data_ptr(), t, ring.shape[0], NZ, NX, grid.radius, src_idx.shape[0],
        surface_row(grid), z0, z1, x0, x1, rw, taps_arg(grid),
        torch.cuda.current_stream(c2.device).cuda_stream,
    )
    raise_on(lib, "recon_step", err)
    recon_step.launches += 1


recon_step.launches = 0


def fused_adjoint_step(grid, c2, profiles, q, q_other, adj, lapw, gacc, ybar, t, src_idx,
                       rcv_idx, lam_src, chain=None, init_chain=False):
    """One transposed step in place (see the module docstring). On CUDA,
    ``chain`` (2 * nrec int32) orders coinciding receivers; ``init_chain``
    builds it, on the first reverse step."""
    if c2.device.type == "cpu":
        return fused_adjoint_step_plain(grid, c2, profiles, q, q_other, adj, lapw, gacc, ybar,
                                        t, src_idx, rcv_idx, lam_src)
    require_cuda("fused_adjoint_step", c2)
    check_args("fused_adjoint_step", grid, c2, profiles, (lapw, gacc, ybar, lam_src), src_idx,
               rcv_idx, bounds=False)
    _check_fields("fused_adjoint_step", grid, (q, q_other, adj), (None, None, ADJ_PLANES))
    nt, nrec = ybar.shape
    if (nrec != rcv_idx.shape[0] or tuple(lam_src.shape) != (nt, src_idx.shape[0])
            or not 0 <= t < nt):
        raise ValueError("fused_adjoint_step: ybar (nt, nrec), lam_src (nt, nsrc), t < nt")
    if chain is None or chain.dtype != torch.int32 or chain.numel() != 2 * nrec:
        raise ValueError("fused_adjoint_step: chain must be 2 * nrec int32")
    lib = load_library()
    NZ, NX = grid.padded_shape
    err = lib.tpufwi_step_adjoint(
        c2.data_ptr(), *(p.data_ptr() for p in profiles), ybar.data_ptr(), lapw.data_ptr(),
        src_idx.data_ptr(), rcv_idx.data_ptr(), chain.data_ptr(), gacc.data_ptr(),
        lam_src.data_ptr(), q.data_ptr(), q_other.data_ptr(), adj.data_ptr(), t,
        int(init_chain), NZ, NX, strip_depth(grid), grid.radius, src_idx.shape[0], nrec,
        surface_row(grid), taps_arg(grid), torch.cuda.current_stream(c2.device).cuda_stream,
    )
    raise_on(lib, "fused_adjoint_step", err)
    fused_adjoint_step.launches += 1


fused_adjoint_step.launches = 0
