"""The K-step engine's two kernels: CUDA wrappers, their plain torch
versions and their launch counters (counterpart of
``tpufwi/kernels/acoustic2d_pallas_kstep.py``).

Each call runs k time steps in one cooperative launch
(``csrc/acoustic2d_kstep.cu``), in place on the caller's state in the halo
layout of ``kernels/acoustic2d_step.py``:

- ``kstep_forward``: steps t0 .. t0 + k - 1, the same as k calls of
  ``fused_forward_step``, each followed by the caller's swap of ``cur``
  and ``prev``; so after the call the caller swaps them once if k is odd.
  ``seis`` (nt, nrec) and ``tape`` (nt, n_ring, optional) get rows t0 ..
  t0 + k - 1.
- ``kstep_reverse``: steps t0 + k - 1 down to t0, the same as k calls of
  ``recon_step`` then ``fused_adjoint_step`` (the merged
  ``fused_reverse_step``), each followed by the caller's swaps of
  (``p_t``, ``p_tp1``) and (``q``, ``q_other``); step t imposes ring row
  t - 2 of the whole ``tape`` (zeros for t < 2 or no tape) and writes
  ``lam_src[t]``.

Receivers are gathered and injected by index anywhere on the grid, and k
is any count from 1 up: unlike the reference's kernels there is no receiver
slab and no padding of nt to a multiple of K. The plain versions are loops
of the single-step plain versions. Each wrapper takes its plain version for
CPU tensors only and launches or raises on CUDA; ``launches`` counts the
time steps its kernel ran, as the whole-scan wrappers do.
"""

from __future__ import annotations

import torch

from .acoustic2d_scanres import (
    check_args,
    load_library,
    raise_on,
    require_cuda,
    ring_plan,
    strip_depth,
    surface_row,
    taps_arg,
)
from .acoustic2d_step import (
    check_fields,
    check_reverse_args,
    fused_forward_step_plain,
    fused_reverse_step_plain,
)


def _check_steps(name, t0, k, nt):
    if k < 1 or t0 < 0 or t0 + k > nt:
        raise ValueError(f"{name}: steps t0={t0} .. t0 + k - 1 (k={k}) outside 0 .. {nt - 1}")


def _check_tape(name, tape, nt, n_ring, device):
    if tape is not None and (tuple(tape.shape) != (nt, n_ring) or tape.dtype != torch.float32
                             or not tape.is_contiguous() or tape.device != device):
        raise ValueError(f"{name}: tape must be contiguous fp32 {(nt, n_ring)} on {device}")


# ------------------------------------------------------------ plain versions


def kstep_forward_plain(grid, c2, profiles, cur, prev, cpml, wavelet, t0, k, src_idx, rcv_idx,
                        seis, tape=None):
    for t in range(t0, t0 + k):
        fused_forward_step_plain(grid, c2, profiles, cur, prev, cpml, wavelet, t, src_idx,
                                 rcv_idx, seis, None if tape is None else tape[t])
        cur, prev = prev, cur


def kstep_reverse_plain(grid, c2, profiles, p_t, p_tp1, q, q_other, adj, gacc, wavelet, ybar,
                        t0, k, src_idx, rcv_idx, lam_src, tape=None):
    for t in reversed(range(t0, t0 + k)):
        row = tape[t - 2] if tape is not None and t >= 2 else None
        fused_reverse_step_plain(grid, c2, profiles, p_t, p_tp1, q, q_other, adj, gacc, wavelet,
                                 ybar, t, src_idx, rcv_idx, lam_src, row)
        p_t, p_tp1 = p_tp1, p_t
        q, q_other = q_other, q


# ---------------------------------------------------------------- wrappers


def kstep_forward(grid, c2, profiles, cur, prev, cpml, wavelet, t0, k, src_idx, rcv_idx, seis,
                  tape=None):
    """k forward steps from t0 in one launch (see the module docstring)."""
    if c2.device.type == "cpu":
        return kstep_forward_plain(grid, c2, profiles, cur, prev, cpml, wavelet, t0, k, src_idx,
                                   rcv_idx, seis, tape)
    require_cuda("kstep_forward", c2)
    check_args("kstep_forward", grid, c2, profiles, (wavelet, seis), src_idx, rcv_idx,
               bounds=False)
    check_fields("kstep_forward", grid, c2.device, (cur, prev, cpml), (None, None, 4))
    nt = wavelet.shape[0]
    _check_steps("kstep_forward", t0, k, nt)
    if seis.shape != (nt, rcv_idx.shape[0]):
        raise ValueError("kstep_forward: seis must be (nt, nrec)")
    _, ring, _ = ring_plan(grid, c2.device)
    _check_tape("kstep_forward", tape, nt, ring.shape[0], c2.device)
    lib = load_library()
    NZ, NX = grid.padded_shape
    err = lib.tpufwi_kstep_forward(
        c2.data_ptr(), *(p.data_ptr() for p in profiles), wavelet.data_ptr(),
        src_idx.data_ptr(), rcv_idx.data_ptr(), seis.data_ptr(), ring.data_ptr(),
        None if tape is None else tape.data_ptr(), cur.data_ptr(), prev.data_ptr(),
        cpml.data_ptr(), t0, k, ring.shape[0], NZ, NX, strip_depth(grid), grid.radius,
        src_idx.shape[0], rcv_idx.shape[0], surface_row(grid), taps_arg(grid),
        torch.cuda.current_stream(c2.device).cuda_stream,
    )
    raise_on(lib, "kstep_forward", err)
    kstep_forward.launches += k


kstep_forward.launches = 0


def kstep_reverse(grid, c2, profiles, p_t, p_tp1, q, q_other, adj, gacc, wavelet, ybar, t0, k,
                  src_idx, rcv_idx, lam_src, tape=None, chain=None, init_chain=False):
    """k reverse steps down to t0 in one launch (see the module docstring).
    On CUDA, ``chain`` (2 * nrec int32) orders coinciding receivers;
    ``init_chain`` builds it, on the first reverse call."""
    if c2.device.type == "cpu":
        return kstep_reverse_plain(grid, c2, profiles, p_t, p_tp1, q, q_other, adj, gacc,
                                   wavelet, ybar, t0, k, src_idx, rcv_idx, lam_src, tape)
    require_cuda("kstep_reverse", c2)
    _check_steps("kstep_reverse", t0, k, ybar.shape[0])
    check_reverse_args("kstep_reverse", grid, c2, profiles, (p_t, p_tp1, q, q_other, adj), gacc,
                       wavelet, ybar, lam_src, src_idx, rcv_idx, chain, (t0, t0 + k - 1))
    _, ring, (z0, z1, x0, x1, rw) = ring_plan(grid, c2.device)
    _check_tape("kstep_reverse", tape, ybar.shape[0], ring.shape[0], c2.device)
    lib = load_library()
    NZ, NX = grid.padded_shape
    err = lib.tpufwi_kstep_reverse(
        c2.data_ptr(), *(p.data_ptr() for p in profiles), wavelet.data_ptr(), ybar.data_ptr(),
        src_idx.data_ptr(), rcv_idx.data_ptr(), chain.data_ptr(), ring.data_ptr(),
        None if tape is None else tape.data_ptr(), p_t.data_ptr(), p_tp1.data_ptr(),
        q.data_ptr(), q_other.data_ptr(), adj.data_ptr(), gacc.data_ptr(), lam_src.data_ptr(),
        t0, k, int(init_chain), ring.shape[0], NZ, NX, strip_depth(grid), grid.radius,
        src_idx.shape[0], rcv_idx.shape[0], surface_row(grid), z0, z1, x0, x1, rw,
        taps_arg(grid), torch.cuda.current_stream(c2.device).cuda_stream,
    )
    raise_on(lib, "kstep_reverse", err)
    kstep_reverse.launches += k


kstep_reverse.launches = 0
