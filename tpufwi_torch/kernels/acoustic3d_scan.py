"""The 3D engine's kernels: CUDA wrappers, their plain torch versions and
their launch counters (counterpart of the kernels of
``tpufwi/adjoint3d_pallas.py``: ``kernels/acoustic3d_fused2.py`` and
``kernels/acoustic3d_bwd_pallas.py``), and the build of their library.

``a3d_forward`` runs the whole 3D acoustic time loop on the padded (y, z, x)
grid and, on request, records the boundary-ring tape (fp32 or bf16) of the
field each step ends with and the illumination ``sum_t P_t^2``.
``a3d_reverse`` reconstructs the field backwards from the last two fields
and the ring tape, images with the laplacian of the reconstruction and runs
the exact transposed step; it returns the imaged gradient and the adjoint
field at the sources. The CUDA sources are ``csrc/acoustic3d_scan.cu`` and
``csrc/acoustic3d_kernels.cuh``.

Each wrapper takes its plain version for tensors on the CPU, and only then;
on a CUDA tensor it launches the kernel or raises. ``launches`` on each
wrapper counts the time steps its kernel ran (the C loop launches each
step's kernels once), and stays 0 on the CPU path. ``LIBRARY`` is built by
one nvcc call at first use (``kernels/build.py``), together with the
per-step 3D kernels' ``csrc/acoustic3d_step.cu``; neither this module's
import nor the plain versions need CUDA.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..grid import D1_COEFFS, D2_COEFFS, Grid
from .acoustic2d_eager import AcousticParams, make_acoustic_step, zero_state
from .acoustic2d_scanres import (
    check_args,
    full_profiles,
    require_cuda,
    ring_plan,
    scanres_reverse_plain,
    strip_depth,
    surface_row,
)
from .build import CSRC, Library, declare_all, raise_on
from .stencils import scaled_taps

TAPE_DTYPES = (None, torch.float32, torch.bfloat16)


# ------------------------------------------------------------ plain versions


def a3d_forward_plain(grid, c2, profiles, wavelet, src_idx, rcv_idx, tape_dtype=None,
                      illum=False):
    """Loop of the step twin. Returns (seis (nt, nrec), tape, P_{nt-2},
    P_{nt-1}, illum). ``tape_dtype`` (fp32 or bf16): the (nt, n_ring) tape,
    row t the ring cells of P_t (``ring_plan`` order) rounded to that type;
    None: no tape; the plain version also takes the field's own type (fp64
    on the CPU). ``illum``: also ``sum_t P_t^2`` on the padded grid, else
    None."""
    if tape_dtype is not None and not tape_dtype.is_floating_point:
        raise ValueError(f"unknown tape dtype {tape_dtype}")
    a, b = full_profiles(grid, profiles)
    params = AcousticParams(c2, a, b, src_idx, rcv_idx)
    step = make_acoustic_step(grid)
    state = zero_state(grid.padded_shape, grid.ndim, c2.dtype, c2.device)
    ring_idx = ring_plan(grid, c2.device)[0] if tape_dtype is not None else None
    acc = torch.zeros_like(c2) if illum else None
    rows, seis = [], []
    for t in range(wavelet.shape[0]):
        state, rec = step(state, params, wavelet[t])
        seis.append(rec)
        if tape_dtype is not None:
            rows.append(state.p.reshape(-1)[ring_idx].to(tape_dtype))
        if illum:
            acc += state.p**2
    tape = torch.stack(rows) if tape_dtype is not None else None
    return torch.stack(seis), tape, state.p_prev, state.p, acc


# the rings reverse's plain version is dimension-agnostic: it reconstructs
# P_{t-2} from P_{t-1} and P_t at each step t (ring row t-2 imposed, zeros
# for t < 2), images lambda_t with the D2 laplacian of P_{t-1} and runs the
# transposed twin step; (gbar, lam_src[, P_{-1}])
a3d_reverse_plain = scanres_reverse_plain


# ------------------------------------------------------------------- build

LIBRARY = Library(
    "acoustic3d",
    (CSRC / "acoustic3d_scan.cu", CSRC / "acoustic3d_step.cu"),
    (CSRC / "acoustic3d_kernels.cuh",),
    lambda lib: declare_all(lib, {
        # pointers..., ints..., taps, stream
        "tpufwi_a3d_forward": (12, 11),
        "tpufwi_a3d_reverse": (16, 18),
        # the per-step kernels (kernels/acoustic3d_step.py, acoustic3d_strips.py)
        "tpufwi_leap3d": (3, 4),
        "tpufwi_strip3d": (5, 5),
    }),
)


# ---------------------------------------------------------------- wrappers


@functools.lru_cache(maxsize=None)
def taps_arg(grid: Grid):
    """(d1 y, z, x; d2 y, z, x) as 6 x 9 fp32, zero-filled past 2R+1 taps;
    built once per grid (the kernels copy it at each call)."""
    taps = np.zeros((6, 9), np.float32)
    for row, (coeffs, power) in enumerate(((D1_COEFFS, 1), (D2_COEFFS, 2))):
        for ax, h in enumerate(grid.h):
            t = scaled_taps(coeffs[grid.order], h, power)
            taps[3 * row + ax, : len(t)] = t
    return (ctypes.c_float * 54)(*taps.reshape(-1).tolist())


def strip_cells(grid: Grid) -> int:
    """Cells of one quantity's three strip arrays (both faces of each axis)."""
    NY, NZ, NX = grid.padded_shape
    return 2 * strip_depth(grid) * (NZ * NX + NY * NX + NY * NZ)


def _halo(grid, f=None, device=None):
    """A zeroed halo field, with ``f`` (padded grid) copied in."""
    R = grid.radius
    if f is not None:
        return torch.nn.functional.pad(f, (R,) * 6).contiguous()
    return torch.zeros([n + 2 * R for n in grid.padded_shape], dtype=torch.float32,
                       device=device)


def packed_profiles(profiles):
    """The six strip profiles (``strip_profiles``' order) as the kernels
    take them: per axis y, z, x, its a then its b, each low strip then
    high (12 S values)."""
    return torch.cat([p.reshape(-1) for p in profiles]).contiguous()


def _inner(grid, f):
    R = grid.radius
    return f[R:-R, R:-R, R:-R]


def a3d_forward(grid, c2, profiles, wavelet, src_idx, rcv_idx, tape_dtype=None, illum=False):
    """Whole 3D forward propagation (see ``a3d_forward_plain`` for the
    contract; the last two fields are views into halo buffers).
    ``profiles`` are the six strip profiles as tensors; ``rcv_idx`` may
    hold no receiver."""
    if c2.device.type == "cpu":
        return a3d_forward_plain(grid, c2, profiles, wavelet, src_idx, rcv_idx, tape_dtype,
                                 illum)
    require_cuda("a3d_forward", c2)
    if tape_dtype not in TAPE_DTYPES:
        raise ValueError(f"unknown tape dtype {tape_dtype}")
    check_args("a3d_forward", grid, c2, profiles, (wavelet,), src_idx, rcv_idx, dims=3,
               min_rcv=0)
    if wavelet.ndim != 1 or wavelet.shape[0] == 0:
        raise ValueError("a3d_forward: wavelet must be (nt,) with nt > 0")
    lib = LIBRARY.load()
    NY, NZ, NX = grid.padded_shape
    nt, nrec = wavelet.shape[0], rcv_idx.shape[0]
    dev = c2.device
    seis = torch.empty((nt, nrec), dtype=torch.float32, device=dev)
    ring, n_ring, tape = None, 0, None
    if tape_dtype is not None:
        ring = ring_plan(grid, dev)[1]
        n_ring = ring.shape[0]
        tape = torch.empty((nt, n_ring), dtype=tape_dtype, device=dev)
    acc = torch.zeros(grid.padded_shape, dtype=torch.float32, device=dev) if illum else None
    c2h = _halo(grid, c2)
    pa, pb = _halo(grid, device=dev), _halo(grid, device=dev)
    strips = torch.zeros(2 * strip_cells(grid), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.tpufwi_a3d_forward(
            c2h.data_ptr(), packed_profiles(profiles).data_ptr(), wavelet.data_ptr(),
            src_idx.data_ptr(), rcv_idx.data_ptr(), seis.data_ptr(),
            None if ring is None else ring.data_ptr(), None if tape is None else tape.data_ptr(),
            None if acc is None else acc.data_ptr(), pa.data_ptr(), pb.data_ptr(),
            strips.data_ptr(),
            NY, NZ, NX, strip_depth(grid), grid.radius, nt, src_idx.shape[0], nrec,
            surface_row(grid), n_ring, int(tape_dtype == torch.bfloat16), taps_arg(grid),
            torch.cuda.current_stream().cuda_stream,
        )
    raise_on(lib, "a3d_forward", err)
    a3d_forward.launches += nt
    last, penult = (pa, pb) if (nt - 1) % 2 == 0 else (pb, pa)
    return seis, tape, _inner(grid, penult), _inner(grid, last), acc


a3d_forward.launches = 0


def a3d_reverse(grid, c2, profiles, wavelet, ybar, tape, p_penult, p_last, src_idx, rcv_idx,
                return_field=False):
    """Reverse with reconstruction (see ``a3d_reverse_plain`` for the
    contract): ``tape`` is the (nt, n_ring) fp32 or bf16 ring tape and
    ``p_penult``, ``p_last`` the last two fields of ``a3d_forward``."""
    if c2.device.type == "cpu":
        return a3d_reverse_plain(grid, c2, profiles, wavelet, ybar, tape, p_penult, p_last,
                                 src_idx, rcv_idx, return_field)
    require_cuda("a3d_reverse", c2)
    check_args("a3d_reverse", grid, c2, profiles, (wavelet, ybar), src_idx, rcv_idx, dims=3)
    if ybar.ndim != 2 or ybar.shape[0] == 0 or ybar.shape[1] != rcv_idx.shape[0]:
        raise ValueError("a3d_reverse: ybar must be (nt > 0, nrec)")
    nt, nrec = ybar.shape
    _, ring, frame = ring_plan(grid, c2.device)
    n_ring = ring.shape[0]
    if (tuple(wavelet.shape) != (nt,) or tuple(tape.shape) != (nt, n_ring)
            or tape.dtype not in TAPE_DTYPES[1:] or tape.device != c2.device
            or not tape.is_contiguous()):
        raise ValueError(f"a3d_reverse: wavelet must be ({nt},), tape contiguous fp32 or "
                         f"bf16 ({nt}, {n_ring})")
    for f in (p_penult, p_last):
        if (tuple(f.shape) != grid.padded_shape or f.device != c2.device
                or f.dtype != torch.float32):
            raise ValueError(f"a3d_reverse: final fields must be fp32 {grid.padded_shape}")
    lib = LIBRARY.load()
    NY, NZ, NX = grid.padded_shape
    dev = c2.device
    nsrc = src_idx.shape[0]
    gbar = torch.zeros(grid.padded_shape, dtype=torch.float32, device=dev)
    lam_src = torch.empty((nt, nsrc), dtype=torch.float32, device=dev)
    c2h = _halo(grid, c2)
    p_tp1, p_t = _halo(grid, p_last), _halo(grid, p_penult)
    qa, qb = _halo(grid, device=dev), _halo(grid, device=dev)
    strips = torch.zeros(4 * strip_cells(grid), dtype=torch.float32, device=dev)
    chain = torch.empty(2 * nrec, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.tpufwi_a3d_reverse(
            c2h.data_ptr(), packed_profiles(profiles).data_ptr(), wavelet.data_ptr(),
            ybar.data_ptr(), tape.data_ptr(), ring.data_ptr(), src_idx.data_ptr(),
            rcv_idx.data_ptr(), gbar.data_ptr(), lam_src.data_ptr(), p_tp1.data_ptr(),
            p_t.data_ptr(), qa.data_ptr(), qb.data_ptr(), strips.data_ptr(), chain.data_ptr(),
            NY, NZ, NX, strip_depth(grid), grid.radius, nt, nsrc, nrec, surface_row(grid),
            n_ring, int(tape.dtype == torch.bfloat16), *frame, taps_arg(grid),
            torch.cuda.current_stream().cuda_stream,
        )
    raise_on(lib, "a3d_reverse", err)
    a3d_reverse.launches += nt
    if not return_field:
        return gbar, lam_src
    return gbar, lam_src, _inner(grid, p_tp1 if nt % 2 == 0 else p_t)


a3d_reverse.launches = 0
