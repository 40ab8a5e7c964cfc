"""The whole-scan engines' three kernels: CUDA wrappers, their plain torch
versions and their launch counters (counterpart of
``tpufwi/kernels/acoustic2d_pallas_scanres.py`` and of ``strip_profiles`` /
``strip_depth`` in ``tpufwi/kernels/acoustic2d_pallas.py``), and the build
of the kernels' library.

``scanres_forward`` runs the whole 2D acoustic time loop and, on request,
records a tape: ``"snap"``, the bf16 D2-only interior laplacian of the field
each step starts from, or ``"rings"``, the fp32 boundary ring of the field
each step ends with; and the illumination ``sum_t P_t^2``, which every 2D
CUDA engine's ``illumination`` takes from it. ``scanres_reverse_snap`` runs the exact transposed step
backwards over the snapshot tape; ``scanres_reverse`` reconstructs the
field backwards from the last two fields and the ring tape, and images with
the laplacian of the reconstruction. Both return the imaged gradient and
the adjoint field at the sources. The CUDA sources are
``csrc/acoustic2d_scanres.cu`` and ``csrc/acoustic2d_kernels.cuh``.

Each runs one shared-memory tiled kernel a time step (launch plan
``scanres_tile_plan``, tile walk ``fused_tiles``) after one small launch a
call, each step a programmatic dependent of the one before unless
``dependent_launch`` is False (plain stream order, for profiling: a
dependent kernel's profiler span includes its wait). The rings reverse's
step is the snapshot reverse's kernel with the reconstruction folded into
the thread that owns each cell. On the card each is held against the
single-step engine that runs the same passes a launch at a time
(``kernels/acoustic2d_step.py``; ``chip_smoke.py``'s ``scanres_*_steps``).

Each wrapper takes its plain version for tensors on the CPU, and only
then; on a CUDA tensor it launches the kernel or raises. ``launches`` on
each wrapper counts the time steps its kernel ran (the C loop launches
each step's kernels once), and stays 0 on the CPU path.

``load_library`` builds ``csrc/acoustic2d_scanres.cu``,
``csrc/acoustic2d_step.cu`` and ``csrc/acoustic2d_kstep.cu`` into one
library with one nvcc call at first use (``kernels/build.py``); neither
this module's import nor the plain versions need CUDA.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import profiling
from ..cpml import CpmlProfile
from ..grid import D1_COEFFS, D2_COEFFS, Grid
from ..propagators.boundary import RingSpec
from .acoustic2d_eager import (
    AcousticParams,
    make_acoustic_step,
    make_reverse_reconstruct_step,
    zero_state,
)
from .build import CSRC, Library, declare_all, raise_on  # noqa: F401 (raise_on: re-export)
from .stencils import apply_stencil, scaled_taps

# halo planes of the workspace: forward pa, pb, phi_z, psi_z, phi_x, psi_x
# and a second phi_z, phi_x; snapshot reverse q0, q1, then psibar/phibar for
# z and x in two sets; the rings reverse P_t and P_{t-1} before the
# snapshot reverse's planes
_FWD_PLANES = 8
_REV_SNAP_PLANES = 2 + 8
_REV_RINGS_PLANES = 2 + _REV_SNAP_PLANES
# kernel launches of a time step of each whole-scan kernel, in every mode;
# each call adds one (scan_setup)
STEP_LAUNCHES = 1
TAPE_MODES = (None, "snap", "rings")

# the fused passes' tile (csrc/acoustic2d_scanres.cu TPUFWI_SCAN_TILE:
# TILE_Z x TILE_X cells, a block of TILE_X x TILE_ROWS threads)
TILE_Z, TILE_X, TILE_ROWS = 16, 32, 8


class ScanresPlan(NamedTuple):
    """Launch plan of the fused passes: a block owns a ``tz`` x ``tx`` tile
    of cells; ``smem`` is the larger pass's shared bytes."""
    tz: int
    tx: int
    smem: int


FUSED_KERNELS = ("fwd_fused", "rev_fused", "rev_fused_rings")


def fused_smem(R: int, kernel: str) -> int:
    """Shared bytes of a fused pass at radius R (``STile``): the field or
    lambda over the tile and its 2R cross; the forward's phi over the
    tile's columns and rows and their R reach and five planes of the own
    cells' operands; the reverse's w over 2R, y over R and two planes of
    operands; its rings form also P_{t-1} (a plane of the 2R cross's
    layout) and a third plane of operands (P_t)."""
    tz, tx = TILE_Z, TILE_X
    H = 2 * R
    rect = (tz + 2 * H) * (tx + 2 * H)
    zcol1, xrow1, own = (tz + 2 * R) * tx, tz * (tx + 2 * R), tz * tx
    if kernel == "fwd_fused":
        return 4 * (rect + zcol1 + xrow1 + 5 * own)
    rev = 4 * (rect + (tz + 2 * H) * tx + tz * (tx + 2 * H) + zcol1 + xrow1 + 2 * own)
    return rev + (4 * (rect + own) if kernel == "rev_fused_rings" else 0)


def scanres_tile_plan(grid: Grid) -> ScanresPlan:
    """The fused passes' plan for ``grid`` (the C side rejects any other)."""
    return ScanresPlan(TILE_Z, TILE_X, max(fused_smem(grid.radius, k) for k in FUSED_KERNELS))


def tile_row(by: int, n: int) -> int:
    """The tile row of block row ``by`` of ``n`` (``tile_row`` in
    csrc/acoustic2d_scanres.cu): the top two and bottom two rows first (0,
    n-1, 1, n-2), whose CPML-band tiles are the heavier ones, then the rest
    in order."""
    if n < 4:
        return by
    if by < 4:
        return n - 1 - (by >> 1) if by & 1 else by >> 1
    return by - 2


def fused_tiles(plan: ScanresPlan, NZ: int, NX: int):
    """The fused passes' tile walk over an (NZ, NX) grid, in block order
    (blockIdx.y, blockIdx.x): each tile's own cells ``(z0, z1, x0, x1)``,
    clipped to the grid (a ragged last tile holds fewer)."""
    n = -(-NZ // plan.tz)
    for by in range(n):
        z0 = tile_row(by, n) * plan.tz
        for x0 in range(0, NX, plan.tx):
            yield z0, min(z0 + plan.tz, NZ), x0, min(x0 + plan.tx, NX)


def strip_depth(grid: Grid) -> int:
    return grid.pml + grid.radius


def strip_profiles(grid: Grid, dt: float, c_max: float, f0: float, dtype=np.float32):
    """Each axis's (a, b) sliced to its two strips, (2, S) broadcast along
    the axis: 2D (az, bz, ax, bx) as (2,S,1), (2,1,S); 3D (ay, by, az, bz,
    ax, bx) as (2,S,1,1), (2,1,S,1), (2,1,1,S). With ``grid.free_surface``
    the low strip of the depth axis z (dim ndim - 2) is disabled (a = b =
    0)."""
    S = strip_depth(grid)
    z_axis = grid.ndim - 2
    out = []
    for ax_i in range(grid.ndim):
        prof = CpmlProfile.build(
            n=grid.shape[ax_i], pml=grid.pml, radius=grid.radius,
            h=grid.h[ax_i], dt=dt, c_max=c_max, f0=f0,
            free_lo=(grid.free_surface and ax_i == z_axis),
        )
        n_pad = grid.padded_shape[ax_i]
        shape = [2] + [1] * grid.ndim
        shape[1 + ax_i] = S
        for v in (prof.a, prof.b):
            out.append(np.stack([v[:S], v[n_pad - S:]]).astype(dtype).reshape(shape))
    return tuple(out)


def full_profiles(grid: Grid, profiles):
    """Strip profiles -> the twin's broadcast-shaped full-axis (a, b)."""
    S = strip_depth(grid)
    a, b = [], []
    for ax in range(grid.ndim):
        n = grid.padded_shape[ax]
        shape = [1] * grid.ndim
        shape[ax] = n
        for prof, out in ((profiles[2 * ax], a), (profiles[2 * ax + 1], b)):
            v = prof.new_zeros(n)
            v[:S] = prof[0].reshape(S)
            v[n - S:] = prof[1].reshape(S)
            out.append(v.reshape(shape))
    return tuple(a), tuple(b)


def interior_lap(grid: Grid, p: torch.Tensor) -> torch.Tensor:
    """D2-only laplacian over every axis: what a snapshot row holds and
    what images."""
    out = None
    for ax, h in enumerate(grid.h):
        term = apply_stencil(p, scaled_taps(D2_COEFFS[grid.order], h, 2), ax)
        out = term if out is None else out + term
    return out


@functools.lru_cache(maxsize=None)
def _ring_plan_cached(grid: Grid, device: torch.device):
    rings = RingSpec.build(grid)
    idx = rings.flat_index(grid.padded_shape, device=device)
    frame = tuple(v for n in grid.shape for v in (grid.pad, grid.pad + n)) + (grid.radius,)
    return idx, idx.to(torch.int32), frame


def ring_plan(grid: Grid, device):
    """(ring int64 index, the same as int32, the frame they tile: (lo, hi)
    of the physical interior per axis, then the ring width; (z0, z1, x0, x1,
    width) in 2D): the ring cells in tape-row order
    (``RingSpec.flat_index``)."""
    return _ring_plan_cached(grid, torch.device(device))


def impose_ring(p: torch.Tensor, ring_idx: torch.Tensor, row) -> torch.Tensor:
    """A copy of ``p`` with its ring cells set from a tape row (zeros when
    ``row`` is None)."""
    flat = p.reshape(-1).clone()
    flat[ring_idx] = 0.0 if row is None else row.to(p.dtype)
    return flat.reshape(p.shape)


# ------------------------------------------------------------ plain versions


def scanres_forward_plain(grid, c2, profiles, wavelet, src_idx, rcv_idx, tape=None,
                          illum=False):
    """Loop of the step twin. Returns (seis (nt, nrec), tape, P_{nt-2},
    P_{nt-1}, illum). ``tape="snap"``: (nt, NZ, NX) bf16, row t the D2-only
    laplacian of P_{t-1}, the field step t starts from. ``tape="rings"``:
    (nt, n_ring) in the wavefield dtype, row t the ring cells of P_t
    (``ring_plan`` order). ``tape=None``: no tape. ``illum``: also ``sum_t
    P_t^2`` on the padded grid (P_t after the sources and the surface pin),
    else None."""
    if tape not in TAPE_MODES:
        raise ValueError(f"unknown tape mode {tape!r}")
    NZ, NX = grid.padded_shape
    nt = wavelet.shape[0]
    a, b = full_profiles(grid, profiles)
    params = AcousticParams(c2, a, b, src_idx, rcv_idx)
    step = make_acoustic_step(grid)
    state = zero_state((NZ, NX), 2, c2.dtype, c2.device)
    ring_idx = ring_plan(grid, c2.device)[0] if tape == "rings" else None
    acc = torch.zeros_like(c2) if illum else None
    rows, seis = [], []
    for t in range(nt):
        if tape == "snap":
            rows.append(interior_lap(grid, state.p).to(torch.bfloat16))
        state, rec = step(state, params, wavelet[t])
        seis.append(rec)
        if tape == "rings":
            rows.append(state.p.reshape(-1)[ring_idx])
        if illum:
            acc += state.p**2
    return (torch.stack(seis), (torch.stack(rows) if tape else None), state.p_prev, state.p,
            acc)


def _reverse_plain(grid, c2, profiles, ybar, src_idx, rcv_idx, image):
    """Reverse loop: the transpose of the twin step from ``torch.func.vjp``
    (the step is affine in the state, so one linearization serves every
    step), imaging ``gbar += lambda_t * image(t)``, called for t descending.
    Returns (gbar (the padded grid) before the source-cell term and
    masking, lam_src (nt, nsrc)). Any dimension."""
    nt = ybar.shape[0]
    a, b = full_profiles(grid, profiles)
    params = AcousticParams(c2, a, b, src_idx, rcv_idx)
    step = make_acoustic_step(grid)
    zero = zero_state(grid.padded_shape, grid.ndim, c2.dtype, c2.device)
    _, step_t = torch.func.vjp(lambda s: step(s, params, 0.0), zero)
    rcv = tuple(rcv_idx[:, d] for d in range(grid.ndim))
    src = tuple(src_idx[:, d] for d in range(grid.ndim))
    fs = grid.pad if grid.free_surface else None
    gbar = torch.zeros_like(c2)
    lam_src = torch.empty((nt, src_idx.shape[0]), dtype=c2.dtype, device=c2.device)
    sbar = zero  # cotangent of the state after the last step
    for t in reversed(range(nt)):
        lam = sbar.p.index_put(rcv, ybar[t], accumulate=True)
        if fs is not None:  # the depth axis z is dim ndim - 2
            lam = lam.index_fill(grid.ndim - 2, torch.tensor([fs], device=c2.device), 0.0)
        lam_src[t] = lam[src]
        gbar += lam * image(t)
        (sbar,) = step_t((sbar, ybar[t]))
    return gbar, lam_src


def scanres_reverse_snap_plain(grid, c2, profiles, ybar, tape, src_idx, rcv_idx):
    """Snapshot reverse: images with the bf16 snapshot rows."""
    return _reverse_plain(grid, c2, profiles, ybar, src_idx, rcv_idx,
                          lambda t: tape[t].to(c2.dtype))


def scanres_reverse_plain(grid, c2, profiles, wavelet, ybar, tape, p_penult, p_last,
                          src_idx, rcv_idx, return_field=False):
    """Rings reverse: reconstructs P_{t-2} from P_{t-1} and P_t at each step
    t (``make_reverse_reconstruct_step``, then ring row t-2 imposed, zeros
    for t < 2) and images with the laplacian of P_{t-1}. ``return_field``
    adds the reconstructed P_{-1}, which is zero in exact arithmetic. Any
    dimension; the tape may be of another float type than the fields."""
    recon = make_reverse_reconstruct_step(grid)
    ring_idx = ring_plan(grid, c2.device)[0]
    fields = [p_penult, p_last]  # P_{t-1}, P_t

    def image(t):
        p_t, p_tp1 = fields
        p_tm1 = recon(p_t, p_tp1, c2, src_idx, wavelet[t])
        fields[:] = [impose_ring(p_tm1, ring_idx, tape[t - 2] if t >= 2 else None), p_t]
        return interior_lap(grid, p_t)

    gbar, lam_src = _reverse_plain(grid, c2, profiles, ybar, src_idx, rcv_idx, image)
    return (gbar, lam_src, fields[1]) if return_field else (gbar, lam_src)


# ------------------------------------------------------------------- build

# the whole-scan entry points' ctypes signatures (pointers, ints)
SCAN_SIGNATURES = {
    "tpufwi_scanres_forward": (15, 13),
    "tpufwi_scanres_reverse_snap": (13, 12),
    "tpufwi_scanres_reverse_rings": (15, 18),
}

LIBRARY = Library(
    "acoustic2d",
    (CSRC / "acoustic2d_scanres.cu", CSRC / "acoustic2d_step.cu",
     CSRC / "acoustic2d_kstep.cu"),
    (CSRC / "acoustic2d_kernels.cuh", CSRC / "pdl.cuh", CSRC / "cell_maps.cuh"),
    lambda lib: declare_all(lib, {
        # pointers..., ints..., taps, stream
        **SCAN_SIGNATURES,
        "tpufwi_step_forward": (15, 9),
        "tpufwi_step_recon": (8, 12),
        "tpufwi_step_adjoint": (15, 9),
        "tpufwi_leapfrog": (4, 3),
        "tpufwi_step_reverse": (19, 15),
        "tpufwi_kstep_forward": (14, 10),
        "tpufwi_kstep_reverse": (19, 16),
    }),
)


def load_library():
    """Build (once per version of the sources) and load the acoustic
    kernels' library: the three sources in one nvcc call."""
    return LIBRARY.load()


# ---------------------------------------------------------------- wrappers


@functools.lru_cache(maxsize=None)
def taps_arg(grid: Grid):
    """(d1z, d2z, d1x, d2x) as 4 x 9 fp32, zero-filled past 2R+1 taps; built
    once per grid (the kernels copy it at each call)."""
    taps = np.zeros((4, 9), np.float32)
    for row, (coeffs, h, power) in enumerate((
        (D1_COEFFS, grid.h[0], 1), (D2_COEFFS, grid.h[0], 2),
        (D1_COEFFS, grid.h[1], 1), (D2_COEFFS, grid.h[1], 2),
    )):
        t = scaled_taps(coeffs[grid.order], h, power)
        taps[row, : len(t)] = t
    return (ctypes.c_float * 36)(*taps.reshape(-1).tolist())


def check_args(name, grid, c2, profiles, vectors, src_idx, rcv_idx, bounds=True, dims=2,
               min_rcv=1):
    """Raise on what the ``dims``-D kernels do not take. ``bounds`` checks
    that the indices lie on the padded grid, at the cost of two host syncs;
    ``min_rcv`` is the fewest receivers the kernel takes. Each wait on the
    device counts in ``profiling``'s ``host_syncs``."""
    if grid.ndim != dims:
        raise ValueError(f"{name}: the kernel is {dims}D")
    if grid.radius not in (1, 2, 4):
        raise ValueError(f"{name}: unsupported order {grid.order}")
    dev = c2.device
    shape = grid.padded_shape
    if tuple(c2.shape) != shape:
        raise ValueError(f"{name}: c2 shape {tuple(c2.shape)} != padded grid {shape}")
    halo = int(np.prod([n + 2 * grid.radius for n in shape]))
    if halo >= 2**31:
        raise ValueError(f"{name}: {halo} halo cells exceed the kernels' int32 indexing")
    for t in (c2, *profiles, *vectors):
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: float tensors must be contiguous fp32 on {dev}")
    S = strip_depth(grid)
    if tuple(p.numel() for p in profiles) != (2 * S,) * (2 * dims):
        raise ValueError(f"{name}: strip profiles must hold 2 x {S} values each")
    for idx, least in ((src_idx, 1), (rcv_idx, min_rcv)):
        if (idx.device != dev or idx.dtype != torch.int64 or not idx.is_contiguous()
                or idx.ndim != 2 or idx.shape[1] != dims or idx.shape[0] < least):
            raise ValueError(f"{name}: indices must be contiguous (n>0, {dims}) int64 on {dev}")
    if bounds:
        both = torch.cat([src_idx, rcv_idx])
        hi = torch.tensor(shape, device=dev)  # a copy from pageable memory: waits
        profiling.count("host_syncs")
        outside = bool(((both < 0) | (both >= hi)).any())  # the answer's copy back: waits
        profiling.count("host_syncs")
        if outside:
            raise ValueError(f"{name}: source or receiver index outside the padded grid")


def require_cuda(name, c2):
    if c2.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {c2.device}")


def surface_row(grid: Grid) -> int:
    """The pinned free-surface row of the padded grid, -1 for none."""
    return grid.pad if grid.free_surface else -1


def _ptr(t):
    return None if t is None else t.data_ptr()


def _maps(grid, nsrc, nrec, dev):
    """The fused passes' zeroed int maps (``SMaps``): three (NZ, NX) cell
    maps, a flag word per tile, the source and receiver chains."""
    NZ, NX = grid.padded_shape
    plan = scanres_tile_plan(grid)
    tiles = -(-NZ // plan.tz) * -(-NX // plan.tx)
    return torch.zeros(3 * NZ * NX + tiles + nsrc + nrec, dtype=torch.int32, device=dev)


def _pass_attrs(NZ, NX, R, S, nsrc, nrec, tape) -> dict:
    """A call's ``kernels.*`` span attributes from which its operations and
    bytes can be counted: the padded grid, the stencil radius, the strip
    depth, the sources, the receivers and the tape mode."""
    return dict(NZ=NZ, NX=NX, radius=R, strip=S, nsrc=nsrc, nrec=nrec, tape=tape)


def scanres_forward(grid, c2, profiles, wavelet, src_idx, rcv_idx, tape=None, illum=False,
                    dependent_launch=True):
    """Whole forward propagation (see ``scanres_forward_plain`` for the
    contract). ``profiles`` are the strip profiles as tensors; ``rcv_idx``
    may hold no receiver. ``dependent_launch``: the steps as programmatic
    dependents (False: plain stream order; the CPU path has neither)."""
    if c2.device.type == "cpu":
        return scanres_forward_plain(grid, c2, profiles, wavelet, src_idx, rcv_idx, tape,
                                     illum)
    require_cuda("scanres_forward", c2)
    if tape not in TAPE_MODES:
        raise ValueError(f"unknown tape mode {tape!r}")
    check_args("scanres_forward", grid, c2, profiles, (wavelet,), src_idx, rcv_idx, min_rcv=0)
    if wavelet.ndim != 1 or wavelet.shape[0] == 0:
        raise ValueError("scanres_forward: wavelet must be (nt,) with nt > 0")
    lib = load_library()
    NZ, NX = grid.padded_shape
    R, S = grid.radius, strip_depth(grid)
    nt, nrec = wavelet.shape[0], rcv_idx.shape[0]
    dev = c2.device
    seis = torch.empty((nt, nrec), dtype=torch.float32, device=dev)
    snap = ring = rows = None
    n_ring = 0
    if tape == "snap":
        snap = torch.empty((nt, NZ, NX), dtype=torch.bfloat16, device=dev)
    elif tape == "rings":
        ring = ring_plan(grid, dev)[1]
        n_ring = ring.shape[0]
        rows = torch.empty((nt, n_ring), dtype=torch.float32, device=dev)
    acc = torch.zeros((NZ, NX), dtype=torch.float32, device=dev) if illum else None
    ws = torch.zeros((_FWD_PLANES, NZ + 2 * R, NX + 2 * R), dtype=torch.float32, device=dev)
    nsrc = src_idx.shape[0]
    iws = _maps(grid, nsrc, nrec, dev)
    fs = surface_row(grid)
    with torch.cuda.device(dev), profiling.span(
            "kernels.forward", device=dev, wrapper="scanres_forward", nt=nt,
            tape_bytes=sum(t.nbytes for t in (snap, rows) if t is not None),
            **_pass_attrs(NZ, NX, R, S, nsrc, nrec, tape)):
        err = lib.tpufwi_scanres_forward(
            c2.data_ptr(), *(p.data_ptr() for p in profiles), wavelet.data_ptr(),
            src_idx.data_ptr(), rcv_idx.data_ptr(), seis.data_ptr(), _ptr(snap), _ptr(ring),
            _ptr(rows), _ptr(acc), ws.data_ptr(), iws.data_ptr(),
            NZ, NX, S, R, nt, nsrc, nrec, fs, n_ring, *scanres_tile_plan(grid),
            int(dependent_launch), taps_arg(grid), torch.cuda.current_stream().cuda_stream,
        )
    raise_on(lib, "scanres_forward", err)
    scanres_forward.launches += nt
    last, penult = (ws[0], ws[1]) if (nt - 1) % 2 == 0 else (ws[1], ws[0])
    return (seis, (snap if tape == "snap" else rows), penult[R:-R, R:-R], last[R:-R, R:-R],
            acc)


scanres_forward.launches = 0


def _check_ybar(name, ybar, rcv_idx):
    if ybar.ndim != 2 or ybar.shape[0] == 0 or ybar.shape[1] != rcv_idx.shape[0]:
        raise ValueError(f"{name}: ybar must be (nt > 0, nrec)")


def scanres_reverse_snap(grid, c2, profiles, ybar, tape, src_idx, rcv_idx,
                         dependent_launch=True):
    """Snapshot reverse (see ``scanres_reverse_snap_plain`` for the
    contract); ``dependent_launch`` as ``scanres_forward``'s."""
    if c2.device.type == "cpu":
        return scanres_reverse_snap_plain(grid, c2, profiles, ybar, tape, src_idx, rcv_idx)
    require_cuda("scanres_reverse_snap", c2)
    check_args("scanres_reverse_snap", grid, c2, profiles, (ybar,), src_idx, rcv_idx)
    NZ, NX = grid.padded_shape
    _check_ybar("scanres_reverse_snap", ybar, rcv_idx)
    nt, nrec = ybar.shape
    if (tape.dtype != torch.bfloat16 or tuple(tape.shape) != (nt, NZ, NX)
            or tape.device != c2.device or not tape.is_contiguous()):
        raise ValueError(f"scanres_reverse_snap: tape must be contiguous bf16 {(nt, NZ, NX)}")
    lib = load_library()
    R, S = grid.radius, strip_depth(grid)
    nsrc = src_idx.shape[0]
    gbar = torch.zeros((NZ, NX), dtype=torch.float32, device=c2.device)
    lam_src = torch.empty((nt, nsrc), dtype=torch.float32, device=c2.device)
    ws = torch.zeros((_REV_SNAP_PLANES, NZ + 2 * R, NX + 2 * R), dtype=torch.float32,
                     device=c2.device)
    iws = _maps(grid, nsrc, nrec, c2.device)
    fs = surface_row(grid)
    with torch.cuda.device(c2.device), profiling.span(
            "kernels.reverse", device=c2.device, wrapper="scanres_reverse_snap", nt=nt,
            tape_bytes=0, **_pass_attrs(NZ, NX, R, S, nsrc, nrec, "snap")):
        err = lib.tpufwi_scanres_reverse_snap(
            c2.data_ptr(), *(p.data_ptr() for p in profiles), ybar.data_ptr(),
            tape.data_ptr(), src_idx.data_ptr(), rcv_idx.data_ptr(), gbar.data_ptr(),
            lam_src.data_ptr(), ws.data_ptr(), iws.data_ptr(),
            NZ, NX, S, R, nt, nsrc, nrec, fs, *scanres_tile_plan(grid), int(dependent_launch),
            taps_arg(grid), torch.cuda.current_stream().cuda_stream,
        )
    raise_on(lib, "scanres_reverse_snap", err)
    scanres_reverse_snap.launches += nt
    return gbar, lam_src


scanres_reverse_snap.launches = 0


def scanres_reverse(grid, c2, profiles, wavelet, ybar, tape, p_penult, p_last,
                    src_idx, rcv_idx, return_field=False, dependent_launch=True):
    """Rings reverse (see ``scanres_reverse_plain`` for the contract):
    ``tape`` is the (nt, n_ring) fp32 ring tape and ``p_penult``, ``p_last``
    the last two fields of ``scanres_forward(..., tape="rings")``;
    ``dependent_launch`` as ``scanres_forward``'s."""
    if c2.device.type == "cpu":
        return scanres_reverse_plain(grid, c2, profiles, wavelet, ybar, tape, p_penult,
                                     p_last, src_idx, rcv_idx, return_field)
    require_cuda("scanres_reverse", c2)
    check_args("scanres_reverse", grid, c2, profiles, (wavelet, ybar, tape), src_idx, rcv_idx)
    NZ, NX = grid.padded_shape
    _check_ybar("scanres_reverse", ybar, rcv_idx)
    nt, nrec = ybar.shape
    _, ring, (z0, z1, x0, x1, rw) = ring_plan(grid, c2.device)
    n_ring = ring.shape[0]
    if tuple(wavelet.shape) != (nt,) or tuple(tape.shape) != (nt, n_ring):
        raise ValueError(f"scanres_reverse: wavelet must be ({nt},), tape ({nt}, {n_ring})")
    for f in (p_penult, p_last):
        if tuple(f.shape) != (NZ, NX) or f.device != c2.device or f.dtype != torch.float32:
            raise ValueError(f"scanres_reverse: final fields must be fp32 {(NZ, NX)}")
    lib = load_library()
    R, S = grid.radius, strip_depth(grid)
    nsrc = src_idx.shape[0]
    gbar = torch.zeros((NZ, NX), dtype=torch.float32, device=c2.device)
    lam_src = torch.empty((nt, nsrc), dtype=torch.float32, device=c2.device)
    ws = torch.zeros((_REV_RINGS_PLANES, NZ + 2 * R, NX + 2 * R), dtype=torch.float32,
                     device=c2.device)
    ws[0, R:-R, R:-R] = p_last
    ws[1, R:-R, R:-R] = p_penult
    iws = _maps(grid, nsrc, nrec, c2.device)
    fs = surface_row(grid)
    with torch.cuda.device(c2.device), profiling.span(
            "kernels.reverse", device=c2.device, wrapper="scanres_reverse", nt=nt,
            tape_bytes=0, **_pass_attrs(NZ, NX, R, S, nsrc, nrec, "rings")):
        err = lib.tpufwi_scanres_reverse_rings(
            c2.data_ptr(), *(p.data_ptr() for p in profiles), wavelet.data_ptr(),
            ybar.data_ptr(), tape.data_ptr(), ring.data_ptr(), src_idx.data_ptr(),
            rcv_idx.data_ptr(), gbar.data_ptr(), lam_src.data_ptr(), ws.data_ptr(),
            iws.data_ptr(),
            NZ, NX, S, R, nt, nsrc, nrec, fs, n_ring, z0, z1, x0, x1, rw,
            *scanres_tile_plan(grid), int(dependent_launch), taps_arg(grid),
            torch.cuda.current_stream().cuda_stream,
        )
    raise_on(lib, "scanres_reverse", err)
    scanres_reverse.launches += nt
    if not return_field:
        return gbar, lam_src
    # the loop swaps its two field planes every step: P_{-1} ends in plane
    # 0 after an even number of steps
    return gbar, lam_src, ws[nt % 2, R:-R, R:-R]


scanres_reverse.launches = 0
