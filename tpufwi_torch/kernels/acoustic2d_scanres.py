"""The whole-scan engines' three kernels: CUDA wrappers, their plain torch
versions and their launch counters (counterpart of
``tpufwi/kernels/acoustic2d_pallas_scanres.py`` and of ``strip_profiles`` /
``strip_depth`` in ``tpufwi/kernels/acoustic2d_pallas.py``), and the build
of the kernels' library.

``scanres_forward`` runs the whole 2D acoustic time loop and, on request,
records a tape: ``"snap"``, the bf16 D2-only interior laplacian of the field
each step starts from, or ``"rings"``, the fp32 boundary ring of the field
each step ends with. ``scanres_reverse_snap`` runs the exact transposed step
backwards over the snapshot tape; ``scanres_reverse`` reconstructs the
field backwards from the last two fields and the ring tape, and images with
the laplacian of the reconstruction. Both return the imaged gradient and
the adjoint field at the sources. The CUDA sources are
``csrc/acoustic2d_scanres.cu`` and ``csrc/acoustic2d_kernels.cuh``.

Each wrapper takes its plain version for tensors on the CPU, and only
then; on a CUDA tensor it launches the kernel or raises. ``launches`` on
each wrapper counts the time steps its kernel ran (the C loop launches
each step's kernels once), and stays 0 on the CPU path.

``load_library`` builds every ``csrc/*.cu`` into one library with one
nvcc call at first use, into ``tpufwi_torch/_build``; neither this module's
import nor the plain versions need CUDA.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import torch

from ..cpml import CpmlProfile
from ..grid import D1_COEFFS, D2_COEFFS, Grid
from ..propagators.boundary import RingSpec
from .acoustic2d_eager import (
    AcousticParams,
    make_acoustic_step,
    make_reverse_reconstruct_step,
    zero_state,
)
from .stencils import apply_stencil, scaled_taps

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
SOURCES = (CSRC / "acoustic2d_scanres.cu", CSRC / "acoustic2d_step.cu")
HEADERS = (CSRC / "acoustic2d_kernels.cuh",)
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_FWD_PLANES = 6  # pa, pb, phi_z, psi_z, phi_x, psi_x
_ADJ_PLANES = 9  # u, then psibar/w/phibar/y for z and for x
_REV_SNAP_PLANES = 2 + _ADJ_PLANES  # q0, q1, adjoint planes
_REV_RINGS_PLANES = 4 + _ADJ_PLANES  # P_t, P_{t-1}, q0, q1, adjoint planes
TAPE_MODES = (None, "snap", "rings")


def strip_depth(grid: Grid) -> int:
    return grid.pml + grid.radius


def strip_profiles(grid: Grid, dt: float, c_max: float, f0: float, dtype=np.float32):
    """(az, bz, ax, bx) sliced to the strips: az/bz (2,S,1), ax/bx (2,1,S).
    With ``grid.free_surface`` the top z strip is disabled (a = b = 0)."""
    S = strip_depth(grid)
    out = []
    for ax_i in range(2):
        prof = CpmlProfile.build(
            n=grid.shape[ax_i], pml=grid.pml, radius=grid.radius,
            h=grid.h[ax_i], dt=dt, c_max=c_max, f0=f0,
            free_lo=(grid.free_surface and ax_i == 0),
        )
        n_pad = grid.padded_shape[ax_i]
        a2 = np.stack([prof.a[:S], prof.a[n_pad - S:]]).astype(dtype)
        b2 = np.stack([prof.b[:S], prof.b[n_pad - S:]]).astype(dtype)
        if ax_i == 0:
            out += [a2[:, :, None], b2[:, :, None]]
        else:
            out += [a2[:, None, :], b2[:, None, :]]
    return tuple(out)


def full_profiles(grid: Grid, profiles):
    """Strip profiles -> the twin's broadcast-shaped full-axis (a, b)."""
    NZ, NX = grid.padded_shape
    S = strip_depth(grid)
    full = []
    for prof, n, shape in zip(profiles, (NZ, NZ, NX, NX),
                              ((NZ, 1), (NZ, 1), (1, NX), (1, NX))):
        v = prof.new_zeros(n)
        v[:S] = prof[0].reshape(S)
        v[n - S:] = prof[1].reshape(S)
        full.append(v.reshape(shape))
    az, bz, ax, bx = full
    return (az, ax), (bz, bx)


def interior_lap(grid: Grid, p: torch.Tensor) -> torch.Tensor:
    """D2-only laplacian: what a snapshot row holds and what images."""
    d2 = [scaled_taps(D2_COEFFS[grid.order], h, 2) for h in grid.h]
    return apply_stencil(p, d2[0], 0) + apply_stencil(p, d2[1], 1)


@functools.lru_cache(maxsize=None)
def _ring_plan_cached(grid: Grid, device: torch.device):
    rings = RingSpec.build(grid)
    idx = rings.flat_index(grid.padded_shape, device=device)
    frame = (grid.pad, grid.pad + grid.shape[0], grid.pad, grid.pad + grid.shape[1],
             grid.radius)
    return idx, idx.to(torch.int32), frame


def ring_plan(grid: Grid, device):
    """(ring int64 index, the same as int32, (z0, z1, x0, x1, width)): the
    ring cells in tape-row order (``RingSpec.flat_index``) and the frame
    they tile."""
    return _ring_plan_cached(grid, torch.device(device))


def impose_ring(p: torch.Tensor, ring_idx: torch.Tensor, row) -> torch.Tensor:
    """A copy of ``p`` with its ring cells set from a tape row (zeros when
    ``row`` is None)."""
    flat = p.reshape(-1).clone()
    flat[ring_idx] = 0.0 if row is None else row.to(p.dtype)
    return flat.reshape(p.shape)


# ------------------------------------------------------------ plain versions


def scanres_forward_plain(grid, c2, profiles, wavelet, src_idx, rcv_idx, tape=None):
    """Loop of the step twin. Returns (seis (nt, nrec), tape, P_{nt-2},
    P_{nt-1}). ``tape="snap"``: (nt, NZ, NX) bf16, row t the D2-only
    laplacian of P_{t-1}, the field step t starts from. ``tape="rings"``:
    (nt, n_ring) in the wavefield dtype, row t the ring cells of P_t
    (``ring_plan`` order). ``tape=None``: no tape."""
    if tape not in TAPE_MODES:
        raise ValueError(f"unknown tape mode {tape!r}")
    NZ, NX = grid.padded_shape
    nt = wavelet.shape[0]
    a, b = full_profiles(grid, profiles)
    params = AcousticParams(c2, a, b, src_idx, rcv_idx)
    step = make_acoustic_step(grid)
    state = zero_state((NZ, NX), 2, c2.dtype, c2.device)
    ring_idx = ring_plan(grid, c2.device)[0] if tape == "rings" else None
    rows, seis = [], []
    for t in range(nt):
        if tape == "snap":
            rows.append(interior_lap(grid, state.p).to(torch.bfloat16))
        state, rec = step(state, params, wavelet[t])
        seis.append(rec)
        if tape == "rings":
            rows.append(state.p.reshape(-1)[ring_idx])
    return torch.stack(seis), (torch.stack(rows) if tape else None), state.p_prev, state.p


def _reverse_plain(grid, c2, profiles, ybar, src_idx, rcv_idx, image):
    """Reverse loop: the transpose of the twin step from ``torch.func.vjp``
    (the step is affine in the state, so one linearization serves every
    step), imaging ``gbar += lambda_t * image(t)``, called for t descending.
    Returns (gbar (NZ, NX) before the source-cell term and masking,
    lam_src (nt, nsrc))."""
    NZ, NX = grid.padded_shape
    nt = ybar.shape[0]
    a, b = full_profiles(grid, profiles)
    params = AcousticParams(c2, a, b, src_idx, rcv_idx)
    step = make_acoustic_step(grid)
    zero = zero_state((NZ, NX), 2, c2.dtype, c2.device)
    _, step_t = torch.func.vjp(lambda s: step(s, params, 0.0), zero)
    rz, rx = rcv_idx[:, 0], rcv_idx[:, 1]
    sz, sx = src_idx[:, 0], src_idx[:, 1]
    fs = grid.pad if grid.free_surface else None
    gbar = torch.zeros_like(c2)
    lam_src = torch.empty((nt, src_idx.shape[0]), dtype=c2.dtype, device=c2.device)
    sbar = zero  # cotangent of the state after the last step
    for t in reversed(range(nt)):
        lam = sbar.p.index_put((rz, rx), ybar[t], accumulate=True)
        if fs is not None:
            lam = lam.index_fill(0, torch.tensor([fs], device=c2.device), 0.0)
        lam_src[t] = lam[sz, sx]
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
    adds the reconstructed P_{-1}, which is zero in exact arithmetic."""
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

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of this process's build, None if none ran


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       f"{CSRC} at first use and need the CUDA toolkit")


def _declare(lib):
    P, I = ctypes.c_void_p, ctypes.c_int
    F = ctypes.POINTER(ctypes.c_float)  # host taps
    sigs = {
        # pointers..., ints..., taps, stream
        "tpufwi_scanres_forward": (13, 9),
        "tpufwi_scanres_reverse_snap": (13, 8),
        "tpufwi_scanres_reverse_rings": (15, 14),
        "tpufwi_step_forward": (14, 9),
        "tpufwi_step_recon": (8, 12),
        "tpufwi_step_adjoint": (15, 9),
    }
    for name, (n_ptr, n_int) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = [P] * n_ptr + [I] * n_int + [F, P]
        fn.restype = I
    lib.tpufwi_error_string.argtypes = [I]
    lib.tpufwi_error_string.restype = ctypes.c_char_p


def load_library() -> ctypes.CDLL:
    """Build (once per version of the sources) and load the kernels'
    library: every source in one nvcc call."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
        for path in SOURCES + HEADERS:
            digest.update(path.read_bytes())
        tag = digest.hexdigest()[:12]
        so = BUILD_DIR / f"libacoustic2d_{tag}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            t0 = time.perf_counter()
            res = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)],
                capture_output=True, text=True,
            )
            build_seconds = time.perf_counter() - t0
            (BUILD_DIR / f"build_{tag}.log").write_text(res.stdout + res.stderr)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        _declare(lib)
        _lib = lib
        return lib


# ---------------------------------------------------------------- wrappers


def taps_arg(grid: Grid):
    """(d1z, d2z, d1x, d2x) as 4 x 9 fp32, zero-filled past 2R+1 taps."""
    taps = np.zeros((4, 9), np.float32)
    for row, (coeffs, h, power) in enumerate((
        (D1_COEFFS, grid.h[0], 1), (D2_COEFFS, grid.h[0], 2),
        (D1_COEFFS, grid.h[1], 1), (D2_COEFFS, grid.h[1], 2),
    )):
        t = scaled_taps(coeffs[grid.order], h, power)
        taps[row, : len(t)] = t
    return (ctypes.c_float * 36)(*taps.reshape(-1).tolist())


def check_args(name, grid, c2, profiles, vectors, src_idx, rcv_idx, bounds=True):
    """Raise on what the kernels do not take. ``bounds`` checks that the
    indices lie on the padded grid, at the cost of one host sync."""
    if grid.ndim != 2:
        raise ValueError(f"{name}: the kernel is 2D")
    if grid.radius not in (1, 2, 4):
        raise ValueError(f"{name}: unsupported order {grid.order}")
    dev = c2.device
    NZ, NX = grid.padded_shape
    if tuple(c2.shape) != (NZ, NX):
        raise ValueError(f"{name}: c2 shape {tuple(c2.shape)} != padded grid {(NZ, NX)}")
    for t in (c2, *profiles, *vectors):
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: float tensors must be contiguous fp32 on {dev}")
    S = strip_depth(grid)
    if tuple(p.numel() for p in profiles) != (2 * S,) * 4:
        raise ValueError(f"{name}: strip profiles must hold 2 x {S} values each")
    for idx in (src_idx, rcv_idx):
        if (idx.device != dev or idx.dtype != torch.int64 or not idx.is_contiguous()
                or idx.ndim != 2 or idx.shape[1] != 2 or idx.shape[0] == 0):
            raise ValueError(f"{name}: indices must be contiguous (n>0, 2) int64 on {dev}")
    if bounds:
        both = torch.cat([src_idx, rcv_idx])
        hi = torch.tensor([NZ, NX], device=dev)
        if bool(((both < 0) | (both >= hi)).any()):  # one host sync per call
            raise ValueError(f"{name}: source or receiver index outside the padded grid")


def raise_on(lib, name, err):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}: "
                           f"{lib.tpufwi_error_string(err).decode()}")


def require_cuda(name, c2):
    if c2.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {c2.device}")


def surface_row(grid: Grid) -> int:
    """The pinned free-surface row of the padded grid, -1 for none."""
    return grid.pad if grid.free_surface else -1


def _ptr(t):
    return None if t is None else t.data_ptr()


def scanres_forward(grid, c2, profiles, wavelet, src_idx, rcv_idx, tape=None):
    """Whole forward propagation (see ``scanres_forward_plain`` for the
    contract). ``profiles`` are the strip profiles as tensors."""
    if c2.device.type == "cpu":
        return scanres_forward_plain(grid, c2, profiles, wavelet, src_idx, rcv_idx, tape)
    require_cuda("scanres_forward", c2)
    if tape not in TAPE_MODES:
        raise ValueError(f"unknown tape mode {tape!r}")
    check_args("scanres_forward", grid, c2, profiles, (wavelet,), src_idx, rcv_idx)
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
    ws = torch.zeros((_FWD_PLANES, NZ + 2 * R, NX + 2 * R), dtype=torch.float32, device=dev)
    fs = surface_row(grid)
    with torch.cuda.device(dev):
        err = lib.tpufwi_scanres_forward(
            c2.data_ptr(), *(p.data_ptr() for p in profiles), wavelet.data_ptr(),
            src_idx.data_ptr(), rcv_idx.data_ptr(), seis.data_ptr(), _ptr(snap), _ptr(ring),
            _ptr(rows), ws.data_ptr(),
            NZ, NX, S, R, nt, src_idx.shape[0], nrec, fs, n_ring, taps_arg(grid),
            torch.cuda.current_stream().cuda_stream,
        )
    raise_on(lib, "scanres_forward", err)
    scanres_forward.launches += nt
    last, penult = (ws[0], ws[1]) if (nt - 1) % 2 == 0 else (ws[1], ws[0])
    return seis, (snap if tape == "snap" else rows), penult[R:-R, R:-R], last[R:-R, R:-R]


scanres_forward.launches = 0


def _check_ybar(name, ybar, rcv_idx):
    if ybar.ndim != 2 or ybar.shape[0] == 0 or ybar.shape[1] != rcv_idx.shape[0]:
        raise ValueError(f"{name}: ybar must be (nt > 0, nrec)")


def scanres_reverse_snap(grid, c2, profiles, ybar, tape, src_idx, rcv_idx):
    """Snapshot reverse (see ``scanres_reverse_snap_plain`` for the
    contract)."""
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
    chain = torch.empty(2 * nrec, dtype=torch.int32, device=c2.device)
    fs = surface_row(grid)
    with torch.cuda.device(c2.device):
        err = lib.tpufwi_scanres_reverse_snap(
            c2.data_ptr(), *(p.data_ptr() for p in profiles), ybar.data_ptr(),
            tape.data_ptr(), src_idx.data_ptr(), rcv_idx.data_ptr(), gbar.data_ptr(),
            lam_src.data_ptr(), ws.data_ptr(), chain.data_ptr(),
            NZ, NX, S, R, nt, nsrc, nrec, fs, taps_arg(grid),
            torch.cuda.current_stream().cuda_stream,
        )
    raise_on(lib, "scanres_reverse_snap", err)
    scanres_reverse_snap.launches += nt
    return gbar, lam_src


scanres_reverse_snap.launches = 0


def scanres_reverse(grid, c2, profiles, wavelet, ybar, tape, p_penult, p_last,
                    src_idx, rcv_idx, return_field=False):
    """Rings reverse (see ``scanres_reverse_plain`` for the contract):
    ``tape`` is the (nt, n_ring) fp32 ring tape and ``p_penult``, ``p_last``
    the last two fields of ``scanres_forward(..., tape="rings")``."""
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
    chain = torch.empty(2 * nrec, dtype=torch.int32, device=c2.device)
    fs = surface_row(grid)
    with torch.cuda.device(c2.device):
        err = lib.tpufwi_scanres_reverse_rings(
            c2.data_ptr(), *(p.data_ptr() for p in profiles), wavelet.data_ptr(),
            ybar.data_ptr(), tape.data_ptr(), ring.data_ptr(), src_idx.data_ptr(),
            rcv_idx.data_ptr(), gbar.data_ptr(), lam_src.data_ptr(), ws.data_ptr(),
            chain.data_ptr(),
            NZ, NX, S, R, nt, nsrc, nrec, fs, n_ring, z0, z1, x0, x1, rw, taps_arg(grid),
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
