"""The machine-model probes: CUDA wrappers, their plain torch versions and
their launch counters (counterpart of the TPU kernels of
``scripts/exp_2d_scanres.py`` and ``scripts/exp_3d_lap.py``). No engine
runs them; the scripts that run them are ``bench/exp_2d_scanres.py`` and
``bench/exp_3d_lap.py``.

- ``scan_probe(grid, c2, profiles, p_prev, p, nt, strips)``: P_nt on the
  padded grid after nt leapfrog steps from P_{-1} = ``p_prev`` and P_0 =
  ``p`` with zero Dirichlet borders, no sources or receivers; with
  ``strips`` the CPML strip work too, its memories starting at zero (the
  reference's probes P1 and P0, ``make_probe``). The reference starts from
  (seed, 0.999 seed) and returns the window ``[0:8, 0:128]`` of this field.
  ``launches`` counts time steps, as the whole-scan forward's does.
- ``tap_probe(p, K)``: per (16, 64, NX) block of an (NY, NZ, NX) array,
  ``out = sum_k (0.1 + 0.01 k) blk[y + oy_k, z + oz_k, x + ox_k]`` for k <
  K (5 or 25), tap k at k % 9 - 4 along axis k % 3 (y, z, x) and at -4
  along the other two, as the reference's scratch slices read; a read
  outside the block reads 0 (``run_vmem_tap_bw``).
- ``stream_copy(p, variant, out)``: ``p + 1`` (``copy1`` and its block
  sweep); the variants differ only in how the card walks the array. The
  default ``"oneshot"`` is a one-shot grid, one float4 a thread;
  ``"bulk"`` a TMA pipeline (bulk loads on an mbarrier into a
  shared ring, bulk stores); ``"vec4"`` the flat grid-stride loop.
- ``stream_step5(pp, p, c2, staged)``: ``(pp + p) + c2`` (``staged``:
  ``(pp + c2) + p``, the order of ``step5s``), then per (16, 64) block the
  8-row halo slabs of ``p`` along y, then along z (``step5``, ``step5s``).
- ``stream_step5x(pp, p, c2, small)``: ``stream_step5``, and ``small[i] +
  small[i + 4]`` for i < 4 over eight (NY, NZ, 24) arrays (``make_step5x``).

Each wrapper takes its plain version for CPU tensors only; on a CUDA tensor
it launches its kernel or raises. The CUDA sources are
``csrc/acoustic2d_probe.cu`` (the 2D probe launches the production kernels
of ``csrc/acoustic2d_kernels.cuh``) and ``csrc/acoustic3d_probes.cu``, built
into their own library so the production libraries are not rebuilt.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from ..grid import Grid
from .acoustic2d_eager import AcousticParams, AcousticState, make_acoustic_step
from .acoustic2d_scanres import full_profiles, require_cuda, strip_depth, taps_arg
from .build import CSRC, Library, raise_on

# the reference's block geometry (scripts/exp_3d_lap.py :202-203, :295-296)
BY, BZ, H = 16, 64, 8
SS = 24  # the small streams' x width (:413)
TAP_KS = (5, 25)
# tap k reads at k % (2r + 1) - r along axis k % 3 (y, z, x) and at -r
# along the other two: the reference's scratch slices start r before the
# block on every axis (:205-219); reads land in the block's zero margins
R_TAP = 4
TAP_LO = (4, 4, 4)  # y, z, x margins below the block
TAP_HI = (2, 3, 4)  # and above it
# stream_copy's variants (the C entry point's codes 0-5) and the (y, z)
# tile each walks: (NY, NZ) must be multiples of it; the flat ones (1, 1)
# need 16-byte aligned arrays
COPY_TILES = {"vec4": (1, 1), "rows16x64": (16, 64), "rows8x128": (8, 128),
              "rows4x256": (4, 256), "oneshot": (1, 1), "bulk": (1, 1)}
COPY_VARIANTS = tuple(COPY_TILES)
COPY_DEFAULT = "oneshot"


def _declare(lib):
    P, I = ctypes.c_void_p, ctypes.c_int
    PP = ctypes.POINTER(ctypes.c_void_p)
    sigs = {
        "tpufwi_scan_probe": [P] * 8 + [I] * 6 + [ctypes.POINTER(ctypes.c_float), P],
        "tpufwi_tap_probe": [P, P] + [I] * 4 + [P],
        "tpufwi_stream_copy": [P, P] + [I] * 4 + [P],
        "tpufwi_stream_step5": [P] * 4 + [I] * 4 + [P],
        "tpufwi_stream_step5x": [P] * 4 + [PP, PP] + [I] * 3 + [P],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = I
    lib.tpufwi_error_string.argtypes = [I]
    lib.tpufwi_error_string.restype = ctypes.c_char_p


LIBRARY = Library(
    "probes",
    (CSRC / "acoustic2d_probe.cu", CSRC / "acoustic3d_probes.cu"),
    (CSRC / "acoustic2d_kernels.cuh", CSRC / "pdl.cuh"),
    _declare,
)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------- 2D probe


def scan_probe_plain(grid: Grid, c2, profiles, p_prev, p, nt: int, strips: bool = True):
    """The loop of the step twin with no sources or receivers (``strips``
    False: the profiles set to zero, so the step is the bare leapfrog)."""
    a, b = full_profiles(grid, profiles)
    if not strips:
        a, b = (tuple(torch.zeros_like(v) for v in x) for x in (a, b))
    none = torch.zeros((0, 2), dtype=torch.int64, device=c2.device)
    zero = torch.zeros_like(c2)
    state = AcousticState(p_prev, p, (zero, zero), (zero, zero))
    params = AcousticParams(c2, a, b, none, none)
    step = make_acoustic_step(grid)
    for _ in range(nt):
        state, _ = step(state, params, 0.0)
    return state.p


def scan_probe(grid: Grid, c2, profiles, p_prev, p, nt: int, strips: bool = True):
    """P_nt on the padded grid (see the module docstring): ``c2``,
    ``p_prev``, ``p`` on the padded grid, ``profiles`` the strip profiles
    (``acoustic2d_scanres.strip_profiles``) as tensors."""
    if c2.device.type == "cpu":
        return scan_probe_plain(grid, c2, profiles, p_prev, p, nt, strips)
    require_cuda("scan_probe", c2)
    if grid.ndim != 2 or grid.radius not in (1, 2, 4):
        raise ValueError("scan_probe: the kernel is 2D, order 2, 4 or 8")
    NZ, NX = grid.padded_shape
    S, R = strip_depth(grid), grid.radius
    for t in (c2, p_prev, p, *profiles):
        if t.device != c2.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"scan_probe: tensors must be contiguous fp32 on {c2.device}")
    if any(tuple(t.shape) != (NZ, NX) for t in (c2, p_prev, p)):
        raise ValueError(f"scan_probe: c2, p_prev and p must be {(NZ, NX)}")
    if tuple(t.numel() for t in profiles) != (2 * S,) * 4:
        raise ValueError(f"scan_probe: strip profiles must hold 2 x {S} values each")
    if nt < 0:
        raise ValueError("scan_probe: nt must be >= 0")
    # P_{-1}, P_0, then the CPML memories phi_z, psi_z, phi_x, psi_x
    ws = torch.zeros((6, NZ + 2 * R, NX + 2 * R), dtype=torch.float32, device=c2.device)
    ws[0, R:-R, R:-R] = p_prev
    ws[1, R:-R, R:-R] = p
    lib = LIBRARY.load()
    err = lib.tpufwi_scan_probe(
        c2.data_ptr(), *(t.data_ptr() for t in profiles), ws[0].data_ptr(), ws[1].data_ptr(),
        ws[2].data_ptr(), NZ, NX, S, R, nt, int(strips), taps_arg(grid), _stream(c2))
    raise_on(lib, "scan_probe", err)
    scan_probe.launches += nt
    return ws[1 - nt % 2, R:-R, R:-R]


scan_probe.launches = 0


# ------------------------------------------------------------- 3D probes


def _check3d(name, arrays, blocked=True):
    dev = arrays[0].device
    shape = tuple(arrays[0].shape)
    for a in arrays:
        if (a.device != dev or a.dtype != torch.float32 or not a.is_contiguous()
                or a.ndim != 3):
            raise ValueError(f"{name}: arrays must be contiguous 3D fp32 on {dev}")
    if any(tuple(a.shape) != shape for a in arrays):
        raise ValueError(f"{name}: arrays must share the shape {shape}")
    NY, NZ, NX = shape
    if blocked and (NY % BY or NZ % BZ or not NY < 2**16):
        raise ValueError(f"{name}: (NY, NZ) must be multiples of ({BY}, {BZ}), NY < 65536")
    return shape


def _tap_offsets(k: int):
    o = [-R_TAP] * 3
    o[k % 3] = k % (2 * R_TAP + 1) - R_TAP
    return o


def tap_weight(k: int) -> float:
    """Tap k's weight as the reference's fp32 kernel sees it."""
    return float(np.float32(0.1 + 0.01 * k))


def tap_probe_plain(p, K: int):
    """The array viewed as its blocks, each zero-padded by its own margins,
    and the K weighted shifted slices summed in the reference's k order: no
    convolution (cuDNN's fp32 convolution may take TF32, and the padding is
    per block)."""
    NY, NZ, NX = p.shape
    blocks = p.reshape(NY // BY, BY, NZ // BZ, BZ, NX)
    (ly, lz, lx), (hy, hz, hx) = TAP_LO, TAP_HI
    padded = F.pad(blocks, (lx, hx, lz, hz, 0, 0, ly, hy))
    acc = None
    for k in range(K):
        oy, oz, ox = _tap_offsets(k)
        t = tap_weight(k) * padded[:, ly + oy:ly + oy + BY, :, lz + oz:lz + oz + BZ,
                                   lx + ox:lx + ox + NX]
        acc = t if acc is None else acc + t
    return acc.reshape(NY, NZ, NX)


def tap_probe(p, K: int):
    """The K-tap sum of ``p`` (see the module docstring), a new array."""
    if p.device.type == "cpu":
        return tap_probe_plain(p, K)
    require_cuda("tap_probe", p)
    NY, NZ, NX = _check3d("tap_probe", (p,))
    if K not in TAP_KS:
        raise ValueError(f"tap_probe: K must be one of {TAP_KS}")
    out = torch.empty_like(p)
    lib = LIBRARY.load()
    err = lib.tpufwi_tap_probe(p.data_ptr(), out.data_ptr(), NY, NZ, NX, K, _stream(p))
    raise_on(lib, "tap_probe", err)
    tap_probe.launches += 1
    return out


tap_probe.launches = 0


def stream_copy_plain(p):
    return p + 1.0


def stream_copy(p, variant: str = COPY_DEFAULT, out=None):
    """``p + 1``, into ``out`` (a new array when None), the card walking it
    as ``variant`` (one of ``COPY_VARIANTS``: flat float4 walks, or scalar
    rows over the reference's (16, 64), (8, 128) or (4, 256) (y, z)
    tiles)."""
    if p.device.type == "cpu":
        return stream_copy_plain(p) if out is None else torch.add(p, 1.0, out=out)
    require_cuda("stream_copy", p)
    if variant not in COPY_VARIANTS:
        raise ValueError(f"stream_copy: variant must be one of {COPY_VARIANTS}")
    NY, NZ, NX = _check3d("stream_copy", (p,), blocked=False)
    code = COPY_VARIANTS.index(variant)
    by, bz = COPY_TILES[variant]
    if NY % by or NZ % bz:
        raise ValueError(f"stream_copy: {variant} needs (NY, NZ) multiples of ({by}, {bz})")
    if out is None:
        out = torch.empty_like(p)
    elif (out.shape != p.shape or out.dtype != p.dtype or out.device != p.device
          or not out.is_contiguous()):
        raise ValueError("stream_copy: out must be a contiguous array like p")
    if (by, bz) == (1, 1) and (p.data_ptr() % 16 or out.data_ptr() % 16):
        raise ValueError(f"stream_copy: {variant} needs 16-byte aligned arrays")
    lib = LIBRARY.load()
    err = lib.tpufwi_stream_copy(p.data_ptr(), out.data_ptr(), NY, NZ, NX, code, _stream(p))
    raise_on(lib, "stream_copy", err)
    stream_copy.launches += 1
    return out


stream_copy.launches = 0


def halo_rows(n: int, b: int) -> np.ndarray:
    """For each row y of an axis of n rows in blocks of b, the row whose
    8-deep halo slab value it adds: the slab below its block for the
    block's low 8 rows (rows [0, 8) for the first block), the slab above
    for its high 8 (the axis's last 8 rows for the last block); -1 for the
    rows between, which add none (``step5``'s index maps, :308-323)."""
    y = np.arange(n)
    g, lo = y // b, y % b
    rows = np.full(n, -1)
    low = lo < H
    rows[low] = np.where(g[low] == 0, lo[low], y[low] - H)
    high = lo >= b - H
    rows[high] = np.where((g[high] + 1) * b < n, y[high] + H, n - b + lo[high])
    return rows


def stream_step5_plain(pp, p, c2, staged: bool = False):
    NY, NZ, _ = p.shape
    o = (pp + c2) + p if staged else (pp + p) + c2
    ry = torch.as_tensor(halo_rows(NY, BY), device=p.device)
    o = o + p.index_select(0, ry)
    rz = halo_rows(NZ, BZ)
    band = torch.as_tensor(np.nonzero(rz >= 0)[0], device=p.device)
    o[:, band] += p.index_select(1, torch.as_tensor(rz[rz >= 0], device=p.device))
    return o


def stream_step5(pp, p, c2, staged: bool = False):
    """``step5`` of (pp, p, c2), a new array (see the module docstring);
    the halos read ``p``; ``staged`` routes p through shared memory."""
    if p.device.type == "cpu":
        return stream_step5_plain(pp, p, c2, staged)
    require_cuda("stream_step5", p)
    NY, NZ, NX = _check3d("stream_step5", (pp, p, c2))
    o = torch.empty_like(p)
    lib = LIBRARY.load()
    err = lib.tpufwi_stream_step5(pp.data_ptr(), p.data_ptr(), c2.data_ptr(), o.data_ptr(), NY,
                                  NZ, NX, int(staged), _stream(p))
    raise_on(lib, "stream_step5", err)
    stream_step5.launches += 1
    return o


stream_step5.launches = 0


def stream_step5x_plain(pp, p, c2, small):
    return (stream_step5_plain(pp, p, c2),
            tuple(small[i] + small[i + 4] for i in range(4)))


def stream_step5x(pp, p, c2, small):
    """(``stream_step5(pp, p, c2)``, the four ``small[i] + small[i + 4]``):
    ``small`` holds eight (NY, NZ, 24) arrays."""
    if p.device.type == "cpu":
        return stream_step5x_plain(pp, p, c2, small)
    require_cuda("stream_step5x", p)
    NY, NZ, NX = _check3d("stream_step5x", (pp, p, c2))
    if len(small) != 8:
        raise ValueError("stream_step5x: small must hold eight arrays")
    _check3d("stream_step5x", tuple(small), blocked=False)
    if tuple(small[0].shape) != (NY, NZ, SS) or small[0].device != p.device:
        raise ValueError(f"stream_step5x: small arrays must be {(NY, NZ, SS)} on {p.device}")
    o = torch.empty_like(p)
    so = tuple(torch.empty_like(small[0]) for _ in range(4))
    ins = (ctypes.c_void_p * 8)(*(s.data_ptr() for s in small))
    outs = (ctypes.c_void_p * 4)(*(s.data_ptr() for s in so))
    lib = LIBRARY.load()
    err = lib.tpufwi_stream_step5x(pp.data_ptr(), p.data_ptr(), c2.data_ptr(), o.data_ptr(),
                                   ins, outs, NY, NZ, NX, _stream(p))
    raise_on(lib, "stream_step5x", err)
    stream_step5x.launches += 1
    return o, so


stream_step5x.launches = 0
