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

The cell passes of both kernels march 2.5D shared-memory tiles along y
(``variant="tiled"``, the default, on the launch plan ``a3d_tile_plan``),
each over the whole grid in one launch (``walk_regions``). A tile that
reaches the CPML (within S + R of a face, outside ``interior_box``) stages
the strip values its cells read in shared memory too; the second reverse
pass's tiles read instead each axis's transposed CPML term at the cell,
which the reverse's line pass computes a block per group of whole lines
along one axis (``a3d_lines``; ``term_cells``). ``variant="gather"``
launches the earlier passes, one thread a cell of the whole grid, every tap
gathered from device memory: they compute the same values bitwise and exist
for the checks that hold the tiled passes to them (``chip_smoke.py``,
``tests/test_torch_cuda.py``); no engine passes it. A tiled call adds its
shell cells x nt to the ``a3d_shell_tiled_cells`` counter, and every
reverse call on the card its term cells x nt to ``a3d_tcpml_cells``
(``profiling``). ``a3d_reverse_pass`` launches one pass of the reverse's
second half alone, for the checks and their timing.

Each wrapper takes its plain version for tensors on the CPU, and only then;
on a CUDA tensor it launches the kernel or raises (a tiled launch is never
retried as a gather one). ``launches`` on each
wrapper counts the time steps its kernel ran (the C loop launches each
step's kernels once), and stays 0 on the CPU path. ``LIBRARY`` is built by
one nvcc call at first use (``kernels/build.py``), together with the
per-step 3D kernels' ``csrc/acoustic3d_step.cu``; neither this module's
import nor the plain versions need CUDA.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import profiling
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
VARIANTS = ("tiled", "gather")  # the C entry points' variant 0 and 1
# tpufwi_a3d_reverse_pass's pass 0, 1, 2: the line pass, the tiled second
# cell pass, its gather variant
REVERSE_PASSES = ("lines", "walk", "gather")

# the tile the library is built for (csrc/acoustic3d_kernels.cuh: kTZ x kTX
# threads, x contiguous, one warp a z row), how many planes ahead its loads
# run (kAhead) and its rings' slots (kFieldSlots, kOpSlots: the operands'
# and the strip tiles')
TILE_Z, TILE_X, AHEAD = 16, 32, 3
FIELD_SLOTS, OP_SLOTS = 8, 4
# the walks' largest shared-memory rings (the header's RingF3S, RingR1S,
# RingR2T; a tile that reaches no CPML leaves the strip and term parts
# unused): (field tiles, operands a cell, strip arrays read along their
# axis, strip arrays read at the cell, operand slots, term arrays read at
# the cell)
RINGS = {"f3_cells_tiled": (1, 3, 1, 1, AHEAD, 0), "r3_cells1_tiled": (1, 4, 0, 1, AHEAD, 0),
         "r3_cells2_tiled": (2, 1, 0, 0, OP_SLOTS, 1)}
SMS = 132  # the H100 SXM's streaming multiprocessors
L2_BYTES = 50 * 2**20  # its L2 cache
RESIDENT = 2  # tiled blocks an SM holds: 512 threads, __launch_bounds__(kTileThreads, 2)
MIN_BLOCKS = 4 * SMS


class TilePlan(NamedTuple):
    """Launch plan of the tiled cell passes: a block of ``tz`` x ``tx``
    threads owns a (z, x) tile and marches ``cy`` planes along y; ``smem``
    is the largest pass's shared bytes (``ring_bytes``)."""
    tz: int
    tx: int
    cy: int
    smem: int


def ring_bytes(R: int, kernel: str, S: int) -> int:
    """Shared bytes of a tiled pass at radius R and strip depth S, fp32: its
    field tiles' ring (FIELD_SLOTS plane tiles of (TILE_Z + 2R) x (TILE_X +
    2R) each) and its operands' ring (its operand slots of TILE_Z x TILE_X
    each); with strip arrays, its operands also hold its cells' own strip
    values (three axes an array read at the cell) and the y columns' fronts,
    then its strip tiles (OP_SLOTS planes of an x tile, TILE_Z x (TILE_X +
    2R), and a z tile, (TILE_Z + 2R) x TILE_X, an array read along its axis)
    and, with an array read at the cell, the 12 S profiles; with term
    arrays, its operands hold the cell's three terms."""
    fields, ops, along, at, slots, terms = RINGS[kernel]
    plane = (TILE_Z + 2 * R) * (TILE_X + 2 * R)
    ops += 3 * at + along + 3 * terms
    strips = along * OP_SLOTS * (TILE_Z * (TILE_X + 2 * R) + (TILE_Z + 2 * R) * TILE_X)
    return 4 * (fields * FIELD_SLOTS * plane + ops * slots * TILE_Z * TILE_X + strips
                + (12 * S if at else 0))


def interior_box(grid: Grid):
    """(lo, (ny, nz, nx)): the box of cells at least S + R from every face
    of the padded grid, where the CPML adds nothing (its extents all 0 when
    it is empty). The rest is the shell (csrc/acoustic3d_kernels.cuh
    interior_box)."""
    lo = strip_depth(grid) + grid.radius
    n = tuple(N - 2 * lo for N in grid.padded_shape)
    return lo, (n if min(n) > 0 else (0, 0, 0))


def walk_regions(grid: Grid):
    """The whole grid's walk (every tiled pass's) in whole planes, each
    ((y0, y1), (0, NZ), (0, NX)): the box's planes, then the low and high y
    slabs; with an empty box the whole grid (csrc/acoustic3d_kernels.cuh
    walk_region)."""
    NY, NZ, NX = grid.padded_shape
    L, (ny, _, _) = interior_box(grid)
    if not ny:
        return [((0, NY), (0, NZ), (0, NX))]
    return [((y0, y1), (0, NZ), (0, NX)) for y0, y1 in ((L, L + ny), (0, L), (L + ny, NY))]


def slab_tiles(slab, cy: int):
    """The tiles of a slab (the whole grid, a walk's region) in block order,
    x fastest, then z, then the y chunks of ``cy`` planes: (y0, y1, z0, x0,
    nz, nx), nz and nx the rows and columns of the tile's cells
    (csrc/acoustic3d_kernels.cuh tile_span)."""
    (ya, yb), (za, zb), (xa, xb) = slab
    return [(y0, min(y0 + cy, yb), z0, x0, min(TILE_Z, zb - z0), min(TILE_X, xb - x0))
            for y0 in range(ya, yb, cy) for z0 in range(za, zb, TILE_Z)
            for x0 in range(xa, xb, TILE_X)]


def shell_cells(grid: Grid) -> int:
    """Cells of the shell: the padded grid less the box."""
    return int(np.prod(grid.padded_shape)) - int(np.prod(interior_box(grid)[1]))


def term_depth(grid: Grid) -> int:
    """The term arrays' band depth at either face of an axis: S + R."""
    return strip_depth(grid) + grid.radius


def term_cells(grid: Grid) -> int:
    """Terms the line pass writes a step: per axis, every cell within S + R
    of one of its faces, once (the two bands of a short axis overlap)."""
    N = grid.padded_shape
    cells = int(np.prod(N))
    return sum(cells // n * min(n, 2 * term_depth(grid)) for n in N)


def a3d_tile_plan(grid: Grid) -> TilePlan:
    """The tiled passes' plan for ``grid``: the box's y extent (the whole
    grid's when the box is empty) is cut into c even chunks of cy planes,
    by which every walk cuts its regions. Rules: the tiles of a whole plane
    make at least ``MIN_BLOCKS`` blocks (4 a streaming multiprocessor) where
    a field outgrows the L2, one a streaming multiprocessor where it fits;
    within that, c minimises waves x (planes a chunk + the 2R halo planes
    its prologue loads again), the blocks running ``RESIDENT`` an SM at a
    time; the fewest chunks on a tie. (Measured on the H100: at the 3D main
    path's grid chunks of 49 planes against 98 took the forward's walk from
    545 to 512 us and the first reverse pass's from 720 to 700; on the
    smoke's free-surface grid, 92 x 76 x 108, chunks of 4-8 planes against 1
    took the forward from 62 to 45 us a step and the reverse from 150 to
    92-95.)"""
    NY, NZ, NX = grid.padded_shape
    R = grid.radius
    ny = interior_box(grid)[1][0] or NY
    tiles = -(-NZ // TILE_Z) * -(-NX // TILE_X)
    smem = max(ring_bytes(R, k, strip_depth(grid)) for k in RINGS)
    blocks = MIN_BLOCKS if 4 * NY * NZ * NX > L2_BYTES else SMS
    c = min(range(min(-(-blocks // tiles), ny), ny + 1),
            key=lambda c: (-(-tiles * c // (RESIDENT * SMS)) * (-(-ny // c) + 2 * R), c))
    return TilePlan(TILE_Z, TILE_X, -(-ny // c), smem)


def _variant_code(name, variant):
    if variant not in VARIANTS:
        raise ValueError(f"{name}: variant must be one of {VARIANTS}, not {variant!r}")
    return VARIANTS.index(variant)


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


def _bands(n: int, depth: int):
    """Padded coordinates of band coordinates 0 .. 2 depth - 1 (bands depth
    deep at either face of an axis of n cells), and whether each is its
    cell's slot: a cell in both bands of a short axis is the low band's
    (csrc/acoustic3d_kernels.cuh band_pos, strip_coord)."""
    j = np.arange(2 * depth)
    c = np.where(j < depth, j, n - 2 * depth + j)
    return c, (c >= 0) & (c < n) & ((j < depth) | (c >= depth))


def a3d_lines_plain(grid, lam, c2, profiles, w, pbar):
    """The reverse's line pass in the tensors' dtype: per axis, at each of
    its strip cells pt = phibar - D1 (C lam + w) (the centre tap left out),
    phibar' = b pt and y = a pt; at each cell within S + R of one of its
    faces the term t = D2 w - D1 y along the axis (w and y zero outside the
    strips, the fields zero outside the padded grid). ``lam``, ``c2`` on the
    padded grid; ``w``, ``pbar`` packed as the kernels' strip arrays
    (``strip_cells``). Returns (phibar', the terms packed ``term_depth``
    deep, zero in the slots no cell owns)."""
    R, S, SE = grid.radius, strip_depth(grid), term_depth(grid)
    N = grid.padded_shape
    dt, dev = lam.dtype, lam.device
    taps = torch.tensor(np.array(taps_arg(grid)[:]).reshape(6, 9), dtype=dt, device=dev)
    prof = packed_profiles(profiles).to(dt)
    u = c2.to(dt) * lam
    pb_out, t_out, off = [], [], 0
    for ax, n in enumerate(N):
        shape = list(N)
        shape[ax] = 2 * S
        size = int(np.prod(shape))
        wa, pa = (a[off:off + size].to(dt).reshape(shape).movedim(ax, 0) for a in (w, pbar))
        off += size
        sc = torch.as_tensor(_bands(n, S)[0], device=dev)
        ua = torch.nn.functional.pad(u.movedim(ax, 0), (0, 0, 0, 0, R, R))
        wf = torch.zeros_like(ua)
        wf[R + sc] = wa
        v = ua + wf
        d1 = sum(taps[ax, k] * v[sc + k] for k in range(2 * R + 1) if k != R)
        pt = pa - d1
        a, b = (prof[4 * S * ax + 2 * S * i:4 * S * ax + 2 * S * (i + 1)][:, None, None]
                for i in (0, 1))
        pb_out.append((b * pt).movedim(0, ax).reshape(-1))
        yf = torch.zeros_like(wf)
        yf[R + sc] = a * pt
        tc, own = _bands(n, SE)
        cc = torch.as_tensor(tc[own], device=dev)
        t = wf.new_zeros((2 * SE,) + wf.shape[1:])
        t[torch.as_tensor(own, device=dev)] = (
            sum(taps[3 + ax, k] * wf[cc + k] for k in range(2 * R + 1))
            - sum(taps[ax, k] * yf[cc + k] for k in range(2 * R + 1) if k != R))
        t_out.append(t.movedim(0, ax).reshape(-1))
    return torch.cat(pb_out), torch.cat(t_out)


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
    lambda lib: _declare(lib),
)


def _declare(lib):
    declare_all(lib, {
        # pointers..., ints..., taps, stream
        "tpufwi_a3d_forward": (12, 16),
        "tpufwi_a3d_reverse": (16, 23),
        "tpufwi_a3d_reverse_pass": (5, 10),
        # the per-step kernels (kernels/acoustic3d_step.py, acoustic3d_strips.py)
        "tpufwi_leap3d": (3, 4),
        "tpufwi_strip3d": (5, 5),
    })
    lib.tpufwi_a3d_walk_occupancy.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.tpufwi_a3d_walk_occupancy.restype = ctypes.c_int


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


def strip_cells(grid: Grid, depth=None) -> int:
    """Cells of one quantity's three strip arrays (both faces of each axis),
    ``depth`` (default S) deep at each face: the term arrays are
    ``term_depth`` deep."""
    NY, NZ, NX = grid.padded_shape
    return 2 * (depth or strip_depth(grid)) * (NZ * NX + NY * NX + NY * NZ)


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


def a3d_forward(grid, c2, profiles, wavelet, src_idx, rcv_idx, tape_dtype=None, illum=False,
                variant="tiled"):
    """Whole 3D forward propagation (see ``a3d_forward_plain`` for the
    contract; the last two fields are views into halo buffers).
    ``profiles`` are the six strip profiles as tensors; ``rcv_idx`` may
    hold no receiver. ``variant``: one of ``VARIANTS`` (module note)."""
    code = _variant_code("a3d_forward", variant)
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
    with torch.cuda.device(dev), profiling.span(
            "kernels.forward", device=dev, wrapper="a3d_forward", variant=variant, nt=nt,
            tape_bytes=0 if tape is None else tape.nbytes):
        err = lib.tpufwi_a3d_forward(
            c2h.data_ptr(), packed_profiles(profiles).data_ptr(), wavelet.data_ptr(),
            src_idx.data_ptr(), rcv_idx.data_ptr(), seis.data_ptr(),
            None if ring is None else ring.data_ptr(), None if tape is None else tape.data_ptr(),
            None if acc is None else acc.data_ptr(), pa.data_ptr(), pb.data_ptr(),
            strips.data_ptr(),
            NY, NZ, NX, strip_depth(grid), grid.radius, nt, src_idx.shape[0], nrec,
            surface_row(grid), n_ring, int(tape_dtype == torch.bfloat16), code,
            *a3d_tile_plan(grid), taps_arg(grid), torch.cuda.current_stream().cuda_stream,
        )
    raise_on(lib, "a3d_forward", err)
    a3d_forward.launches += nt
    if code == 0:
        profiling.count("a3d_shell_tiled_cells", shell_cells(grid) * nt)
    last, penult = (pa, pb) if (nt - 1) % 2 == 0 else (pb, pa)
    return seis, tape, _inner(grid, penult), _inner(grid, last), acc


a3d_forward.launches = 0


def a3d_reverse(grid, c2, profiles, wavelet, ybar, tape, p_penult, p_last, src_idx, rcv_idx,
                return_field=False, variant="tiled"):
    """Reverse with reconstruction (see ``a3d_reverse_plain`` for the
    contract): ``tape`` is the (nt, n_ring) fp32 or bf16 ring tape and
    ``p_penult``, ``p_last`` the last two fields of ``a3d_forward``.
    ``variant``: one of ``VARIANTS`` (module note)."""
    code = _variant_code("a3d_reverse", variant)
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
    strips = _reverse_strips(grid, dev)
    chain = torch.empty(2 * nrec, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev), profiling.span(
            "kernels.reverse", device=dev, wrapper="a3d_reverse", variant=variant, nt=nt,
            tape_bytes=0):
        err = lib.tpufwi_a3d_reverse(
            c2h.data_ptr(), packed_profiles(profiles).data_ptr(), wavelet.data_ptr(),
            ybar.data_ptr(), tape.data_ptr(), ring.data_ptr(), src_idx.data_ptr(),
            rcv_idx.data_ptr(), gbar.data_ptr(), lam_src.data_ptr(), p_tp1.data_ptr(),
            p_t.data_ptr(), qa.data_ptr(), qb.data_ptr(), strips.data_ptr(), chain.data_ptr(),
            NY, NZ, NX, strip_depth(grid), grid.radius, nt, nsrc, nrec, surface_row(grid),
            n_ring, int(tape.dtype == torch.bfloat16), *frame, code, *a3d_tile_plan(grid),
            taps_arg(grid), torch.cuda.current_stream().cuda_stream,
        )
    raise_on(lib, "a3d_reverse", err)
    a3d_reverse.launches += nt
    if code == 0:
        profiling.count("a3d_shell_tiled_cells", shell_cells(grid) * nt)
    profiling.count("a3d_tcpml_cells", term_cells(grid) * nt)
    if not return_field:
        return gbar, lam_src
    return gbar, lam_src, _inner(grid, p_tp1 if nt % 2 == 0 else p_t)


a3d_reverse.launches = 0


def _reverse_strips(grid, dev):
    """The reverse's zeroed strip buffers: psibar, w and phibar
    (``strip_cells`` each), then the terms (``term_depth`` deep)."""
    n = 3 * strip_cells(grid) + strip_cells(grid, term_depth(grid))
    return torch.zeros(n, dtype=torch.float32, device=dev)


class PassBuffers(NamedTuple):
    """The buffers of the reverse's second half as ``a3d_reverse`` lays
    them out: halo fields ``lam`` (lambda_t), ``other`` (lambda_{t+1} in,
    lambda_{t-1} out) and ``c2``, the packed profiles, and the strips
    (``_reverse_strips``)."""
    lam: torch.Tensor
    other: torch.Tensor
    c2: torch.Tensor
    prof: torch.Tensor
    strips: torch.Tensor

    def part(self, grid, k):
        """Strip buffer k: 0 psibar, 1 w, 2 phibar, 3 the terms."""
        ns = strip_cells(grid)
        return self.strips[k * ns:(k + 1) * ns] if k < 3 else self.strips[3 * ns:]


def pass_buffers(grid, lam, c2, profiles, other=None, w=None, pbar=None, terms=None):
    """``PassBuffers`` on ``lam``'s device from padded-grid fields (``other``
    zero when None) and packed strip arrays (zero when None)."""
    dev = lam.device
    buf = PassBuffers(_halo(grid, lam), _halo(grid, other, device=dev), _halo(grid, c2),
                      packed_profiles(profiles), _reverse_strips(grid, dev))
    for k, a in ((1, w), (2, pbar), (3, terms)):
        if a is not None:
            buf.part(grid, k).copy_(a)
    return buf


def a3d_reverse_pass(grid, name, buf):
    """Launch one pass of the reverse's second half alone on the current
    stream, on ``buf`` (``pass_buffers``): ``"lines"`` the line pass (phibar
    and the terms in ``buf.strips`` from ``buf.lam``, ``buf.c2`` and w),
    ``"walk"`` the tiled second cell pass on the plan and ``"gather"`` its
    gather variant (lambda_{t-1} into ``buf.other`` from ``buf.lam``,
    ``buf.other`` and the terms). For the checks and their timing: CUDA
    events around a call time its launch alone. The card only."""
    if name not in REVERSE_PASSES:
        raise ValueError(f"a3d_reverse_pass: pass must be one of {REVERSE_PASSES}, not {name!r}")
    require_cuda("a3d_reverse_pass", buf.lam)
    lib = LIBRARY.load()
    NY, NZ, NX = grid.padded_shape
    with torch.cuda.device(buf.lam.device):
        err = lib.tpufwi_a3d_reverse_pass(
            buf.lam.data_ptr(), buf.other.data_ptr(), buf.c2.data_ptr(), buf.prof.data_ptr(),
            buf.strips.data_ptr(), REVERSE_PASSES.index(name), NY, NZ, NX, strip_depth(grid),
            grid.radius, *a3d_tile_plan(grid), taps_arg(grid),
            torch.cuda.current_stream().cuda_stream)
    raise_on(lib, "a3d_reverse_pass", err)


def a3d_lines(grid, lam, c2, profiles, w, pbar):
    """The reverse's line pass alone (``a3d_lines_plain`` for the contract;
    the plain version on CPU tensors): (phibar', the terms)."""
    if lam.device.type == "cpu":
        return a3d_lines_plain(grid, lam, c2, profiles, w, pbar)
    buf = pass_buffers(grid, lam, c2, profiles, w=w, pbar=pbar)
    a3d_reverse_pass(grid, "lines", buf)
    return buf.part(grid, 2), buf.part(grid, 3)


def walk_occupancy(grid):
    """The tiled walks on the card at ``grid``'s radius and strip depth:
    {walk: (registers a thread, dynamic shared bytes, blocks an SM)}, from
    cudaFuncGetAttributes and cudaOccupancyMaxActiveBlocksPerMultiprocessor."""
    lib = LIBRARY.load()
    out = (ctypes.c_int * 9)()
    raise_on(lib, "walk_occupancy",
             lib.tpufwi_a3d_walk_occupancy(grid.radius, strip_depth(grid), out))
    return {k: tuple(out[3 * i:3 * i + 3]) for i, k in enumerate(RINGS)}
