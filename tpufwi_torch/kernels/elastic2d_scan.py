"""The whole-scan elastic engine's two kernels: CUDA wrappers, their plain
torch versions and their launch counters (counterpart of
``tpufwi/kernels/elastic2d_pallas_scan.py``).

``escan_forward`` runs the whole 2D elastic P-SV time loop (staggered
velocity-stress stages, CPML on the 8 derivative terms, free-surface
images, a pressure or vertical-force source, v or p receivers) and, on
request, records the fp32 five-field boundary-ring tape; it returns the
seismogram, the tape and the five final fields. ``escan_reverse``
reconstructs the fields backwards from the final ones and the tape while it
runs the exact transposed stages, and returns the five material-field
cotangents (lam, lam2mu, mu_xz, buoy_x, buoy_z, before the source-point
chain and the valid-region mask) and the per-step source-point cotangent
``srcrow``. The forward runs two launches a step (``FORWARD_LAUNCHES``):
stage V (the per-step engine's kernel, which also adds the step before's
force sources), then one shared-memory tiled kernel that
computes stage S from v over its tile and their R cross (a free-surface
ghost row read from its mirror: the velocity image) with the glue folded
into the thread that owns each cell: the sources (a force source's vz kept
in registers for the receivers and the tape), the stress image and the
surface pin, the receivers, the tape entries and the ghost rows' image
(tile walk ``forward_tiles``: with the free surface a tile row starts at
fs - 2R, so the stress image stays inside a tile); a tail launch adds the
last step's force sources. The reverse runs one shared-memory tiled kernel
per stage, which computes the dbar values over its tile and their R reach
and applies the transposed stencils from shared memory, with the step's
glue in the thread that owns each cell: the receiver cotangents, the
source-point cotangent, the source undone and both ring imposes. It walks
the forward's tiles (``forward_tiles``), so with the free surface one tile
row holds every ghost row and its mirrors and runs the images after its
cells (``reverse_launches``: 2 launches a step, with or without the free
surface). Both run on the launch plan
``escan_tile_plan``, each launch a programmatic dependent of the one
before unless ``dependent_launch`` is False. On the card each is held
against the per-step engine (``kernels/elastic2d_step.py``
``estep_forward``, ``adjoint_elastic_step.estep_reverse``), which runs the
same stages with the same per-cell arithmetic. The CUDA sources are
``csrc/elastic2d_scan.cu`` and
``csrc/elastic2d_kernels.cuh``, built at first use by one nvcc call into
the elastic library (``kernels/build.py``), with the per-step kernels of
``csrc/elastic2d_step.cu`` (``kernels/elastic2d_step.py``).

Tape contract: row t holds rings(state after step t) of vx, vz, sxx, szz,
sxz (``ring_plan`` order, field after field), unshifted; the reverse step t
imposes row t-1 (zeros for t = 0). The TPU kernel writes the same rows one
step later through a one-deep delay in VMEM.

Each wrapper takes its plain version for tensors on the CPU, and only then;
on a CUDA tensor it launches the kernel or raises. ``launches`` on each
wrapper counts the time steps its kernel ran, and stays 0 on the CPU path;
so does the profiling counter ``escan_image_steps``, which a reverse call
with the free surface raises by its steps (on each of which the folded
images run).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import profiling
from ..grid import D1_STAGGERED_COEFFS, Grid
from .acoustic2d_scanres import check_args, full_profiles, require_cuda, ring_plan, strip_depth
from .build import CSRC, Library, declare_all, raise_on
from .elastic2d_eager import (
    FIELDS,
    ElasticParams,
    check_kinds,
    make_elastic_reverse_reconstruct,
    make_elastic_step,
    zero_elastic_state,
)

LIBRARY = Library(
    "elastic2d",
    (CSRC / "elastic2d_scan.cu", CSRC / "elastic2d_step.cu"),
    (CSRC / "elastic2d_kernels.cuh", CSRC / "pdl.cuh", CSRC / "cell_maps.cuh"),
    lambda lib: declare_all(lib, {
        # pointers..., ints..., taps and dt, stream
        "tpufwi_escan_forward": (17, 15),
        "tpufwi_escan_reverse": (19, 15),
        # the per-step kernels (kernels/elastic2d_step.py)
        "tpufwi_estep_v": (11, 5),
        "tpufwi_estep_s": (17, 11),
        "tpufwi_estep_rs": (22, 12),
        "tpufwi_estep_rv": (16, 6),
    }),
)

_FWD_HALO, _FWD_COMPACT = 5, 8  # the forward's fields; CPML memories
# the reverse's: halo planes (the fields) and compact ones (cotangents, then
# the duals, ping-ponged in two sets of 8)
_REV_HALO, _REV_COMPACT = 5, 5 + 16

# the fused passes' tile (csrc/elastic2d_kernels.cuh kFTZ x kFTX cells, a
# block of TILE_X x TILE_ROWS threads, TILE_Z / TILE_ROWS rows a thread)
# and the reverse's shared planes of (TILE_Z + 2R) x (TILE_X + 2R) fp32:
# er_s v and the four dbar planes, er_v the three stresses and the four
# dbar planes (ef_s_fused: see fused_smem)
TILE_Z, TILE_X, TILE_ROWS = 16, 32, 8
FUSED_PLANES = {"er_s": 6, "er_v": 7}
FUSED_KERNELS = ("ef_s_fused", "er_s", "er_v")


class EscanPlan(NamedTuple):
    """Launch plan of the fused passes: a block owns a ``tz`` x ``tx`` tile
    of cells; ``smem`` is the larger pass's shared bytes."""
    tz: int
    tx: int
    smem: int


def fused_smem(R: int, kernel: str) -> int:
    """Shared bytes of a fused pass at radius R: the reverse's planes
    (``FUSED_PLANES``); the forward's (``ef_smem``) v over the tile and
    its R reach, and ten planes over the tile (the three stresses, lam,
    lam2mu, mu_xz and stage S's four memories)."""
    cross = (TILE_Z + 2 * R) * (TILE_X + 2 * R)
    if kernel == "ef_s_fused":
        return 4 * (2 * cross + 10 * TILE_Z * TILE_X)
    return 4 * FUSED_PLANES[kernel] * cross


def escan_tile_plan(grid: Grid) -> EscanPlan:
    """The fused passes' plan for ``grid`` (the C side rejects any other)."""
    return EscanPlan(TILE_Z, TILE_X, max(fused_smem(grid.radius, k) for k in FUSED_KERNELS))


def fused_tiles(plan: EscanPlan, NZ: int, NX: int, shift: int = 0):
    """The fused passes' tile walk over an (NZ, NX) grid: for each block
    (blockIdx.y, blockIdx.x), its own cells ``(z0, z1, x0, x1)``, clipped
    to the grid (a ragged first or last tile holds fewer); block row by
    starts at row ``by tz - shift``."""
    for z0 in range(-shift, NZ, plan.tz):
        for x0 in range(0, NX, plan.tx):
            yield max(z0, 0), min(z0 + plan.tz, NZ), x0, min(x0 + plan.tx, NX)


def forward_shift(plan: EscanPlan, grid: Grid) -> int:
    """The fused passes' tile-row shift (``ef_shift``), the forward's and
    the reverse's: with the free surface (row fs = grid.pad) a tile row
    starts at fs - 2R, so its tiles hold the ghost rows fs-R .. fs-1 and
    their mirrors fs .. fs+R."""
    if not grid.free_surface:
        return 0
    return (plan.tz - (grid.pad - 2 * grid.radius) % plan.tz) % plan.tz


def forward_tiles(plan: EscanPlan, grid: Grid):
    """The fused passes' tile walk over ``grid``'s padded grid, the
    forward's and the reverse's."""
    return fused_tiles(plan, *grid.padded_shape, forward_shift(plan, grid))


def reach_cells(plan: EscanPlan, R: int):
    """The shared-plane (row, column) that each reach index k of a fused
    pass fills (``FTile::reach``): 2R rows of ``tx`` above and below the
    tile, then ``tz`` rows of 2R columns left and right of it. Their union
    with the tile is the cross that the passes' stencils read."""
    out = []
    for k in range(2 * R * plan.tx + plan.tz * 2 * R):
        if k < 2 * R * plan.tx:
            r = k // plan.tx
            out.append((r if r < R else plan.tz + r, R + k - r * plan.tx))
        else:
            k -= 2 * R * plan.tx
            r, e = divmod(k, 2 * R)
            out.append((R + r, e if e < R else plan.tx + e))
    return out


# kernel launches of one forward step (csrc/elastic2d_scan.cu), with or
# without the free surface; a call adds one (``ef_setup``), and one more
# with a force source (the last step's)
FORWARD_LAUNCHES = 2


def reverse_launches(free_surface: bool, nt: int | None = None) -> int:
    """Kernel launches of one reverse step (csrc/elastic2d_scan.cu), or with
    ``nt`` of a whole call: its steps' and its own, ``er_setup`` (the cell
    maps, and the first step's force-source undo and pressure-receiver
    cotangents), with the free surface also ``er_image_s_t`` (the first
    step's stress-image transpose). A step is ``er_s`` and ``er_v``, with
    the free surface too: their surface tile row runs the images."""
    if nt is None:
        return 2
    return 2 * nt + 1 + int(free_surface)


def load_library():
    """Build (once per version of the sources) and load the elastic
    kernels' library: both sources in one nvcc call."""
    return LIBRARY.load()


def _params(grid, mats, profiles, src_idx, rcv_idx):
    (az, ax), (bz, bx) = full_profiles(grid, profiles)
    return ElasticParams(*mats, az=az, bz=bz, ax=ax, bx=bx, src_idx=src_idx, rcv_idx=rcv_idx)


def impose_rings(fields, ring_idx, row):
    """Copies of ``fields`` with their ring cells set from consecutive
    n_ring-long parts of ``row`` (zeros when ``row`` is None)."""
    n = ring_idx.shape[0]
    out = []
    for k, f in enumerate(fields):
        flat = f.reshape(-1).clone()
        flat[ring_idx] = 0.0 if row is None else row[k * n:(k + 1) * n].to(f.dtype)
        out.append(flat.reshape(f.shape))
    return out


# ------------------------------------------------------------ plain versions


def escan_forward_plain(grid, dt, mats, profiles, wavelet, src_idx, rcv_idx,
                        source_type="pressure", record="v", tape=False):
    """Loop of the step twin. Returns (seis, tape, finals): seis (nt, nrec,
    2) (vz, vx) for record "v", (nt, nrec) for "p"; tape (nt, 5 n_ring) in
    the fields' dtype, row t the rings of the state after step t, or None;
    finals the five fields (vx, vz, sxx, szz, sxz) after the last step."""
    params = _params(grid, mats, profiles, src_idx, rcv_idx)
    step = make_elastic_step(grid, dt, source_type, record)
    state = zero_elastic_state(grid.padded_shape, mats[0].dtype, mats[0].device)
    ring_idx = ring_plan(grid, mats[0].device)[0] if tape else None
    seis, rows = [], []
    for t in range(wavelet.shape[0]):
        state, rec = step(state, params, wavelet[t])
        seis.append(rec)
        if tape:
            rows.append(torch.cat([getattr(state, f).reshape(-1)[ring_idx] for f in FIELDS]))
    finals = tuple(getattr(state, f) for f in FIELDS)
    return torch.stack(seis), (torch.stack(rows) if tape else None), finals


def make_elastic_reverse_stages(grid, dt, source_type="pressure", record="v"):
    """The two halves of one boundary-saving reverse step t in plain torch,
    on tuples of padded-grid tensors (the plain versions of the per-step
    kernels R-S and R-V with their glue, and the body of
    ``escan_reverse_plain``):

      rev_s(params, fields, cot, dual_s, g3, w_t, ybar_t, row, ring_idx)
          -> (fields, cot, dual_s, g3, srcrow_t): receiver injection of
          ``ybar_t`` and stress-image transpose; the source-point cotangent
          ``srcrow_t``; sigma_t reconstructed (the source undone), the
          stress rings of ``row`` imposed and the primal re-imaged; the
          transposed stress update by ``torch.func.vjp`` at zero CPML
          memory; the velocity-image transpose;
      rev_v(params, fields, cot, dual_v, g2, row, ring_idx)
          -> (fields, cot, dual_v, g2): v_{t-1/2} reconstructed, its rings
          imposed and re-imaged; the transposed velocity update.

    ``fields`` (vx, vz, sxx, szz, sxz); ``cot`` their cotangents;
    ``dual_s`` / ``dual_v`` the cotangents of stage S's / stage V's CPML
    memories; ``g3`` / ``g2`` the (lam, lam2mu, mu_xz) / (buoy_x, buoy_z)
    cotangents; ``row`` the tape row t-1 (None: zeros); ``ring_idx`` its
    cells (``ring_plan``)."""
    step = make_elastic_step(grid, dt, source_type, record)
    recon_stress, recon_velocity = make_elastic_reverse_reconstruct(grid, dt, source_type)
    image = step.image

    def rev_s(params, fields, cot, dual_s, g3, w_t, ybar_t, row, ring_idx):
        n = ring_idx.shape[0]
        vxb, vzb, sxxb, szzb, sxzb = cot
        z = torch.zeros_like(vxb)
        rz, rx = params.rcv_idx[:, 0], params.rcv_idx[:, 1]
        sz, sx = params.src_idx[:, 0], params.src_idx[:, 1]
        if record == "v":
            vzb = vzb.index_put((rz, rx), ybar_t[:, 0], accumulate=True)
            vxb = vxb.index_put((rz, rx), ybar_t[:, 1], accumulate=True)
        else:
            sxxb = sxxb.index_put((rz, rx), -0.5 * ybar_t, accumulate=True)
            szzb = szzb.index_put((rz, rx), -0.5 * ybar_t, accumulate=True)
        if image is not None:
            szzb, sxzb = image.s_t(szzb, sxzb)
        srcrow_t = vzb[sz, sx] if source_type == "force_z" else (sxxb + szzb)[sz, sx]

        vx, vz, sxx, szz, sxz = recon_stress(*fields, params, w_t)
        sxx, szz, sxz = impose_rings((sxx, szz, sxz), ring_idx,
                                     None if row is None else row[2 * n:])
        if image is not None:
            szz, sxz = image.s(szz, sxz)

        def upd_s(vx_, vz_, m_, lam, l2m, mu):
            p = params._replace(lam=lam, lam2mu=l2m, mu_xz=mu)
            return step.update_s(vx_, vz_, sxx, szz, sxz, m_, p)

        _, pull = torch.func.vjp(upd_s, vx, vz, (z,) * 4, params.lam, params.lam2mu,
                                 params.mu_xz)
        vxb_s, vzb_s, dual_s, *gm = pull((sxxb, szzb, sxzb, dual_s))
        vxb, vzb = vxb + vxb_s, vzb + vzb_s
        g3 = tuple(a + b for a, b in zip(g3, gm))
        if image is not None:
            vxb, vzb = image.v_t(vxb, vzb)
        return (vx, vz, sxx, szz, sxz), (vxb, vzb, sxxb, szzb, sxzb), dual_s, g3, srcrow_t

    def rev_v(params, fields, cot, dual_v, g2, row, ring_idx):
        n = ring_idx.shape[0]
        vx, vz, sxx, szz, sxz = fields
        vxb, vzb, sxxb, szzb, sxzb = cot
        z = torch.zeros_like(vx)
        vx, vz = recon_velocity(vx, vz, sxx, szz, sxz, params)
        vx, vz = impose_rings((vx, vz), ring_idx, None if row is None else row[: 2 * n])
        if image is not None:
            vx, vz = image.v(vx, vz)

        def upd_v(sxx_, szz_, sxz_, m_, bxm, bzm):
            p = params._replace(buoy_x=bxm, buoy_z=bzm)
            return step.update_v(z, z, sxx_, szz_, sxz_, m_, p)

        _, pull = torch.func.vjp(upd_v, sxx, szz, sxz, (z,) * 4, params.buoy_x, params.buoy_z)
        sxxb_v, szzb_v, sxzb_v, dual_v, *gm = pull((vxb, vzb, dual_v))
        cot = (vxb, vzb, sxxb + sxxb_v, szzb + szzb_v, sxzb + sxzb_v)
        return (vx, vz, sxx, szz, sxz), cot, dual_v, tuple(a + b for a, b in zip(g2, gm))

    return rev_s, rev_v


def escan_reverse_plain(grid, dt, mats, profiles, wavelet, ybar, tape, finals, src_idx,
                        rcv_idx, source_type="pressure", record="v"):
    """The boundary-saving reverse, fed a tape, the final fields and the
    receiver cotangent ``ybar`` (the seismogram's shape): for t descending,
    ``make_elastic_reverse_stages``'s two halves with tape row t-1 (zeros
    for t = 0). Returns (grads, srcrow): the five material cotangents (lam,
    lam2mu, mu_xz, buoy_x, buoy_z) without the force source's buoy_z term
    and unmasked, and srcrow (nt, nsrc), the source-point cotangent of each
    step."""
    params = _params(grid, mats, profiles, src_idx, rcv_idx)
    rev_s, rev_v = make_elastic_reverse_stages(grid, dt, source_type, record)
    dtype, dev = mats[0].dtype, mats[0].device
    ring_idx = ring_plan(grid, dev)[0]
    z = torch.zeros(grid.padded_shape, dtype=dtype, device=dev)
    fields, cot = tuple(finals), (z,) * 5
    dual_s = dual_v = (z,) * 4
    g3, g2 = (z,) * 3, (z,) * 2
    nt = wavelet.shape[0]
    srcrow = torch.empty((nt, src_idx.shape[0]), dtype=dtype, device=dev)
    for t in reversed(range(nt)):
        row = tape[t - 1] if t >= 1 else None
        fields, cot, dual_s, g3, srcrow[t] = rev_s(params, fields, cot, dual_s, g3, wavelet[t],
                                                   ybar[t], row, ring_idx)
        fields, cot, dual_v, g2 = rev_v(params, fields, cot, dual_v, g2, row, ring_idx)
    return g3 + g2, srcrow


# ---------------------------------------------------------------- wrappers


def taps_arg(grid: Grid, dt: float):
    """Staggered taps over h for z and x (4 each, zero-filled past R), then
    dt: 9 fp32."""
    taps = np.zeros(9, np.float32)
    cs = D1_STAGGERED_COEFFS[grid.order]
    taps[: len(cs)] = cs / grid.h[0]
    taps[4 : 4 + len(cs)] = cs / grid.h[1]
    taps[8] = dt
    return (ctypes.c_float * 9)(*taps.tolist())


def _check(name, grid, mats, profiles, vectors, src_idx, rcv_idx, source_type, record):
    check_kinds(source_type, record)
    if len(mats) != 5:
        raise ValueError(f"{name}: five material fields expected")
    check_args(name, grid, mats[0], profiles, (*mats[1:], *vectors), src_idx, rcv_idx)
    for m in mats[1:]:
        if tuple(m.shape) != tuple(mats[0].shape):
            raise ValueError(f"{name}: material fields must share the padded grid's shape")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _flags(grid, source_type, record):
    return (grid.pad if grid.free_surface else -1, int(source_type == "force_z"),
            int(record == "v"))


def _maps(grid, plan, shift, nsrc, nrec, dev, vblocks=True):
    """The passes' zeroed int maps (``SMaps``: three (NZ, NX) cell
    maps, a flag word per tile of rows shifted by ``shift``, the source and
    receiver chains), then for the forward (``vblocks``) a flag word per
    32 x 8 block of stage V."""
    NZ, NX = grid.padded_shape
    tiles = -(-(NZ + shift) // plan.tz) * -(-NX // plan.tx)
    extra = -(-NZ // 8) * -(-NX // 32) if vblocks else 0
    return torch.zeros(3 * NZ * NX + tiles + nsrc + nrec + extra, dtype=torch.int32,
                       device=dev)


def escan_forward(grid, dt, mats, profiles, wavelet, src_idx, rcv_idx,
                  source_type="pressure", record="v", tape=False, dependent_launch=True):
    """Whole elastic forward (see ``escan_forward_plain`` for the
    contract). ``mats`` are the five padded material fields, ``profiles``
    the strip profiles as tensors, fp32 on one card. ``dependent_launch``
    as ``escan_reverse``'s."""
    if mats[0].device.type == "cpu":
        return escan_forward_plain(grid, dt, mats, profiles, wavelet, src_idx, rcv_idx,
                                   source_type, record, tape)
    require_cuda("escan_forward", mats[0])
    _check("escan_forward", grid, mats, profiles, (wavelet,), src_idx, rcv_idx, source_type,
           record)
    if wavelet.ndim != 1 or wavelet.shape[0] == 0:
        raise ValueError("escan_forward: wavelet must be (nt,) with nt > 0")
    lib = load_library()
    dev = mats[0].device
    NZ, NX = grid.padded_shape
    R, S = grid.radius, strip_depth(grid)
    nt, nrec = wavelet.shape[0], rcv_idx.shape[0]
    seis = torch.empty((nt, nrec, 2) if record == "v" else (nt, nrec), dtype=torch.float32,
                       device=dev)
    ring = rows = None
    n_ring = 0
    if tape:
        ring = ring_plan(grid, dev)[1]
        n_ring = ring.shape[0]
        rows = torch.empty((nt, 5 * n_ring), dtype=torch.float32, device=dev)
    halo = (NZ + 2 * R) * (NX + 2 * R)
    ws = torch.zeros(_FWD_HALO * halo + _FWD_COMPACT * NZ * NX, dtype=torch.float32, device=dev)
    plan = escan_tile_plan(grid)
    nsrc = src_idx.shape[0]
    iws = _maps(grid, plan, forward_shift(plan, grid), nsrc, nrec, dev)
    fs, force, rec_v = _flags(grid, source_type, record)
    with torch.cuda.device(dev), profiling.span(
            "kernels.forward", device=dev, wrapper="escan_forward", nt=nt,
            tape_bytes=0 if rows is None else rows.nbytes, free_surface=grid.free_surface):
        err = lib.tpufwi_escan_forward(
            *(m.data_ptr() for m in mats), *(p.data_ptr() for p in profiles),
            wavelet.data_ptr(), src_idx.data_ptr(), rcv_idx.data_ptr(), seis.data_ptr(),
            _ptr(ring), _ptr(rows), ws.data_ptr(), iws.data_ptr(),
            NZ, NX, S, R, nt, nsrc, nrec, fs, n_ring, force, rec_v, *plan, int(dependent_launch),
            taps_arg(grid, dt), torch.cuda.current_stream().cuda_stream,
        )
    raise_on(lib, "escan_forward", err)
    escan_forward.launches += nt
    fields = ws[: _FWD_HALO * halo].view(_FWD_HALO, NZ + 2 * R, NX + 2 * R)
    return seis, rows, tuple(fields[k, R:-R, R:-R] for k in range(5))


escan_forward.launches = 0


def escan_reverse(grid, dt, mats, profiles, wavelet, ybar, tape, finals, src_idx, rcv_idx,
                  source_type="pressure", record="v", dependent_launch=True):
    """Whole elastic reverse (see ``escan_reverse_plain`` for the
    contract): ``tape`` (nt, 5 n_ring) and ``finals`` as
    ``escan_forward(..., tape=True)`` returns them. The launches are each a
    programmatic dependent of the one before it (its launch overlapping
    that kernel's drain) unless ``dependent_launch`` is False (plain stream
    order, in which a profiler's kernel spans do not overlap). The plain
    version has neither."""
    if mats[0].device.type == "cpu":
        return escan_reverse_plain(grid, dt, mats, profiles, wavelet, ybar, tape, finals,
                                   src_idx, rcv_idx, source_type, record)
    require_cuda("escan_reverse", mats[0])
    _check("escan_reverse", grid, mats, profiles, (wavelet, ybar, tape), src_idx, rcv_idx,
           source_type, record)
    dev = mats[0].device
    NZ, NX = grid.padded_shape
    R, S = grid.radius, strip_depth(grid)
    nt, nrec, nsrc = wavelet.shape[0], rcv_idx.shape[0], src_idx.shape[0]
    ring = ring_plan(grid, dev)[1]
    n_ring = ring.shape[0]
    seis_shape = (nt, nrec, 2) if record == "v" else (nt, nrec)
    if tuple(ybar.shape) != seis_shape or tuple(tape.shape) != (nt, 5 * n_ring):
        raise ValueError(f"escan_reverse: ybar must be {seis_shape}, tape ({nt}, {5 * n_ring})")
    if len(finals) != 5 or any(tuple(f.shape) != (NZ, NX) or f.device != dev
                               or f.dtype != torch.float32 for f in finals):
        raise ValueError(f"escan_reverse: five fp32 final fields {(NZ, NX)} expected")
    lib = load_library()
    halo = (NZ + 2 * R) * (NX + 2 * R)
    ws = torch.zeros(_REV_HALO * halo + _REV_COMPACT * NZ * NX, dtype=torch.float32, device=dev)
    fields = ws[: 5 * halo].view(5, NZ + 2 * R, NX + 2 * R)
    for k, f in enumerate(finals):
        fields[k, R:-R, R:-R] = f
    g = torch.zeros((5, NZ, NX), dtype=torch.float32, device=dev)
    srcrow = torch.empty((nt, nsrc), dtype=torch.float32, device=dev)
    plan = escan_tile_plan(grid)
    iws = _maps(grid, plan, forward_shift(plan, grid), nsrc, nrec, dev, vblocks=False)
    fs, force, rec_v = _flags(grid, source_type, record)
    with torch.cuda.device(dev), profiling.span(
            "kernels.reverse", device=dev, wrapper="escan_reverse", nt=nt, tape_bytes=0,
            free_surface=grid.free_surface):
        err = lib.tpufwi_escan_reverse(
            *(m.data_ptr() for m in mats), *(p.data_ptr() for p in profiles),
            wavelet.data_ptr(), ybar.data_ptr(), tape.data_ptr(), ring.data_ptr(),
            src_idx.data_ptr(), rcv_idx.data_ptr(), g.data_ptr(), srcrow.data_ptr(),
            ws.data_ptr(), iws.data_ptr(),
            NZ, NX, S, R, nt, nsrc, nrec, fs, n_ring, force, rec_v, *plan, int(dependent_launch),
            taps_arg(grid, dt), torch.cuda.current_stream().cuda_stream,
        )
        if grid.free_surface:
            profiling.count("escan_image_steps", nt)
    raise_on(lib, "escan_reverse", err)
    escan_reverse.launches += nt
    return tuple(g), srcrow


escan_reverse.launches = 0
