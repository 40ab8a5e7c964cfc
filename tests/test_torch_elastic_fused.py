"""The fused elastic reverse's walk (``escan_reverse``, TPU kernel 9)
transcribed in plain torch, on the CPU, fp32.

The CUDA passes ``er_s`` and ``er_v`` (csrc/elastic2d_kernels.cuh) run each
stage as tiles of ``escan_tile_plan``: a tile computes the dbar values over
its cells and their R reach, writes only its own cells, reads the dual
memories from one set and writes them to the other (ping-pong), and runs
the step's glue (receivers, sources, ring impose) at its own cells; with
the free surface the tile rows are the forward's (``forward_tiles``), so
one tile row holds every ghost row and its mirrors and runs the images
after its cells. ``fused_walk`` runs that walk
with the plain version's own functions (the step twin's ``update_s`` /
``update_v`` through ``torch.func.vjp``, the reconstruction, the sources,
the images, the ring impose) on each tile's window, the tiles in turn and
in place, so a tile that read what an earlier one wrote, or glue out of
the per-step engine's order, would show. Per-cell torch arithmetic does not depend on the
window, so the walk must equal ``escan_reverse_plain`` bitwise; and through
the port's engine it must agree with the reference (the jnp engine, and the
whole-scan engine in interpret mode) within test_torch_elastic_scan.py's
tolerances. The plan's tile walk and reach numbering are checked as the C
side computes them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_elastic_scan import NAMES, _jax_grads, _port_grads, _rel, _setup

from tpufwi.adjoint_elastic_scan import make_elastic_simulator_scan as j_make_scan
from tpufwi.grid import Grid as JGrid
from tpufwi.propagators.elastic2d import make_elastic_simulator as j_make_simulator
from tpufwi.wavelets import ricker_np

from tpufwi_torch.adjoint_scanres import profile_source
from tpufwi_torch.grid import Grid
from tpufwi_torch.kernels import elastic2d_scan as ke
from tpufwi_torch.kernels.acoustic2d_scanres import ring_plan
from tpufwi_torch.kernels.elastic2d_eager import (
    inject_sources,
    make_elastic_reverse_reconstruct,
    make_elastic_step,
)
from tpufwi_torch.propagators.elastic2d import elastic_cfl_dt, make_elastic_function


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def fused_walk(grid, dt, mats, profiles, wavelet, ybar, tape, finals, src_idx, rcv_idx,
               source_type="pressure", record="v", plan=None, ping_pong=True):
    """The fused reverse's walk (``escan_reverse_plain``'s contract), the
    step's glue where the CUDA passes run it. Once a call, ``er_setup``'s
    glue of step nt-1 (a force source undone, the p receivers' cotangents)
    and, with the free surface, that step's stress-image transpose. Per
    step t: er_s tile by tile, each tile's glue at its own cells before and
    after its cells' update (the v receivers' cotangents, the source-point
    cotangent, a pressure source undone; the stress rings), and in a tile
    of the surface tile row then the stress image and the velocity-image
    transpose of its columns (``er_s_images``); er_v tile by tile (the
    velocity rings; for step t-1 a force source undone off the velocity
    image's rows and the p receivers' cotangents), and in a tile of the
    surface tile row then the velocity image of its columns and, for step
    t-1, the stress-image transpose and a force source undone on the
    image's rows (``er_v_images``). The tiles are the forward's, shifted
    with the free surface so that the surface tile row holds every ghost
    row and its mirrors. Each tile reads its window (its cells and their R
    reach, clipped to the grid) of the current fields and writes its own
    cells in place; the duals are read from one set and written to the
    other, swapped each step (``ping_pong=False``: one set, updated in
    place)."""
    params = ke._params(grid, mats, profiles, src_idx, rcv_idx)
    no_src = params._replace(src_idx=src_idx[:0])
    step = make_elastic_step(grid, dt, source_type, record)
    recon_stress, recon_velocity = make_elastic_reverse_reconstruct(grid, dt, source_type)
    image = step.image
    NZ, NX = grid.padded_shape
    R, fs = grid.radius, grid.pad
    tiles = list(ke.forward_tiles(plan or ke.escan_tile_plan(grid), grid))
    dtype, dev = mats[0].dtype, mats[0].device
    ring_idx = ring_plan(grid, dev)[0]
    n = ring_idx.shape[0]
    force = source_type == "force_z"

    def zeros():
        return torch.zeros((NZ, NX), dtype=dtype, device=dev)

    f = [x.clone() for x in finals]  # vx, vz, sxx, szz, sxz
    cb = [zeros() for _ in range(5)]
    duals = [[zeros() for _ in range(8)], [zeros() for _ in range(8)]]
    g = [zeros() for _ in range(5)]
    nt = wavelet.shape[0]
    srcrow = torch.empty((nt, src_idx.shape[0]), dtype=dtype, device=dev)
    rz, rx = rcv_idx[:, 0], rcv_idx[:, 1]
    sz, sx = src_idx[:, 0], src_idx[:, 1]
    # sources on the velocity image's vz rows, undone after the image
    on_image = (sz >= fs - R) & (sz < fs + R) if image is not None else sz < 0
    ring_z, ring_x = ring_idx // NX, ring_idx % NX
    everywhere = (0, NZ, 0, NX)

    def inside(z, x, tile):
        z0, z1, x0, x1 = tile
        return (z >= z0) & (z < z1) & (x >= x0) & (x < x1)

    def undo(sel, t):
        """The sources ``sel`` of step t undone on the primal."""
        p = params._replace(src_idx=src_idx[sel])
        f[1], f[2], f[3] = inject_sources(f[1], f[2], f[3], p, wavelet[t], dt, source_type,
                                          sign=-1.0)

    def inject(sel, t):
        """The cotangents of ybar row t of the receivers ``sel``."""
        at = (rz[sel], rx[sel])
        if record == "v":
            cb[1] = cb[1].index_put(at, ybar[t][:, 0][sel], accumulate=True)
            cb[0] = cb[0].index_put(at, ybar[t][:, 1][sel], accumulate=True)
        else:
            cb[2] = cb[2].index_put(at, (-0.5 * ybar[t])[sel], accumulate=True)
            cb[3] = cb[3].index_put(at, (-0.5 * ybar[t])[sel], accumulate=True)

    def impose(first, count, row, tile):
        """The ring cells inside ``tile`` of fields first .. first+count-1."""
        sel = inside(ring_z, ring_x, tile)
        for j in range(first, first + count):
            flat = f[j].reshape(-1).clone()
            flat[ring_idx[sel]] = 0.0 if row is None else row[j * n:(j + 1) * n][sel]
            f[j] = flat.reshape(NZ, NX)

    def window(z0, z1, x0, x1):
        wz, wx = slice(max(0, z0 - R), min(NZ, z1 + R)), slice(max(0, x0 - R), min(NX, x1 + R))
        own = (slice(z0 - wz.start, z1 - wz.start), slice(x0 - wx.start, x1 - wx.start))
        p = no_src._replace(**{k: getattr(no_src, k)[wz, wx] for k in
                               ("lam", "lam2mu", "mu_xz", "buoy_x", "buoy_z")},
                            az=no_src.az[wz], bz=no_src.bz[wz], ax=no_src.ax[:, wx],
                            bx=no_src.bx[:, wx])
        return (lambda a: a[wz, wx]), own, (slice(z0, z1), slice(x0, x1)), p

    def surface(tile):
        """The columns of ``tile`` if it is in the surface tile row, which
        must hold the ghost rows and every mirror row, else None."""
        z0, z1, x0, x1 = tile
        if image is None or not z0 <= fs < z1:
            return None
        assert z0 <= fs - R and fs + R < z1, tile
        return slice(x0, x1)

    def images(pair, fields, cols):
        """The image or transpose ``pair`` of two of ``fields`` on columns
        ``cols``, in place."""
        a, b = fields
        a[:, cols], b[:, cols] = pair(a[:, cols], b[:, cols])

    # er_setup, and the first step's stress-image transpose
    if force:
        undo(inside(sz, sx, everywhere), nt - 1)
    if record == "p":
        inject(inside(rz, rx, everywhere), nt - 1)
    if image is not None:
        cb[3], cb[4] = image.s_t(cb[3], cb[4])
    for t in reversed(range(nt)):
        k = (nt - 1 - t) % 2 if ping_pong else 0
        din, dout = duals[k], duals[1 - k] if ping_pong else duals[k]
        row = tape[t - 1] if t >= 1 else None
        w_t = wavelet[t]
        # er_s
        for tile in tiles:
            W, own, cells, p = window(*tile)
            if record == "v":
                inject(inside(rz, rx, tile), t)
            here = inside(sz, sx, tile)
            srcrow[t, here] = (cb[1][sz[here], sx[here]] if force
                               else cb[2][sz[here], sx[here]] + cb[3][sz[here], sx[here]])
            if not force:
                undo(here, t)
            vx, vz, sxx, szz, sxz = (W(a) for a in f)
            _, _, *sig = recon_stress(vx, vz, sxx, szz, sxz, p, w_t)
            z = torch.zeros_like(vx)

            def upd_s(vx_, vz_, m_, lam, l2m, mu, p=p, sxx=sxx, szz=szz, sxz=sxz):
                return step.update_s(vx_, vz_, sxx, szz, sxz, m_,
                                     p._replace(lam=lam, lam2mu=l2m, mu_xz=mu))

            _, pull = torch.func.vjp(upd_s, vx, vz, (z,) * 4, p.lam, p.lam2mu, p.mu_xz)
            vxb_s, vzb_s, dual_s, *gm = pull((W(cb[2]), W(cb[3]), W(cb[4]),
                                              tuple(W(d) for d in din[:4])))
            for j in range(3):
                f[2 + j][cells] = sig[j][own]
                g[j][cells] = g[j][cells] + gm[j][own]
            impose(2, 3, row, tile)
            cb[0][cells] = cb[0][cells] + vxb_s[own]
            cb[1][cells] = cb[1][cells] + vzb_s[own]
            for j in range(4):
                dout[j][cells] = dual_s[j][own]
            cols = surface(tile)
            if cols is not None:  # er_s_images
                images(image.s, (f[3], f[4]), cols)
                images(image.v_t, (cb[0], cb[1]), cols)
        # er_v
        for tile in tiles:
            W, own, cells, p = window(*tile)
            vx, vz, sxx, szz, sxz = (W(a) for a in f)
            vel = recon_velocity(vx, vz, sxx, szz, sxz, p)
            z = torch.zeros_like(vx)

            def upd_v(sxx_, szz_, sxz_, m_, bxm, bzm, p=p, z=z):
                return step.update_v(z, z, sxx_, szz_, sxz_, m_,
                                     p._replace(buoy_x=bxm, buoy_z=bzm))

            _, pull = torch.func.vjp(upd_v, sxx, szz, sxz, (z,) * 4, p.buoy_x, p.buoy_z)
            *sb_v, dual_v, gbx, gbz = pull((W(cb[0]), W(cb[1]), tuple(W(d) for d in din[4:])))
            for j in range(2):
                f[j][cells] = vel[j][own]
            impose(0, 2, row, tile)
            if force and t >= 1:
                undo(inside(sz, sx, tile) & ~on_image, t - 1)
            for j in range(3):
                cb[2 + j][cells] = cb[2 + j][cells] + sb_v[j][own]
            if record == "p" and t >= 1:
                inject(inside(rz, rx, tile), t - 1)
            g[3][cells] = g[3][cells] + gbx[own]
            g[4][cells] = g[4][cells] + gbz[own]
            for j in range(4):
                dout[4 + j][cells] = dual_v[j][own]
            cols = surface(tile)
            if cols is not None:  # er_v_images
                images(image.v, (f[0], f[1]), cols)
                if t >= 1:
                    images(image.s_t, (cb[3], cb[4]), cols)
                    if force:
                        undo(inside(sz, sx, tile) & on_image, t - 1)
    return tuple(g), srcrow


def _case(order, source_type, record, free_surface, nt, shape=(40, 50), pml=8, seed=0,
          edge=False):
    """A random model on a ragged padded grid (neither axis a multiple of
    the 16 x 64 tile), a surface source and a deeper one, a receiver line
    at depth 2 with a coinciding pair; the plain forward's tape and final
    fields and a random receiver cotangent, all made from ``seed``. With
    ``edge`` the first source sits on the top ring row (the free surface's
    row, so on the velocity image's rows) with a second source and three
    receivers on its cell, and one more receiver on the bottom-left ring
    corner."""
    grid = Grid(shape=shape, h=(10.0, 12.0), pml=pml, order=order, free_surface=free_surface)
    rng = np.random.default_rng(seed + order)
    vp = np.clip(2300 + 150 * rng.standard_normal(shape), 2000, 2600)
    dt = elastic_cfl_dt(grid.h, 2600.0, order, safety=0.7)
    from tpufwi_torch.propagators.elastic2d import ElasticPropagator

    prop = ElasticPropagator(grid, dt, 14.0, 2600.0, source_type=source_type, record=record,
                             device="cpu")
    mats = tuple(m.contiguous() for m in prop.material_fields(
        *(torch.as_tensor(x, dtype=torch.float32) for x in (vp, vp / 1.8, 1000.0 + 0.3 * vp))))
    prof = profile_source(grid, dt, 14.0, 2600.0)(mats[0])
    src = torch.as_tensor(np.array([[2, 20], [shape[0] // 2, shape[1] // 3]]) + grid.pad)
    rx = np.arange(3, shape[1] - 3, 3)
    rcv = np.concatenate([np.stack([np.full(rx.size, 2), rx], 1), [[2, 3], [shape[0] - 5, 7]]])
    if edge:
        top = [0, 20]
        src = torch.as_tensor(np.array([top, [shape[0] // 2, shape[1] // 3], top]) + grid.pad)
        rcv = np.concatenate([[top], rcv, [top, [shape[0] - 1, 0], top]])
    rcv = torch.as_tensor(rcv + grid.pad)
    w = torch.as_tensor(ricker_np(14.0, dt, nt, t0=0.02), dtype=torch.float32)
    args = (grid, dt, mats, prof)
    seis, tape, finals = ke.escan_forward_plain(*args, w, src, rcv, source_type, record,
                                                tape=True)
    ybar = torch.as_tensor(rng.standard_normal(tuple(seis.shape)), dtype=torch.float32)
    return args, w, ybar, tape, finals, (src, rcv)


KINDS = [("force_z", "v"), ("pressure", "p")]


@pytest.mark.parametrize("free_surface", [False, True])
@pytest.mark.parametrize("source_type,record", KINDS)
@pytest.mark.parametrize("order", [2, 4, 8])
def test_fused_walk_equals_plain_bitwise(order, source_type, record, free_surface):
    args, w, ybar, tape, finals, idx = _case(order, source_type, record, free_surface, nt=14)
    kind = (source_type, record)
    g_p, sr_p = ke.escan_reverse_plain(*args, w, ybar, tape, finals, *idx, *kind)
    g_f, sr_f = fused_walk(*args, w, ybar, tape, finals, *idx, *kind)
    assert float(g_p[0].abs().max()) > 0.0
    for name, a, b in zip(NAMES, g_f, g_p):
        assert torch.equal(a, b), (name, float((a - b).abs().max()))
    assert torch.equal(sr_f, sr_p)


@pytest.mark.parametrize("free_surface", [False, True])
def test_fused_walk_small_tiles_and_ping_pong(free_surface):
    """On 8 x 12 tiles (many tile edges inside the CPML strips) the walk
    still equals the plain reverse bitwise, and without the dual ping-pong
    it does not: a tile's reach then reads duals an earlier tile already
    updated."""
    args, w, ybar, tape, finals, idx = _case(4, "force_z", "v", free_surface, nt=10)
    small = ke.EscanPlan(8, 12, 0)
    g_p, sr_p = ke.escan_reverse_plain(*args, w, ybar, tape, finals, *idx, "force_z", "v")
    g_f, sr_f = fused_walk(*args, w, ybar, tape, finals, *idx, "force_z", "v", plan=small)
    assert all(torch.equal(a, b) for a, b in zip(g_f, g_p)) and torch.equal(sr_f, sr_p)
    g_x, _ = fused_walk(*args, w, ybar, tape, finals, *idx, "force_z", "v", plan=small,
                        ping_pong=False)
    assert not all(torch.equal(a, b) for a, b in zip(g_x, g_p))


@pytest.mark.parametrize("source_type,record,free_surface", [
    ("force_z", "v", False), ("pressure", "p", True),
])
def test_fused_walk_matches_jnp_engine(source_type, record, free_surface):
    """The walk as the port engine's reverse against the reference's jnp
    engine, test_torch_elastic_scan.py's problem and tolerance (2e-4 of
    each gradient's max)."""
    kw, dt, f0, c_max, mats, w, geom = _setup(free_surface=free_surface)
    sim_j = j_make_simulator(JGrid(**kw), dt, f0, c_max, dtype=jnp.float32, record=record,
                             source_type=source_type)
    d_obs = sim_j(*(jnp.asarray(m) for m in mats), jnp.asarray(w), geom.src_idx, geom.rcv_idx)
    mats_p = tuple(m * np.float32(1.02) for m in mats)
    sim_t = make_elastic_function(Grid(**kw), dt, f0, c_max, ke.escan_forward_plain, fused_walk,
                                  source_type, record)
    ga = _jax_grads(sim_j, mats_p, w, geom, d_obs)
    gb = _port_grads(sim_t, mats_p, w, geom, d_obs)
    for name, a, b in zip(NAMES, ga, gb):
        assert _rel(b, a) < 2e-4, f"{source_type}/{record}: {name} gradient {_rel(b, a):.3e}"


def test_fused_walk_matches_reference_scan_engine():
    """Against the reference's whole-scan engine in interpret mode (its
    Pallas kernel 9 itself), as test_torch_elastic_scan.py runs it: nt 24,
    the Ricker peaking at 0.02 s, force source and v record."""
    kw, dt, f0, c_max, mats, w, geom = _setup(nt=24)
    w = ricker_np(f0, dt, 24, t0=0.02).astype(np.float32)
    sim_j = j_make_scan(JGrid(**kw), dt, f0, c_max, source_type="force_z", record="v",
                        interpret=True)
    sim_t = make_elastic_function(Grid(**kw), dt, f0, c_max, ke.escan_forward_plain, fused_walk,
                                  "force_z", "v")
    d_obs = np.zeros((w.shape[0], geom.rcv_idx.shape[0], 2), np.float32)
    ga = _jax_grads(sim_j, mats, w, geom, d_obs)
    gb = _port_grads(sim_t, mats, w, geom, d_obs)
    for name, a, b in zip(NAMES, ga, gb):
        assert _rel(b, a) < 2e-4, f"{name} gradient {_rel(b, a):.3e}"


@pytest.mark.parametrize("order", [2, 4, 8])
@pytest.mark.parametrize("shape,pml", [((40, 50), 8), ((351, 1701), 20), ((17, 9), 3)])
def test_tile_plan_covers_every_cell_once(order, shape, pml):
    """The tiles of ``escan_tile_plan`` cover every cell of the padded grid
    exactly once (ragged edges included), the plan is the tile the library
    is built for with the largest fused pass's shared bytes (the forward's
    ``ef_s_fused``, above the reverse's er_v), and the reach numbering of
    ``FTile::reach`` fills exactly the tile's cross (its R reach along z
    and along x, not the corners) once."""
    grid = Grid(shape=shape, h=(10.0, 10.0), pml=pml, order=order)
    NZ, NX = grid.padded_shape
    R = grid.radius
    plan = ke.escan_tile_plan(grid)
    assert (plan.tz, plan.tx) == (ke.TILE_Z, ke.TILE_X) and plan.tz % ke.TILE_ROWS == 0
    cross = (plan.tz + 2 * R) * (plan.tx + 2 * R)
    assert ke.fused_smem(R, "er_v") == 4 * 7 * cross
    assert plan.smem == ke.fused_smem(R, "ef_s_fused") == 4 * (2 * cross
                                                                + 10 * plan.tz * plan.tx)
    cover = np.zeros((NZ, NX), np.int64)
    tiles = list(ke.fused_tiles(plan, NZ, NX))
    assert len(tiles) == -(-NZ // plan.tz) * -(-NX // plan.tx)
    for z0, z1, x0, x1 in tiles:
        assert z0 % plan.tz == 0 and x0 % plan.tx == 0
        cover[z0:z1, x0:x1] += 1
    assert (cover == 1).all()
    cells = ke.reach_cells(plan, R)
    assert len(cells) == len(set(cells)) == 2 * R * (plan.tz + plan.tx)
    cross = {(rz, rx) for rz in range(plan.tz + 2 * R) for rx in range(plan.tx + 2 * R)
             if (R <= rz < plan.tz + R) != (R <= rx < plan.tx + R)}
    assert set(cells) == cross


@pytest.mark.parametrize("nt", [1, 2, 5])
@pytest.mark.parametrize("free_surface", [False, True])
@pytest.mark.parametrize("source_type,record", KINDS)
def test_fused_walk_edge_cases_bitwise(nt, source_type, record, free_surface):
    """The glue's edge cases, the walk bitwise against the plain reverse:
    nt 1 and 2 (er_setup's step, the zero ring row at t = 0), two sources
    and three receivers on one cell (the chains' order), sources and
    receivers on ring cells, a source on the free surface's row (the tail
    undoes it there)."""
    args, w, ybar, tape, finals, idx = _case(4, source_type, record, free_surface, nt=nt,
                                             edge=True)
    kind = (source_type, record)
    g_p, sr_p = ke.escan_reverse_plain(*args, w, ybar, tape, finals, *idx, *kind)
    g_f, sr_f = fused_walk(*args, w, ybar, tape, finals, *idx, *kind)
    assert float(sr_p.abs().max()) > 0.0
    for name, a, b in zip(NAMES, g_f, g_p):
        assert torch.equal(a, b), (name, float((a - b).abs().max()))
    assert torch.equal(sr_f, sr_p)


def test_reverse_launches_and_variants():
    """2 launches a reverse step, with the free surface too (its images
    run in the surface tile row of er_s and er_v), plus er_setup a call and
    with the free surface the first step's stress-image transpose; on the
    CPU the wrapper is the plain version, with and without dependent
    launches, and launches nothing."""
    assert [ke.reverse_launches(fs) for fs in (False, True)] == [2, 2]
    assert [ke.reverse_launches(fs, nt=10) for fs in (False, True)] == [21, 22]
    args, w, ybar, tape, finals, idx = _case(4, "force_z", "v", False, nt=4)
    r0 = ke.escan_reverse.launches
    g_p, sr_p = ke.escan_reverse_plain(*args, w, ybar, tape, finals, *idx, "force_z", "v")
    for dep in (True, False):
        g, sr = ke.escan_reverse(*args, w, ybar, tape, finals, *idx, "force_z", "v",
                                 dependent_launch=dep)
        assert all(torch.equal(a, b) for a, b in zip(g, g_p)) and torch.equal(sr, sr_p)
    assert ke.escan_reverse.launches == r0


@pytest.mark.parametrize("order", [2, 4, 8])
@pytest.mark.parametrize("shape,pml", [((351, 1701), 20), ((40, 50), 8)])
def test_reverse_tiles_hold_each_image_pair_in_one_tile_row(order, shape, pml):
    """With the free surface the reverse walks the forward's tiles (the
    walk of ``fused_walk``, and one flag word a tile in the maps that
    ``escan_reverse`` allocates): the tile row starting at fs - 2R holds
    each ghost row fs-1-k and all of its mirror rows (fs+k for vz and sxz,
    fs+1+k for vx and szz, and the pinned row fs), and the R reach of no
    other tile row touches a ghost row; without it the rows are unshifted.
    The marine cell's padded grid (351 x 1701 at pml 20) and a small one."""
    grid = Grid(shape=shape, h=(10.0, 10.0), pml=pml, order=order, free_surface=True)
    NZ, NX = grid.padded_shape
    R, fs = grid.radius, grid.pad
    plan = ke.escan_tile_plan(grid)
    shift = ke.forward_shift(plan, grid)
    tiles = list(ke.forward_tiles(plan, grid))
    maps = ke._maps(grid, plan, shift, 0, 0, "cpu", vblocks=False)
    assert maps.numel() - 3 * NZ * NX == len(tiles)
    rows = sorted({(z0, z1) for z0, z1, _, _ in tiles})
    assert [z0 for z0, _ in rows] == [max(0, z) for z in range(-shift, NZ, plan.tz)]
    (surf,) = [(z0, z1) for z0, z1 in rows if z0 <= fs < z1]
    assert surf[0] == max(0, fs - 2 * R)
    for k in range(R):
        assert all(surf[0] <= z < surf[1] for z in (fs - 1 - k, fs + k, fs + 1 + k, fs))
    for z0, z1 in rows:
        if (z0, z1) != surf:
            assert z1 + R <= fs - R or z0 - R >= fs, (z0, z1)
    land = Grid(shape=shape, h=(10.0, 10.0), pml=pml, order=order)
    assert ke.forward_shift(plan, land) == 0
