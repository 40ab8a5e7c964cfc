"""The 3D whole-scan engine's tiled cell passes and the reverse's line
pass, on the CPU.

The tiled passes (``csrc/acoustic3d_kernels.cuh``: ``march`` in
``f3_cells_tiled``, ``r3_cells1_tiled`` and ``r3_cells2_tiled``, each one
walk over the whole grid; a tile that reaches the CPML also stages strip
values, or in ``r3_cells2_tiled`` copies its cells' transposed CPML terms)
and the line pass ``r3_lines`` (the terms, a block per group of whole lines
along one axis) run only on the card, where ``tests/test_torch_cuda.py``
holds them bitwise against the gather passes. Here the launch plan
``a3d_tile_plan``, the walk's regions (``walk_regions``, ``slab_tiles``)
and numpy transcriptions of ``march``'s addressing (each thread's copies of
a plane tile and their masks, the register column, the ring of plane tiles
in shared memory, a tile's strip tiles, y columns and own strip values, and
its cells' term operands) and of ``r3_lines`` (each block's lines, their
windows in shared memory, its strip and term cells) are held to the plan's
rules:

- the whole grid's walk covers every cell of the padded grid exactly once,
  and its tiles that reach the CPML every cell of the shell, at the 3D main
  path's, the full Overthrust and the bench grids and at small grids:
  ragged, with an empty box, a one-tile box and ragged slabs, at orders 2,
  4 and 8, free surface on and off;
- every copy that is not masked lies inside the halo layout, its strip
  array or its term array, no cell reads a masked field value (masked
  copies are poisoned with NaN), each ring slot read holds the plane
  expected, and a staged strip value outside the strips, or a term outside
  its axis's reach, is the zero the tails expect;
- the three D2 stencils the walk gives, the D1 stencils of strip arrays
  along each axis that a tile's cells read from its staged values, and the
  line pass's y and terms equal the reference's ``apply_stencil`` (fp64,
  1e-12 of max: the same taps summed in another order); the line pass
  writes every strip cell and every cell within S + R of a face once an
  axis, where the two bands of a short axis overlap too;
- at least 4 blocks a streaming multiprocessor and the fewest waves x
  (planes + re-read halo planes) a chunk at the main path's, the full
  Overthrust and the bench grids (fields larger than the L2), the block
  count alone on fields that fit it, the rings within a block's shared
  memory and r3_cells2_tiled's within two blocks an SM, and the plan's
  tile, look-ahead and rings the ones the header compiles;
- an unknown variant raises on the CPU too, and on the CPU both variants
  return the plain versions' outputs unchanged.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufwi.kernels.stencils import apply_stencil as j_apply_stencil

import chip_smoke
from tpufwi_torch.grid import Grid
from tpufwi_torch.kernels import acoustic3d_scan as k3
from tpufwi_torch.kernels.build import CSRC


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _grid(ny, nz, nx, pml, order):
    return Grid(shape=(ny, nz, nx), h=(10.0, 11.0, 12.0), pml=pml, order=order)


# the 3D main path's (428 x 188 x 588), the full Overthrust (829 x 215 x 829)
# and the bench's (849 x 235 x 849, orders 8, 4, 2 as exp_3d_lap merged runs)
LARGE = {
    "main": (400, 160, 560, 10, 8),
    "overthrust": (801, 187, 801, 10, 8),
    "bench": (801, 187, 801, 20, 8),
    "bench_order4": (801, 187, 801, 20, 4),
    "bench_order2": (801, 187, 801, 20, 2),
}
# (shape, pml, order[, free surface]): padded 45 x 37 x 61 (every padded
# dimension odd); boxes of 17 x 33 (one past the (16, 32) tile) in z and x;
# a box 7 planes deep cut in chunks; at each order with the free surface on
# and off; an empty box (a physical extent of 2R); a box of one full tile;
# slabs of 13 cells and full rows of 88 (2 tiles and 24)
SMALL = {
    "odd": (29, 21, 45, 4, 8),
    "tile_plus_one": (24, 21, 37, 2, 4),
    "ragged_chunks": (9, 30, 40, 3, 2),
    "order8_fs": (20, 24, 28, 6, 8, True),
    "order4_fs": (25, 17, 41, 4, 4, True),
    "order2_fs": (27, 19, 43, 4, 2, True),
    "empty_box": (20, 8, 28, 6, 8),
    "empty_box_order2": (2, 11, 9, 3, 2, True),
    "one_tile_box": (20, 20, 36, 3, 4),
    "ragged_slabs": (22, 37, 70, 5, 8),
}


def _small(name):
    shape, (pml, order, *fs) = SMALL[name][:3], SMALL[name][3:]
    return Grid(shape=shape, h=(10.0, 11.0, 12.0), pml=pml, order=order,
                free_surface=bool(fs and fs[0]))


def _blocks(grid, plan):
    """(x tiles, z tiles, y chunks) of the interior box."""
    _, (ny, nz, nx) = k3.interior_box(grid)
    return (-(-nx // plan.tx), -(-nz // plan.tz), -(-ny // plan.cy))


def tiles(grid, plan):
    """The whole grid's walk (every tiled pass's) as the kernels' blocks
    take it: (y0, y1, z0, x0, nz, nx) each."""
    return [t for r in k3.walk_regions(grid) for t in k3.slab_tiles(r, plan.cy)]


def _reach(grid, tile):
    """csrc tile_span's reach: whether the tile has cells within S + R of a
    face of each axis."""
    y0, y1, z0, x0, nz, nx = tile
    NY, NZ, NX = grid.padded_shape
    SE = k3.term_depth(grid)
    return (y0 < SE or y1 > NY - SE, z0 < SE or z0 + nz > NZ - SE, x0 < SE or x0 + nx > NX - SE)


def strip_arrays(grid, rng, depth=None):
    """Random strip arrays of the three axes in the kernels' packed layout
    (2 ``depth`` along the axis, default S: the term arrays are S + R deep)
    and each on the padded grid, zero outside the bands (what strip_at
    reads; where the bands of a short axis overlap, the low band's)."""
    N = grid.padded_shape
    S = depth or k3.strip_depth(grid)
    packed, full = [], []
    for ax in range(3):
        shape = list(N)
        shape[ax] = 2 * S
        a = rng.standard_normal(shape)
        c, own = k3._bands(N[ax], S)
        a[(slice(None),) * ax + (~own,)] = 0.0  # slots no cell owns
        f = np.zeros(N)
        f[(slice(None),) * ax + (c[own],)] = a[(slice(None),) * ax + (own,)]
        packed.append(a.ravel())
        full.append(f)
    return packed, full


def _strip_coord(c, n, S):
    """csrc strip_coord, on arrays."""
    c = np.asarray(c)
    return np.where((c < 0) | (c >= n), -1, np.where(c < S, c, np.where(c >= n - S, c - n + 2 * S, -1)))


def walk(grid, plan, field, d2, spans, strips=None, d1=None, terms=None):
    """Run ``march`` over ``field`` in the halo layout (a flat fp64 array)
    with the D2 taps ``d2`` (3, 2R+1), for the tiles ``spans``, as the
    kernel addresses it: each thread's copies of a plane tile into the field
    ring (FIELD_SLOTS slots, a slot holding grid plane p at p mod
    FIELD_SLOTS), the column below the chunk loaded directly, the column
    front and the tile of plane y read from their slots. Copies land at
    once here; the slots read are checked to hold the plane expected. With
    ``strips`` (the packed strip arrays of the three axes) and the D1 taps
    ``d1`` the tiles also stage them as f3's tiles do (x and z tiles in
    their ring, y columns whose front is an operand, the cell's own
    values), and each cell within S + R of a face takes D1 along that axis
    from the staged values. With ``terms`` (the packed term arrays, S + R
    deep) a tile that reaches the CPML copies its cells' terms as
    r3_cells2_tiled's do: an operand per axis it reaches (a zero fill at
    cells outside the reach), in the operand ring (OP_SLOTS slots, plane p
    at p mod OP_SLOTS, refilled AHEAD planes ahead), zero on the axes it
    does not reach. Returns (d2y, d2z, d2x on the padded grid, the D1
    stencils of the strips along each axis (NaN where unread), runs of
    each cell, the flat offsets of every field copy and load that is not
    masked, the strip copies' offsets per axis, the terms each cell read
    (NaN without ``terms``), the term copies' offsets per axis). Masked
    field copies fill NaN."""
    NY, NZ, NX = N = grid.padded_shape
    R = grid.radius
    S = k3.strip_depth(grid)
    SE, S2 = S + R, 2 * S
    tz, tx = plan.tz, plan.tx
    W, ez, ex = tx + 2 * R, NZ + 2 * R, NX + 2 * R
    ly, plane = ez * ex, (tz + 2 * R) * (tx + 2 * R)
    ns, no, threads = k3.FIELD_SLOTS, k3.OP_SLOTS, tz * tx
    per = -(-plane // threads)
    out = np.full((3, NY, NZ, NX), np.nan)
    d1s = np.full((3, NY, NZ, NX), np.nan)
    tout = np.full((3, NY, NZ, NX), np.nan)
    runs = np.zeros((NY, NZ, NX), np.int64)
    loaded = [np.zeros(0, np.int64)]
    sloaded = [[np.zeros(0, np.int64)] for _ in range(3)]
    tloaded = [[np.zeros(0, np.int64)] for _ in range(3)]
    t = np.arange(threads)
    tzs, txs = t // tx, t % tx
    mine = (tzs + R) * W + txs + R
    e = t[:, None] + np.arange(per)[None, :] * threads
    r, c = e // W, e % W
    xt_n, zt_n = tz * W, (tz + 2 * R) * tx
    ex_ = t[:, None] + np.arange(-(-xt_n // threads))[None, :] * threads
    xr, xc = ex_ // W, ex_ % W
    ez_ = t[:, None] + np.arange(-(-zt_n // threads))[None, :] * threads
    zr, zc = ez_ // tx, ez_ % tx
    for y0, y1, z0, x0, nz, nx in spans:
        z, x = z0 + tzs, x0 + txs
        on = (tzs < nz) & (txs < nx)
        zh, xh = z0 + r, x0 + c
        goff = np.where(e >= plane, -2, np.where(
            (zh < ez) & (xh < ex) & (r < nz + 2 * R) & (c < nx + 2 * R), zh * ex + xh, -1))
        own = (z + R) * ex + x + R
        ring = np.full((ns, plane), -np.inf)  # -inf: never written
        held = np.full(ns, -1)
        reach = _reach(grid, (y0, y1, z0, x0, nz, nx))
        sring = {}  # plane: (x tile, z tile) of the strips
        oring = {}  # operand slot: (plane, the three terms of each thread)
        tjz, tjx = _strip_coord(z, NZ, SE), _strip_coord(x, NX, SE)

        def copy_field(p):
            ok = goff >= 0
            loaded.append((p + R) * ly + goff[ok])
            ring[p % ns, e[goff != -2]] = np.where(
                ok, field[(p + R) * ly + np.maximum(goff, 0)], np.nan)[goff != -2]
            held[p % ns] = p

        def slot(p):
            assert held[p % ns] == p
            return ring[p % ns]

        def copy_strips(p):
            """plane p's x tile (rows < nz by columns +- R) and z tile (rows
            +- R below nz + 2R by columns < nx): the kernel's offsets, and
            what it stages there (zero where masked)"""
            xs, zs = np.full(xt_n, np.nan), np.full(zt_n, np.nan)
            if reach[2]:
                js = _strip_coord(x0 - R + xc, NX, S)
                off = np.where(ex_ >= xt_n, -2, np.where((xr < nz) & (js >= 0), (z0 + xr) * S2 + js, -1))
                m = off >= 0
                sloaded[2].append(p * NZ * S2 + off[m])
                xs[ex_[off != -2]] = np.where(m, strips[2][p * NZ * S2 + np.maximum(off, 0)], 0.0)[off != -2]
            if reach[1]:
                js = _strip_coord(z0 - R + zr, NZ, S)
                off = np.where(ez_ >= zt_n, -2, np.where((zc < nx) & (zr < nz + 2 * R) & (js >= 0),
                                                         js * NX + x0 + zc, -1))
                m = off >= 0
                sloaded[1].append(p * S2 * NX + off[m])
                zs[ez_[off != -2]] = np.where(m, strips[1][p * S2 * NX + np.maximum(off, 0)], 0.0)[off != -2]
            sring[p] = (xs, zs)

        def copy_terms(p):
            """plane p's term operands (none off the tile's cells), into
            slot p mod OP_SLOTS"""
            vals = np.full((3, threads), np.nan)
            tjy = np.full(threads, int(_strip_coord(p, NY, SE)))
            for ax, (tj, off) in enumerate((
                    (tjy, (tjy * NZ + z) * NX + x), (tjz, (p * 2 * SE + tjz) * NX + x),
                    (tjx, (p * NZ + z) * 2 * SE + tjx))):
                if reach[ax]:
                    m = on & (tj >= 0)
                    tloaded[ax].append(off[m])
                    vals[ax] = np.where(m, terms[ax][np.where(m, off, 0)], 0.0)
            oring[p % no] = (p, vals)

        def ycol(p):
            """the y column's value at plane p: the operand copy of the
            cell's y-strip value (zero outside the strips)"""
            jy = int(_strip_coord(p, NY, S))
            if jy < 0:
                return np.zeros(threads)
            o = (jy * NZ + z) * NX + x
            sloaded[0].append(o[on])
            return np.where(on, strips[0][np.where(on, o, 0)], 0.0)

        q = [None] * (2 * R + 1)
        for k in range(1, R + 1):
            loaded.append((y0 + k - 1) * ly + own[on])
            q[k] = np.where(on, field[(y0 + k - 1) * ly + np.where(on, own, 0)], 0.0)
        col = None if strips is None else [None] + [ycol(y0 + k - 1 - R)
                                                    for k in range(1, 2 * R + 1)]
        for pl in range(y0, y0 + R):
            copy_field(pl)
        for a in range(k3.AHEAD):
            if y0 + R + a < y1 + R:
                copy_field(y0 + R + a)
            if strips is not None and y0 + a < y1:
                copy_strips(y0 + a)
            if terms is not None and any(reach) and y0 + a < y1:
                copy_terms(y0 + a)
        for k in range(R + 1, 2 * R + 1):
            q[k] = slot(y0 + k - R - 1)[mine]
        for y in range(y0, y1):
            if y + R + k3.AHEAD < y1 + R:
                copy_field(y + R + k3.AHEAD)
            if strips is not None and y + k3.AHEAD < y1:
                copy_strips(y + k3.AHEAD)
            if terms is not None and any(reach):
                if y + k3.AHEAD < y1:
                    copy_terms(y + k3.AHEAD)
                at, vals = oring[y % no]  # read after the refill is started
                assert at == y
                vals = np.where(np.array(reach)[:, None], vals, 0.0)  # zeroed as read
                tout[:, y, z[on], x[on]] = vals[:, on]
            elif terms is not None:
                tout[:, y, z[on], x[on]] = 0.0  # a box tile
            q = q[1:] + [slot(y + R)[mine]]
            f = slot(y)
            taps = [mine + (k - R) * W for k in range(2 * R + 1)]
            assert not np.isneginf(f[np.concatenate(taps)][np.tile(on, 2 * R + 1)]).any()
            d2y = sum(d2[0, k] * q[k] for k in range(2 * R + 1))
            d2z = sum(d2[1, k] * f[mine + (k - R) * W] for k in range(2 * R + 1))
            d2x = sum(d2[2, k] * f[mine + k - R] for k in range(2 * R + 1))
            out[:, y, z[on], x[on]] = np.stack([d2y, d2z, d2x])[:, on]
            runs[y, z[on], x[on]] += 1
            if strips is None:
                continue
            col = col[1:] + [ycol(y + R)]
            xs, zs = sring.pop(y)
            coords = (np.full(threads, y), z, x)
            for ax in range(3):
                cells = on & ((coords[ax] < SE) | (coords[ax] >= N[ax] - SE))
                if not cells.any():
                    continue
                assert reach[ax]
                if ax == 0:
                    vals = [col[k] for k in range(2 * R + 1)]
                elif ax == 1:
                    vals = [zs[(tzs + k) * tx + txs] for k in range(2 * R + 1)]
                else:
                    vals = [xs[tzs * W + txs + k] for k in range(2 * R + 1)]
                acc = sum(d1[ax, k] * vals[k] for k in range(2 * R + 1) if k != R)
                d1s[ax, y, z[cells], x[cells]] = acc[cells]
            # the cell's own strip values: the operand copies' offsets
            jz, jx = _strip_coord(z, NZ, S), _strip_coord(x, NX, S)
            jy = int(_strip_coord(y, NY, S))
            if reach[0] and jy >= 0:
                sloaded[0].append(((jy * NZ + z) * NX + x)[on])
            if reach[1]:
                sloaded[1].append(((y * S2 + jz) * NX + x)[on & (jz >= 0)])
            if reach[2]:
                sloaded[2].append(((y * NZ + z) * S2 + jx)[on & (jx >= 0)])
    return (out, d1s, runs, np.concatenate(loaded), [np.concatenate(v) for v in sloaded], tout,
            [np.concatenate(v) for v in tloaded])


def _taps(grid, row):
    R = grid.radius
    return np.array(k3.taps_arg(grid)[:], np.float64).reshape(6, 9)[3 * row:3 * row + 3, : 2 * R + 1]


@pytest.mark.parametrize("cy", ["plan", "one_chunk", 3])
@pytest.mark.parametrize("name", list(SMALL))
def test_walk_and_shell_cover_the_grid_and_match_the_reference_stencils(name, cy):
    """The whole grid's walk runs every cell once, copies only inside the
    halo layout, the strip arrays and the term arrays, reads no masked
    field value, and gives the reference's D2 stencils of the field; with
    strips staged (f3), within S + R of a face, D1 stencils of the strip
    arrays from their staged values (zero outside the strips); with terms
    (r3_cells2), each cell's terms, zero outside each axis's reach (the
    shell's cells the ones that read any): on the plan's chunks (1 plane on
    these small fields), one chunk of the whole box (the whole grid when the
    box is empty), and chunks of 3 with a ragged last one."""
    grid = _small(name)
    plan = k3.a3d_tile_plan(grid)
    NY, NZ, NX = grid.padded_shape
    if cy != "plan":
        ny = k3.interior_box(grid)[1][0] or NY
        plan = plan._replace(cy=ny if cy == "one_chunk" else cy)
    R = grid.radius
    rng = np.random.default_rng(NY * NZ * NX)
    f = rng.standard_normal((NY, NZ, NX))
    halo = np.pad(f, R).ravel()
    d2, d1 = _taps(grid, 1), _taps(grid, 0)
    packed, full = strip_arrays(grid, rng)
    tpacked, tfull = strip_arrays(grid, rng, k3.term_depth(grid))
    walk_tiles = tiles(grid, plan)
    L, (ny, nz, nx) = k3.interior_box(grid)
    box = np.zeros((NY, NZ, NX), bool)
    box[L:L + ny, L:L + nz, L:L + nx] = True
    # the walk with its cells' terms, as r3_cells2
    tout, _, truns, tl, _, terms, tloads = walk(grid, plan, halo, d2, walk_tiles, terms=tpacked)
    assert (truns == 1).all()
    assert (np.abs(terms).sum(0)[box] == 0).all() and (terms == np.stack(tfull)).all()
    assert k3.shell_cells(grid) == (~box).sum()
    # the walk staging the strips, as f3 (and r3_cells1, its own values)
    wout, wd1, wruns, wloaded, wstrips, _, _ = walk(grid, plan, halo, d2, walk_tiles, packed, d1)
    assert (wruns == 1).all()
    S = k3.strip_depth(grid)
    for ax in range(3):
        if tloads[ax].size:
            assert tloads[ax].min() >= 0 and tloads[ax].max() < tpacked[ax].size
    for out, d1s, lo, strip_loads in ((tout, None, tl, None), (wout, wd1, wloaded, wstrips)):
        assert lo.min() >= 0 and lo.max() < halo.size
        assert np.isfinite(out).all()  # no cell read a masked (NaN) copy
        for ax in range(3):
            ref = np.asarray(j_apply_stencil(jnp.asarray(f), tuple(d2[ax]), ax))
            err = np.abs(out[ax] - ref).max() / np.abs(ref).max()
            assert err <= 1e-12, (name, ax, err)
        if d1s is None:
            continue
        for ax in range(3):
            if strip_loads[ax].size:
                assert strip_loads[ax].min() >= 0 and strip_loads[ax].max() < packed[ax].size
            # D1 of the strips along ax at every cell within S + R of its faces
            c = np.arange(grid.padded_shape[ax])
            near = (c < S + R) | (c >= grid.padded_shape[ax] - S - R)
            shape = [1, 1, 1]
            shape[ax] = -1
            reach = np.broadcast_to(near.reshape(shape), (NY, NZ, NX))
            assert np.isfinite(d1s[ax][reach]).all() and np.isnan(d1s[ax][~reach]).all()
            taps = d1[ax].copy()
            taps[R] = 0.0
            ref = np.asarray(j_apply_stencil(jnp.asarray(full[ax]), tuple(taps), ax))[reach]
            err = np.abs(d1s[ax][reach] - ref).max() / np.abs(ref).max()
            assert err <= 1e-12, (name, "d1", ax, err)


LINES, LINE_THREADS = 32, 256  # csrc kLines, kLineThreads


def _band_off(N, ax, y, z, x, j, depth):
    """csrc band_off: the offset in an axis-ax array 2 depth deep on ax."""
    return ((j * N[1] + z) * N[2] + x, (y * 2 * depth + j) * N[2] + x,
            (y * N[1] + z) * 2 * depth + j)[ax]


def line_pass(grid, lam, c2, w, pbar, prof, d1, d2):
    """Run ``r3_lines`` as the kernel addresses it, in fp64: for each axis
    the line groups a block each (x fastest), each block's items split over
    its lines as its threads take them, its shared memory a NaN-poisoned
    array of ``line_floats`` (every window slot read must have been
    written), its lines' windows (w and a zeroed y of both bands; C and
    lambda where the band's strip cells read them), then each strip cell's
    phibar -> (phibar', y), y into every window holding its cell, then each
    owned term cell's t = D2 w - D1 y from the windows. ``lam``, ``c2`` on
    the padded grid; ``w``, ``pbar`` the three packed strip arrays; ``prof``
    the packed profiles. Returns (phibar' and the terms per axis, the terms
    NaN where unwritten; how often each strip cell and each term slot was
    written)."""
    N = grid.padded_shape
    R, S = grid.radius, k3.strip_depth(grid)
    SE, L = S + R, S + 3 * R
    hl, hc = np.pad(lam, R), np.pad(c2, R)
    pb_out, t_out, pb_runs, t_runs = [], [], [], []
    for ax in range(3):
        n, step = N[ax], LINES if ax < 2 else 1
        pb = pbar[ax].copy()
        tv = np.full(pbar[ax].size // (2 * S) * 2 * SE, np.nan)
        runs_pb, runs_t = np.zeros(pb.size, np.int64), np.zeros(tv.size, np.int64)
        gx, gz = -(-N[2] // LINES), -(-N[1] // LINES)
        a, b_ = prof[4 * S * ax:4 * S * ax + 2 * S], prof[4 * S * ax + 2 * S:4 * S * (ax + 1)]

        def win0(b):
            return np.where(b == 0, -R, n - S - 2 * R)

        for g in range((N[1] * gx, N[0] * gx, N[0] * gz)[ax]):
            y0 = z0 = x0 = 0
            if ax < 2:
                y0, z0 = (0, g // gx) if ax == 0 else (g // gx, 0)
                x0 = g % gx * LINES
                lines = min(LINES, N[2] - x0)
            else:
                y0, z0 = g // gz, g % gz * LINES
                lines = min(LINES, N[1] - z0)

            def split(count):
                e = np.arange(LINES * count)
                l, i = (e % LINES, e // LINES) if ax < 2 else (e // count, e % count)
                keep = l < lines
                return l[keep], i[keep]

            def cell(l, c):
                y, z, x = np.full_like(l, y0), np.full_like(l, z0), np.full_like(l, x0)
                if ax < 2:
                    x = x + l
                else:
                    z = z + l
                return [c if d == ax else v for d, v in enumerate((y, z, x))]

            def slot(arr, b, s, l):
                return (((arr * 2 + b) * L + s) * LINES + l if ax < 2
                        else ((arr * 2 + b) * LINES + l) * L + s)

            sh = np.full((4 * 2 * L + 2 * S) * LINES, np.nan)  # csrc line_floats
            pbs = 4 * 2 * L * LINES  # the strip cells' phibar, item order
            l, i = split(2 * L)
            b, s = i // L, i % L
            c = win0(b) + s
            y, z, x = cell(l, c)
            j = _strip_coord(c, n, S)
            off = _band_off(N, ax, y, z, x, np.maximum(j, 0), S)
            sh[slot(0, b, s, l)] = np.where(j >= 0, w[ax][np.where(j >= 0, off, 0)], 0.0)
            sh[slot(1, b, s, l)] = 0.0
            m = np.where(b == 0, s < S + 2 * R, s >= R)
            assert ((c[m] >= -R) & (c[m] < n + R)).all()  # inside the halo layout
            h = (y[m] + R, z[m] + R, x[m] + R)
            sh[slot(2, b[m], s[m], l[m])] = hc[h]
            sh[slot(3, b[m], s[m], l[m])] = hl[h]
            e = np.arange(LINES * 2 * S)
            el, ei = (e % LINES, e // LINES) if ax < 2 else (e // (2 * S), e % (2 * S))
            e, el, ei = e[el < lines], el[el < lines], ei[el < lines]
            y, z, x = cell(el, np.where(ei < S, ei, n - 2 * S + ei))
            sh[pbs + e] = pb[_band_off(N, ax, y, z, x, ei, S)]
            # (barrier) the strip cells
            l, i = split(2 * S)
            b = (i >= S).astype(np.int64)
            c = np.where(i < S, i, n - 2 * S + i)
            s = c - win0(b)
            y, z, x = cell(l, c)
            o = _band_off(N, ax, y, z, x, i, S)
            acc = np.zeros(l.size)
            for k in range(2 * R + 1):
                if k != R:
                    hk = (k - R) * step
                    acc = d1[ax, k] * (sh[slot(2, b, s, l) + hk] * sh[slot(3, b, s, l) + hk]
                                       + sh[slot(0, b, s, l) + hk]) + acc
            pt = sh[pbs + e] - acc  # (e: the same items as the phibar copies)
            pb[o] = b_[i] * pt
            runs_pb[o] += 1
            sh[slot(1, b, s, l)] = a[i] * pt
            so = c - win0(1 - b)
            m = (so >= 0) & (so < L)
            sh[slot(1, 1 - b[m], so[m], l[m])] = (a[i] * pt)[m]
            # (barrier) the term cells, each owned once
            l, i = split(2 * SE)
            c = np.where(i < SE, i, n - 2 * SE + i)
            keep = _strip_coord(c, n, SE) == i
            l, i, c = l[keep], i[keep], c[keep]
            b = (i >= SE).astype(np.int64)
            s = c - win0(b)
            y, z, x = cell(l, c)
            acc = np.zeros(l.size)
            for k in range(2 * R + 1):
                hk = (k - R) * step
                acc = d2[ax, k] * sh[slot(0, b, s, l) + hk] + acc
                if k != R:
                    acc = -d1[ax, k] * sh[slot(1, b, s, l) + hk] + acc
            o = _band_off(N, ax, y, z, x, i, SE)
            tv[o] = acc
            runs_t[o] += 1
        pb_out.append(pb)
        t_out.append(tv)
        pb_runs.append(runs_pb)
        t_runs.append(runs_t)
    return pb_out, t_out, pb_runs, t_runs


# physical extents under 2R: the term bands of y and z overlap (n < 2(S +
# R)), and a low-band term cell's taps reach y of the high strip
SHORT = {"short_axes": (6, 3, 29, 3, 8)}


@pytest.mark.parametrize("name", list(SMALL) + list(SHORT))
def test_line_pass_covers_its_cells_once_and_matches_the_reference_stencils(name):
    """The line pass, as its blocks address their lines and windows, writes
    every strip cell's phibar' and every term cell's t (each cell within S
    + R of a face of the axis, once, where the two bands of an axis shorter
    than 2R overlap too) once an axis, reads no window slot it did not fill,
    and gives
    the reference's stencils (``apply_stencil``, fp64, 1e-12 of max):
    phibar' = b (phibar - D1 (C lambda + w)) and t = D2 w - D1 y with y = a
    (phibar - D1 (C lambda + w)) on the strips, zero off them; and so does
    the wrapper's plain version, ``a3d_lines_plain``."""
    grid = _small(name) if name in SMALL else _grid(*SHORT[name])
    N = NY, NZ, NX = grid.padded_shape
    R, S, SE = grid.radius, k3.strip_depth(grid), k3.term_depth(grid)
    rng = np.random.default_rng(NY * NZ * NX + 1)
    lam, c2 = rng.standard_normal(N), rng.uniform(0.05, 0.3, N)
    (w, wfull), (pbar, pfull) = strip_arrays(grid, rng), strip_arrays(grid, rng)
    prof = rng.uniform(0.1, 0.9, 12 * S)
    d2, d1 = _taps(grid, 1), _taps(grid, 0)
    pb, terms, pb_runs, t_runs = line_pass(grid, lam, c2, w, pbar, prof, d1, d2)
    u = c2 * lam
    for ax in range(3):
        n = N[ax]
        assert (pb_runs[ax] == 1).all()
        c, own = k3._bands(n, SE)
        assert own.sum() == min(n, 2 * SE)
        shape = list(N)
        shape[ax] = 2 * SE
        runs = t_runs[ax].reshape(shape)
        idx = (slice(None),) * ax
        assert (runs[idx + (own,)] == 1).all() and (runs[idx + (~own,)] == 0).all()
        # the reference, on the padded grid
        taps = d1[ax].copy()
        taps[R] = 0.0
        d1v = np.asarray(j_apply_stencil(jnp.asarray(u + wfull[ax]), tuple(taps), ax))
        sc, _ = k3._bands(n, S)
        pt = pfull[ax] - d1v
        a = np.zeros(n)
        bb = np.zeros(n)
        a[sc] = prof[4 * S * ax:4 * S * ax + 2 * S]
        bb[sc] = prof[4 * S * ax + 2 * S:4 * S * (ax + 1)]
        bshape = [1, 1, 1]
        bshape[ax] = -1
        a, bb = a.reshape(bshape), bb.reshape(bshape)
        ref_pb = np.take(bb * pt, sc, axis=ax).ravel()
        yfull = a * pt  # zero off the strips (a is)
        ref_t = (np.asarray(j_apply_stencil(jnp.asarray(wfull[ax]), tuple(d2[ax]), ax))
                 - np.asarray(j_apply_stencil(jnp.asarray(yfull), tuple(taps), ax)))
        got_t = np.zeros(N)
        got_t[idx + (c[own],)] = terms[ax].reshape(shape)[idx + (own,)]
        near = (np.arange(n) < SE) | (np.arange(n) >= n - SE)
        ref_t = ref_t * near.reshape(bshape)
        for got, ref in ((pb[ax], ref_pb), (got_t, ref_t)):
            assert np.isfinite(got).all()
            err = np.abs(got - ref).max() / np.abs(ref).max()
            assert err <= 1e-12, (name, ax, err)
    tw = lambda a: torch.as_tensor(np.concatenate(a))  # noqa: E731
    prof_t = [torch.as_tensor(prof[2 * S * k:2 * S * (k + 1)]) for k in range(6)]
    ppb, pt_ = k3.a3d_lines_plain(grid, torch.as_tensor(lam), torch.as_tensor(c2), prof_t,
                                  tw(w), tw(pbar))
    got = np.concatenate([np.nan_to_num(t) for t in terms])
    for a, b in ((ppb.numpy(), np.concatenate(pb)), (pt_.numpy(), got)):
        assert np.abs(a - b).max() <= 1e-12 * np.abs(b).max()


def _axis_cover(n, b):
    """Cells of an axis of n run by blocks of b (the last one ragged)."""
    runs = np.zeros(n, np.int64)
    for lo in range(0, -(-n // b) * b, b):
        runs[lo:min(lo + b, n)] += 1
    return runs


@pytest.mark.parametrize("name", list(LARGE) + [n for n in SMALL if "empty" not in n])
def test_plan_tiles_cover_the_box_once_and_loads_stay_inside(name):
    """Per axis (the tiling is separable): the box's y chunks, z and x tiles
    run each of its cells once, and the shell holds the rest (its slabs
    counted), every shell cell in a walk tile that reaches the CPML; a
    column's planes stay within the halo layout, and a tile's z and x copies
    are masked exactly where they leave it."""
    grid = _grid(*LARGE[name]) if name in LARGE else _small(name)
    plan = k3.a3d_tile_plan(grid)
    NY, NZ, NX = grid.padded_shape
    R = grid.radius
    L, box = k3.interior_box(grid)
    assert min(box) > 0 and L == k3.strip_depth(grid) + R
    for n, b in zip(box, (plan.cy, plan.tz, plan.tx)):
        assert (_axis_cover(n, b) == 1).all()
    ny, nz, nx = box
    slabs = 2 * L * NZ * NX + ny * (2 * L * NX + 2 * L * nz)
    assert slabs == NY * NZ * NX - ny * nz * nx == k3.shell_cells(grid)
    walk_tiles = tiles(grid, plan)
    cells = [(y1 - y0) * n_z * n_x for y0, y1, _, _, n_z, n_x in walk_tiles]
    assert sum(cells) == NY * NZ * NX and min(cells) > 0
    # a tile reaching no CPML lies in the box: per axis, its cells do
    for t in walk_tiles:
        if not any(_reach(grid, t)):
            y0, y1, z0, x0, n_z, n_x = t
            assert L <= y0 and y1 <= L + ny and L <= z0 and z0 + n_z <= L + nz
            assert L <= x0 and x0 + n_x <= L + nx
    gx, gz, gy = _blocks(grid, plan)
    # y: a chunk [y0, y1) of the box copies halo planes y0 .. y1 - 1 + 2R
    assert L + ny - 1 + 2 * R < NY + 2 * R
    # z and x: the last tile spans halo coordinates z0 .. z0 + tile + 2R - 1
    for n, b, blocks, m in ((NZ, plan.tz, gz, nz), (NX, plan.tx, gx, nx)):
        ext = n + 2 * R
        coords = L + (blocks - 1) * b + np.arange(b + 2 * R)
        masked = coords >= ext
        # a cell of the box reads halo coordinates up to L + m - 1 + 2R
        assert not masked[coords <= L + m - 1 + 2 * R].any()
        assert (coords[~masked] < ext).all()


@pytest.mark.parametrize("name", ["main", "overthrust", "bench", "bench_order4",
                                  "bench_order2"])
def test_plan_follows_its_rules(name):
    """At least 4 blocks an SM (528) from a whole plane's tiles, no chunk
    count within that rule with fewer waves x (planes + 2R re-read halo
    planes) a chunk (these fields outgrow the L2), the largest pass's rings
    within a block's 227 KB of shared memory."""
    grid = _grid(*LARGE[name])
    plan = k3.a3d_tile_plan(grid)
    R = grid.radius
    NY, NZ, NX = grid.padded_shape
    assert 4 * NY * NZ * NX > k3.L2_BYTES
    tiles = -(-NZ // plan.tz) * -(-NX // plan.tx)
    ny = k3.interior_box(grid)[1][0]
    gy = -(-ny // plan.cy)
    assert tiles * gy >= 4 * 132 == k3.MIN_BLOCKS

    def cost(c):
        return -(-tiles * c // (k3.RESIDENT * k3.SMS)) * (-(-ny // c) + 2 * R)

    allowed = [c for c in range(1, ny + 1) if tiles * c >= k3.MIN_BLOCKS]
    assert cost(gy) == min(cost(c) for c in allowed)
    S = k3.strip_depth(grid)
    assert plan.smem == max(k3.ring_bytes(R, kernel, S) for kernel in k3.RINGS)
    assert plan.smem <= 227 * 1024  # a block's limit, above 48 KB by attribute
    assert plan.tx % 32 == 0


def test_plan_tile_is_the_compiled_tile():
    """The header's kTZ, kTX, kAhead and rings are the plan's (the C side
    rejects any other plan), the rings hold the planes the walk keeps
    (planes y .. y + R + AHEAD of the field, y .. y + AHEAD of the operands,
    R <= 4); the main path's box (392 x 152 x 552) makes 180 tiles and
    needs y chunks, and the whole grid's walk 2280, 1256 of them reaching
    the CPML (two rings an SM's shared memory for every walk)."""
    src = (CSRC / "acoustic3d_kernels.cuh").read_text()
    consts = {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
              for k in ("kTZ", "kTX", "kAhead", "kFieldSlots", "kOpSlots")}
    assert tuple(consts.values()) == (k3.TILE_Z, k3.TILE_X, k3.AHEAD, k3.FIELD_SLOTS,
                                      k3.OP_SLOTS)
    rings = dict(re.findall(r"using (Ring\w+) = Ring<R, ([\w, ]+)>;", src))
    for name, kernel in (("RingF3S", "f3_cells_tiled"), ("RingR1S", "r3_cells1_tiled"),
                         ("RingR2T", "r3_cells2_tiled")):
        nf, nh, ng, *strips = rings[name].replace("kAhead", str(k3.AHEAD)).replace(
            "kOpSlots", str(k3.OP_SLOTS)).split(", ")
        strips = list(map(int, strips)) + [0, 0, k3.OP_SLOTS, 0][len(strips):]
        assert (int(nf), int(nh) + int(ng), *strips) == k3.RINGS[kernel]
    grid = _grid(*LARGE["main"])
    plan = k3.a3d_tile_plan(grid)
    gx, gz, gy = _blocks(grid, plan)
    assert (gx * gz, gy, plan.cy) == (180, 8, 49)
    walk_tiles = tiles(grid, plan)
    assert (len(walk_tiles), sum(any(_reach(grid, t)) for t in walk_tiles)) == (2280, 1256)
    # (two blocks an SM of the walks' rings under ~96 KB each: two of 108.7
    # KB ran the box's tiles 14% slower on the H100)
    S = k3.strip_depth(grid)
    kb = {k: k3.ring_bytes(4, k, S) / 1024 for k in k3.RINGS}
    assert kb["f3_cells_tiled"] < 96 and kb["r3_cells1_tiled"] < 96
    per_sm = {k: 228 * 1024 // (k3.ring_bytes(4, k, S) + 1024) for k in k3.RINGS}
    assert per_sm == {"f3_cells_tiled": 2, "r3_cells1_tiled": 3, "r3_cells2_tiled": 2}
    assert 4 + k3.AHEAD + 1 <= k3.FIELD_SLOTS and k3.AHEAD + 1 <= k3.OP_SLOTS


@pytest.mark.parametrize("name", list(LARGE))
def test_r3_cells2_ring_leaves_room_for_two_blocks(name):
    """r3_cells2_tiled's ring (C and lambda_t: 2 x FIELD_SLOTS plane tiles;
    lambda_{t+1} and the three terms: 4 x OP_SLOTS operand tiles) is 92 KB
    at order 8, at most 96 KB at every order (where the H100 ran the tiles
    no slower, and a 108.7 KB ring 14% slower), so RESIDENT = 2 blocks an SM
    hold it, with the 1 KB the card reserves a block, as they hold the
    other walks' rings."""
    grid = _grid(*LARGE[name])
    R, S = grid.radius, k3.strip_depth(grid)
    ring = k3.ring_bytes(R, "r3_cells2_tiled", S)
    plane = (k3.TILE_Z + 2 * R) * (k3.TILE_X + 2 * R)
    assert ring == 4 * (2 * k3.FIELD_SLOTS * plane + 4 * k3.OP_SLOTS * k3.TILE_Z * k3.TILE_X)
    assert ring <= 96 * 1024 and (R != 4 or ring == 94208)
    assert k3.RESIDENT == 2
    for kernel in k3.RINGS:
        assert 228 * 1024 // (k3.ring_bytes(R, kernel, S) + 1024) >= k3.RESIDENT


def test_plan_on_a_field_within_the_l2_takes_the_block_count():
    """The smoke's free-surface grid (92 x 76 x 108, 3 MB a field; its box
    56 x 40 x 72): at least one block an SM (a whole plane makes 20 tiles),
    then the fewest waves x (planes + 2R halo planes): chunks of 5 planes
    (108 blocks of the box, 400 of the whole grid's walk), where 1-plane
    chunks made 1840."""
    grid = Grid(shape=(64, 48, 80), h=(25.0,) * 3, pml=10, order=8, free_surface=True)
    plan = k3.a3d_tile_plan(grid)
    assert grid.padded_shape == (92, 76, 108)
    assert plan.cy == 5 and np.prod(_blocks(grid, plan)) == 108
    assert len(tiles(grid, plan)) == 400


def _cpu_case(nt=12):
    grid = Grid(shape=(14, 12, 16), h=(10.0, 11.0, 12.0), pml=4, order=4)
    rng = np.random.default_rng(3)
    vp = np.clip(2200 + 150 * rng.standard_normal(grid.shape), 1900, 2600)
    dt = grid.cfl_dt(2600.0, safety=0.7)
    src = np.array([[7, 2, 8]])
    rcv = np.array([[y, 3, x] for y in range(2, 12, 4) for x in range(2, 14, 5)])
    return chip_smoke.a3d_inputs(torch.device("cpu"), grid, vp, dt, 18.0, 2600.0, nt, src, rcv)


def test_unknown_variant_raises_on_the_cpu():
    args, w, si, ri = _cpu_case(nt=4)
    with pytest.raises(ValueError, match="variant"):
        k3.a3d_forward(*args, w, si, ri, variant="tiles")
    seis, tape, ppen, plast, _ = k3.a3d_forward_plain(*args, w, si, ri, torch.float32)
    with pytest.raises(ValueError, match="variant"):
        k3.a3d_reverse(*args, w, seis, tape, ppen, plast, si, ri, variant="gathered")


def test_reverse_pass_raises_on_the_cpu():
    """a3d_reverse_pass launches the card's passes alone: an unknown pass
    and a CPU buffer raise; a3d_lines takes its plain version on the CPU."""
    (grid, c2, prof), w, si, ri = _cpu_case(nt=4)
    lam = torch.linspace(-1.0, 1.0, c2.numel()).reshape(c2.shape)
    buf = k3.pass_buffers(grid, lam, c2, prof)
    with pytest.raises(ValueError, match="pass"):
        k3.a3d_reverse_pass(grid, "shell", buf)
    with pytest.raises(ValueError, match="no kernel"):
        k3.a3d_reverse_pass(grid, "lines", buf)
    ns = k3.strip_cells(grid)
    wv, pb = torch.full((ns,), 0.5), torch.full((ns,), -0.25)
    got = k3.a3d_lines(grid, lam, c2, prof, wv, pb)
    for a, b in zip(got, k3.a3d_lines_plain(grid, lam, c2, prof, wv, pb)):
        assert torch.equal(a, b)
    assert got[1].numel() == k3.strip_cells(grid, k3.term_depth(grid))


@pytest.mark.parametrize("variant", k3.VARIANTS)
def test_cpu_path_is_the_plain_version(variant):
    """On CPU tensors both variants return the plain versions' outputs,
    bitwise."""
    args, w, si, ri = _cpu_case()
    ref = k3.a3d_forward_plain(*args, w, si, ri, torch.float32, illum=True)
    got = k3.a3d_forward(*args, w, si, ri, torch.float32, illum=True, variant=variant)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    seis, tape, ppen, plast, _ = ref
    rev_ref = k3.a3d_reverse_plain(*args, w, seis, tape, ppen, plast, si, ri, True)
    rev = k3.a3d_reverse(*args, w, seis, tape, ppen, plast, si, ri, return_field=True,
                         variant=variant)
    for a, b in zip(rev, rev_ref):
        assert torch.equal(a, b)
