"""The 3D whole-scan engine's tiled cell passes, on the CPU.

The tiled passes (``csrc/acoustic3d_kernels.cuh``: ``march`` in
``f3_cells_tiled``, ``r3_cells1_tiled``, ``r3_cells2_tiled`` over the
interior box, and ``f3_shell``, ``r3_shell1``, ``r3_shell2`` over the
CPML-reach shell) run only on the card, where ``tests/test_torch_cuda.py``
holds them bitwise against the gather passes. Here the launch plan
``a3d_tile_plan`` and numpy transcriptions of ``march``'s addressing (each
thread's copies of a plane tile and their masks, the register column, the
ring of plane tiles in shared memory) and of ``shell_cell`` are held to
the plan's rules:

- the box's chunks and tiles and the shell cover every cell of the padded
  grid exactly once, at the 3D main path's, the full Overthrust and the
  bench grids and at small ragged grids;
- every copy that is not masked lies inside the halo layout, no cell of the
  box reads a masked value (masked copies are poisoned with NaN), and each
  ring slot read holds the plane expected;
- the three D2 stencils the walk gives equal the reference's
  ``apply_stencil`` (fp64, 1e-12 of max: the same taps summed in another
  order);
- at least 4 blocks a streaming multiprocessor and a y re-read of at most
  10% at the main path's, the full Overthrust and the bench grids (fields
  larger than the L2), the block count alone on fields that fit it, the
  rings within a block's shared memory, and the plan's tile, look-ahead
  and rings the ones the header compiles;
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
# padded 45 x 37 x 61 (every padded dimension odd); boxes of 17 x 33 (one
# past the (16, 32) tile) in z and x; a box 7 planes deep cut in chunks
SMALL = {
    "odd": (29, 21, 45, 4, 8),
    "tile_plus_one": (24, 21, 37, 2, 4),
    "ragged_chunks": (9, 30, 40, 3, 2),
}


def _blocks(grid, plan):
    """(x tiles, z tiles, y chunks) of the interior box."""
    _, (ny, nz, nx) = k3.interior_box(grid)
    return (-(-nx // plan.tx), -(-nz // plan.tz), -(-ny // plan.cy))


def shell_cells(grid):
    """``shell_cell`` for every shell index: (y, z, x) arrays."""
    NY, NZ, NX = grid.padded_shape
    L, (ny, nz, nx) = k3.interior_box(grid)
    e = np.arange(NY * NZ * NX - ny * nz * nx)
    plane = NZ * NX
    low = NY * plane if ny == 0 else L * plane
    mid = plane - nz * nx
    slab = (e < low) | (e >= low + ny * mid)
    f = np.where(e < low, e, e - low - ny * mid)
    yy = np.where(e < low, 0, L + ny)
    y = np.where(slab, yy + f // plane, 0)
    r = np.where(slab, f % plane, 0)
    z, x = r // NX, r % NX
    m = ~slab
    em = e[m] - low
    ym = L + em // mid
    rm = em - (ym - L) * mid
    zm, xm = rm // NX, rm % NX  # the low z slab
    rx = rm - L * NX
    xs = (rx >= 0) & (rx < 2 * L * nz)  # the x slabs of the middle rows
    j = rx % (2 * L)
    zm = np.where(xs, L + rx // (2 * L), zm)
    xm = np.where(xs, np.where(j < L, j, NX - 2 * L + j), xm)
    rh = rx - 2 * L * nz  # the high z slab
    hz = rx >= 2 * L * nz
    zm = np.where(hz, L + nz + rh // NX, zm)
    xm = np.where(hz, rh % NX, xm)
    y[m], z[m], x[m] = ym, zm, xm
    return y, z, x


def walk(grid, plan, field, d2):
    """Run ``march`` over ``field`` in the halo layout (a flat fp64 array)
    with the D2 taps ``d2`` (3, 2R+1), as the kernel addresses it: the
    box's tiles, each thread's copies of a plane tile into the field ring
    (FIELD_SLOTS slots, a slot holding grid plane p at p mod FIELD_SLOTS), the
    column below the chunk loaded directly, the column front and the tile
    of plane y read from their slots. Copies land at once here; the slots
    read are checked to hold the plane expected. Returns (d2y, d2z, d2x on
    the padded grid, runs of each cell, the flat offsets of every copy and
    load that is not masked). Masked copies fill NaN."""
    NY, NZ, NX = grid.padded_shape
    R = grid.radius
    L, (bny, bnz, bnx) = k3.interior_box(grid)
    tz, tx, cy = plan.tz, plan.tx, plan.cy
    W, ez, ex = tx + 2 * R, NZ + 2 * R, NX + 2 * R
    ly, plane = ez * ex, (tz + 2 * R) * (tx + 2 * R)
    ns, threads = k3.FIELD_SLOTS, tz * tx
    per = -(-plane // threads)
    out = np.full((3, NY, NZ, NX), np.nan)
    runs = np.zeros((NY, NZ, NX), np.int64)
    loaded = [np.zeros(0, np.int64)]
    t = np.arange(threads)
    tzs, txs = t // tx, t % tx
    mine = (tzs + R) * W + txs + R
    e = t[:, None] + np.arange(per)[None, :] * threads
    r, c = e // W, e % W
    gx, gz, gy = _blocks(grid, plan)
    for by in range(gy):
        for bz in range(gz):
            for bx in range(gx):
                z0, x0 = L + bz * tz, L + bx * tx
                z, x = z0 + tzs, x0 + txs
                on = (z < L + bnz) & (x < L + bnx)
                zh, xh = z0 + r, x0 + c
                goff = np.where(e >= plane, -2, np.where((zh < ez) & (xh < ex), zh * ex + xh, -1))
                own = (z + R) * ex + x + R
                ring = np.full((ns, plane), -np.inf)  # -inf: never written
                held = np.full(ns, -1)

                def copy_field(p):
                    ok = goff >= 0
                    loaded.append((p + R) * ly + goff[ok])
                    ring[p % ns, e[goff != -2]] = np.where(
                        ok, field[(p + R) * ly + np.maximum(goff, 0)], np.nan)[goff != -2]
                    held[p % ns] = p

                def slot(p):
                    assert held[p % ns] == p
                    return ring[p % ns]

                y0, y1 = L + by * cy, min(L + by * cy + cy, L + bny)
                q = [None] * (2 * R + 1)
                for k in range(1, R + 1):
                    loaded.append((y0 + k - 1) * ly + own[on])
                    q[k] = np.where(on, field[(y0 + k - 1) * ly + np.where(on, own, 0)], 0.0)
                for pl in range(y0, y0 + R):
                    copy_field(pl)
                for a in range(k3.AHEAD):
                    if y0 + R + a < y1 + R:
                        copy_field(y0 + R + a)
                for k in range(R + 1, 2 * R + 1):
                    q[k] = slot(y0 + k - R - 1)[mine]
                for y in range(y0, y1):
                    if y + R + k3.AHEAD < y1 + R:
                        copy_field(y + R + k3.AHEAD)
                    q = q[1:] + [slot(y + R)[mine]]
                    f = slot(y)
                    taps = [mine + (k - R) * W for k in range(2 * R + 1)]
                    assert not np.isneginf(f[np.concatenate(taps)][np.tile(on, 2 * R + 1)]).any()
                    d2y = sum(d2[0, k] * q[k] for k in range(2 * R + 1))
                    d2z = sum(d2[1, k] * f[mine + (k - R) * W] for k in range(2 * R + 1))
                    d2x = sum(d2[2, k] * f[mine + k - R] for k in range(2 * R + 1))
                    out[:, y, z[on], x[on]] = np.stack([d2y, d2z, d2x])[:, on]
                    runs[y, z[on], x[on]] += 1
    return out, runs, np.concatenate(loaded)


def _d2_taps(grid):
    R = grid.radius
    return np.array(k3.taps_arg(grid)[:], np.float64).reshape(6, 9)[3:, : 2 * R + 1]


@pytest.mark.parametrize("cy", ["plan", "one_chunk", 3])
@pytest.mark.parametrize("name", list(SMALL))
def test_walk_and_shell_cover_the_grid_and_match_the_reference_stencils(name, cy):
    """The box's walk and the shell run every cell once, the walk copies
    only inside the halo layout, reads no masked value, and its D2 stencils
    are the reference's: on the plan's chunks (1 plane on these small
    fields), one chunk of the whole box, and chunks of 3 with a ragged last
    one."""
    grid = _grid(*SMALL[name])
    plan = k3.a3d_tile_plan(grid)
    L, (ny, nz, nx) = k3.interior_box(grid)
    if cy != "plan":
        plan = plan._replace(cy=ny if cy == "one_chunk" else cy)
    NY, NZ, NX = grid.padded_shape
    R = grid.radius
    rng = np.random.default_rng(NY * NZ * NX)
    f = rng.standard_normal((NY, NZ, NX))
    halo = np.pad(f, R).ravel()
    d2 = _d2_taps(grid)
    out, runs, loaded = walk(grid, plan, halo, d2)
    box = np.zeros((NY, NZ, NX), bool)
    box[L:L + ny, L:L + nz, L:L + nx] = True
    assert box.sum() > 0 and (runs == box).all()
    sy, sz, sx = shell_cells(grid)
    np.add.at(runs, (sy, sz, sx), 1)
    assert (runs == 1).all()
    assert loaded.min() >= 0 and loaded.max() < halo.size
    assert np.isfinite(out[:, box]).all()  # no cell read a masked (NaN) copy
    for ax in range(3):
        ref = np.asarray(j_apply_stencil(jnp.asarray(f), tuple(d2[ax]), ax))[box]
        err = np.abs(out[ax][box] - ref).max() / np.abs(ref).max()
        assert err <= 1e-12, (name, ax, err)


def _axis_cover(n, b):
    """Cells of an axis of n run by blocks of b (the last one ragged)."""
    runs = np.zeros(n, np.int64)
    for lo in range(0, -(-n // b) * b, b):
        runs[lo:min(lo + b, n)] += 1
    return runs


@pytest.mark.parametrize("name", list(LARGE) + list(SMALL))
def test_plan_tiles_cover_the_box_once_and_loads_stay_inside(name):
    """Per axis (the tiling is separable): the box's y chunks, z and x tiles
    run each of its cells once, and the shell holds the rest (its slabs
    counted); a column's planes stay within the halo layout, and a tile's
    z and x copies are masked exactly where they leave it."""
    grid = _grid(*(LARGE | SMALL)[name])
    plan = k3.a3d_tile_plan(grid)
    NY, NZ, NX = grid.padded_shape
    R = grid.radius
    L, box = k3.interior_box(grid)
    assert min(box) > 0 and L == k3.strip_depth(grid) + R
    for n, b in zip(box, (plan.cy, plan.tz, plan.tx)):
        assert (_axis_cover(n, b) == 1).all()
    ny, nz, nx = box
    slabs = 2 * L * NZ * NX + ny * (2 * L * NX + 2 * L * nz)
    assert slabs == NY * NZ * NX - ny * nz * nx
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
    """At least 4 blocks an SM (528), a y re-read 2R / cy of at most 10%,
    no chunk count within those rules with fewer waves x planes, the
    largest pass's rings within a block's 227 KB of shared memory."""
    grid = _grid(*LARGE[name])
    plan = k3.a3d_tile_plan(grid)
    R = grid.radius
    gx, gz, gy = _blocks(grid, plan)
    tiles = gx * gz
    assert tiles * gy >= 4 * 132 == k3.MIN_BLOCKS
    assert 2 * R / plan.cy <= 0.1
    ny = k3.interior_box(grid)[1][0]

    def cost(c):
        return -(-tiles * c // (k3.RESIDENT * k3.SMS)) * -(-ny // c)

    allowed = [c for c in range(1, ny + 1)
               if tiles * c >= k3.MIN_BLOCKS and -(-ny // c) >= 20 * R]
    assert cost(gy) == min(cost(c) for c in allowed)
    assert plan.smem == max(k3.ring_bytes(R, kernel) for kernel in k3.RINGS)
    assert plan.smem <= 227 * 1024  # a block's limit, above 48 KB by attribute
    assert plan.tx % 32 == 0


def test_plan_tile_is_the_compiled_tile():
    """The header's kTZ, kTX, kAhead and rings are the plan's (the C side
    rejects any other plan), the rings hold the planes the walk keeps
    (planes y .. y + R + AHEAD of the field, y .. y + AHEAD of the
    operands, R <= 4); the main path's box (392 x 152 x 552) makes 180
    tiles and needs y chunks."""
    src = (CSRC / "acoustic3d_kernels.cuh").read_text()
    consts = {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
              for k in ("kTZ", "kTX", "kAhead", "kFieldSlots", "kOpSlots")}
    assert tuple(consts.values()) == (k3.TILE_Z, k3.TILE_X, k3.AHEAD, k3.FIELD_SLOTS,
                                      k3.OP_SLOTS)
    rings = dict(re.findall(r"using (Ring\w+) = Ring<R, (\d+, \d+, \d+)>;", src))
    for name, kernel in (("RingF3", "f3_cells_tiled"), ("RingR1", "r3_cells1_tiled"),
                         ("RingR2", "r3_cells2_tiled")):
        nf, nh, ng = map(int, rings[name].split(", "))
        assert (nf, nh + ng) == k3.RINGS[kernel]
    plan = k3.a3d_tile_plan(_grid(*LARGE["main"]))
    gx, gz, gy = _blocks(_grid(*LARGE["main"]), plan)
    assert (gx * gz, gy, plan.cy) == (180, 4, 98)
    assert 4 + k3.AHEAD + 1 <= k3.FIELD_SLOTS and k3.AHEAD + 1 <= k3.OP_SLOTS


def test_plan_on_a_field_within_the_l2_takes_the_block_count():
    """The smoke's free-surface grid (92 x 76 x 108, 3 MB a field; its box
    56 x 40 x 72): chunks of 1 plane (504 blocks), where the re-read floor
    would leave 9."""
    grid = Grid(shape=(64, 48, 80), h=(25.0,) * 3, pml=10, order=8, free_surface=True)
    plan = k3.a3d_tile_plan(grid)
    assert grid.padded_shape == (92, 76, 108)
    assert plan.cy == 1 and np.prod(_blocks(grid, plan)) == 504


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
