"""The fused elastic forward's walk (``escan_forward``, TPU kernel 8)
transcribed in plain torch, on the CPU, fp32.

The fused forward runs two launches a step (csrc/elastic2d_scan.cu): stage
V over the whole grid in place (the per-step engine's ``ef_v``), which first
adds the step before's force sources to vz; then ``ef_s_fused``
(csrc/elastic2d_kernels.cuh) as the tiles of ``forward_tiles``: a tile
copies v over its cells and their R cross, a free-surface ghost row from
its mirror row (the velocity image), and runs stage S, the sources (a force
source's vz only for the receivers and the tape), the surface pin and the
stress image, the receivers and the ring-tape entries of its own cells,
writing its own stresses, stage S's memories and, at its ghost cells, the
imaged v. No tile reads what another writes: the stresses and memories are
read at their own cell only, a ghost row's v never. With the free surface
the tile rows are shifted so that one starts at fs - 2R: that row's tiles
hold the ghost rows and their mirrors, so the stress image stays inside a
tile. After the last step a tail launch adds its force sources.

``fused_forward_walk`` runs that walk with the plain version's own
functions (the step twin's ``update_v`` / ``update_s``, its images, its
sources) on each tile's window, the tiles in turn and in place; v outside
the tile's R cross is NaN, as the kernel copies none there. Per-cell torch
arithmetic does not depend on the window, so the walk must equal
``escan_forward_plain`` bitwise; through the port's engine it must agree
with the reference's jnp engine within test_torch_elastic_scan.py's
tolerances. The plan's tile walk is checked as the C side computes it.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_elastic_fused import KINDS, _case
from test_torch_elastic_scan import NAMES, _jax_grads, _port_grads, _rel, _setup

from tpufwi.grid import Grid as JGrid
from tpufwi.propagators.elastic2d import make_elastic_simulator as j_make_simulator

from tpufwi_torch.grid import Grid
from tpufwi_torch.kernels import elastic2d_scan as ke
from tpufwi_torch.kernels.acoustic2d_scanres import ring_plan
from tpufwi_torch.kernels.elastic2d_eager import (
    inject_sources,
    make_elastic_step,
    make_free_surface_image,
)
from tpufwi_torch.propagators.elastic2d import make_elastic_function

FIELDS = ("vx", "vz", "sxx", "szz", "sxz")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def fused_forward_walk(grid, dt, mats, profiles, wavelet, src_idx, rcv_idx,
                       source_type="pressure", record="v", tape=False, plan=None,
                       defer=True, shift=None):
    """The fused forward's walk (``escan_forward_plain``'s contract). Per
    step: the step before's force sources added to vz and stage V over the
    grid, in place; then each tile of ``fused_tiles(plan, NZ, NX, shift)``
    (``shift``: ``forward_shift``'s unless given) on its window (its cells
    and their R reach, clipped to the grid): v imaged (ghost rows from their
    mirrors) and kept on the R cross, stage S, its own sources, the stress
    image when the tile row starts at fs - 2R, then its own stresses and
    stage S's memories, the image at its ghost cells, its receivers and its
    ring-tape entries. ``defer=False``: the tile writes its force sources'
    vz itself, so a tile after it reads that vz with the source added."""
    params = ke._params(grid, mats, profiles, src_idx, rcv_idx)
    step = make_elastic_step(grid, dt, source_type, record)
    image = step.image
    NZ, NX = grid.padded_shape
    R = grid.radius
    plan = plan or ke.escan_tile_plan(grid)
    shift = ke.forward_shift(plan, grid) if shift is None else shift
    fs = grid.pad if grid.free_surface else None
    force = source_type == "force_z"
    dtype = mats[0].dtype

    def zeros():
        return torch.zeros((NZ, NX), dtype=dtype)

    f = [zeros() for _ in range(5)]  # vx, vz, sxx, szz, sxz
    vmem, smem = [zeros() for _ in range(4)], [zeros() for _ in range(4)]
    ring_idx = ring_plan(grid, "cpu")[0]
    n = ring_idx.shape[0]
    ring_zx = torch.stack([ring_idx // NX, ring_idx % NX], 1)
    nt, nrec = wavelet.shape[0], rcv_idx.shape[0]
    seis = torch.empty((nt, nrec, 2) if record == "v" else (nt, nrec), dtype=dtype)
    rows = []

    def mine(idx, z0, z1, x0, x1):
        return torch.nonzero((idx[:, 0] >= z0) & (idx[:, 0] < z1) & (idx[:, 1] >= x0)
                             & (idx[:, 1] < x1))[:, 0]

    def add_force(vz, t):
        return inject_sources(vz, f[2], f[3], params, wavelet[t], dt, source_type)[0]

    for t in range(nt):
        if force and defer and t >= 1:
            f[1] = add_force(f[1], t - 1)
        f[0], f[1], vmem = step.update_v(*f, tuple(vmem), params)
        row = torch.empty(5 * n, dtype=dtype) if tape else None
        for z0, z1, x0, x1 in ke.fused_tiles(plan, NZ, NX, shift):
            surf = fs is not None and (z0 if z0 > 0 else -shift) == fs - 2 * R
            wz = slice(max(0, z0 - R), min(NZ, z1 + R))
            wx = slice(max(0, x0 - R), min(NX, x1 + R))
            off = torch.tensor([wz.start, wx.start])
            own = (slice(z0 - wz.start, z1 - wz.start), slice(x0 - wx.start, x1 - wx.start))
            cells = (slice(z0, z1), slice(x0, x1))
            ks, kr = mine(src_idx, z0, z1, x0, x1), mine(rcv_idx, z0, z1, x0, x1)
            p = params._replace(
                **{k: getattr(params, k)[wz, wx] for k in ("lam", "lam2mu", "mu_xz", "buoy_x",
                                                           "buoy_z")},
                az=params.az[wz], bz=params.bz[wz], ax=params.ax[:, wx], bx=params.bx[:, wx],
                src_idx=src_idx[ks] - off, rcv_idx=rcv_idx[kr] - off)

            def W(a):
                return a[wz, wx]

            vx, vz = (W(a) for a in (image.v(f[0], f[1]) if image is not None else f[:2]))
            zz = torch.arange(wz.start, wz.stop)[:, None]
            xx = torch.arange(wx.start, wx.stop)[None, :]
            cross = (((zz >= z0) & (zz < z1)) | ((xx >= x0) & (xx < x1)))
            vx = torch.where(cross, vx, torch.nan)
            vz = torch.where(cross, vz, torch.nan)
            sxx, szz, sxz, ms = step.update_s(vx, vz, W(f[2]), W(f[3]), W(f[4]),
                                              tuple(W(m) for m in smem), p)
            vz_out, sxx, szz = inject_sources(vz, sxx, szz, p, wavelet[t], dt, source_type)
            if surf:
                szz, sxz = make_free_surface_image(types.SimpleNamespace(
                    free_surface=True, pad=fs - wz.start, radius=R)).s(szz, sxz)
            f[0][cells] = vx[own]
            f[1][cells] = (vz if defer else vz_out)[own]
            for j, a in ((2, sxx), (3, szz), (4, sxz)):
                f[j][cells] = a[own]
            for j in range(4):
                smem[j][cells] = ms[j][own]
            rz, rx = p.rcv_idx[:, 0], p.rcv_idx[:, 1]
            if record == "v":
                seis[t, kr] = torch.stack([vz_out[rz, rx], vx[rz, rx]], dim=-1)
            else:
                seis[t, kr] = -(sxx[rz, rx] + szz[rz, rx]) / 2.0
            if row is not None:
                g = mine(ring_zx, z0, z1, x0, x1)
                for j, a in enumerate((vx, vz_out, sxx, szz, sxz)):
                    row[j * n + g] = a[ring_zx[g, 0] - wz.start, ring_zx[g, 1] - wx.start]
        if tape:
            rows.append(row)
    if force and defer:
        f[1] = add_force(f[1], nt - 1)
    return seis, (torch.stack(rows) if tape else None), tuple(f)


def _assert_same(got, ref):
    (s_g, t_g, f_g), (s_r, t_r, f_r) = got, ref
    assert torch.equal(s_g, s_r), ("seis", float((s_g - s_r).abs().max()))
    assert (t_g is None) == (t_r is None)
    if t_g is not None:
        assert torch.equal(t_g, t_r), ("tape", float((t_g - t_r).abs().max()))
    for name, a, b in zip(FIELDS, f_g, f_r):
        assert torch.equal(a, b), (name, float((a - b).abs().max()))


@pytest.mark.parametrize("free_surface", [False, True])
@pytest.mark.parametrize("source_type,record", KINDS)
@pytest.mark.parametrize("order", [2, 4, 8])
def test_fused_forward_walk_equals_plain_bitwise(order, source_type, record, free_surface):
    args, w, _, _, _, idx = _case(order, source_type, record, free_surface, nt=12)
    kind = (source_type, record)
    ref = ke.escan_forward_plain(*args, w, *idx, *kind, tape=True)
    got = fused_forward_walk(*args, w, *idx, *kind, tape=True)
    assert float(ref[0].abs().max()) > 0.0
    _assert_same(got, ref)


@pytest.mark.parametrize("free_surface", [False, True])
def test_fused_forward_walk_small_tiles_and_ping_pong(free_surface):
    """On 7 x 12 tiles (ragged at both grid edges, tile edges inside every
    CPML strip) the walk still equals the plain forward bitwise. With the
    force sources written by stage S's tiles rather than deferred to the
    next stage V it does not, on tiles whose edge runs beside a source: the
    tile after it then reads vz with the step's source already added. With
    the free surface and the tile rows not shifted it does not either: the
    ghost rows and their mirrors then fall in different tiles, and the
    stress image runs in none."""
    args, w, _, _, _, idx = _case(4, "force_z", "v", free_surface, nt=10)
    small = ke.EscanPlan(7, 12, 0)
    grid = args[0]
    assert ke.forward_shift(small, grid) == ((7 - (grid.pad - 4) % 7) % 7 if free_surface
                                            else 0)
    ref = ke.escan_forward_plain(*args, w, *idx, "force_z", "v", tape=True)
    _assert_same(fused_forward_walk(*args, w, *idx, "force_z", "v", tape=True, plan=small), ref)
    beside = ke.EscanPlan(16, int(idx[0][1, 1]) + 1, 0)  # an edge right of the deep source
    bad = fused_forward_walk(*args, w, *idx, "force_z", "v", plan=beside, defer=False)
    assert not all(torch.equal(a, b) for a, b in zip(bad[2], ref[2]))
    if free_surface:
        shift = (ke.forward_shift(small, grid) + 3) % 7
        bad = fused_forward_walk(*args, w, *idx, "force_z", "v", plan=small, shift=shift)
        assert not all(torch.equal(a, b) for a, b in zip(bad[2], ref[2]))


@pytest.mark.parametrize("source_type,record,free_surface", [
    ("force_z", "v", False), ("pressure", "p", True),
])
def test_fused_forward_walk_matches_jnp_engine(source_type, record, free_surface):
    """The walk as the port engine's forward (the reverse its plain
    version, fed the walk's tape and final fields) against the reference's
    jnp engine, test_torch_elastic_scan.py's problem and tolerances:
    seismogram 1e-5 of its max, every gradient 2e-4 of its max."""
    kw, dt, f0, c_max, mats, w, geom = _setup(free_surface=free_surface)
    sim_j = j_make_simulator(JGrid(**kw), dt, f0, c_max, dtype=jnp.float32, record=record,
                             source_type=source_type)
    d_obs = sim_j(*(jnp.asarray(m) for m in mats), jnp.asarray(w), geom.src_idx, geom.rcv_idx)
    mats_p = tuple(m * np.float32(1.02) for m in mats)
    plan = ke.EscanPlan(32, 64, 0)  # few windows keep the 90 steps cheap

    def forward(*a, **kw_):
        return fused_forward_walk(*a, **kw_, plan=plan)

    sim_t = make_elastic_function(Grid(**kw), dt, f0, c_max, forward, ke.escan_reverse_plain,
                                  source_type, record)
    src, rcv = (torch.as_tensor(np.array(i)) for i in (geom.src_idx, geom.rcv_idx))
    with torch.no_grad():
        seis = sim_t(*(torch.as_tensor(np.array(m)) for m in mats), torch.as_tensor(w), src, rcv)
    assert _rel(seis.numpy(), np.asarray(d_obs)) < 1e-5
    ga = _jax_grads(sim_j, mats_p, w, geom, d_obs)
    gb = _port_grads(sim_t, mats_p, w, geom, d_obs)
    for name, a, b in zip(NAMES, ga, gb):
        assert _rel(b, a) < 2e-4, f"{source_type}/{record}: {name} gradient {_rel(b, a):.3e}"


@pytest.mark.parametrize("order", [2, 4, 8])
@pytest.mark.parametrize("free_surface", [False, True])
@pytest.mark.parametrize("shape,pml", [((40, 50), 8), ((351, 1701), 20), ((17, 9), 3),
                                       ((30, 20), 0)])
def test_forward_tile_plan(order, free_surface, shape, pml):
    """The forward's tiles cover every cell of the padded grid exactly once
    (ragged first and last rows included); with the free surface exactly
    one tile row starts at fs - 2R (block row by at by tz - shift, as
    ``ef_shift`` computes it), and its own rows hold fs - R .. fs + R; the
    plan's shared bytes are the forward's ``ef_s_fused``, the largest fused
    pass's, within 48 KB."""
    grid = Grid(shape=shape, h=(10.0, 10.0), pml=pml, order=order,
                free_surface=free_surface)
    NZ, NX = grid.padded_shape
    R = grid.radius
    plan = ke.escan_tile_plan(grid)
    shift = ke.forward_shift(plan, grid)
    assert 0 <= shift < plan.tz
    assert ke.fused_smem(R, "er_v") < plan.smem == ke.fused_smem(R, "ef_s_fused") <= 48 * 1024
    tiles = list(ke.forward_tiles(plan, grid))
    assert len(tiles) == -(-(NZ + shift) // plan.tz) * -(-NX // plan.tx)
    cover = np.zeros((NZ, NX), np.int64)
    for z0, z1, x0, x1 in tiles:
        assert (z0 + shift) % plan.tz == 0 or z0 == 0
        cover[z0:z1, x0:x1] += 1
    assert (cover == 1).all()
    if free_surface:
        fs = grid.pad
        starts = {z0 if z0 > 0 else -shift for z0, _, _, _ in tiles}
        assert fs - 2 * R in starts
        z0, z1 = max(fs - 2 * R, 0), min(fs - 2 * R + plan.tz, NZ)
        assert z0 <= fs - R and fs + R < z1


def test_forward_launches_and_variants():
    """Two launches a forward step with and without the free surface
    (ef_setup and, with a force source, its tail once a call); on the CPU
    the wrapper is the plain version, with and without dependent launches,
    and launches nothing."""
    assert ke.FORWARD_LAUNCHES == 2
    args, w, _, _, _, idx = _case(2, "pressure", "p", True, nt=4)
    f0 = ke.escan_forward.launches
    ref = ke.escan_forward_plain(*args, w, *idx, "pressure", "p", tape=True)
    for dep in (True, False):
        _assert_same(ke.escan_forward(*args, w, *idx, "pressure", "p", tape=True,
                                      dependent_launch=dep), ref)
    assert ke.escan_forward.launches == f0
