"""The fused whole-scan steps' walk (``scanres_forward`` and
``scanres_reverse_snap``, TPU kernels 1 and 2)
transcribed in plain torch, on the CPU, fp32.

The CUDA passes ``fwd_fused`` and ``rev_fused`` (csrc/acoustic2d_scanres.cu)
run each time step as the tiles of ``scanres_tile_plan``: a tile reads its
window (its cells and their 2R reach, clipped to the grid) of the step's
inputs and writes only its own cells. The forward reads phi from one set of
planes and writes phi' to the other (ping-pong), rewrites P_{t-2} with P_t
in place, and adds its own cells' sources, receivers, ring-tape entries and
illumination. The reverse reads psibar and phibar from one set and writes
the other; the receiver-cotangent injection of lambda_{t-1} and its surface
pin run in the tile that writes lambda_{t-1} (lambda_{nt-1}: once a call,
before the first step), which also writes lambda at its sources.

``fused_forward`` and ``fused_reverse`` run that walk with the plain
version's own functions (the step twin ``make_acoustic_step`` on each
tile's window, its transpose through ``torch.func.vjp``), the tiles in turn
and in place, so a tile that read what an earlier one wrote in the same
step would show. Per-cell torch arithmetic does not depend on the window,
so the walks must equal ``scanres_forward_plain`` and
``scanres_reverse_snap_plain`` bitwise, and through the port's engine they
must agree with the reference within test_torch_scanres.py's tolerances.
The plan's tile walk is checked as the C side computes it.
"""

import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_scanres import GTOL, SNAP_GTOL, _setup

from tpufwi.acquisition import Geometry as JGeometry
from tpufwi.adjoint import make_simulator as j_make_simulator
from tpufwi.grid import Grid as JGrid
from tpufwi.propagators.boundary import RingSpec as JRingSpec

import tpufwi_torch.adjoint_scanres as adjoint_scanres
from tpufwi_torch.adjoint_scanres import make_simulator_scanres
from tpufwi_torch.grid import Grid
from tpufwi_torch.kernels import acoustic2d_scanres as ks
from tpufwi_torch.kernels.acoustic2d_eager import (
    AcousticParams,
    AcousticState,
    make_acoustic_step,
    make_reverse_reconstruct_step,
    zero_state,
)
from tpufwi_torch.wavelets import ricker_np

import jax  # noqa: E402  (after the port: the reference runs on the CPU)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


class _Tile:
    """One tile of the walk: its own cells and its window (the cells and
    their 2R reach, clipped to the grid), the step twin and its
    reconstruction on the window (the surface row in window coordinates),
    and the sources and receivers whose cells it owns (window-relative, in
    index order)."""

    def __init__(self, grid, tile, params, src_idx, rcv_idx):
        NZ, NX = grid.padded_shape
        R = grid.radius
        z0, z1, x0, x1 = tile
        wz = slice(max(0, z0 - 2 * R), min(NZ, z1 + 2 * R))
        wx = slice(max(0, x0 - 2 * R), min(NX, x1 + 2 * R))
        self.win = (wz, wx)
        self.cells = (slice(z0, z1), slice(x0, x1))
        self.own = (slice(z0 - wz.start, z1 - wz.start), slice(x0 - wx.start, x1 - wx.start))
        fs = grid.pad if grid.free_surface else None
        local = types.SimpleNamespace(
            order=grid.order, h=grid.h, ndim=2,
            free_surface=fs is not None and wz.start <= fs < wz.stop,
            pad=None if fs is None else fs - wz.start)
        self.step = make_acoustic_step(local)
        self.recon = make_reverse_reconstruct_step(local)
        self.fs = local.pad if local.free_surface else None
        off = torch.tensor([wz.start, wx.start])

        def mine(idx):
            k = torch.nonzero((idx[:, 0] >= z0) & (idx[:, 0] < z1) & (idx[:, 1] >= x0)
                              & (idx[:, 1] < x1))[:, 0]
            return k, idx[k] - off

        self.src_k, self.src = mine(src_idx)
        self.rcv_k, self.rcv = mine(rcv_idx)
        a, b = params.a, params.b
        self.params = AcousticParams(params.c2dt2[wz, wx], (a[0][wz], a[1][:, wx]),
                                     (b[0][wz], b[1][:, wx]), self.src, self.rcv)

    def W(self, f):
        return f[self.win]


def _tiles(grid, plan, c2, profiles, src_idx, rcv_idx):
    a, b = ks.full_profiles(grid, profiles)
    params = AcousticParams(c2, a, b, src_idx, rcv_idx)
    NZ, NX = grid.padded_shape
    return [_Tile(grid, t, params, src_idx, rcv_idx) for t in ks.fused_tiles(plan, NZ, NX)]


def fused_forward(grid, c2, profiles, wavelet, src_idx, rcv_idx, tape=None, illum=False,
                  plan=None, ping_pong=True):
    """The fused forward's walk (``scanres_forward_plain``'s contract): per
    step t each tile runs the step twin on its window of P_{t-1}, P_{t-2},
    phi (set t % 2) and psi, writes its own cells' P_t over P_{t-2}, phi'
    (to the other set; ``ping_pong=False``: to the same set, in place) and
    psi', the snapshot row (the window's D2 laplacian of P_{t-1}) and, for
    the cells it owns, the receivers, the ring-tape entries and P_t^2."""
    NZ, NX = grid.padded_shape
    tiles = _tiles(grid, plan or ks.scanres_tile_plan(grid), c2, profiles, src_idx, rcv_idx)
    nt = wavelet.shape[0]

    def zeros():
        return torch.zeros((NZ, NX), dtype=c2.dtype)

    cur, prev = zeros(), zeros()  # P_{t-1}, P_{t-2}
    phi = [[zeros(), zeros()], [zeros(), zeros()]]
    psi = [zeros(), zeros()]
    acc = zeros() if illum else None
    ring_idx = ks.ring_plan(grid, c2.device)[0]
    ring_zx = torch.stack([ring_idx // NX, ring_idx % NX], 1)
    seis = torch.empty((nt, rcv_idx.shape[0]), dtype=c2.dtype)
    rows = ([] if tape else None)
    for t in range(nt):
        k = t % 2 if ping_pong else 0
        din, dout = phi[k], (phi[1 - k] if ping_pong else phi[k])
        snap = torch.empty((NZ, NX), dtype=torch.bfloat16) if tape == "snap" else None
        ring_row = torch.empty(ring_idx.shape[0], dtype=c2.dtype) if tape == "rings" else None
        for tl in tiles:
            state = AcousticState(tl.W(prev), tl.W(cur), (tl.W(din[0]), tl.W(din[1])),
                                  (tl.W(psi[0]), tl.W(psi[1])))
            if snap is not None:
                snap[tl.cells] = ks.interior_lap(grid, tl.W(cur))[tl.own].to(torch.bfloat16)
            new, rec = tl.step(state, tl.params, wavelet[t])
            prev[tl.cells] = new.p[tl.own]
            for j in range(2):
                dout[j][tl.cells] = new.phi[j][tl.own]
                psi[j][tl.cells] = new.psi[j][tl.own]
            seis[t, tl.rcv_k] = rec
            if ring_row is not None:
                z0, x0 = tl.cells[0].start, tl.cells[1].start
                g = torch.nonzero((ring_zx[:, 0] >= z0) & (ring_zx[:, 0] < tl.cells[0].stop)
                                  & (ring_zx[:, 1] >= x0) & (ring_zx[:, 1] < tl.cells[1].stop))[:, 0]
                ring_row[g] = prev[ring_zx[g, 0], ring_zx[g, 1]]
            if acc is not None:
                acc[tl.cells] += new.p[tl.own] ** 2
        if tape:
            rows.append(snap if tape == "snap" else ring_row)
        cur, prev = prev, cur
    return seis, (torch.stack(rows) if tape else None), prev, cur, acc


def fused_reverse(grid, c2, profiles, ybar, tape, src_idx, rcv_idx, plan=None, ping_pong=True,
                  rings=None):
    """The fused snapshot reverse's walk (``scanres_reverse_snap_plain``'s
    contract). Per step t each tile transposes the step twin on its window
    (``torch.func.vjp``) at lambda_t (injected and pinned), the carried
    cotangent of P_{t-1} and psibar / phibar (set (nt - 1 - t) % 2), images
    its own cells with lambda_t, and writes its own cells' lambda_{t-1}
    with ybar row t-1 injected and the surface pinned, lambda at its
    sources, and psibar', phibar' (to the other set; ``ping_pong=False``:
    in place). lambda_{nt-1} is injected before the first step.

    ``rings=(wavelet, p_penult, p_last)``: the fused rings reverse's walk
    (``scanres_reverse_plain``'s contract with ``return_field``), ``tape``
    the ring tape. Each tile images its own cells with the D2 laplacian of
    its window of P_{t-1} and rewrites its own cells of P_t, in place, with
    P_{t-2}: the reconstruction on its window with its own sources, then
    its ring cells from tape row t-2 (zeros for t < 2). Returns (gbar,
    lam_src, P_{-1}).

    The plain version images with lambda injected receiver by receiver
    (``index_put``) and transposes the step with each cell's receivers
    summed first (autograd's scatter into zeros, then added); the two
    differ only where receivers coincide, so the walk carries both."""
    NZ, NX = grid.padded_shape
    tiles = _tiles(grid, plan or ks.scanres_tile_plan(grid), c2, profiles, src_idx, rcv_idx)
    nt = ybar.shape[0]

    def zeros():
        return torch.zeros((NZ, NX), dtype=c2.dtype)

    def inject(pre, rcv, y, fs):
        """(lambda for the step, lambda for the image) of a block of cells."""
        lam_step = pre + torch.zeros_like(pre).index_put(tuple(rcv.T), y, accumulate=True)
        lam_img = pre.index_put(tuple(rcv.T), y, accumulate=True)
        if fs is not None:
            lam_step[fs] = 0.0
            lam_img[fs] = 0.0
        return lam_step, lam_img

    fs_row = grid.pad if grid.free_surface else None
    lam_src = torch.empty((nt, src_idx.shape[0]), dtype=c2.dtype)
    rcv_all, src_all = tuple(rcv_idx.T), tuple(src_idx.T)
    ls0, li0 = inject(zeros(), rcv_idx, ybar[nt - 1], fs_row)
    lam_src[nt - 1] = li0[src_all]
    lam = [[ls0, li0], [zeros(), zeros()]]  # (step, image) of lambda_t, then of lambda_{t+1}
    pbar = zeros()  # the cotangent of P_{t-1} carried by the transposed step (-lambda_{t+1})
    duals = [[zeros() for _ in range(4)] for _ in range(2)]  # phibar z, x; psibar z, x
    gbar = zeros()
    no_rcv = torch.zeros(0, dtype=c2.dtype)
    if rings is not None:
        wavelet = rings[0]
        fields = [rings[1].clone(), rings[2].clone()]  # P_{t-1}, P_t
        ring_idx = ks.ring_plan(grid, c2.device)[0]
        ring_zx = torch.stack([ring_idx // NX, ring_idx % NX], 1)
    for t in reversed(range(nt)):
        k = (nt - 1 - t) % 2 if ping_pong else 0
        din, dout = duals[k], (duals[1 - k] if ping_pong else duals[k])
        (ls, li), nxt = lam
        img = tape[t].to(c2.dtype) if rings is None else None
        for tl in tiles:
            zero = zero_state(tl.W(c2).shape, 2, c2.dtype)
            _, step_t = torch.func.vjp(
                lambda s, tl=tl: tl.step(s, tl.params._replace(rcv_idx=tl.rcv[:0]), 0.0), zero)
            cot = AcousticState(tl.W(pbar), tl.W(ls), (tl.W(din[0]), tl.W(din[1])),
                                (tl.W(din[2]), tl.W(din[3])))
            (out,) = step_t((cot, no_rcv))
            if rings is None:
                gbar[tl.cells] += li[tl.cells] * img[tl.cells]
            else:
                p_t, p_tp1 = fields
                gbar[tl.cells] += li[tl.cells] * ks.interior_lap(grid, tl.W(p_t))[tl.own]
                new = tl.recon(tl.W(p_t), tl.W(p_tp1), tl.W(c2), tl.src, wavelet[t])[tl.own]
                (z0, z1), (x0, x1) = ((c.start, c.stop) for c in tl.cells)
                g = torch.nonzero((ring_zx[:, 0] >= z0) & (ring_zx[:, 0] < z1)
                                  & (ring_zx[:, 1] >= x0) & (ring_zx[:, 1] < x1))[:, 0]
                new[ring_zx[g, 0] - z0, ring_zx[g, 1] - x0] = (
                    tape[t - 2][g].to(c2.dtype) if t >= 2 else 0.0)
                p_tp1[tl.cells] = new
            pre = out.p[tl.own]
            if t >= 1:
                own_rcv = tl.rcv - torch.tensor([tl.own[0].start, tl.own[1].start])
                fs = (None if tl.fs is None or not (tl.own[0].start <= tl.fs < tl.own[0].stop)
                      else tl.fs - tl.own[0].start)
                step_l, img_l = inject(pre, own_rcv, ybar[t - 1][tl.rcv_k], fs)
                own_src = tl.src - torch.tensor([tl.own[0].start, tl.own[1].start])
                lam_src[t - 1, tl.src_k] = img_l[tuple(own_src.T)]
                nxt[0][tl.cells], nxt[1][tl.cells] = step_l, img_l
            pbar[tl.cells] = out.p_prev[tl.own]
            for j in range(2):
                dout[j][tl.cells] = out.phi[j][tl.own]
                dout[2 + j][tl.cells] = out.psi[j][tl.own]
        lam = [nxt, [ls, li]]
        if rings is not None:
            fields = [fields[1], fields[0]]  # P_{t-2} where P_t was, P_{t-1}
    del rcv_all
    return (gbar, lam_src) if rings is None else (gbar, lam_src, fields[1])


def _case(order, free_surface, nt, shape=(30, 44), pml=6, seed=0):
    """A random model on a padded grid that no tile divides; sources: two
    coinciding, one in the boundary ring beside the left CPML strip, and
    with the free surface one on the surface row; a receiver line at depth
    2 with a coinciding pair, a receiver on a source cell and one beside the
    left strip; all made from ``seed``."""
    grid = Grid(shape=shape, h=(10.0, 12.0), pml=pml, order=order, free_surface=free_surface)
    c_max, f0 = 2500.0, 16.0
    dt = grid.cfl_dt(c_max, safety=0.7)
    rng = np.random.default_rng(seed + order)
    vp = np.clip(2000 + 200 * rng.standard_normal(grid.shape), 1700, 2500)
    c2 = torch.as_tensor((np.pad(vp, grid.pad, mode="edge") * dt) ** 2, dtype=torch.float32)
    prof = tuple(torch.as_tensor(p) for p in ks.strip_profiles(grid, dt, c_max, f0))
    src = np.array([[shape[0] // 2, shape[1] // 3], [shape[0] // 2, shape[1] // 3],
                    [shape[0] // 2, grid.radius - 1]])
    if free_surface:
        src = np.concatenate([src, [[0, shape[1] // 2]]])
    rx = np.arange(2, shape[1] - 2, 3)
    rcv = np.concatenate([np.stack([np.full(rx.size, 2), rx], 1),
                          [[2, 5], src[0], [shape[0] // 2, 0]]])
    w = torch.as_tensor(ricker_np(f0, dt, nt, t0=0.03), dtype=torch.float32)
    idx = (torch.as_tensor(src + grid.pad), torch.as_tensor(rcv + grid.pad))
    return (grid, c2, prof), w, idx


def _assert_same(got, ref, names):
    for name, a, b in zip(names, got, ref):
        assert (a is None) == (b is None), name
        if a is not None:
            assert torch.equal(a, b), (name, float((a.double() - b.double()).abs().max()))


FWD_NAMES = ("seis", "tape", "penult", "last", "illum")


@pytest.mark.parametrize("tape", ["snap", "rings"])
@pytest.mark.parametrize("free_surface", [False, True])
@pytest.mark.parametrize("order", [2, 4, 8])
def test_fused_forward_equals_plain_bitwise(order, free_surface, tape):
    args, w, idx = _case(order, free_surface, nt=14)
    ref = ks.scanres_forward_plain(*args, w, *idx, tape=tape, illum=True)
    got = fused_forward(*args, w, *idx, tape=tape, illum=True)
    assert float(ref[0].abs().max()) > 0.0
    _assert_same(got, ref, FWD_NAMES)


@pytest.mark.parametrize("free_surface", [False, True])
@pytest.mark.parametrize("order", [2, 4, 8])
def test_fused_reverse_equals_plain_bitwise(order, free_surface):
    args, w, idx = _case(order, free_surface, nt=14)
    seis, snap, _, _, _ = ks.scanres_forward_plain(*args, w, *idx, "snap")
    ybar = torch.as_tensor(np.random.default_rng(order).standard_normal(tuple(seis.shape)),
                           dtype=torch.float32)
    g_p, ls_p = ks.scanres_reverse_snap_plain(*args, ybar, snap, *idx)
    g_f, ls_f = fused_reverse(*args, ybar, snap, *idx)
    assert float(g_p.abs().max()) > 0.0
    _assert_same((g_f, ls_f), (g_p, ls_p), ("gbar", "lam_src"))


@pytest.mark.parametrize("free_surface", [False, True])
def test_small_tiles_and_ping_pong(free_surface):
    """On 8 x 6 tiles (tile edges inside every CPML strip) both walks still
    equal the plain versions bitwise, and without the ping-pong they do
    not: a tile's reach then reads phi (forward) or psibar / phibar
    (reverse) that an earlier tile already rewrote."""
    args, w, idx = _case(4, free_surface, nt=10)
    small = ks.ScanresPlan(8, 6, 0)
    ref = ks.scanres_forward_plain(*args, w, *idx, tape="snap", illum=True)
    _assert_same(fused_forward(*args, w, *idx, tape="snap", illum=True, plan=small), ref,
                 FWD_NAMES)
    bad = fused_forward(*args, w, *idx, tape="snap", illum=True, plan=small, ping_pong=False)
    assert not all(torch.equal(a, b) for a, b in zip(bad, ref) if a is not None)
    ybar = torch.as_tensor(np.random.default_rng(1).standard_normal(tuple(ref[0].shape)),
                           dtype=torch.float32)
    g_p, ls_p = ks.scanres_reverse_snap_plain(*args, ybar, ref[1], *idx)
    _assert_same(fused_reverse(*args, ybar, ref[1], *idx, plan=small), (g_p, ls_p),
                 ("gbar", "lam_src"))
    g_x, _ = fused_reverse(*args, ybar, ref[1], *idx, plan=small, ping_pong=False)
    assert not torch.equal(g_x, g_p)


@pytest.mark.parametrize("nsrc,free_surface", [(1, False), (3, True)])
def test_fused_walks_match_reference_jnp_engine(monkeypatch, nsrc, free_surface):
    """The walks as the port's snapshot engine (``cuda_scansnap``'s
    functions, ``make_simulator_scanres``) against the reference's jnp
    engine, test_torch_scanres.py's problem and tolerances: seismogram 1e-5
    of its max, J and the wavelet gradient GTOL, the masked model gradient
    SNAP_GTOL (the bf16 snapshot tape)."""
    kw, dt, f0, c_max, c2, w, src_p, rcv_p = _setup(96, nsrc, free_surface)
    jg = JGrid(**kw)
    geom = JGeometry(src_idx=jnp.asarray(src_p), rcv_idx=jnp.asarray(rcv_p))
    sim_j = j_make_simulator(jg, dt, f0, c_max, dtype=jnp.float32)
    d_obs = sim_j(jnp.asarray(c2), jnp.asarray(w), geom.src_idx, geom.rcv_idx)

    def loss_j(c, w_):
        r = sim_j(c, w_, geom.src_idx, geom.rcv_idx) - d_obs
        return 0.5 * jnp.sum(r * r)

    J_j, (g_j, gw_j) = jax.value_and_grad(loss_j, argnums=(0, 1))(jnp.asarray(c2) * 1.01,
                                                                    jnp.asarray(w))
    g_j = np.asarray(JRingSpec.build(jg).mask_valid(g_j))
    d_obs = np.asarray(d_obs)

    # 32 x 64 tiles (6 on this grid; the plan's own tiles are held bitwise
    # above) keep the 96 steps' windowed transposes cheap
    plan = ks.ScanresPlan(32, 64, 0)
    monkeypatch.setattr(adjoint_scanres, "scanres_forward",
                        functools.partial(fused_forward, plan=plan))
    monkeypatch.setattr(adjoint_scanres, "scanres_reverse_snap",
                        functools.partial(fused_reverse, plan=plan))
    sim = make_simulator_scanres(Grid(**kw), dt, f0, c_max, tape_mode="snap")
    si, ri = torch.tensor(src_p), torch.tensor(rcv_p)
    with torch.no_grad():
        seis = sim(torch.tensor(c2), torch.tensor(w), si, ri).numpy()
    c = (torch.tensor(c2) * 1.01).requires_grad_()
    wt = torch.tensor(w).requires_grad_()
    r = sim(c, wt, si, ri) - torch.tensor(d_obs)
    J = 0.5 * torch.sum(r * r)
    g, gw = (x.numpy() for x in torch.autograd.grad(J, (c, wt)))
    assert np.abs(seis - d_obs).max() <= 1e-5 * np.abs(d_obs).max()
    assert abs(float(J) - float(J_j)) / float(J_j) < GTOL
    werr = np.abs(gw - np.asarray(gw_j)).max() / np.abs(np.asarray(gw_j)).max()
    assert werr < GTOL, f"wavelet gradient rel err {werr:.3e}"
    err = np.abs(g - g_j).max() / np.abs(g_j).max()
    assert err < SNAP_GTOL, f"gradient vs jnp engine rel err {err:.3e}"


@pytest.mark.parametrize("order", [2, 4, 8])
@pytest.mark.parametrize("shape,pml", [((30, 44), 6), ((351, 1701), 20), ((9, 13), 3)])
def test_tile_plan_covers_every_cell_once(order, shape, pml):
    """The tiles of ``scanres_tile_plan`` cover every cell of the padded
    grid exactly once (ragged edges included), the rows in the kernels'
    block order (the CPML band's rows first); the plan is the tile the
    library is built for with the largest pass's shared bytes."""
    grid = Grid(shape=shape, h=(10.0, 10.0), pml=pml, order=order)
    NZ, NX = grid.padded_shape
    R = grid.radius
    plan = ks.scanres_tile_plan(grid)
    assert (plan.tz, plan.tx) == (ks.TILE_Z, ks.TILE_X) and plan.tz % ks.TILE_ROWS == 0
    H = 2 * R
    rect, own = (plan.tz + 2 * H) * (plan.tx + 2 * H), plan.tz * plan.tx
    reach = (plan.tz + 2 * R) * plan.tx + plan.tz * (plan.tx + 2 * R)
    fwd = 4 * (rect + reach + 5 * own)
    rev = 4 * (rect + (plan.tz + 2 * H) * plan.tx + plan.tz * (plan.tx + 2 * H) + reach
               + 2 * own)
    rings = rev + 4 * (rect + own)  # the rings form: P_{t-1} over the cross, P_t
    assert [ks.fused_smem(R, k) for k in ks.FUSED_KERNELS] == [fwd, rev, rings]
    assert plan.smem == max(fwd, rev, rings) <= 48 * 1024
    cover = np.zeros((NZ, NX), np.int64)
    tiles = list(ks.fused_tiles(plan, NZ, NX))
    assert len(tiles) == -(-NZ // plan.tz) * -(-NX // plan.tx)
    rows = [z0 // plan.tz for z0, _, x0, _ in tiles if x0 == 0]
    n = len(rows)
    assert rows == ([0, n - 1, 1, n - 2] + list(range(2, n - 2)) if n >= 4 else list(range(n)))
    for z0, z1, x0, x1 in tiles:
        assert z0 % plan.tz == 0 and x0 % plan.tx == 0
        cover[z0:z1, x0:x1] += 1
    assert (cover == 1).all()


def test_variants_and_launches():
    """On the CPU the wrappers are the plain version, with and without
    dependent launches, and launch nothing; one launch a step of every
    whole-scan kernel in every mode."""
    args, w, idx = _case(4, True, nt=6)
    f0, r0 = ks.scanres_forward.launches, ks.scanres_reverse_snap.launches
    for mode in (dict(tape="snap"), dict(tape="rings", illum=True)):
        ref = ks.scanres_forward_plain(*args, w, *idx, **mode)
        for dep in (True, False):
            _assert_same(ks.scanres_forward(*args, w, *idx, dependent_launch=dep, **mode), ref,
                         FWD_NAMES)
    seis, snap = ks.scanres_forward(*args, w, *idx, tape="snap")[:2]
    _assert_same(ks.scanres_reverse_snap(*args, seis, snap, *idx, dependent_launch=False),
                 ks.scanres_reverse_snap_plain(*args, seis, snap, *idx), ("gbar", "lam_src"))
    assert (ks.scanres_forward.launches, ks.scanres_reverse_snap.launches) == (f0, r0)
    assert ks.STEP_LAUNCHES == 1
