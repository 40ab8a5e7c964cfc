"""tpufwi_torch K-step engine (``cuda_kstep``), merged reverse step and bare
leapfrog == tpufwi's, on the CPU.

Each kernel's plain version against the reference's Pallas kernel run in
interpret mode, from random inputs, the layouts converted as in
tests/test_torch_step.py: the K-step forward (fields, CPML strips, the K
ring rows, the seismogram against the receiver rows; with and without the
free surface) and reverse (K = 4), the merged reverse step, and the bare
leapfrog (also against the step twin with zero CPML). Tolerance 1e-5 of
each output's max: a few fp32 steps, summed in another order. Then the
engine's plain path against the reference's jnp engine and the port's
single-step engine, nt not a multiple of K, at the reference suite's GTOL
= 1e-4 (tests/test_kstep.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_step import (
    _geometry,
    _grid_kw,
    _halo,
    _inputs,
    _planes_to_strips,
    _rel,
    _strips_to_planes,
)

from tpufwi.adjoint import make_simulator as j_make_simulator
from tpufwi.grid import Grid as JGrid
from tpufwi.kernels import acoustic2d_pallas as jp
from tpufwi.kernels import acoustic2d_pallas_bwd as jb
from tpufwi.kernels import acoustic2d_pallas_kstep as jk
from tpufwi.propagators.boundary import RingSpec as JRingSpec

from tpufwi_torch.adjoint_kstep import make_simulator_kstep
from tpufwi_torch.adjoint_step import make_simulator_step
from tpufwi_torch.grid import Grid
from tpufwi_torch.kernels import acoustic2d_kstep as kk
from tpufwi_torch.kernels import acoustic2d_step as kst
from tpufwi_torch.kernels.acoustic2d_eager import AcousticParams, AcousticState, make_acoustic_step
from tpufwi_torch.kernels.acoustic2d_scanres import strip_profiles
from tpufwi_torch.propagators.acoustic2d import AcousticPropagator

GTOL = 1e-4
STEP_TOL = 1e-5
K = 4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _idx(a):
    return jnp.asarray(np.asarray(a).reshape(1, -1), jnp.int32)


def _ring_rows(rings_chunk, j):
    """Sub-step j's ring slabs of the reference, flat in ring-plan order."""
    return np.concatenate([np.asarray(r[j]).ravel() for r in rings_chunk])


def _slab_shapes(jg):
    return [tuple(sl.stop - sl.start for sl in s) for s in JRingSpec.build(jg).slices]


@pytest.mark.parametrize("free_surface", [False, True])
def test_kstep_forward_matches_pallas_kernel(free_surface):
    kw = _grid_kw(free_surface)
    grid, jg = Grid(**kw), JGrid(**kw)
    dt = grid.cfl_dt(2500.0, 0.7)
    rng, f32, c2, strips = _inputs(grid, 11)
    p_prev, p = f32(*grid.padded_shape), f32(*grid.padded_shape)
    src, rcv = _geometry(grid)
    nt, t0 = 9, 3
    w = f32(nt)
    profiles = strip_profiles(grid, dt, 2500.0, 14.0)

    step = jk.make_kstep_forward(jg, K=K, nsrc=len(src), rcv_rows=16, with_tape=True,
                                 interpret=True)
    state = jp.StripState(jp.to_ext(jnp.asarray(p_prev)), jp.to_ext(jnp.asarray(p)),
                          *map(jnp.asarray, strips))
    amps = (c2[src[:, 0], src[:, 1]][None, :] * w[t0:t0 + K, None]).reshape(K, 1, -1)
    r0 = (rcv[:, 0].min() // 8) * 8
    new, rings_chunk, rows = step(state, jp.to_ext(jnp.asarray(c2), "edge"), profiles,
                                  _idx(src[:, 0]), _idx(src[:, 1]), jnp.asarray(amps),
                                  jnp.asarray([[r0]], jnp.int32))
    rows = np.asarray(rows)

    cur, prev = _halo(grid, p), _halo(grid, p_prev)
    phiz, phix = _strips_to_planes(grid, strips[0], strips[2])
    psiz, psix = _strips_to_planes(grid, strips[1], strips[3])
    cpml = torch.stack([_halo(grid, x) for x in (phiz, psiz, phix, psix)]).contiguous()
    seis = torch.zeros((nt, len(rcv)))
    tape = torch.zeros((nt, sum(int(np.prod(s)) for s in _slab_shapes(jg))))
    before = kk.kstep_forward.launches
    kk.kstep_forward(grid, torch.tensor(c2), tuple(map(torch.tensor, profiles)), cur, prev, cpml,
                     torch.tensor(w), t0, K, torch.tensor(src), torch.tensor(rcv), seis, tape)
    assert kk.kstep_forward.launches == before  # plain version on the CPU
    R = grid.radius
    # K even: cur holds the last field, prev the one before
    assert _rel(cur[R:-R, R:-R].numpy(), jp.from_ext(new.p, jg)) < STEP_TOL
    assert _rel(prev[R:-R, R:-R].numpy(), jp.from_ext(new.p_prev, jg)) < STEP_TOL
    c = cpml[:, R:-R, R:-R].numpy()
    got = _planes_to_strips(grid, c[0], c[2]) + _planes_to_strips(grid, c[1], c[3])
    for got_s, ref_s in zip(got, (new.phiz, new.phix, new.psiz, new.psix)):
        assert _rel(got_s, ref_s) < STEP_TOL
    for j in range(K):
        assert _rel(tape[t0 + j].numpy(), _ring_rows(rings_chunk, j)) < STEP_TOL
        assert _rel(seis[t0 + j].numpy(), rows[j, rcv[:, 0] - r0, rcv[:, 1]]) < STEP_TOL
    assert not seis[:t0].any() and not seis[t0 + K:].any()


def test_kstep_reverse_matches_pallas_kernel():
    kw = _grid_kw(False)
    grid, jg = Grid(**kw), JGrid(**kw)
    dt = grid.cfl_dt(2500.0, 0.7)
    rng, f32, c2, strips = _inputs(grid, 12)
    p_t, p_tp1 = f32(*grid.padded_shape), f32(*grid.padded_shape)
    q_pm, q_p, gbar = (f32(*grid.padded_shape) for _ in range(3))
    src, rcv = _geometry(grid)  # receivers in the reference's 16-row slab
    nt, t0 = 10, 4
    w, ybar = f32(nt), f32(nt, len(rcv))
    profiles = strip_profiles(grid, dt, 2500.0, 14.0)
    shapes = _slab_shapes(jg)
    tape = np.stack([np.concatenate([f32(*s).ravel() for s in shapes]) for _ in range(nt)])
    # the reference's chunk entry j imposes tape row t0 + j - 2
    splits = np.cumsum([int(np.prod(s)) for s in shapes])[:-1]
    rings_chunk = tuple(
        jnp.asarray(np.stack([np.split(tape[t0 + j - 2], splits)[i].reshape(s)
                              for j in range(K)]))
        for i, s in enumerate(shapes))
    amps = (c2[src[:, 0], src[:, 1]][None, :] * w[t0:t0 + K, None]).reshape(K, 1, -1)
    r0 = (rcv[:, 0].min() // 8) * 8
    rev = jk.make_kstep_reverse(jg, K=K, nsrc=len(src), nrec=len(rcv), rcv_rows=16,
                                interpret=True)
    outs = [np.asarray(x) for x in rev(
        jp.to_ext(jnp.asarray(p_tp1)), jp.to_ext(jnp.asarray(p_t)), jnp.asarray(c2),
        jnp.asarray(q_pm), jnp.asarray(q_p), jnp.asarray(gbar), tuple(map(jnp.asarray, strips)),
        profiles, _idx(src[:, 0]), _idx(src[:, 1]), jnp.asarray(amps), _idx(rcv[:, 0]),
        jnp.asarray(rcv[:, 1].reshape(-1, 1), jnp.int32),
        jnp.asarray(ybar[t0:t0 + K, :, None]), jnp.asarray([[r0]], jnp.int32), rings_chunk)]
    p_t_r, p_tp1_r, q_pm_r, q_p_r, gbar_r, pbz_r, psz_r, pbx_r, psx_r, lam_r = outs

    fields = [_halo(grid, x) for x in (p_t, p_tp1, q_p, -q_pm)]
    planes = np.zeros((kst.ADJ_PLANES, *grid.padded_shape), np.float32)
    planes[3], planes[7] = _strips_to_planes(grid, strips[0], strips[2])
    planes[1], planes[5] = _strips_to_planes(grid, strips[1], strips[3])
    adj = torch.stack([_halo(grid, x) for x in planes]).contiguous()
    gacc = torch.tensor(gbar)
    lam_src = torch.zeros((nt, len(src)))
    before = kk.kstep_reverse.launches
    kk.kstep_reverse(grid, torch.tensor(c2), tuple(map(torch.tensor, profiles)), *fields, adj,
                     gacc, torch.tensor(w), torch.tensor(ybar), t0, K, torch.tensor(src),
                     torch.tensor(rcv), lam_src, torch.tensor(tape))
    assert kk.kstep_reverse.launches == before
    R = grid.radius
    inner = lambda x: x[..., R:-R, R:-R].numpy()  # noqa: E731
    # K even: each buffer holds its role again, two steps below t0
    assert _rel(inner(fields[0]), jp.from_ext(p_t_r, jg)) < STEP_TOL  # P_{t0-2}
    assert _rel(inner(fields[1]), jp.from_ext(p_tp1_r, jg)) < STEP_TOL  # P_{t0-1}
    assert _rel(inner(fields[2]), q_p_r) < STEP_TOL  # lambda_{t0-1}, before injection
    assert _rel(inner(fields[3]), -q_pm_r) < STEP_TOL  # lambda_{t0}
    assert _rel(gacc.numpy(), gbar_r) < STEP_TOL
    assert _rel(lam_src[t0:t0 + K].numpy(), lam_r[:, 0, :]) < STEP_TOL
    a = inner(adj)
    got = _planes_to_strips(grid, a[3], a[7]) + _planes_to_strips(grid, a[1], a[5])
    for got_s, ref_s in zip(got, (pbz_r, pbx_r, psz_r, psx_r)):
        assert _rel(got_s, ref_s) < STEP_TOL


@pytest.mark.parametrize("free_surface", [False, True])
def test_fused_reverse_step_matches_pallas_kernel(free_surface):
    kw = _grid_kw(free_surface)
    grid, jg = Grid(**kw), JGrid(**kw)
    dt = grid.cfl_dt(2500.0, 0.7)
    rng, f32, c2, strips = _inputs(grid, 13)
    p_t, p_tp1, q_pm, q_p, gbar = (f32(*grid.padded_shape) for _ in range(5))
    src, rcv = _geometry(grid)
    nt, t = 6, 4
    w, ybar = f32(nt), f32(nt, len(rcv))
    profiles = strip_profiles(grid, dt, 2500.0, 14.0)
    ring_vals = tuple(f32(*s) for s in _slab_shapes(jg))
    rev = jb.make_fused_reverse_step(jg, nsrc=len(src), nrec=len(rcv), interpret=True)
    amp = (c2[src[:, 0], src[:, 1]] * w[t]).reshape(1, -1)
    outs = [np.asarray(x) for x in rev(
        jnp.asarray(p_tp1), jnp.asarray(p_t), jnp.asarray(c2), _idx(src[:, 0]), _idx(src[:, 1]),
        jnp.asarray(amp), tuple(map(jnp.asarray, ring_vals)), jnp.asarray(q_pm),
        jnp.asarray(q_p), jnp.asarray(gbar), tuple(map(jnp.asarray, strips)), profiles,
        _idx(rcv[:, 0]), jnp.asarray(rcv[:, 1].reshape(-1, 1), jnp.int32),
        jnp.asarray(ybar[t].reshape(-1, 1)))]
    p_ref, q_pm_r, q_p_r, gbar_r, pbz_r, psz_r, pbx_r, psx_r = outs

    pt, ptp1, q, q_other = (_halo(grid, x) for x in (p_t, p_tp1, q_p, -q_pm))
    planes = np.zeros((kst.ADJ_PLANES, *grid.padded_shape), np.float32)
    planes[3], planes[7] = _strips_to_planes(grid, strips[0], strips[2])
    planes[1], planes[5] = _strips_to_planes(grid, strips[1], strips[3])
    adj = torch.stack([_halo(grid, x) for x in planes]).contiguous()
    gacc = torch.tensor(gbar)
    lam_src = torch.zeros((nt, len(src)))
    row = torch.tensor(np.concatenate([r.ravel() for r in ring_vals]))
    before = kst.fused_reverse_step.launches
    kst.fused_reverse_step(grid, torch.tensor(c2), tuple(map(torch.tensor, profiles)), pt, ptp1,
                           q, q_other, adj, gacc, torch.tensor(w), torch.tensor(ybar), t,
                           torch.tensor(src), torch.tensor(rcv), lam_src, row)
    assert kst.fused_reverse_step.launches == before
    R = grid.radius
    inner = lambda x: x[..., R:-R, R:-R].numpy()  # noqa: E731
    got = inner(ptp1)
    keep = np.ones(got.shape, bool)
    if free_surface:
        # the port pins the whole surface row, as the jnp engine does; the
        # reference kernel leaves its padding columns, which no valid cell reads
        pad, nx = grid.pad, grid.shape[1]
        outside = np.ones(got.shape[1], bool)
        outside[pad:pad + nx] = False  # the ring covers the rest of the row
        keep[pad, outside] = False
        assert np.all(got[pad, outside] == 0)
    assert _rel(got[keep], p_ref[keep]) < STEP_TOL
    assert _rel(inner(q), -q_pm_r) < STEP_TOL  # lambda_t
    assert _rel(inner(q_other), q_p_r) < STEP_TOL
    assert _rel(gacc.numpy(), gbar_r) < STEP_TOL
    assert _rel(lam_src[t].numpy(), -q_pm_r[src[:, 0], src[:, 1]]) < STEP_TOL
    a = inner(adj)
    got_s = _planes_to_strips(grid, a[3], a[7]) + _planes_to_strips(grid, a[1], a[5])
    for g_s, ref_s in zip(got_s, (pbz_r, pbx_r, psz_r, psx_r)):
        assert _rel(g_s, ref_s) < STEP_TOL


def test_leapfrog_matches_pallas_kernel_and_step_twin():
    kw = _grid_kw(False)
    grid, jg = Grid(**kw), JGrid(**kw)
    rng, f32, c2, _ = _inputs(grid, 14)
    p_other, p = f32(*grid.padded_shape), f32(*grid.padded_shape)
    call = jp.make_leapfrog_kernel(jg, interpret=True, with_lap=True)
    out, lap_ref = call(jp.to_ext(jnp.asarray(p_other)), jp.to_ext(jnp.asarray(p)),
                        jp.to_ext(jnp.asarray(c2), "edge"))
    p_ref = np.asarray(jp.from_ext(out, jg))

    zero = torch.zeros(grid.padded_shape)
    step = make_acoustic_step(grid)
    params = AcousticParams(torch.tensor(c2), (zero, zero), (zero, zero),
                            torch.zeros((1, 2), dtype=torch.int64),
                            torch.zeros((1, 2), dtype=torch.int64))
    twin, _ = step(AcousticState(torch.tensor(p_other), torch.tensor(p), (zero, zero),
                                 (zero, zero)), params, 0.0)
    R = grid.radius
    for with_lap in (True, False):
        pk, ok = _halo(grid, p), _halo(grid, p_other)
        lap = torch.zeros(grid.padded_shape) if with_lap else None
        before = kst.leapfrog.launches
        kst.leapfrog(grid, torch.tensor(c2), pk, ok, lap)
        assert kst.leapfrog.launches == before
        got = ok[R:-R, R:-R].numpy()
        assert _rel(got, p_ref) < STEP_TOL
        assert _rel(got, twin.p.numpy()) < STEP_TOL
        assert np.array_equal(pk[R:-R, R:-R].numpy(), p)  # p is read only
        if with_lap:
            assert _rel(lap.numpy(), np.asarray(lap_ref)) < STEP_TOL


def _engine_case(nt, nsrc, free_surface):
    kw = dict(shape=(48, 72), h=(10.0, 10.0), pml=10, order=8, free_surface=free_surface)
    grid, jg = Grid(**kw), JGrid(**kw)
    c_max, f0 = 2500.0, 14.0
    dt = grid.cfl_dt(c_max, safety=0.7)
    rng = np.random.default_rng(nt)
    vp = np.clip(2000 + 200 * rng.standard_normal(grid.shape), 1700, 2500)
    c2 = ((np.pad(vp, grid.pad, mode="edge") * dt) ** 2).astype(np.float32)
    # a broadband wavelet from t = 0 and receivers 7 rows above the sources,
    # so that the short records hold the direct wave
    w = (rng.standard_normal(nt) * np.hanning(nt)).astype(np.float32)
    src = np.stack([np.full(nsrc, 12), np.linspace(20, 52, nsrc).astype(np.int64)], 1) + grid.pad
    rcv = np.stack([np.full(20, 5), np.arange(5, 65, 3)], 1) + grid.pad
    return grid, jg, dt, f0, c_max, c2, w, src, rcv


@pytest.mark.parametrize("K_,nt,nsrc,free_surface", [
    (4, 40, 1, False), (2, 42, 3, False), (5, 37, 1, True),
])
def test_simulate_matches_jnp_and_single_step_engines(K_, nt, nsrc, free_surface):
    grid, jg, dt, f0, c_max, c2, w, src, rcv = _engine_case(nt, nsrc, free_surface)
    sim_j = j_make_simulator(jg, dt, f0, c_max, dtype=jnp.float32)
    d_obs = np.asarray(sim_j(jnp.asarray(c2), jnp.asarray(w), src, rcv))

    def j_loss(c, w_):
        r = sim_j(c, w_, jnp.asarray(src), jnp.asarray(rcv)) - d_obs
        return 0.5 * jnp.sum(r * r)

    J_j, (g_j, gw_j) = jax.value_and_grad(j_loss, argnums=(0, 1))(jnp.asarray(c2) * 1.01,
                                                                  jnp.asarray(w))
    ref = {"jnp": (float(J_j), np.asarray(JRingSpec.build(jg).mask_valid(g_j)),
                   np.asarray(gw_j))}

    def run(sim):
        c = (torch.tensor(c2) * 1.01).requires_grad_()
        wt = torch.tensor(w).requires_grad_()
        r = sim(c, wt, torch.tensor(src), torch.tensor(rcv)) - torch.tensor(d_obs)
        J = 0.5 * torch.sum(r * r)
        g, gw = (x.numpy() for x in torch.autograd.grad(J, (c, wt)))
        return float(J.detach()), g, gw

    sim = make_simulator_kstep(grid, dt, f0, c_max, K=K_)
    ref["cuda_step"] = run(make_simulator_step(grid, dt, f0, c_max))
    J, g, gw = run(sim)
    for name, (J_r, g_r, gw_r) in ref.items():
        assert abs(J - J_r) / J_r < GTOL, name
        assert _rel(g, g_r) < GTOL, f"gradient vs {name}: {_rel(g, g_r):.3e}"
        assert _rel(gw, gw_r) < GTOL, f"wavelet gradient vs {name}: {_rel(gw, gw_r):.3e}"
    with torch.no_grad():
        seis = sim(torch.tensor(c2), torch.tensor(w), torch.tensor(src), torch.tensor(rcv))
    assert _rel(seis.numpy(), d_obs) < 1e-5


def test_merged_reverse_matches_two_call_reverse():
    grid, _, dt, f0, c_max, c2, w, src, rcv = _engine_case(30, 2, True)
    out = []
    for merged in (False, True):
        sim = make_simulator_step(grid, dt, f0, c_max, merged_reverse=merged)
        c = torch.tensor(c2).requires_grad_()
        wt = torch.tensor(w).requires_grad_()
        seis = sim(c, wt, torch.tensor(src), torch.tensor(rcv))
        out.append(torch.autograd.grad(0.5 * (seis**2).sum(), (c, wt)))
    for a, b in zip(*out):
        assert _rel(b.numpy(), a.numpy()) <= 1e-6


def test_cuda_kstep_is_explicit_and_wrappers_refuse_other_devices():
    grid = Grid(**_grid_kw(False))
    dt = grid.cfl_dt(2500.0, 0.7)
    prop = AcousticPropagator(grid, dt, 14.0, 2500.0, impl="cuda_kstep", device="cuda")
    assert prop.resolve_impl(nt=100) == "cuda_kstep"
    merged = AcousticPropagator(grid, dt, 14.0, 2500.0, impl="cuda_step", device="cuda",
                                merged_reverse=True)
    assert merged.resolve_impl(nt=100) == "cuda_step"
    for impl in ("cuda_kstep", "cuda_scanres"):
        with pytest.raises(ValueError, match="merged_reverse is a cuda_step option"):
            AcousticPropagator(grid, dt, 14.0, 2500.0, impl=impl, device="cuda",
                               merged_reverse=True)
    with pytest.raises(ValueError, match="CUDA device"):
        AcousticPropagator(grid, dt, 14.0, 2500.0, impl="cuda_kstep", device="cpu")
    for K_ in (1, 0):
        with pytest.raises(ValueError, match="K >= 2"):
            make_simulator_kstep(grid, dt, 14.0, 2500.0, K=K_)
    meta = torch.empty(grid.padded_shape, device="meta")
    idx = torch.zeros((1, 2), dtype=torch.int64)
    for call in (
        lambda: kk.kstep_forward(grid, meta, (), meta, meta, meta, meta, 0, 1, idx, idx, meta),
        lambda: kk.kstep_reverse(grid, meta, (), meta, meta, meta, meta, meta, meta, meta, meta,
                                 0, 1, idx, idx, meta),
        lambda: kst.fused_reverse_step(grid, meta, (), meta, meta, meta, meta, meta, meta, meta,
                                       meta, 0, idx, idx, meta),
        lambda: kst.leapfrog(grid, meta, meta, meta),
    ):
        with pytest.raises(ValueError, match="no kernel for device"):
            call()
