"""tpufwi_torch single-step engine (``cuda_step``) == tpufwi's, on the CPU.

Each single-step kernel's plain version against the reference's Pallas
kernel run in interpret mode, for one step from random inputs (the layouts
converted: the reference keeps CPML state on strips and the forward fields
in an aligned extended layout; the port keeps halo planes): the forward
step (with sources and ring slabs), the reconstruction (sources before the
ring), the transposed step (receiver injection with coinciding receivers,
imaging). Tolerance 1e-5 of each output's max: one fp32 step, summed in
another order. Then the whole engine's plain path against
``make_simulator_pallas(interpret=True)`` and the jnp engine at the
reference suite's GTOL = 1e-4 (tests/test_pallas_adjoint.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufwi.adjoint import make_simulator as j_make_simulator
from tpufwi.adjoint_pallas import make_simulator_pallas
from tpufwi.grid import Grid as JGrid
from tpufwi.kernels import acoustic2d_pallas as jp
from tpufwi.kernels import acoustic2d_pallas_bwd as jb
from tpufwi.propagators.boundary import RingSpec as JRingSpec
from tpufwi.wavelets import ricker_np

from tpufwi_torch.adjoint_step import make_simulator_step
from tpufwi_torch.grid import Grid
from tpufwi_torch.kernels import acoustic2d_step as kst
from tpufwi_torch.kernels.acoustic2d_scanres import strip_depth, strip_profiles
from tpufwi_torch.propagators.acoustic2d import AcousticPropagator

GTOL = 1e-4
STEP_TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _grid_kw(free_surface):
    return dict(shape=(40, 56), h=(10.0, 12.0), pml=10, order=8, free_surface=free_surface)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30)


def _halo(grid, x):
    R = grid.radius
    return torch.nn.functional.pad(torch.as_tensor(np.asarray(x)), (R, R, R, R)).contiguous()


def _strips_to_planes(grid, zs, xs):
    """(2, S, NX) z strips and (2, NZ, S) x strips -> one padded plane each."""
    NZ, NX = grid.padded_shape
    S = strip_depth(grid)
    pz, px = np.zeros((NZ, NX), np.float32), np.zeros((NZ, NX), np.float32)
    pz[:S], pz[NZ - S:] = zs[0], zs[1]
    px[:, :S], px[:, NX - S:] = xs[0], xs[1]
    return pz, px


def _planes_to_strips(grid, pz, px):
    NZ, NX = grid.padded_shape
    S = strip_depth(grid)
    return np.stack([pz[:S], pz[NZ - S:]]), np.stack([px[:, :S], px[:, NX - S:]])


def _inputs(grid, seed):
    rng = np.random.default_rng(seed)
    NZ, NX = grid.padded_shape
    S = strip_depth(grid)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    c2 = rng.uniform(0.05, 0.2, (NZ, NX)).astype(np.float32)
    return rng, f32, c2, (f32(2, S, NX), f32(2, S, NX), f32(2, NZ, S), f32(2, NZ, S))


def _geometry(grid):
    pad, r = grid.pad, grid.radius
    src = np.array([[pad + 15, pad + 20], [pad + r - 2, pad + 30]])  # the second in the ring
    rx = np.arange(pad + 3, pad + 50, 4)
    rcv = np.stack([np.full_like(rx, pad + 5), rx], 1)
    return src, np.concatenate([rcv, rcv[:3]])  # three coinciding receivers


@pytest.mark.parametrize("free_surface", [False, True])
def test_forward_step_matches_pallas_kernel(free_surface):
    kw = _grid_kw(free_surface)
    grid, jg = Grid(**kw), JGrid(**kw)
    dt = grid.cfl_dt(2500.0, 0.7)
    rng, f32, c2, strips = _inputs(grid, 1)
    p_prev, p = f32(*grid.padded_shape), f32(*grid.padded_shape)
    src, rcv = _geometry(grid)
    w = f32(5)
    t = 3
    profiles = strip_profiles(grid, dt, 2500.0, 14.0)

    step = jp.make_fused_forward_step(jg, interpret=True, nsrc=len(src), with_tape=True)
    state = jp.StripState(jp.to_ext(jnp.asarray(p_prev)), jp.to_ext(jnp.asarray(p)),
                          *map(jnp.asarray, strips))
    amp = (c2[src[:, 0], src[:, 1]] * w[t]).reshape(1, -1)
    new, rings = step(state, jp.to_ext(jnp.asarray(c2), "edge"), profiles,
                      jnp.asarray(src[:, 0].reshape(1, -1), jnp.int32),
                      jnp.asarray(src[:, 1].reshape(1, -1), jnp.int32), jnp.asarray(amp))
    p_ref = np.asarray(jp.from_ext(new.p, jg))

    cur, prev = _halo(grid, p), _halo(grid, p_prev)
    phiz, phix = _strips_to_planes(grid, strips[0], strips[2])
    psiz, psix = _strips_to_planes(grid, strips[1], strips[3])
    cpml = torch.stack([_halo(grid, x) for x in (phiz, psiz, phix, psix)]).contiguous()
    seis = torch.zeros((5, len(rcv)))
    ring_row = torch.zeros(sum(int(np.asarray(r).size) for r in rings))
    before = kst.fused_forward_step.launches
    kst.fused_forward_step(grid, torch.tensor(c2), tuple(map(torch.tensor, profiles)), cur, prev,
                           cpml, torch.tensor(w), t, torch.tensor(src), torch.tensor(rcv), seis,
                           ring_row)
    assert kst.fused_forward_step.launches == before  # plain version on the CPU
    R = grid.radius
    got = prev[R:-R, R:-R].numpy()
    assert _rel(got, p_ref) < STEP_TOL
    assert _rel(seis[t].numpy(), p_ref[rcv[:, 0], rcv[:, 1]]) < STEP_TOL
    assert _rel(ring_row.numpy(), np.concatenate([np.asarray(r).ravel() for r in rings])) \
        < STEP_TOL
    c = cpml[:, R:-R, R:-R].numpy()
    strips = _planes_to_strips(grid, c[0], c[2]) + _planes_to_strips(grid, c[1], c[3])
    for got_s, ref_s in zip(strips, (new.phiz, new.phix, new.psiz, new.psix)):
        assert _rel(got_s, ref_s) < STEP_TOL


def test_forward_steps_write_the_whole_scan_snapshot_tape():
    """A loop of fused_forward_step, handed a bf16 row each step (the
    whole-scan forward's per-step oracle, chip_smoke.scanres_forward_steps),
    gives scanres_forward_plain(tape="snap")'s seismogram, snapshot tape and
    last two fields bitwise: with the free surface, a source in the ring
    and coinciding receivers."""
    import chip_smoke
    from tpufwi_torch.kernels import acoustic2d_scanres as ks

    grid = Grid(**_grid_kw(True))
    dt = grid.cfl_dt(2500.0, 0.7)
    rng = np.random.default_rng(5)
    c2 = torch.tensor(((2000.0 + 400.0 * rng.random(grid.padded_shape)) * dt) ** 2,
                      dtype=torch.float32)
    args = (grid, c2, tuple(map(torch.tensor, strip_profiles(grid, dt, 2500.0, 14.0))))
    w = torch.tensor(ricker_np(14.0, dt, 12), dtype=torch.float32)
    src, rcv = map(torch.tensor, _geometry(grid))
    got = chip_smoke.scanres_forward_steps(args, w, src, rcv, tape="snap")
    ref = ks.scanres_forward_plain(*args, w, src, rcv, "snap")
    assert got[1].dtype == torch.bfloat16 and got[4] is None and ref[4] is None
    assert float(got[1].float().abs().max()) > 0.0
    for name, a, b in zip(("seis", "tape", "penult", "last"), got, ref):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("free_surface", [False, True])
def test_recon_step_matches_pallas_kernel(free_surface):
    kw = _grid_kw(free_surface)
    grid, jg = Grid(**kw), JGrid(**kw)
    rng, f32, c2, _ = _inputs(grid, 2)
    p_t, p_tp1 = f32(*grid.padded_shape), f32(*grid.padded_shape)
    src, _ = _geometry(grid)
    w = f32(6)
    t = 4
    rings = JRingSpec.build(jg)
    ring_vals = tuple(f32(*[sl.stop - sl.start for sl in s]) for s in rings.slices)
    recon = jb.make_recon_kernel(jg, interpret=True, nsrc=len(src))
    amp = (c2[src[:, 0], src[:, 1]] * w[t]).reshape(1, -1)
    p_ref, lap_ref = (np.asarray(x) for x in recon(
        jnp.asarray(p_tp1), jnp.asarray(p_t), jnp.asarray(c2),
        jnp.asarray(src[:, 0].reshape(1, -1), jnp.int32),
        jnp.asarray(src[:, 1].reshape(1, -1), jnp.int32), jnp.asarray(amp),
        *map(jnp.asarray, ring_vals)))

    pt, ptp1 = _halo(grid, p_t), _halo(grid, p_tp1)
    lapw = torch.zeros(grid.padded_shape)
    row = torch.tensor(np.concatenate([r.ravel() for r in ring_vals]))
    kst.recon_step(grid, torch.tensor(c2), pt, ptp1, lapw, torch.tensor(w), t,
                   torch.tensor(src), row)
    R = grid.radius
    got = ptp1[R:-R, R:-R].numpy()
    assert _rel(lapw.numpy(), lap_ref) < STEP_TOL
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
    assert np.array_equal(got[src[1, 0], src[1, 1]], p_ref[src[1, 0], src[1, 1]])  # ring wins


@pytest.mark.parametrize("free_surface", [False, True])
def test_adjoint_step_matches_pallas_kernel(free_surface):
    kw = _grid_kw(free_surface)
    grid, jg = Grid(**kw), JGrid(**kw)
    dt = grid.cfl_dt(2500.0, 0.7)
    rng, f32, c2, strips = _inputs(grid, 3)
    q_pm, q_p, lapw, gbar = (f32(*grid.padded_shape) for _ in range(4))
    src, rcv = _geometry(grid)
    nt, t = 5, 2
    ybar = f32(nt, len(rcv))
    profiles = strip_profiles(grid, dt, 2500.0, 14.0)
    pbz, psz, pbx, psx = strips
    step_T = jb.make_fused_adjoint_step(jg, interpret=True, nrec=len(rcv))
    outs = [np.asarray(x) for x in step_T(
        jnp.asarray(q_pm), jnp.asarray(q_p), jnp.asarray(c2), jnp.asarray(lapw),
        jnp.asarray(gbar), tuple(map(jnp.asarray, strips)), profiles,
        jnp.asarray(rcv[:, 0].reshape(1, -1), jnp.int32),
        jnp.asarray(rcv[:, 1].reshape(-1, 1), jnp.int32), jnp.asarray(ybar[t].reshape(-1, 1)))]
    q_pm_r, q_p_r, gbar_r, pbz_r, psz_r, pbx_r, psx_r = outs

    q, q_other = _halo(grid, q_p), _halo(grid, -q_pm)
    planes = np.zeros((kst.ADJ_PLANES, *grid.padded_shape), np.float32)
    planes[3], planes[7] = _strips_to_planes(grid, pbz, pbx)
    planes[1], planes[5] = _strips_to_planes(grid, psz, psx)
    adj = torch.stack([_halo(grid, x) for x in planes]).contiguous()
    gacc = torch.tensor(gbar)
    lam_src = torch.zeros((nt, len(src)))
    kst.fused_adjoint_step(grid, torch.tensor(c2), tuple(map(torch.tensor, profiles)), q,
                           q_other, adj, torch.tensor(lapw), gacc, torch.tensor(ybar), t,
                           torch.tensor(src), torch.tensor(rcv), lam_src)
    R = grid.radius
    inner = lambda x: x[..., R:-R, R:-R].numpy()  # noqa: E731
    assert _rel(inner(q), -q_pm_r) < STEP_TOL  # lambda_t
    assert _rel(inner(q_other), q_p_r) < STEP_TOL
    assert _rel(gacc.numpy(), gbar_r) < STEP_TOL
    assert _rel(lam_src[t].numpy(), -q_pm_r[src[:, 0], src[:, 1]]) < STEP_TOL
    a = inner(adj)
    strips = _planes_to_strips(grid, a[3], a[7]) + _planes_to_strips(grid, a[1], a[5])
    for got_s, ref_s in zip(strips, (pbz_r, pbx_r, psz_r, psx_r)):
        assert _rel(got_s, ref_s) < STEP_TOL


@pytest.mark.parametrize("free_surface", [False, True])
def test_simulate_matches_reference_single_step_engine(free_surface):
    kw = dict(shape=(48, 72), h=(10.0, 10.0), pml=10, order=4, free_surface=free_surface)
    grid, jg = Grid(**kw), JGrid(**kw)
    c_max, f0, nt = 2500.0, 14.0, 120
    dt = grid.cfl_dt(c_max, safety=0.7)
    vp = np.clip(2000 + 200 * np.random.default_rng(0).standard_normal(grid.shape), 1700, 2500)
    c2 = ((np.pad(vp, grid.pad, mode="edge") * dt) ** 2).astype(np.float32)
    w = ricker_np(f0, dt, nt).astype(np.float32)
    src = np.array([[24, 36]]) + grid.pad
    rcv = np.stack([np.full(20, 5), np.arange(5, 65, 3)], 1) + grid.pad
    sims = {"jnp": j_make_simulator(jg, dt, f0, c_max, dtype=jnp.float32),
            "pallas": make_simulator_pallas(jg, dt, f0, c_max, interpret=True)}
    d_obs = np.asarray(sims["jnp"](jnp.asarray(c2), jnp.asarray(w), src, rcv))
    ref = {}
    for name, sim in sims.items():
        def loss(c, w_, sim=sim):
            r = sim(c, w_, jnp.asarray(src), jnp.asarray(rcv)) - d_obs
            return 0.5 * jnp.sum(r * r)

        J, (g, gw) = jax.value_and_grad(loss, argnums=(0, 1))(jnp.asarray(c2) * 1.01,
                                                             jnp.asarray(w))
        ref[name] = (float(J), np.asarray(JRingSpec.build(jg).mask_valid(g)), np.asarray(gw))

    sim = make_simulator_step(grid, dt, f0, c_max)
    c = (torch.tensor(c2) * 1.01).requires_grad_()
    wt = torch.tensor(w).requires_grad_()
    r = sim(c, wt, torch.tensor(src), torch.tensor(rcv)) - torch.tensor(d_obs)
    J = 0.5 * torch.sum(r * r)
    g, gw = (x.numpy() for x in torch.autograd.grad(J, (c, wt)))
    for name, (J_r, g_r, gw_r) in ref.items():
        assert abs(float(J.detach()) - J_r) / J_r < GTOL, name
        assert _rel(g, g_r) < GTOL, f"gradient vs {name}: {_rel(g, g_r):.3e}"
        assert _rel(gw, gw_r) < GTOL, f"wavelet gradient vs {name}: {_rel(gw, gw_r):.3e}"
    with torch.no_grad():
        seis = sim(torch.tensor(c2), torch.tensor(w), torch.tensor(src), torch.tensor(rcv))
    assert _rel(seis.numpy(), d_obs) < 1e-5


def test_cuda_step_is_explicit_and_wrappers_refuse_other_devices():
    grid = Grid(**_grid_kw(False))
    prop = AcousticPropagator(grid, grid.cfl_dt(2500.0, 0.7), 14.0, 2500.0,
                              impl="cuda_step", device="cuda")
    assert prop.resolve_impl(nt=100) == "cuda_step"
    meta = torch.empty(grid.padded_shape, device="meta")
    idx = torch.zeros((1, 2), dtype=torch.int64)
    with pytest.raises(ValueError, match="no kernel for device"):
        kst.fused_forward_step(grid, meta, (), meta, meta, meta, meta, 0, idx, idx, meta)
    with pytest.raises(ValueError, match="no kernel for device"):
        kst.recon_step(grid, meta, meta, meta, meta, meta, 0, idx)
    with pytest.raises(ValueError, match="no kernel for device"):
        kst.fused_adjoint_step(grid, meta, (), meta, meta, meta, meta, meta, meta, 0, idx, idx,
                               meta)
