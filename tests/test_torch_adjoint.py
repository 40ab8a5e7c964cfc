"""tpufwi_torch exact boundary-saving adjoint (``adjoint.make_simulator``,
the CPU engine ``impl="eager"``) == tpufwi's, on the CPU.

Mirrors tests/test_adjoint.py, test_reconstruction.py, test_analytic.py and
test_cpml.py with the reference's tolerances:
- the rings gradient equals the plain-autograd ("full") gradient on the
  valid region, fp64, 1e-11;
- adjoint dot-product <L dm, db> == <dm, L^T db> through
  ``AcousticPropagator(device="cpu")``: fp64 1e-11, fp32 1e-4;
- finite-difference directional derivative, 1e-7;
- bf16 ring tape: gradient within 2e-2 (relative L2) and cosine > 0.999;
- against the reference's ``make_simulator``: fp64 J and gradient 1e-12;
- reverse reconstruction equals the stored forward field on the valid
  region, 1e-10 of the field's maximum;
- the 2D Green's function within 1% and the CPML below -60 dB.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufwi.adjoint import make_simulator as j_make_simulator
from tpufwi.grid import Grid as JGrid
from tpufwi.kernels import acoustic2d_jnp as jstep
from tpufwi.propagators.acoustic2d import AcousticPropagator as JProp
from tpufwi.acquisition import Geometry as JGeometry
from tpufwi.propagators.boundary import RingSpec as JRingSpec
from tpufwi.wavelets import ricker_np

from tpufwi_torch.acquisition import Geometry
from tpufwi_torch.adjoint import make_simulator
from tpufwi_torch.cpml import build_profiles
from tpufwi_torch.grid import Grid
from tpufwi_torch.kernels import acoustic2d_eager as tstep
from tpufwi_torch.propagators.acoustic2d import AcousticPropagator
from tpufwi_torch.propagators.boundary import RingSpec


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _problem(dtype, order=4, nz=40, nx=50, pml=8, nt=160, f0=14.0):
    """tests/test_adjoint.py's problem, on the port."""
    rng = np.random.default_rng(7)
    grid = Grid(shape=(nz, nx), h=(12.0, 12.0), pml=pml, order=order)
    vp_true = 2000.0 + 300.0 * rng.standard_normal((nz, nx)).cumsum(0) / nz
    vp_true = np.clip(vp_true, 1600.0, 2600.0)
    vp0 = np.full((nz, nx), float(vp_true.mean()))
    c_max = 2800.0
    dt = grid.cfl_dt(c_max, safety=0.7)
    w = torch.tensor(ricker_np(f0, dt, nt), dtype=dtype)
    src = np.array([[6, nx // 3]])
    rx = np.arange(5, nx - 5, 2)
    rcv = np.stack([np.full_like(rx, 4), rx], 1)
    geom = Geometry.from_physical(grid, src, rcv, device="cpu")
    prop = AcousticPropagator(grid, dt, f0, c_max, dtype=dtype, device="cpu")
    sim_ad = make_simulator(grid, dt, f0, c_max, gradient="full")

    def forward_ad(vp):
        return sim_ad(prop.c2dt2(vp), w, geom.src_idx, geom.rcv_idx)

    with torch.no_grad():
        d_obs = prop(torch.tensor(vp_true, dtype=dtype), geom, w)
    return grid, prop, forward_ad, geom, w, torch.tensor(vp0, dtype=dtype), d_obs


def _interior_mask(grid):
    m = np.zeros(grid.shape)
    r = grid.radius
    m[r:-r, r:-r] = 1.0
    return m


def _grad(fn, x):
    x = x.detach().requires_grad_(True)
    J = fn(x)
    (g,) = torch.autograd.grad(J, x)
    return float(J.detach()), g


def test_gradient_matches_full_ad_fp64():
    grid, prop, forward_ad, geom, w, vp0, d_obs = _problem(torch.float64)
    assert prop.resolve_impl(nt=w.shape[0]) == "eager"
    J1, g_custom = _grad(lambda v: 0.5 * ((prop(v, geom, w) - d_obs) ** 2).sum(), vp0)
    J2, g_ad = _grad(lambda v: 0.5 * ((forward_ad(v) - d_obs) ** 2).sum(), vp0)
    assert abs(J1 - J2) <= 1e-12 * abs(J2)
    mask = _interior_mask(grid)
    g_custom, g_ad = g_custom.numpy(), g_ad.numpy() * mask
    assert np.all(g_custom * (1 - mask) == 0.0)
    err = np.abs(g_custom - g_ad).max() / np.abs(g_ad).max()
    assert err < 1e-11, f"custom vs full-AD gradient rel err {err:.3e}"


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-11), (torch.float32, 1e-4)])
def test_adjoint_dot_product(dtype, tol):
    """<L dm, db> == <dm, L^T db> (the graded V2 metric, BASELINE.json:2):
    L by forward-mode AD through the plain loop, L^T by the propagator."""
    grid, prop, forward_ad, geom, w, vp0, d_obs = _problem(dtype)
    rng = np.random.default_rng(3)
    dm = torch.tensor(rng.standard_normal(grid.shape) * _interior_mask(grid), dtype=dtype)
    db = torch.tensor(rng.standard_normal(tuple(d_obs.shape)), dtype=dtype)
    _, Ldm = torch.func.jvp(forward_ad, (vp0,), (dm,))
    v = vp0.clone().requires_grad_(True)
    (LTdb,) = torch.autograd.grad(prop(v, geom, w), v, grad_outputs=db)
    lhs = float((Ldm.double() * db.double()).sum())
    rhs = float((dm.double() * LTdb.double()).sum())
    rel = abs(lhs - rhs) / (float(Ldm.double().norm() * db.double().norm()) + 1e-300)
    assert rel < tol, f"dot-product rel err {rel:.3e} ({dtype})"


def test_gradient_finite_difference():
    grid, prop, _, geom, w, vp0, d_obs = _problem(torch.float64, nt=120)

    def loss(vp):
        return 0.5 * ((prop(vp, geom, w) - d_obs) ** 2).sum()

    _, g = _grad(loss, vp0)
    dv = torch.tensor(np.random.default_rng(11).standard_normal(grid.shape)
                      * _interior_mask(grid))
    gdot = float((g * dv).sum())
    eps = 1e-4
    with torch.no_grad():
        fd = (float(loss(vp0 + eps * dv)) - float(loss(vp0 - eps * dv))) / (2 * eps)
    rel = abs(fd - gdot) / (abs(fd) + 1e-300)
    assert rel < 1e-7, f"FD check rel err {rel:.3e}"


def test_bf16_tape_gradient():
    """``tape_dtype=torch.bfloat16`` halves the ring tape; the rounding
    perturbs only the reconstruction on the ring (2D case of the
    reference's test)."""
    grid = Grid(shape=(30, 36), h=(10.0, 10.0), pml=8, order=4)
    vp = 2000.0 + 150.0 * np.random.default_rng(0).random(grid.shape)
    dt = grid.cfl_dt(float(vp.max()), safety=0.6)
    w = torch.tensor(ricker_np(13.0, dt, 90), dtype=torch.float32)
    geom = Geometry.from_physical(grid, np.array([[15, 8]]),
                                  np.stack([np.full(5, 8), np.arange(8, 28, 4)], 1), device="cpu")
    c2 = torch.tensor((np.pad(vp, grid.pad, mode="edge") ** 2 * dt * dt), dtype=torch.float32)
    s32 = make_simulator(grid, dt, 13.0, float(vp.max()))
    s16 = make_simulator(grid, dt, 13.0, float(vp.max()), tape_dtype=torch.bfloat16)
    assert s16.rings.tape_dtype == torch.bfloat16
    assert all(r.dtype == torch.bfloat16 for r in s16.rings.extract(torch.zeros(c2.shape)))

    def loss(sim):
        return lambda c: (sim(c, w, geom.src_idx, geom.rcv_idx) ** 2).sum()

    J32, g32 = _grad(loss(s32), c2)
    J16, g16 = _grad(loss(s16), c2)
    assert abs(J32 - J16) <= 1e-6 * J32
    g32, g16 = g32.double().ravel(), g16.double().ravel()
    rel = float((g16 - g32).norm() / g32.norm())
    cos = float(g16 @ g32 / (g16.norm() * g32.norm()))
    assert rel < 2e-2 and cos > 0.999, f"bf16 tape: rel {rel:.3e}, cos {cos:.6f}"
    prop = AcousticPropagator(grid, dt, 13.0, float(vp.max()), tape_dtype=torch.bfloat16,
                              device="cpu")
    assert prop.resolve_impl(nt=90) == "eager"


@pytest.mark.parametrize("free_surface,nsrc", [(False, 1), (True, 2)])
def test_make_simulator_matches_reference_x64(free_surface, nsrc):
    kw = dict(shape=(40, 50), h=(12.0, 12.0), pml=8, order=4, free_surface=free_surface)
    grid = Grid(**kw)
    c_max, f0, nt = 2800.0, 14.0, 100
    dt = grid.cfl_dt(c_max, safety=0.7)
    rng = np.random.default_rng(5)
    vp = np.clip(2000 + 200 * rng.standard_normal(grid.shape), 1700, 2600)
    c2 = (np.pad(vp, grid.pad, mode="edge") * dt) ** 2
    w = ricker_np(f0, dt, nt)
    # the second source sits in the ring (row radius - 1 of the interior)
    src = (np.array([[20, 17], [grid.radius - 1, 30]])[:nsrc]) + grid.pad
    rx = np.arange(5, 45, 2)
    rcv = np.stack([np.full_like(rx, 4), rx], 1) + grid.pad
    d = rng.standard_normal((nt, rcv.shape[0]))

    jsim = j_make_simulator(JGrid(**kw), dt, f0, c_max, dtype=jnp.float64)

    def jloss(c, w_):
        return jnp.sum(jsim(c, w_, jnp.asarray(src), jnp.asarray(rcv)) * jnp.asarray(d))

    Jr, (gr, gwr) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(c2, jnp.float64), jnp.asarray(w, jnp.float64))
    Jr, gr, gwr = float(Jr), np.asarray(gr), np.asarray(gwr)

    sim = make_simulator(grid, dt, f0, c_max)
    assert sim.rings.valid == JRingSpec.build(JGrid(**kw)).valid
    c = torch.tensor(c2, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    J = (sim(c, wt, torch.tensor(src), torch.tensor(rcv)) * torch.tensor(d)).sum()
    g, gw = torch.autograd.grad(J, (c, wt))
    assert abs(float(J.detach()) - Jr) <= 1e-12 * abs(Jr)
    assert np.abs(g.numpy() - gr).max() <= 1e-12 * np.abs(gr).max()
    assert np.abs(gw.numpy() - gwr).max() <= 1e-12 * np.abs(gwr).max()


def test_gradient_modes():
    grid = Grid(shape=(30, 36), h=(10.0, 10.0), pml=8, order=4)
    with pytest.raises(NotImplementedError, match="remat.py"):
        make_simulator(grid, 1e-3, 10.0, 2000.0, gradient="remat")
    with pytest.raises(ValueError, match="unknown gradient mode"):
        make_simulator(grid, 1e-3, 10.0, 2000.0, gradient="ad")
    assert make_simulator(grid, 1e-3, 10.0, 2000.0, gradient="full").rings.valid == \
        RingSpec.build(grid).valid


@pytest.mark.parametrize("order,width", [(4, None), (8, 5)])
def test_ring_spec_matches_reference(order, width):
    kw = dict(shape=(30, 44), h=(10.0, 10.0), pml=6, order=order)
    jr = JRingSpec.build(JGrid(**kw), width=width)
    tr = RingSpec.build(Grid(**kw), width=width)
    assert tr.slices == jr.slices and tr.valid == jr.valid
    assert tr.tape_bytes_per_step() == jr.tape_bytes_per_step()
    p = np.random.default_rng(2).standard_normal(Grid(**kw).padded_shape)
    jslabs = jr.extract(jnp.asarray(p))
    tslabs = tr.extract(torch.tensor(p))
    for a, b in zip(jslabs, tslabs):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert np.array_equal(torch.cat(tslabs).numpy(),
                          p.reshape(-1)[tr.flat_index(p.shape).numpy()])
    q = np.zeros_like(p)
    imposed = tr.impose(torch.tensor(q), tslabs).numpy()
    assert np.array_equal(imposed, np.asarray(jr.impose(jnp.asarray(q), jslabs)))
    assert [z.numel() for z in tr.zeros_like_rings(p.shape, torch.float32)] == \
        [int(np.asarray(z).size) for z in jr.zeros_like_rings(p.shape, jnp.float32)]
    with pytest.raises(ValueError, match="too small"):
        RingSpec.build(Grid(shape=(16, 44), h=(10.0, 10.0), pml=6, order=8))


def test_reconstruction_exact_in_valid_region():
    """tests/test_reconstruction.py on the port's twin and recon steps."""
    dtype = torch.float64
    grid = Grid(shape=(48, 60), h=(10.0, 10.0), pml=10, order=4)
    c_max, f0, nt = 2400.0, 14.0, 200
    dt = grid.cfl_dt(c_max, safety=0.7)
    vp = np.clip(2000 + 200 * np.random.default_rng(0).standard_normal(grid.shape), 1700, 2400)
    pad = grid.pad
    c2 = torch.tensor((np.pad(vp, pad, mode="edge") * dt) ** 2)
    profs = build_profiles(grid, dt, c_max, f0, dtype=np.float64)
    params = tstep.AcousticParams(
        c2dt2=c2, a=tuple(torch.tensor(p[0]) for p in profs),
        b=tuple(torch.tensor(p[1]) for p in profs),
        src_idx=torch.tensor([[pad + 24, pad + 30]]), rcv_idx=torch.tensor([[pad + 5, pad + 5]]))
    w = torch.tensor(ricker_np(f0, dt, nt))
    step = tstep.make_acoustic_step(grid)
    recon = tstep.make_reverse_reconstruct_step(grid)
    rings = RingSpec.build(grid)
    s = tstep.zero_state(grid.padded_shape, 2, dtype)
    ps, tape = [], []
    for t in range(nt):
        s, _ = step(s, params, w[t])
        ps.append(s.p)
        tape.append(rings.extract(s.p))
    scale = float(torch.stack(ps).abs().max())
    sl = rings.valid
    p_t, p_tp1 = s.p_prev, s.p
    for t in range(nt - 1, 0, -1):
        p_tm1 = recon(p_t, p_tp1, c2, params.src_idx, w[t])
        if t >= 2:
            p_tm1 = rings.impose(p_tm1, tape[t - 2])
            err = float((p_tm1[sl] - ps[t - 2][sl]).abs().max()) / scale
            assert err < 1e-10, f"t={t - 1}: reconstruction err {err:.3e}"
        p_t, p_tp1 = p_tm1, p_t


def test_reconstruct_step_matches_jnp_x64():
    kw = dict(shape=(40, 56), h=(10.0, 12.0), pml=8, order=8, free_surface=True)
    grid = Grid(**kw)
    rng = np.random.default_rng(9)
    p_t, p_tp1 = (rng.standard_normal(grid.padded_shape) for _ in range(2))
    c2 = rng.uniform(0.05, 0.2, grid.padded_shape)
    src = np.array([[grid.pad, 20], [grid.pad + 10, 30]])  # one on the surface row
    ref = np.asarray(jstep.make_reverse_reconstruct_step(JGrid(**kw))(
        jnp.asarray(p_t), jnp.asarray(p_tp1), jnp.asarray(c2), jnp.asarray(src), 0.7))
    got = tstep.make_reverse_reconstruct_step(grid)(
        torch.tensor(p_t), torch.tensor(p_tp1), torch.tensor(c2), torch.tensor(src), 0.7)
    assert np.abs(got.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()


def _analytic_trace(r, c, h, w, dt, nt):
    """tests/test_analytic.py's trace: the 2D Green's function convolved
    with the wavelet, seis[t] recording p at (t+1) dt."""
    t = (np.arange(nt) + 1) * dt
    t_src = np.arange(nt) * dt
    out = np.zeros(nt)
    for i, ti in enumerate(t):
        if ti * c <= r:
            continue
        u = np.linspace(0.0, np.arccosh(c * ti / r), 400)
        integrand = np.interp(ti - (r / c) * np.cosh(u), t_src, w, left=0.0, right=0.0)
        out[i] = (h * h / (2 * np.pi)) * np.trapezoid(integrand, u)
    return out


def test_matches_2d_greens_function():
    c, f0, h = 2000.0, 12.0, 5.0
    nz = nx = 240
    grid = Grid(shape=(nz, nx), h=(h, h), pml=20, order=8)
    dt = grid.cfl_dt(c, safety=0.5)
    nt = int(0.42 / dt)
    w = ricker_np(f0, dt, nt)
    r_cells = 60
    geom = Geometry.from_physical(grid, np.array([[nz // 2, nx // 2]]),
                                  np.array([[nz // 2, nx // 2 + r_cells]]), device="cpu")
    prop = AcousticPropagator(grid, dt, f0, c, dtype=torch.float64, device="cpu")
    with torch.no_grad():
        seis = prop(torch.full(grid.shape, c, dtype=torch.float64), geom,
                    torch.tensor(w))[:, 0].numpy()
    ref = _analytic_trace(r_cells * h, c, h, w, dt, nt)
    err = np.linalg.norm(seis - ref) / np.linalg.norm(ref)
    assert err < 0.01, f"rel L2 error vs analytic {err:.3f}"
    assert abs(int(np.argmax(seis)) - int(np.argmax(ref))) <= 2


def _energy_trace(pml):
    nz, nx, c, f0 = 60, 60, 2000.0, 15.0
    grid = Grid(shape=(nz, nx), h=(10.0, 10.0), pml=pml, order=4)
    dt = grid.cfl_dt(c, safety=0.7)
    nt = int(3.0 * nz * 10.0 / c / dt)
    prop = AcousticPropagator(grid, dt, f0, c, dtype=torch.float64, device="cpu")
    geom = Geometry.from_physical(grid, np.array([[nz // 2, nx // 2]]), np.array([[4, 4]]),
                                  device="cpu")
    return prop.wavefield_energy(torch.full(grid.shape, c, dtype=torch.float64), geom,
                                 torch.tensor(ricker_np(f0, dt, nt))).numpy()


@pytest.mark.parametrize("pml", [20, 0])
def test_cpml_absorbs_below_minus_60db(pml):
    e = _energy_trace(pml)
    if pml:  # the wave leaves through the CPML
        assert 10 * np.log10(e[-1] / e.max()) < -60.0
    else:  # a rigid box keeps it
        assert 10 * np.log10(e[len(e) // 2:].max() / e.max()) > -10.0


def test_forward_snapshots_and_energy_match_reference():
    kw = dict(shape=(40, 56), h=(10.0, 10.0), pml=10, order=8, free_surface=True)
    c_max, f0, nt = 2500.0, 14.0, 60
    dt = Grid(**kw).cfl_dt(c_max, safety=0.7)
    vp = np.clip(2000 + 200 * np.random.default_rng(4).standard_normal(kw["shape"]), 1700, 2500)
    src, rcv = np.array([[20, 28]]), np.stack([np.full(16, 3), np.arange(4, 52, 3)], 1)
    w = np.random.default_rng(5).standard_normal(nt) * np.hanning(nt)
    jprop = JProp(JGrid(**kw), dt, f0, c_max, dtype=jnp.float64, impl="jnp")
    jg = JGeometry.from_physical(JGrid(**kw), src, rcv)
    seis_r, snaps_r = (np.asarray(x) for x in jprop.forward_snapshots(
        jnp.asarray(vp), jg, jnp.asarray(w), stride=7))
    e_r = np.asarray(jprop.wavefield_energy(jnp.asarray(vp), jg, jnp.asarray(w)))
    prop = AcousticPropagator(Grid(**kw), dt, f0, c_max, dtype=torch.float64, device="cpu")
    geom = Geometry.from_physical(Grid(**kw), src, rcv, device="cpu")
    seis, snaps = prop.forward_snapshots(torch.tensor(vp), geom, torch.tensor(w), stride=7)
    e = prop.wavefield_energy(torch.tensor(vp), geom, torch.tensor(w)).numpy()
    assert snaps.shape == snaps_r.shape
    for got, ref in ((seis.numpy(), seis_r), (snaps.numpy(), snaps_r), (e, e_r)):
        assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()
