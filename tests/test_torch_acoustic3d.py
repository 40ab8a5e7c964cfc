"""tpufwi_torch's 3D acoustic path == tpufwi's, on the CPU.

- The CPU engine ``eager`` in 3D: forward against the reference's jnp
  engine (x64, 1e-12 of max) and the fp64 NumPy oracle (< 1e-9 RMS, the bar
  of tests/test_acoustic3d.py), the fp64 adjoint dot-product (1e-11) and
  the gradient against the jnp engine's custom VJP (x64, 1e-10 of max on
  the valid region).
- The plain versions of the 3D kernels composed as the ``cuda3d`` engine
  composes them, against the reference's fused engine
  ``make_simulator3d_fused`` run in interpret mode at the setup of
  tests/test_acoustic3d_bwd.py, with that suite's bars: seismogram 1e-5,
  gradient and wavelet cotangent 1e-4 of their max, illumination 2e-5; a
  free-surface case against the jnp engine (fp32: seismogram 1e-5, wavelet
  cotangent 1e-4, gradient 5e-4, the reference's bar for this case; fp64:
  1e-10).
- The bf16 ring tape, with a source in the ring: gradient within 5e-2
  (norm) and cosine 0.999 of the fp32 tape's (measured 1.8e-2 and
  0.99983; the reference states the 1e-3 level for its full-scale run).
- ``'auto'`` on a 3D grid with the card's memory stubbed; ``overthrust_like``
  bit-equal to the reference; ``from_reference`` in 3D; one ``invert()``
  iteration in 3D against the reference's (the preconditioner's depth axis
  is dim 1 of a (y, z, x) grid).
"""

import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpufwi.invert as jinv
from tpufwi.acquisition import Geometry as JGeometry
from tpufwi.adjoint import make_simulator as j_make_simulator
from tpufwi.adjoint3d_pallas import make_simulator3d_fused
from tpufwi.config import FwiConfig as JFwiConfig
from tpufwi.grid import Grid as JGrid
from tpufwi.io import overthrust_like as j_overthrust_like
from tpufwi.kernels.oracle_numpy import oracle_forward
from tpufwi.misfit import l2_misfit as j_l2
from tpufwi.propagators.acoustic2d import AcousticPropagator as JProp

import tpufwi_torch.invert as tinv
from tpufwi_torch.acquisition import Geometry
from tpufwi_torch.adjoint import make_simulator
from tpufwi_torch.adjoint3d import make_simulator3d
from tpufwi_torch.config import FwiConfig
from tpufwi_torch.grid import Grid
from tpufwi_torch.interop import from_reference
from tpufwi_torch.io import OVERTHRUST_SHAPE, overthrust_like
from tpufwi_torch.kernels import acoustic3d_scan as k3
from tpufwi_torch.kernels.acoustic2d_scanres import strip_profiles
from tpufwi_torch.propagators.acoustic2d import AcousticPropagator
from tpufwi_torch.wavelets import ricker_np


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-300)


# ------------------------------------------------------------ eager engine


def _eager_setup():
    """tests/test_acoustic3d.py's problem: (y, z, x), order 4, nt 80."""
    kw = dict(shape=(28, 24, 30), h=(15.0, 15.0, 15.0), pml=6, order=4)
    dt = Grid(**kw).cfl_dt(2500.0, safety=0.7)
    rng = np.random.default_rng(0)
    vp = np.clip(2100 + 150 * rng.standard_normal(kw["shape"]), 1800, 2500)
    w = ricker_np(10.0, dt, 80)
    src = np.array([[14, 12, 15]])
    rcv = np.array([[14, 3, x] for x in range(4, 26, 3)])
    return kw, vp, dt, w, src, rcv, 10.0


def test_eager_3d_forward_matches_jnp_and_oracle():
    kw, vp, dt, w, src, rcv, f0 = _eager_setup()
    c_max = float(vp.max())
    jg = JGrid(**kw)
    jprop = JProp(jg, dt, f0, c_max, dtype=jnp.float64, impl="jnp")
    ref = np.asarray(jprop(jnp.asarray(vp), JGeometry.from_physical(jg, src, rcv),
                           jnp.asarray(w)))
    grid = Grid(**kw)
    prop = AcousticPropagator(grid, dt, f0, c_max, dtype=torch.float64, device="cpu")
    assert prop.resolve_impl(nt=len(w)) == "eager"
    with torch.no_grad():
        seis = prop(torch.tensor(vp), Geometry.from_physical(grid, src, rcv, device="cpu"),
                    torch.tensor(w)).numpy()
    assert _rel(seis, ref) <= 1e-12
    seis_o, _ = oracle_forward(vp, jg, dt, w, src, rcv, f0)
    rms = np.sqrt(np.mean((seis - seis_o) ** 2)) / np.sqrt(np.mean(seis_o**2))
    assert rms < 1e-9, f"3D relative RMS {rms:.3e}"


def test_eager_3d_adjoint_dot_product():
    kw, vp, dt, w, src, rcv, f0 = _eager_setup()
    grid = Grid(**kw)
    c_max = float(vp.max())
    prop = AcousticPropagator(grid, dt, f0, c_max, dtype=torch.float64, device="cpu")
    geom = Geometry.from_physical(grid, src, rcv, device="cpu")
    sim_ad = make_simulator(grid, dt, f0, c_max, gradient="full")
    wt = torch.tensor(w)
    rng = np.random.default_rng(3)
    r = grid.radius
    mask = np.zeros(grid.shape)
    mask[r:-r, r:-r, r:-r] = 1.0
    dm = torch.tensor(rng.standard_normal(grid.shape) * mask)
    db = torch.tensor(rng.standard_normal((len(w), len(rcv))))
    vp0 = torch.tensor(vp)
    _, Ldm = torch.func.jvp(
        lambda v: sim_ad(prop.c2dt2(v), wt, geom.src_idx, geom.rcv_idx), (vp0,), (dm,))
    v = vp0.clone().requires_grad_(True)
    (LTdb,) = torch.autograd.grad(prop(v, geom, wt), v, grad_outputs=db)
    lhs, rhs = float((Ldm * db).sum()), float((dm * LTdb).sum())
    rel = abs(lhs - rhs) / float(Ldm.norm() * db.norm())
    assert rel < 1e-11, f"3D dot-product rel err {rel:.3e}"


def test_eager_3d_gradient_matches_jnp_vjp():
    kw, vp, dt, w, src, rcv, f0 = _eager_setup()
    c_max = float(vp.max())
    jg = JGrid(**kw)
    grid = Grid(**kw)
    vp1 = vp * 1.02
    jprop = JProp(jg, dt, f0, c_max, dtype=jnp.float64, impl="jnp")
    jgeom = JGeometry.from_physical(jg, src, rcv)
    d = jprop(jnp.asarray(vp), jgeom, jnp.asarray(w))
    g_ref = np.asarray(jax.grad(lambda v: j_l2(jprop(v, jgeom, jnp.asarray(w)), d))(
        jnp.asarray(vp1)))
    prop = AcousticPropagator(grid, dt, f0, c_max, dtype=torch.float64, device="cpu")
    v = torch.tensor(vp1, requires_grad=True)
    seis = prop(v, Geometry.from_physical(grid, src, rcv, device="cpu"), torch.tensor(w))
    (g,) = torch.autograd.grad(0.5 * ((seis - torch.tensor(np.asarray(d))) ** 2).sum(), v)
    assert _rel(g.numpy(), g_ref) <= 1e-10


# ------------------------------------- the cuda3d engine's plain versions


def _fused_setup(nt=24, free_surface=False):
    """tests/test_acoustic3d_bwd.py's _setup (and _setup_fs)."""
    kw = dict(shape=(24, 30, 40), h=(10.0, 10.0, 10.0), pml=8, order=8,
              free_surface=free_surface)
    grid = Grid(**kw)
    c_max, f0 = 3000.0, 10.0
    dt = grid.cfl_dt(c_max, safety=0.6)
    rng = np.random.default_rng(7 if free_surface else 3)
    NY, NZ, NX = grid.padded_shape
    pad = grid.pad
    vp = 2500.0 + 150 * rng.standard_normal(grid.shape).astype(np.float32)
    c2 = ((np.pad(vp, pad, mode="edge") * dt) ** 2).astype(np.float32)
    w = ricker_np(f0, dt, nt).astype(np.float32)
    rx = np.arange(pad + 6, NX - pad - 6, 3)
    if free_surface:
        src = np.array([[NY // 2, pad + 8, NX // 2]])
        rcv = np.stack([np.full_like(rx, pad + 6), np.full_like(rx, pad + 2), rx], 1)
    else:
        src = np.array([[NY // 2, NZ // 2, NX // 2]])
        rcv = np.stack([np.full_like(rx, pad + 6), np.full_like(rx, NZ // 2), rx], 1)
    return kw, dt, f0, c_max, c2, w, src, rcv


def _port_runs(kw, dt, f0, c_max, c2, w, src, rcv, d_obs, scale=1.03, tape_dtype=None):
    """(seis, J, c2 gradient, wavelet gradient) of the port's cuda3d engine
    composed of the kernels' plain versions, for 0.5 |seis(scale c2) - d|^2."""
    sim = make_simulator3d(Grid(**kw), dt, f0, c_max, tape_dtype=tape_dtype)
    si, ri = torch.tensor(src), torch.tensor(rcv)
    c = (torch.tensor(c2) * scale).requires_grad_(True)
    wt = torch.tensor(w).requires_grad_(True)
    seis = sim(c, wt, si, ri)
    J = 0.5 * ((seis - torch.tensor(np.asarray(d_obs))) ** 2).sum()
    gc, gw = torch.autograd.grad(J, (c, wt))
    with torch.no_grad():
        seis1 = sim(torch.tensor(c2), torch.tensor(w), si, ri)
    return seis1.numpy(), float(J.detach()), gc.numpy(), gw.numpy()


def _jax_runs(sim, c2, w, src, rcv, d_obs, scale=1.03):
    c2j, wj = jnp.asarray(c2), jnp.asarray(w)
    si, ri = jnp.asarray(src), jnp.asarray(rcv)
    seis = np.asarray(sim(c2j, wj, si, ri))
    J, (gc, gw) = jax.value_and_grad(
        lambda c, ww: j_l2(sim(c, ww, si, ri), d_obs), argnums=(0, 1))(c2j * scale, wj)
    return seis, float(J), np.asarray(gc), np.asarray(gw)


@pytest.fixture(scope="module")
def fused_reference():
    kw, dt, f0, c_max, c2, w, src, rcv = _fused_setup()
    jg = JGrid(**kw)
    d_obs = j_make_simulator(jg, dt, f0, c_max, use_custom_vjp=False)(
        jnp.asarray(c2), jnp.asarray(w), jnp.asarray(src), jnp.asarray(rcv))
    sim = make_simulator3d_fused(jg, dt, f0, c_max, by=8, bz=16, bz_y=16, interpret=True)
    ref = _jax_runs(sim, c2, w, src, rcv, d_obs)
    illum = np.asarray(sim.illumination(jnp.asarray(c2), jnp.asarray(w), jnp.asarray(src)))
    got = _port_runs(kw, dt, f0, c_max, c2, w, src, rcv, d_obs)
    port = make_simulator3d(Grid(**kw), dt, f0, c_max)
    got_illum = port.illumination(torch.tensor(c2), torch.tensor(w), torch.tensor(src))
    return ref, got, illum, got_illum.numpy()


@pytest.mark.parametrize("what,tol", [("seis", 1e-5), ("J", 1e-5), ("gradient", 1e-4),
                                      ("wavelet", 1e-4), ("illumination", 2e-5)])
def test_plain_kernels_match_fused_reference(fused_reference, what, tol):
    ref, got, illum, got_illum = fused_reference
    i = {"seis": 0, "J": 1, "gradient": 2, "wavelet": 3}.get(what)
    if what == "illumination":
        assert got_illum.shape == illum.shape
        assert _rel(got_illum, illum) <= tol
    else:
        assert _rel(got[i], ref[i]) <= tol, what


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_plain_kernels_free_surface_match_jnp(dtype):
    """A source on the surface row and one below, surface-row receivers,
    coinciding receivers: the port pins after injection, as the jnp engine
    does. fp32 at the reference's bars for this case (gradient 5e-4: both
    boundary-saving engines carry fp32 reconstruction noise,
    tests/test_acoustic3d_bwd.py:181-184); fp64 to 1e-10."""
    kw, dt, f0, c_max, c2, w, src, rcv = _fused_setup(nt=48, free_surface=True)
    src = np.concatenate([src, [[src[0, 0] - 3, kw["pml"] + 4, src[0, 2] + 5]]])
    rcv = np.concatenate([rcv, rcv[:2]])
    c2, w = c2.astype(dtype), w.astype(dtype)
    jg = JGrid(**kw)
    sim = j_make_simulator(jg, dt, f0, c_max, dtype=jnp.dtype(dtype), use_custom_vjp=True)
    d_obs = sim(jnp.asarray(c2), jnp.asarray(w), jnp.asarray(src), jnp.asarray(rcv))
    ref = _jax_runs(sim, c2, w, src, rcv, d_obs)
    got = _port_runs(kw, dt, f0, c_max, c2, w, src, rcv, d_obs)
    tol = dict(seis=1e-5, grad=5e-4, wbar=1e-4) if dtype == np.float32 else dict(
        seis=1e-10, grad=1e-10, wbar=1e-10)
    assert _rel(got[0], ref[0]) <= tol["seis"] and abs(got[1] - ref[1]) <= tol["seis"] * ref[1]
    assert _rel(got[2], ref[2]) <= tol["grad"] and _rel(got[3], ref[3]) <= tol["wbar"]


def test_bf16_tape_gradient_within_bound():
    """A source in the ring (as a surface shot's is), so the tape carries
    the wavefield's largest values and their bf16 rounding re-enters every
    reconstructed step: measured 1.8e-2 (norm) and cosine 0.99983 here."""
    kw, dt, f0, c_max, c2, w, src, rcv = _fused_setup(nt=48)
    grid = Grid(**kw)
    src = src.copy()
    src[0, 0] = grid.pad + 2
    with torch.no_grad():
        d = make_simulator3d(grid, dt, f0, c_max)(torch.tensor(c2), torch.tensor(w),
                                                  torch.tensor(src), torch.tensor(rcv))
    _, J32, g32, w32 = _port_runs(kw, dt, f0, c_max, c2, w, src, rcv, d)
    _, J16, g16, w16 = _port_runs(kw, dt, f0, c_max, c2, w, src, rcv, d,
                                  tape_dtype=torch.bfloat16)
    assert J16 == J32  # the forward is the same; only the tape is rounded
    g32, g16 = g32.ravel().astype(np.float64), g16.ravel().astype(np.float64)
    rel = np.linalg.norm(g16 - g32) / np.linalg.norm(g32)
    cos = g16 @ g32 / (np.linalg.norm(g16) * np.linalg.norm(g32))
    assert rel < 5e-2 and cos > 0.999, f"bf16 tape: rel {rel:.3e}, cos {cos:.6f}"
    assert _rel(w16, w32) < 5e-2


def test_plain_forward_tape_rows_and_reconstruction():
    """Row t of the tape is rings(P_t) in RingSpec order (bf16: the same,
    rounded), and the reverse reconstructs P_{-1} = 0 on the valid
    region."""
    kw, dt, f0, c_max, c2, w, src, rcv = _fused_setup(nt=40)
    grid = Grid(**kw)
    prof = tuple(torch.as_tensor(p) for p in strip_profiles(grid, dt, c_max, f0))
    c2t, wt = torch.tensor(c2), torch.tensor(w)
    si, ri = torch.tensor(src), torch.tensor(rcv)
    seis, tape, ppen, plast, illum = k3.a3d_forward_plain(grid, c2t, prof, wt, si, ri,
                                                          torch.float32, illum=True)
    _, tape16, _, _, none = k3.a3d_forward_plain(grid, c2t, prof, wt, si, ri, torch.bfloat16)
    assert none is None and tape16.dtype == torch.bfloat16
    assert torch.equal(tape16, tape.to(torch.bfloat16))
    rings = make_simulator3d(grid, dt, f0, c_max).rings
    assert torch.equal(tape[-1], torch.cat(rings.extract(plast)))
    assert tuple(illum.shape) == grid.padded_shape and float(illum.min()) >= 0.0
    _, _, p0 = k3.a3d_reverse_plain(grid, c2t, prof, wt, seis, tape, ppen, plast, si, ri,
                                    return_field=True)
    assert float(p0[rings.valid].abs().max()) <= 1e-4 * float(plast.abs().max())


# ---------------------------------------------------------- engine choice


def _prop3(dtype=torch.float32, device="cuda", shape=(40, 30, 50), **kw):
    grid = Grid(shape=shape, h=(25.0,) * 3, pml=10, order=8)
    return AcousticPropagator(grid, grid.cfl_dt(6000.0, 0.7), 6.0, 6000.0, dtype=dtype,
                              device=device, **kw)


def test_resolve_impl_3d(monkeypatch):
    """'eager' on the CPU; on the card the fp32 ring tape while it fits 70%
    of the card's memory (one tape alive at once), then the bf16 tape, then
    a raise with the reason; fp64 on the card raises."""
    gib = 2**30
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(total_memory=80 * gib))
    assert _prop3(device="cpu").resolve_impl(nt=500) == "eager"
    prop = _prop3()
    budget = prop.tape3d_budget_bytes()
    assert budget == int(0.7 * 80 * gib)
    per_row = prop.tape3d_bytes(1, 4)
    nt32 = budget // per_row
    assert prop.resolve_impl(nt=nt32) == "cuda3d" and "fp32 ring tape" in prop.resolve_note
    assert prop.resolve_impl(nt=nt32 + 1) == "cuda3d_bf16"
    assert "bf16 ring tape" in prop.resolve_note and "over the" in prop.resolve_note
    assert prop.resolve_impl(nt=2 * nt32) == "cuda3d_bf16"
    with pytest.raises(NotImplementedError, match="3D grid: no ported engine fits"):
        prop.resolve_impl(nt=2 * nt32 + 2)
    with pytest.raises(NotImplementedError, match="cannot be sized"):
        prop.resolve_impl()
    with pytest.raises(ValueError, match="fp32 only"):
        _prop3(dtype=torch.float64).resolve_impl(nt=100)
    # the full SEG/EAGE Overthrust grid at t_max 4 s: only the bf16 tape fits
    nz, ny, nx = OVERTHRUST_SHAPE
    big = _prop3(shape=(ny, nz, nx))
    nt = int(4.0 / big.dt)
    assert big.fix_impl_for(nt=nt) == "cuda3d_bf16" and big.impl == "cuda3d_bf16"
    assert abs(big.tape3d_bytes(nt, 2) / 1e9 - 44.9) < 0.1
    # explicit engines are checked against the grid
    assert _prop3(impl="cuda3d_bf16").resolve_impl(nt=10) == "cuda3d_bf16"
    with pytest.raises(ValueError, match="2D engine"):
        _prop3(impl="cuda_scanres")
    grid2 = Grid(shape=(40, 50), h=(10.0, 10.0), pml=10, order=8)
    with pytest.raises(ValueError, match="3D engine"):
        AcousticPropagator(grid2, grid2.cfl_dt(3000.0, 0.7), 8.0, 3000.0, impl="cuda3d")
    with pytest.raises(ValueError, match="CUDA device"):
        _prop3(device="cpu", impl="cuda3d")


# ------------------------------------------------------------- models, I/O


def test_overthrust_like_bit_equal():
    got, dx = overthrust_like(nz=14, ny=12, nx=20)
    ref, jdx = j_overthrust_like(nz=14, ny=12, nx=20)
    assert dx == jdx and got.dtype == np.float64
    assert np.array_equal(got, np.asarray(ref))
    assert OVERTHRUST_SHAPE == (187, 801, 801)


def test_from_reference_carries_3d_problem():
    kw, dt, f0, c_max, c2, w, src, rcv = _fused_setup()
    jg = JGrid(**kw)
    rng = np.random.default_rng(1)
    vp = 2500.0 + 100 * rng.random(jg.shape)
    jprop = JProp(jg, dt, f0, c_max, dtype=jnp.float64, impl="jnp")
    grid, geom, vp_t, w_t = from_reference(dataclasses.asdict(jg), src, rcv, vp, w,
                                           device="cpu", dtype=torch.float64)
    assert grid.padded_shape == jg.padded_shape and grid.ndim == 3
    assert tuple(geom.src_idx.shape) == (1, 3) and geom.rcv_idx.dtype == torch.int64
    prop = AcousticPropagator(grid, dt, f0, c_max, dtype=torch.float64, device="cpu")
    assert np.array_equal(prop.c2dt2(vp_t).numpy(), np.asarray(jprop.c2dt2(jnp.asarray(vp))))
    assert np.array_equal(w_t.numpy(), w.astype(np.float64))


# --------------------------------------------------------------- inversion


def _invert_cfg(run_dir):
    return json.dumps(dict(
        stages=[dict(fmax=None, iterations=1)],
        prop=dict(order=4, pml=6, cfl_safety=0.7, dtype="float64"),
        precond=dict(use_illumination=True, mask_top=3, depth_power=1.0),
        opt=dict(vmin=1800.0, vmax=2600.0),
        run_dir=run_dir,
    ))


def _invert_problem(pkg, tmp_path):
    """A two-shot 3D survey (y, z, x) on the same inputs in either package."""
    shape = (14, 12, 16)
    vp_true = np.full(shape, 2000.0)
    vp_true[:, 7:, :] = 2300.0
    vp_true[5:9, 4:7, 6:10] = 2150.0
    rcv = np.array([[y, 1, x] for y in range(2, 12, 3) for x in range(2, 14, 3)])
    srcs = [np.array([[4, 1, 5]]), np.array([[9, 1, 10]])]
    f0, c_max = 12.0, 2600.0
    if pkg == "ref":
        cfg = JFwiConfig.from_json(_invert_cfg(str(tmp_path / "ref")))
        grid = JGrid(shape=shape, h=(15.0, 12.0, 15.0), pml=cfg.prop.pml, order=cfg.prop.order)
        dt = grid.cfl_dt(c_max, cfg.prop.cfl_safety)
        w = jnp.asarray(ricker_np(f0, dt, 70))
        prop = JProp(grid, dt, f0, c_max, dtype=jnp.float64, impl="jnp")
        geoms = [JGeometry.from_physical(grid, s, rcv) for s in srcs]
        stacked = JGeometry(src_idx=jnp.stack([g.src_idx for g in geoms]),
                            rcv_idx=jnp.stack([g.rcv_idx for g in geoms]))
        d = jnp.stack([prop(jnp.asarray(vp_true), g, w) for g in geoms])
        problem = jinv.FwiProblem(prop=prop, geoms=stacked, d_obs=d, wavelet=w, dt=dt)
        return cfg, problem, jnp.full(shape, 2100.0)
    cfg = FwiConfig.from_json(_invert_cfg(str(tmp_path / "port")))
    grid = Grid(shape=shape, h=(15.0, 12.0, 15.0), pml=cfg.prop.pml, order=cfg.prop.order)
    dt = grid.cfl_dt(c_max, cfg.prop.cfl_safety)
    w = torch.tensor(ricker_np(f0, dt, 70))
    prop = AcousticPropagator(grid, dt, f0, c_max, dtype=torch.float64, device="cpu")
    geoms = Geometry.stack([Geometry.from_physical(grid, s, rcv, device="cpu") for s in srcs])
    with torch.no_grad():
        d = torch.stack([prop(torch.tensor(vp_true), geoms.shot(i), w) for i in range(2)])
    problem = tinv.FwiProblem(prop=prop, geoms=geoms, d_obs=d, wavelet=w, dt=dt)
    return cfg, problem, torch.full(shape, 2100.0, dtype=torch.float64)


def test_invert_3d_masks_depth_axis_like_reference(tmp_path):
    """One L-BFGS iteration with illumination, depth weighting and
    mask_top: the port's model equals the reference's, and the first
    mask_top rows of the depth axis (dim 1) are not updated."""
    out = {}
    for pkg, inv in (("ref", jinv), ("port", tinv)):
        cfg, problem, vp0 = _invert_problem(pkg, tmp_path)
        out[pkg] = (np.asarray(inv.invert(problem, vp0, cfg)), np.asarray(vp0))
    vp_ref, vp0 = out["ref"]
    vp_port = out["port"][0]
    assert np.abs(vp_port - vp0).max() > 1.0  # the iteration moved the model
    assert np.array_equal(vp_port[:, :3, :], vp0[:, :3, :])
    assert np.abs(vp_port - vp_ref).max() <= 1e-8 * np.abs(vp_ref).max()
