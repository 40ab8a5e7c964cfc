"""tpufwi_torch elastic P-SV step twin, CPU engine and propagator ==
tpufwi's, on the CPU.

Tolerances:
- ``D1_STAGGERED_COEFFS`` and ``elastic_cfl_dt`` bit-equal; ``material_fields``
  within 1e-12 (fp64);
- the step twin against the reference's jnp step, fp64: 1e-12 relative per
  field and per step (pressure and force_z sources, v and p records, free
  surface on and off);
- the twin against the independent numpy oracle: relative RMS < 1e-9 (as
  tests/test_elastic.py and test_elastic_free_surface.py);
- the CPU engine ``eager`` against the reference's jnp engine, fp64: J and
  the (vp, vs, rho) gradients within 1e-10 on the interior shrunk by
  radius + 1 (the elastic gradient's exact region);
- the custom backward against plain autograd through the twin, 1e-10;
- the adjoint dot-product <J dm, dy> = <dm, J^T dy> of the linearized
  modelling, fp64, dm supported on the exact region: 1e-11 (measured
  1.7e-15 on this CPU).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufwi.acquisition import Geometry as JGeometry
from tpufwi.grid import D1_STAGGERED_COEFFS as J_COEFFS
from tpufwi.grid import Grid as JGrid
from tpufwi.kernels import elastic2d_jnp as jstep
from tpufwi.kernels.oracle_numpy import oracle_elastic_2d
from tpufwi.propagators.elastic2d import ElasticPropagator as JProp
from tpufwi.propagators.elastic2d import elastic_cfl_dt as j_cfl
from tpufwi.wavelets import ricker_np

from tpufwi_torch.acquisition import Geometry
from tpufwi_torch.cpml import build_profiles
from tpufwi_torch.grid import D1_STAGGERED_COEFFS, Grid
from tpufwi_torch.kernels import elastic2d_eager as tstep
from tpufwi_torch.propagators.boundary import RingSpec
from tpufwi_torch.propagators.elastic2d import (
    ElasticPropagator,
    elastic_cfl_dt,
    make_elastic_simulator,
)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _setup(order=4, nz=40, nx=50, pml=8, nt=160, f0=12.0, free_surface=False, src_z=None,
           rcv_z=5):
    """tests/test_elastic.py's problem: a two-layer model."""
    vp = np.full((nz, nx), 2200.0)
    vp[nz // 2:] = 2600.0
    vs = vp / 1.8
    rho = 1000.0 + 0.3 * vp
    kw = dict(shape=(nz, nx), h=(10.0, 10.0), pml=pml, order=order, free_surface=free_surface)
    dt = elastic_cfl_dt(kw["h"], float(vp.max()), order, safety=0.7)
    w = ricker_np(f0, dt, nt)
    src = np.array([[nz // 2 - 6 if src_z is None else src_z, nx // 2]])
    rx = np.arange(5, nx - 5, 3)
    rcv = np.stack([np.full_like(rx, rcv_z), rx], 1)
    return kw, vp, vs, rho, dt, w, src, rcv, f0


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def test_tables_and_cfl_match_reference():
    for order, c in J_COEFFS.items():
        assert D1_STAGGERED_COEFFS[order].dtype == np.float64
        assert np.array_equal(D1_STAGGERED_COEFFS[order], c)
        for h in (10.0, (10.0, 12.5)):
            for safety in (0.7, 1.0):
                assert elastic_cfl_dt(h, 3100.0, order, safety) == j_cfl(h, 3100.0, order, safety)


def test_material_fields_match_reference():
    kw, vp, vs, rho, dt, *_ = _setup()
    rng = np.random.default_rng(1)
    vp = vp + 50 * rng.standard_normal(vp.shape)
    jp = JProp(JGrid(**kw), dt, 12.0, 2700.0, dtype=jnp.float64, impl="jnp")
    tp = ElasticPropagator(Grid(**kw), dt, 12.0, 2700.0, dtype=torch.float64, device="cpu")
    ref = jp.material_fields(jnp.asarray(vp), jnp.asarray(vs), jnp.asarray(rho))
    got = tp.material_fields(_t(vp), _t(vs), _t(rho))
    for a, b in zip(got, ref):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-12 * np.abs(b).max()


@pytest.mark.parametrize("source_type,record,free_surface", [
    ("pressure", "v", False), ("force_z", "p", False),
    ("pressure", "p", True), ("force_z", "v", True),
])
def test_step_twin_matches_jnp_step(source_type, record, free_surface):
    kw, vp, vs, rho, dt, w, _, rcv, f0 = _setup(free_surface=free_surface)
    jg, g = JGrid(**kw), Grid(**kw)
    mats_j = JProp(jg, dt, f0, 2600.0, dtype=jnp.float64, impl="jnp").material_fields(
        jnp.asarray(vp), jnp.asarray(vs), jnp.asarray(rho))
    # two sources, one on the surface row (in the boundary ring)
    src = np.array([[0, 20], [14, 31]]) + g.pad
    rcv = rcv + g.pad
    profs = build_profiles(g, dt, 2600.0, f0, dtype=np.float64)
    jparams = jstep.ElasticParams(*mats_j, az=profs[0][0], bz=profs[0][1], ax=profs[1][0],
                                  bx=profs[1][1], src_idx=jnp.asarray(src),
                                  rcv_idx=jnp.asarray(rcv))
    tparams = tstep.ElasticParams(*(_t(m) for m in mats_j), az=_t(profs[0][0]),
                                  bz=_t(profs[0][1]), ax=_t(profs[1][0]), bx=_t(profs[1][1]),
                                  src_idx=torch.as_tensor(src), rcv_idx=torch.as_tensor(rcv))
    jfn = jax.jit(jstep.make_elastic_step(jg, dt, source_type, record))
    tfn = tstep.make_elastic_step(g, dt, source_type, record)
    js = jstep.zero_elastic_state(g.padded_shape, jnp.float64)
    ts = tstep.zero_elastic_state(g.padded_shape, torch.float64)
    for t in range(60):
        js, jrec = jfn(js, jparams, w[t])
        ts, trec = tfn(ts, tparams, float(w[t]))
        for name in tstep.FIELDS:
            a, b = getattr(ts, name).numpy(), np.asarray(getattr(js, name))
            assert np.abs(a - b).max() <= 1e-12 * max(np.abs(b).max(), 1e-300), (t, name)
        for a, b in zip(ts.mem, js.mem):
            assert np.abs(a.numpy() - np.asarray(b)).max() <= 1e-12 * max(
                np.abs(np.asarray(b)).max(), 1e-300)
        jrec = np.asarray(jrec)
        assert np.abs(trec.numpy() - jrec).max() <= 1e-12 * max(np.abs(jrec).max(), 1e-300)


def _port_seis(kw, vp, vs, rho, dt, w, src, rcv, f0, source_type, record="v"):
    g = Grid(**kw)
    prop = ElasticPropagator(g, dt, f0, float(vp.max()), dtype=torch.float64,
                             source_type=source_type, record=record, device="cpu")
    geom = Geometry.from_physical(g, src, rcv, device="cpu")
    with torch.no_grad():
        return prop(_t(vp), _t(vs), _t(rho), geom, _t(w)).numpy()


@pytest.mark.parametrize("source_type,free_surface", [
    ("pressure", False), ("force_z", False), ("pressure", True), ("force_z", True),
])
def test_twin_matches_oracle(source_type, free_surface):
    if free_surface:  # tests/test_elastic_free_surface.py's problem
        args = _setup(nz=48, nt=200, free_surface=True, src_z=6, rcv_z=12)
    else:
        args = _setup()
    kw, vp, vs, rho, dt, w, src, rcv, f0 = args
    seis_o, _ = oracle_elastic_2d(vp, vs, rho, JGrid(**kw), dt, w, src, rcv, f0,
                                  source_type=source_type)
    seis = _port_seis(*args, source_type)
    rms = np.sqrt(np.mean((seis - seis_o) ** 2)) / np.sqrt(np.mean(seis_o**2))
    assert rms < 1e-9, f"elastic twin vs oracle relative RMS {rms:.3e}"


def _losses(args, source_type, record, free_surface=False):
    """(J, grads) of 0.5 |seis(m) - d|^2 at m = (vp, vs, rho) in the
    reference's jnp engine and the port's CPU engine, fp64; d from vp 1.02x."""
    kw, vp, vs, rho, dt, w, src, rcv, f0 = args
    kw = dict(kw, free_surface=free_surface)
    jg, g = JGrid(**kw), Grid(**kw)
    jp = JProp(jg, dt, f0, 2700.0, dtype=jnp.float64, source_type=source_type, record=record,
               impl="jnp")
    jgeom = JGeometry.from_physical(jg, src, rcv)
    d = jp(jnp.asarray(vp * 1.02), jnp.asarray(vs), jnp.asarray(rho), jgeom, jnp.asarray(w))
    J_ref, g_ref = jax.value_and_grad(
        lambda m: 0.5 * jnp.sum((jp(*m, jgeom, jnp.asarray(w)) - d) ** 2))(
        (jnp.asarray(vp), jnp.asarray(vs), jnp.asarray(rho)))
    tp = ElasticPropagator(g, dt, f0, 2700.0, dtype=torch.float64, source_type=source_type,
                           record=record, device="cpu")
    geom = Geometry.from_physical(g, src, rcv, device="cpu")
    m = [_t(x).requires_grad_(True) for x in (vp, vs, rho)]
    J = 0.5 * ((tp(*m, geom, _t(w)) - _t(np.asarray(d))) ** 2).sum()
    J.backward()
    return (float(J), [x.grad.numpy() for x in m]), (float(J_ref), [np.asarray(x) for x in g_ref])


def _exact_region(grid_shape, radius):
    rr = radius + 1
    mask = np.zeros(grid_shape)
    mask[rr:-rr, rr:-rr] = 1.0
    return mask


@pytest.mark.parametrize("source_type,record,free_surface", [
    ("force_z", "v", False), ("pressure", "p", True),
])
def test_cpu_engine_matches_reference(source_type, record, free_surface):
    args = _setup(nt=110)
    (J, g), (J_ref, g_ref) = _losses(args, source_type, record, free_surface)
    assert abs(J - J_ref) <= 1e-10 * J_ref
    mask = _exact_region(args[0]["shape"], Grid(**args[0]).radius)
    for name, a, b in zip(("vp", "vs", "rho"), g, g_ref):
        err = np.abs((a - b) * mask).max() / np.abs(b * mask).max()
        assert err < 1e-10, f"{name} gradient rel err {err:.3e}"


def test_custom_backward_matches_full_autograd():
    """tests/test_elastic.py::test_elastic_gradient_matches_full_ad on the
    port: the boundary-saving backward against autograd through the twin."""
    kw, vp, vs, rho, dt, w, src, rcv, f0 = _setup(nt=110)
    g = Grid(**kw)
    prop = ElasticPropagator(g, dt, f0, float(vp.max()), dtype=torch.float64, device="cpu")
    sim_ad = make_elastic_simulator(g, dt, f0, float(vp.max()), use_custom_vjp=False)
    geom = Geometry.from_physical(g, src, rcv, device="cpu")
    wt = _t(w)
    with torch.no_grad():
        d = prop(_t(vp * 1.02), _t(vs), _t(rho), geom, wt)

    def grads(fwd):
        m = [_t(x).requires_grad_(True) for x in (vp, vs, rho)]
        J = 0.5 * ((fwd(m) - d) ** 2).sum()
        J.backward()
        return float(J), [x.grad.numpy() for x in m]

    J1, g1 = grads(lambda m: prop(*m, geom, wt))
    J2, g2 = grads(lambda m: sim_ad(*prop.material_fields(*m), wt, geom.src_idx, geom.rcv_idx))
    assert abs(J1 - J2) < 1e-10 * abs(J1)
    mask = _exact_region(g.shape, g.radius)
    for name, a, b in zip(("vp", "vs", "rho"), g1, g2):
        err = np.abs((a - b) * mask).max() / np.abs(b * mask).max()
        assert err < 1e-10, f"{name} grad: custom vs full autograd rel err {err:.3e}"


def test_adjoint_dot_product():
    """<J dm, dy> == <dm, J^T dy> for the linearized map from the five
    material fields to the seismogram (J dm by forward-mode AD through the
    twin, J^T dy by the boundary-saving backward), dm on the exact region."""
    kw, vp, vs, rho, dt, w, src, rcv, f0 = _setup(nt=90)
    g = Grid(**kw)
    prop = ElasticPropagator(g, dt, f0, float(vp.max()), dtype=torch.float64,
                             source_type="force_z", device="cpu")
    sim = make_elastic_simulator(g, dt, f0, float(vp.max()), source_type="force_z")
    sim_ad = make_elastic_simulator(g, dt, f0, float(vp.max()), source_type="force_z",
                                    use_custom_vjp=False)
    geom = Geometry.from_physical(g, src, rcv, device="cpu")
    wt = _t(w)
    mats = tuple(m.detach() for m in prop.material_fields(_t(vp), _t(vs), _t(rho)))
    rng = np.random.default_rng(5)
    valid = np.zeros(g.padded_shape)
    r = g.pad + g.radius + 1
    valid[r:-r, r:-r] = 1.0
    dm = tuple(_t(rng.standard_normal(g.padded_shape) * valid) * m.abs().max() * 1e-3
               for m in mats)
    _, Jdm = torch.func.jvp(lambda *m: sim_ad(*m, wt, geom.src_idx, geom.rcv_idx), mats, dm)
    dy = _t(rng.standard_normal(tuple(Jdm.shape)))
    m_req = [m.clone().requires_grad_(True) for m in mats]
    seis = sim(*m_req, wt, geom.src_idx, geom.rcv_idx)
    JTdy = torch.autograd.grad(seis, m_req, dy)
    lhs = float((Jdm * dy).sum())
    rhs = sum(float((a * b).sum()) for a, b in zip(dm, JTdy))
    assert abs(lhs - rhs) <= 1e-11 * abs(lhs), (lhs, rhs)


def test_forward_snapshots_consistent():
    nz, nx, f0, nt = 40, 50, 12.0, 120
    vp = np.full((nz, nx), 2200.0)
    g = Grid(shape=(nz, nx), h=(10.0, 10.0), pml=8, order=4)
    dt = elastic_cfl_dt(g.h, 2200.0, 4, safety=0.6)
    geom = Geometry.from_physical(g, np.array([[20, 25]]), np.array([[10, 10], [10, 40]]),
                                  device="cpu")
    prop = ElasticPropagator(g, dt, f0, 2200.0, dtype=torch.float64, device="cpu")
    args = (_t(vp), _t(vp / 1.8), _t(np.full_like(vp, 1800.0)), geom, _t(ricker_np(f0, dt, nt)))
    with torch.no_grad():
        seis0 = prop(*args)
    seis1, snaps = prop.forward_snapshots(*args, stride=10, field="p")
    assert float((seis0 - seis1).abs().max()) == 0.0
    assert tuple(snaps.shape) == (nt // 10, nz, nx) and float(snaps[-1].abs().max()) > 0.0


# ------------------------------------------------------------ resolution


def _prop(device="cpu", dtype=torch.float32, impl="auto", grid=None):
    grid = grid or Grid(shape=(40, 50), h=(10.0, 10.0), pml=8, order=8)
    dt = elastic_cfl_dt(grid.h[:2], 3000.0, grid.order, safety=0.7)
    return ElasticPropagator(grid, dt, 12.0, 3000.0, dtype=dtype, impl=impl, device=device)


def test_auto_is_eager_on_cpu():
    prop = _prop()
    assert prop.resolve_impl(nt=500) == "eager"
    assert prop.resolve_note == "auto: CPU tensor -> exact eager engine"
    assert prop.fix_impl_for(nt=500) == "eager" and prop.impl == "eager"


def test_unported_or_misplaced_engines_raise():
    with pytest.raises(ValueError, match="needs a CUDA device"):
        _prop(impl="cuda_escan")
    with pytest.raises(ValueError, match="fp32 only"):
        _prop(device="cuda", dtype=torch.float64).resolve_impl(nt=100)
    with pytest.raises(ValueError, match="fp32 only"):
        _prop(device="cuda", dtype=torch.float64, impl="cuda_escan")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        _prop(impl="cuda_estep")
    assert _prop(device="cuda", impl="cuda_estep").resolve_impl(nt=100) == "cuda_estep"
    grid3 = Grid(shape=(24, 30, 40), h=(10.0,) * 3, pml=8, order=8)
    for device in ("cpu", "cuda"):
        with pytest.raises(NotImplementedError, match="3D grid"):
            _prop(device=device, grid=grid3).resolve_impl(nt=100)
    with pytest.raises(ValueError, match="fp32 only"):
        _prop(device="cuda", dtype=torch.float64).forward_fused(None, None, None, None, None)
    with pytest.raises(ValueError, match="unknown elastic impl"):
        _prop(impl="pallas_scansnap")  # an acoustic engine of the reference


def test_auto_raises_when_ring_tape_over_budget(monkeypatch):
    """'auto' on the card sizes one shot's five-field ring tape against the
    card's budget (two tapes in 80% of its memory) and raises past it: the
    reference's elastic 'auto' has no such guard."""
    gib = 2**30
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(total_memory=80 * gib))
    prop = _prop(device="cuda")
    assert prop.tape_budget_bytes() == 32 * gib
    per_step = prop.tape_bytes(1)
    assert per_step == 5 * RingSpec.build(prop.grid).tape_bytes_per_step(4)
    nt_fit = prop.tape_budget_bytes() // per_step
    assert prop.resolve_impl(nt=int(nt_fit)) == "cuda_escan"
    assert "whole-scan" in prop.resolve_note
    with pytest.raises(ValueError, match="exceeds the 32.0 GiB budget"):
        prop.resolve_impl(nt=int(nt_fit) + 1)
    # the main path's survey: 351 x 1701 at 10 m, order 8, nt 4885 -> 1.49 GiB
    big = Grid(shape=(351, 1701), h=(10.0, 10.0), pml=20, order=8)
    big_prop = ElasticPropagator(big, elastic_cfl_dt(big.h, 4700.0, 8, 0.7), 12.0, 4700.0,
                                 device="cuda")
    assert big_prop.fix_impl_for(nt=4885) == "cuda_escan"
    assert abs(big_prop.tape_bytes(4885) / gib - 1.49) < 0.01
