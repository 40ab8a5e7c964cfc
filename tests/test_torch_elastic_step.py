"""The per-step elastic engine's kernels (TPU kernels 10-11) through their
plain versions == tpufwi's, on the CPU.

Tolerances:
- (a) each plain stage (``estep_v``, ``estep_s``, ``estep_rs``,
  ``estep_rv`` on CPU tensors, with their glue) against the reference's
  Pallas kernels in interpret mode (``make_elastic_fused_step``,
  ``make_elastic_bwd_kernels``) with the reference engine's glue around
  them, one step from the same seeded random state, fp32: 1e-5 of each
  output's maximum (fp32 summation order);
- (b) the CPU engine against the reference's
  ``make_elastic_simulator_fused(interpret=True)``: the seismogram within
  1e-5 and the five material and wavelet gradients within 2e-4 of their
  maxima, the reference's own bars (tests/test_elastic_pallas.py);
- (c) the engine against the port's exact ``eager`` engine, fp64: 1e-12
  of the maximum (the same plain stages in the same order: measured 0);
- (d) ``forward_fused`` against ``__call__``, fp64: 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufwi.acquisition import Geometry as JGeometry
from tpufwi.grid import Grid as JGrid
from tpufwi.kernels.acoustic2d_pallas import strip_profiles as j_strip_profiles
from tpufwi.kernels.elastic2d_jnp import make_free_surface_image as j_image
from tpufwi.kernels.elastic2d_pallas import ElasticStripState, make_elastic_fused_step
from tpufwi.kernels.elastic2d_pallas_bwd import make_elastic_bwd_kernels
from tpufwi.propagators.boundary import RingSpec as JRingSpec
from tpufwi.propagators.elastic2d import ElasticPropagator as JProp
from tpufwi.propagators.elastic2d import make_elastic_simulator_fused as j_make_fused
from tpufwi.wavelets import ricker_np

from tpufwi_torch.acquisition import Geometry
from tpufwi_torch.adjoint_elastic_step import make_elastic_simulator_fused
from tpufwi_torch.grid import Grid
from tpufwi_torch.kernels import elastic2d_step as kst
from tpufwi_torch.kernels.acoustic2d_scanres import ring_plan, strip_depth
from tpufwi_torch.propagators.elastic2d import (
    ElasticPropagator,
    elastic_cfl_dt,
    make_elastic_simulator,
)

NAMES = ("lam", "lam2mu", "mu_xz", "buoy_x", "buoy_z", "wavelet")
# the strip of each CPML memory plane (x or z), in the port's order:
# m_sxx_x, m_sxz_z, m_sxz_x, m_szz_z (stage V), m_vx_x, m_vz_z, m_vx_z,
# m_vz_x (stage S); the duals hold R-S's four (stage S's) first
MEM_ON_X = (True, False, True, False, True, False, False, True)
COUNTERS = (kst.estep_v, kst.estep_s, kst.estep_rs, kst.estep_rv)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype)


# --------------------------------------------------- (a) stage by stage


def _stage_case(source_type, free_surface, seed=7):
    """A 32 x 40 grid, order 4, pml 6; a random model; a source on the
    surface row and a deeper one; a surface receiver line, a borehole pair
    and a coinciding receiver; the five fields, memories (on their strips),
    cotangents, duals and gradient accumulators random at physical scales."""
    nz, nx = 32, 40
    kw = dict(shape=(nz, nx), h=(10.0, 12.0), pml=6, order=4, free_surface=free_surface)
    jg, g = JGrid(**kw), Grid(**kw)
    rng = np.random.default_rng(seed)
    vp = np.clip(2300 + 150 * rng.standard_normal((nz, nx)), 2000, 2600)
    dt = elastic_cfl_dt(g.h, 2600.0, 4, safety=0.7)
    mats = tuple(np.asarray(m, np.float32) for m in JProp(
        jg, dt, 14.0, 2600.0, dtype=jnp.float32, impl="jnp").material_fields(
        *(jnp.asarray(x, jnp.float32) for x in (vp, vp / 1.8, 1000.0 + 0.3 * vp))))
    src = np.array([[0, 17], [15, 22]]) + g.pad
    rx = np.arange(3, nx - 3, 4)
    rcv = np.concatenate([np.stack([np.full(rx.size, 2), rx], 1),
                          [[12, 20], [20, 20], [2, 3]]]) + g.pad
    NZ, NX = g.padded_shape
    S = strip_depth(g)
    xs = np.zeros((NZ, NX), bool)
    xs[:, :S] = xs[:, NX - S:] = True
    zs = np.zeros((NZ, NX), bool)
    zs[:S] = zs[NZ - S:] = True

    def planes(*scales):
        return np.stack([s * rng.standard_normal((NZ, NX)) for s in scales]).astype(np.float32)

    def strip_planes(*scales, on_x):
        return planes(*scales) * np.stack([xs if x else zs for x in on_x])

    # stress per velocity ~ rho vp; the scales of a real state's planes
    zimp = float(np.max(1000.0 + 0.3 * vp) * 2600.0)
    fields = planes(1.0, 1.0, zimp, zimp, zimp)
    state = dict(fields=fields,
                 mem=strip_planes(*(zimp / 10,) * 4, *(0.1,) * 4, on_x=MEM_ON_X),
                 cot=planes(1.0, 1.0, *(1.0 / zimp,) * 3),
                 dual=strip_planes(*(1.0,) * 4, *(5e-7,) * 4, on_x=MEM_ON_X[4:] + MEM_ON_X[:4]),
                 grads=planes(1e-11, 1e-11, 1e-11, 500.0, 500.0))
    n_ring = ring_plan(g, "cpu")[0].shape[0]
    row = np.concatenate([rng.standard_normal(n_ring) * (1.0 if k < 2 else zimp)
                          for k in range(5)]).astype(np.float32)
    ybar_t = rng.standard_normal((len(rcv), 2)).astype(np.float32)
    w_t = np.float32(0.7)
    prof = tuple(np.asarray(p) for p in j_strip_profiles(jg, dt, 2600.0, 14.0))
    return jg, g, dt, mats, prof, src, rcv, state, row, ybar_t, w_t


def _x_strips(p, S):
    return np.stack([p[:, :S], p[:, p.shape[1] - S:]])


def _z_strips(p, S):
    return np.stack([p[:S], p[p.shape[0] - S:]])


def _ref_forward(jg, dt, mats, prof, src, rcv, state, w_t, source_type, record):
    """One step of the reference's per-step forward: its fused step (Pallas
    stage V, velocity image, Pallas stage S), then its scan body's sources,
    stress image, receivers and rings (elastic2d.py:261-285)."""
    S = strip_depth(jg)
    f, m = state["fields"], state["mem"]
    memx = tuple(_x_strips(m[k], S) for k in (0, 2, 4, 7))  # sxx_x, sxz_x, vx_x, vz_x
    memz = tuple(_z_strips(m[k], S) for k in (1, 3, 6, 5))  # sxz_z, szz_z, vx_z, vz_z
    step = make_elastic_fused_step(jg, dt, interpret=True)
    s = step(ElasticStripState(*(jnp.asarray(x) for x in f), memx=memx, memz=memz),
             tuple(jnp.asarray(x) for x in mats), tuple(jnp.asarray(p) for p in prof))
    si = (src[:, 0], src[:, 1])
    if source_type == "pressure":
        s = s._replace(sxx=s.sxx.at[si].add(dt * w_t), szz=s.szz.at[si].add(dt * w_t))
    else:
        s = s._replace(vz=s.vz.at[si].add(dt * mats[4][si] * w_t))
    image = j_image(jg)
    if image is not None:
        szz, sxz = image.s(s.szz, s.sxz)
        s = s._replace(szz=szz, sxz=sxz)
    ri = (rcv[:, 0], rcv[:, 1])
    rec = (jnp.stack([s.vz[ri], s.vx[ri]], -1) if record == "v"
           else -(s.sxx[ri] + s.szz[ri]) / 2.0)
    rings = JRingSpec.build(jg)
    fields = (s.vx, s.vz, s.sxx, s.szz, s.sxz)
    row = jnp.concatenate([jnp.concatenate(rings.extract(x)) for x in fields])
    mem = (s.memx[0], s.memz[0], s.memx[1], s.memz[1], s.memx[2], s.memz[3], s.memz[2],
           s.memx[3])
    return [np.asarray(x) for x in fields], [np.asarray(x) for x in mem], np.asarray(rec), \
        np.asarray(row)


def _ref_reverse(jg, dt, mats, prof, src, rcv, state, row, ybar_t, w_t, source_type, record):
    """One reverse step of the reference's per-step engine: its scan body's
    receiver scatter, stress-image transpose and source-point cotangent,
    the Pallas R-S kernel, the re-imaging of sigma_t and the velocity-image
    transpose, the Pallas R-V kernel and the re-imaging of v
    (elastic2d.py:333-398). Returns the state after R-S with its glue, the
    state after R-V, and the source-point cotangent."""
    S = strip_depth(jg)
    call_rs, call_rv = make_elastic_bwd_kernels(jg, dt, source_type, interpret=True)
    image = j_image(jg)
    rings = JRingSpec.build(jg)
    dims = [tuple(sl.stop - sl.start for sl in s_) for s_ in rings.slices]
    n = sum(int(np.prod(d)) for d in dims)
    slabs = []
    for k in range(5):
        part, o = row[k * n:(k + 1) * n], 0
        for d in dims:
            slabs.append(jnp.asarray(part[o:o + int(np.prod(d))].reshape(d)))
            o += int(np.prod(d))
    vx, vz, sxx, szz, sxz = (jnp.asarray(x) for x in state["fields"])
    vxb, vzb, sxxb, szzb, sxzb = (jnp.asarray(x) for x in state["cot"])
    d = state["dual"]
    mS = (_x_strips(d[0], S), _z_strips(d[1], S), _z_strips(d[2], S), _x_strips(d[3], S))
    mV = (_x_strips(d[4], S), _z_strips(d[5], S), _x_strips(d[6], S), _z_strips(d[7], S))
    g = tuple(jnp.asarray(x) for x in state["grads"])
    lam, l2m, muxz, bxm, bzm = (jnp.asarray(x) for x in mats)
    az, bzp, ax, bxp = (jnp.asarray(p) for p in prof)
    si, ri = (src[:, 0], src[:, 1]), (rcv[:, 0], rcv[:, 1])
    sz, sx = (jnp.asarray(src[:, k].astype(np.int32)) for k in (0, 1))
    bsrc = bzm[si]
    w1 = jnp.asarray([w_t], jnp.float32)
    if record == "v":
        vzb = vzb.at[ri].add(ybar_t[:, 0])
        vxb = vxb.at[ri].add(ybar_t[:, 1])
    else:
        sxxb = sxxb.at[ri].add(-0.5 * ybar_t[:, 0])
        szzb = szzb.at[ri].add(-0.5 * ybar_t[:, 0])
    if image is not None:
        szzb, sxzb = image.s_t(szzb, sxzb)
    srcrow = vzb[si] if source_type == "force_z" else sxxb[si] + szzb[si]
    (sxx, szz, sxz, vxb, vzb, *mS, g0, g1, g2) = call_rs(
        vx, vz, sxx, szz, sxz, *slabs[8:12], *slabs[12:16], *slabs[16:20], w1, lam, l2m,
        muxz, sxxb, szzb, sxzb, vxb, vzb, *mS, *g[:3], az, bzp, ax, bxp, sz, sx, bsrc)
    if image is not None:
        szz, sxz = image.s(szz, sxz)
        vxb, vzb = image.v_t(vxb, vzb)
    after_rs = dict(stress=(sxx, szz, sxz), cot=(vxb, vzb, sxxb, szzb, sxzb), dual=mS,
                    grads=(g0, g1, g2))
    (vx, vz, sxxb, szzb, sxzb, *mV, g3, g4) = call_rv(
        sxx, szz, sxz, vx, vz, *slabs[:4], *slabs[4:8], bxm, bzm, vxb, vzb, sxxb, szzb, sxzb,
        *mV, *g[3:], az, bzp, ax, bxp, w1, sz, sx, bsrc)
    if image is not None:
        vx, vz = image.v(vx, vz)
    after_rv = dict(fields=(vx, vz, sxx, szz, sxz), cot=(vxb, vzb, sxxb, szzb, sxzb), dual=mV,
                    grads=(g3, g4))
    return after_rs, after_rv, np.asarray(srcrow)


def _strip_part(plane, on_x, S):
    return _x_strips(plane, S) if on_x else _z_strips(plane, S)


@pytest.mark.parametrize("source_type,record,free_surface", [
    ("pressure", "p", False), ("force_z", "v", True),
])
def test_plain_stages_match_reference_kernels(source_type, record, free_surface):
    jg, g, dt, mats, prof, src, rcv, st, row, ybar_t, w_t = _stage_case(source_type,
                                                                        free_surface)
    S = strip_depth(g)
    mats_t = tuple(_t(m) for m in mats)
    prof_t = tuple(_t(p) for p in prof)
    si, ri = _t(src, torch.int64), _t(rcv, torch.int64)
    launches = [k.launches for k in COUNTERS]

    # forward: estep_v, estep_s against stage V, stage S and their glue
    fs = kst.zero_elastic_step_state(g, device="cpu")
    kst.inner(g, fs.fields).copy_(_t(st["fields"]))
    fs.mem.copy_(_t(st["mem"]))
    fields, mem, rec, ring = _ref_forward(jg, dt, mats, prof, src, rcv, st, w_t, source_type,
                                          record)
    wav = _t([w_t])
    kst.estep_v(g, dt, mats_t, prof_t, fs)
    # vx (vz: after the force source lands, below)
    assert _rel(kst.inner(g, fs.fields)[0].numpy(), fields[0]) < 1e-5
    on_x = MEM_ON_X
    for k in range(4):
        assert _rel(_strip_part(fs.mem[k].numpy(), on_x[k], S), mem[k]) < 1e-5, ("memV", k)
    seis = torch.zeros((1, len(rcv), 2) if record == "v" else (1, len(rcv)))
    ring_row = torch.zeros(ring.shape[0])
    kst.estep_s(g, dt, mats_t, prof_t, fs, wav, 0, si, ri, seis, ring_row, source_type, record)
    got = kst.inner(g, fs.fields).numpy()
    for k in range(5):
        assert _rel(got[k], fields[k]) < 1e-5, ("S", k)
    for k in range(4, 8):
        assert _rel(_strip_part(fs.mem[k].numpy(), on_x[k], S), mem[k]) < 1e-5, ("memS", k)
    assert _rel(seis[0].numpy(), rec) < 1e-5
    assert _rel(ring_row.numpy(), ring) < 1e-5

    # reverse: estep_rs, estep_rv against R-S, R-V and their glue
    rs = kst.zero_elastic_reverse_state(g, device="cpu")
    kst.inner(g, rs.fields).copy_(_t(st["fields"]))
    for name in ("cot", "dual", "grads"):
        getattr(rs, name).copy_(_t(st[name]))
    after_rs, after_rv, srcrow_ref = _ref_reverse(jg, dt, mats, prof, src, rcv, st, row,
                                                  ybar_t, w_t, source_type, record)
    ybar = _t(ybar_t[None] if record == "v" else ybar_t[None, :, 0])
    srcrow = torch.zeros((1, len(src)))
    kst.estep_rs(g, dt, mats_t, prof_t, rs, wav, ybar, 0, si, ri, srcrow, _t(row), source_type,
                 record)
    got = kst.inner(g, rs.fields).numpy()
    for k in range(3):  # the reference's R-S leaves v as it was (vz: see the module)
        assert _rel(got[2 + k], after_rs["stress"][k]) < 1e-5, ("R-S", k)
    for k in range(5):
        assert _rel(rs.cot[k].numpy(), after_rs["cot"][k]) < 1e-5, ("R-S cot", k)
    for k in range(4):
        assert _rel(_strip_part(rs.dual[k].numpy(), on_x[4 + k], S),
                    after_rs["dual"][k]) < 1e-5, ("R-S dual", k)
    for k in range(3):
        assert _rel(rs.grads[k].numpy(), after_rs["grads"][k]) < 1e-5, ("R-S grad", k)
    assert _rel(srcrow[0].numpy(), srcrow_ref) < 1e-5
    kst.estep_rv(g, dt, mats_t, prof_t, rs, _t(row))
    got = kst.inner(g, rs.fields).numpy()
    for k in range(5):
        assert _rel(got[k], after_rv["fields"][k]) < 1e-5, ("R-V", k)
        assert _rel(rs.cot[k].numpy(), after_rv["cot"][k]) < 1e-5, ("R-V cot", k)
    for k in range(4):
        assert _rel(_strip_part(rs.dual[4 + k].numpy(), on_x[k], S),
                    after_rv["dual"][k]) < 1e-5, ("R-V dual", k)
    for k in range(2):
        assert _rel(rs.grads[3 + k].numpy(), after_rv["grads"][k]) < 1e-5, ("R-V grad", k)
    # the plain versions launch nothing
    assert [k.launches for k in COUNTERS] == launches


# ------------------------------------------------ (b) the engine, fp32


def _engine_case(nt, free_surface=False):
    """tests/test_elastic_pallas.py's gradient problem: a random model, two
    sources, a receiver line at depth 5."""
    nz, nx, f0 = 40, 50, 12.0
    rng = np.random.default_rng(3)
    vp = np.clip(2300 + 150 * rng.standard_normal((nz, nx)), 2000, 2600)
    kw = dict(shape=(nz, nx), h=(10.0, 10.0), pml=8, order=4, free_surface=free_surface)
    dt = elastic_cfl_dt(kw["h"], float(vp.max()), 4, safety=0.7)
    src = np.array([[nz // 2 - 6, nx // 2], [nz // 2, nx // 2 - 8]])
    rx = np.arange(5, nx - 5, 3)
    rcv = np.stack([np.full_like(rx, 5), rx], 1)
    model = (vp, vp / 1.8, 1000.0 + 0.3 * vp)
    return kw, dt, f0, float(vp.max()), model, ricker_np(f0, dt, nt, t0=0.04), src, rcv


def test_engine_matches_reference_fused_engine():
    """Against the reference's per-step engine in interpret mode (its
    Pallas kernels 10-11), pressure source, v record."""
    kw, dt, f0, c_max, model, w, src, rcv = _engine_case(nt=40)
    w = w.astype(np.float32)
    jg, g = JGrid(**kw), Grid(**kw)
    mats = tuple(np.asarray(m) for m in JProp(jg, dt, f0, c_max, dtype=jnp.float32,
                                              impl="jnp").material_fields(
        *(jnp.asarray(x, jnp.float32) for x in model)))
    geom = JGeometry.from_physical(jg, src, rcv)
    sim_j = j_make_fused(jg, dt, f0, c_max, source_type="pressure", record="v", interpret=True)
    sim_t = make_elastic_simulator_fused(g, dt, f0, c_max, source_type="pressure", record="v")
    d_obs = 0.5 * np.asarray(sim_j(*(jnp.asarray(m) for m in mats), jnp.asarray(w),
                                   geom.src_idx, geom.rcv_idx))
    src_t, rcv_t = (torch.as_tensor(np.array(i)) for i in (geom.src_idx, geom.rcv_idx))

    args_j = tuple(jnp.asarray(m) for m in mats) + (jnp.asarray(w),)
    seis_j, pull = jax.vjp(lambda *a: sim_j(*a[:5], a[5], geom.src_idx, geom.rcv_idx), *args_j)
    ga = pull(seis_j - d_obs)
    args = [_t(a).requires_grad_(True) for a in (*mats, w)]
    seis_t = sim_t(*args, src_t, rcv_t)
    J = 0.5 * ((seis_t - _t(d_obs)) ** 2).sum()
    gb = torch.autograd.grad(J, args)
    assert _rel(seis_t.detach().numpy(), seis_j) < 1e-5
    for name, a, b in zip(NAMES, ga, gb):
        assert _rel(b.numpy(), a) < 2e-4, f"{name} gradient {_rel(b.numpy(), a):.3e}"


# ------------------------------------------ (c) the engine, fp64 exactness


@pytest.mark.parametrize("source_type,record,free_surface", [
    ("pressure", "v", False), ("pressure", "p", False), ("force_z", "v", False),
    ("force_z", "v", True),
])
def test_engine_matches_eager_fp64(source_type, record, free_surface):
    kw, dt, f0, c_max, model, w, src, rcv = _engine_case(nt=70, free_surface=free_surface)
    if free_surface:  # a source and receivers on the surface row
        src, rcv = np.array([[0, 25], [14, 17]]), np.concatenate([rcv, [[0, 30], [0, 30]]])
    g = Grid(**kw)
    prop = ElasticPropagator(g, dt, f0, c_max, dtype=torch.float64, source_type=source_type,
                             record=record, device="cpu")
    geom = Geometry.from_physical(g, src, rcv, device="cpu")
    mats = tuple(m.detach() for m in prop.material_fields(*(_t(x, torch.float64)
                                                            for x in model)))
    wt = _t(w, torch.float64)
    launches = [k.launches for k in COUNTERS]
    out = []
    for sim in (make_elastic_simulator(g, dt, f0, c_max, source_type, record),
                make_elastic_simulator_fused(g, dt, f0, c_max, source_type, record)):
        args = [x.clone().requires_grad_(True) for x in (*mats, wt)]
        seis = sim(*args, geom.src_idx, geom.rcv_idx)
        grads = torch.autograd.grad(0.5 * (seis**2).sum(), args)
        out.append((seis.detach().numpy(), [x.numpy() for x in grads]))
    (seis_e, g_e), (seis_s, g_s) = out
    assert _rel(seis_s, seis_e) <= 1e-12
    for name, a, b in zip(NAMES, g_s, g_e):
        assert _rel(a, b) <= 1e-12, name
    assert [k.launches for k in COUNTERS] == launches


# --------------------------------------------- (d) forward_fused, engine


def test_forward_fused_matches_call():
    kw, dt, f0, c_max, model, w, src, rcv = _engine_case(nt=80, free_surface=True)
    g = Grid(**kw)
    geom = Geometry.from_physical(g, src, rcv, device="cpu")
    m = tuple(_t(x, torch.float64) for x in model)
    prop = ElasticPropagator(g, dt, f0, c_max, dtype=torch.float64, source_type="force_z",
                             device="cpu")
    with torch.no_grad():
        ref = prop(*m, geom, _t(w, torch.float64)).numpy()
    got = prop.forward_fused(*m, geom, _t(w, torch.float64))
    assert not got.requires_grad and tuple(got.shape) == ref.shape
    assert _rel(got.numpy(), ref) <= 1e-12
    with pytest.raises(ValueError, match="needs a CUDA device"):
        ElasticPropagator(g, dt, f0, c_max, impl="cuda_estep", device="cpu")
