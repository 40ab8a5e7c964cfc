"""tpufwi_torch whole-scan engines == tpufwi's, on the CPU.

The port's ``simulate`` (plain versions of the kernels) against the
reference's ``make_simulator_pallas_scanres`` run in interpret mode, as
tests/test_scanres.py runs it, and against the jnp boundary-saving engine.
Tolerances are the reference suite's: seismogram 1e-5 of its max (fp32
summation order), J and wavelet gradient 1e-4 (GTOL). Snapshot mode: the
masked model gradient 1e-4 against the reference's snapshot engine (same
bf16 tape) and SNAP_GTOL = 5e-3 against the jnp engine (bf16 tape
rounding). Rings mode: GTOL against both the reference's rings engine and
the jnp engine (no tape rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufwi.acquisition import Geometry as JGeometry
from tpufwi.adjoint import make_simulator as j_make_simulator
from tpufwi.adjoint_pallas_scanres import make_simulator_pallas_scanres
from tpufwi.grid import Grid as JGrid
from tpufwi.propagators.boundary import RingSpec as JRingSpec
from tpufwi.wavelets import ricker_np

from tpufwi_torch.adjoint_scanres import make_simulator_scanres
from tpufwi_torch.grid import Grid
from tpufwi_torch.kernels import acoustic2d_scanres as ks
from tpufwi_torch.propagators.boundary import RingSpec

GTOL = 1e-4
SNAP_GTOL = 5e-3


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _setup(nt, nsrc=1, free_surface=False):
    kw = dict(shape=(48, 72), h=(10.0, 10.0), pml=10, order=8, free_surface=free_surface)
    grid = Grid(**kw)
    c_max, f0 = 2500.0, 14.0
    dt = grid.cfl_dt(c_max, safety=0.7)
    rng = np.random.default_rng(0)
    vp = np.clip(2000 + 200 * rng.standard_normal(grid.shape), 1700, 2500)
    c2 = ((np.pad(vp, grid.pad, mode="edge") * dt) ** 2).astype(np.float32)
    w = ricker_np(f0, dt, nt).astype(np.float32)
    src = np.stack([np.full(nsrc, 24), np.linspace(20, 52, nsrc).astype(np.int64)], 1)
    rcv = np.stack([np.full(20, 5), np.arange(5, 65, 3)], 1)
    return kw, dt, f0, c_max, c2, w, src + grid.pad, rcv + grid.pad


def _jax_runs(kw, dt, f0, c_max, c2, w, src_p, rcv_p, mode="snap"):
    """(d_obs, {engine: (seis, J, g, gw)}) of the reference's jnp engine and
    its whole-scan engine in ``mode``."""
    jg = JGrid(**kw)
    geom = JGeometry(src_idx=jnp.asarray(src_p), rcv_idx=jnp.asarray(rcv_p))
    sims = {
        "jnp": j_make_simulator(jg, dt, f0, c_max, dtype=jnp.float32),
        mode: make_simulator_pallas_scanres(jg, dt, f0, c_max, rcv_rows=16,
                                            interpret=True, tape_mode=mode),
    }
    d_obs = sims["jnp"](jnp.asarray(c2), jnp.asarray(w), geom.src_idx, geom.rcv_idx)
    out = {}
    for name, sim in sims.items():
        def loss(c, w_, sim=sim):
            r = sim(c, w_, geom.src_idx, geom.rcv_idx) - d_obs
            return 0.5 * jnp.sum(r * r)

        J, (g, gw) = jax.value_and_grad(loss, argnums=(0, 1))(
            jnp.asarray(c2) * 1.01, jnp.asarray(w))
        seis = sim(jnp.asarray(c2), jnp.asarray(w), geom.src_idx, geom.rcv_idx)
        out[name] = (np.asarray(seis), float(J), np.asarray(g), np.asarray(gw))
    seis, J, g, gw = out["jnp"]
    out["jnp"] = (seis, J, np.asarray(JRingSpec.build(jg).mask_valid(jnp.asarray(g))), gw)
    return np.asarray(d_obs), out


@pytest.mark.parametrize("nsrc,free_surface", [(1, False), (3, True)])
def test_simulate_matches_reference_snapshot_engine(nsrc, free_surface):
    kw, dt, f0, c_max, c2, w, src_p, rcv_p = _setup(96, nsrc, free_surface)
    d_obs, ref = _jax_runs(kw, dt, f0, c_max, c2, w, src_p, rcv_p)

    sim = make_simulator_scanres(Grid(**kw), dt, f0, c_max, tape_mode="snap")
    si, ri = torch.tensor(src_p), torch.tensor(rcv_p)
    before = (ks.scanres_forward.launches, ks.scanres_reverse_snap.launches)
    with torch.no_grad():
        seis = sim(torch.tensor(c2), torch.tensor(w), si, ri).numpy()
    c = (torch.tensor(c2) * 1.01).requires_grad_()
    wt = torch.tensor(w).requires_grad_()
    r = sim(c, wt, si, ri) - torch.tensor(d_obs)
    J = 0.5 * torch.sum(r * r)
    g, gw = torch.autograd.grad(J, (c, wt))
    g, gw, J = g.numpy(), gw.numpy(), float(J.detach())
    # the CPU path runs the plain versions and launches no kernel
    assert (ks.scanres_forward.launches, ks.scanres_reverse_snap.launches) == before

    s_snap, J_snap, g_snap, gw_snap = ref["snap"]
    _, J_jnp, g_jnp, gw_jnp = ref["jnp"]
    assert np.abs(seis - s_snap).max() <= 1e-5 * np.abs(s_snap).max()
    assert np.abs(seis - d_obs).max() <= 1e-5 * np.abs(d_obs).max()
    assert abs(J - J_snap) / J_snap < GTOL
    assert abs(J - J_jnp) / J_jnp < GTOL
    werr = np.abs(gw - gw_snap).max() / np.abs(gw_snap).max()
    assert werr < GTOL, f"wavelet gradient rel err {werr:.3e}"
    err = np.abs(g - g_snap).max() / np.abs(g_snap).max()
    assert err < GTOL, f"gradient vs snapshot engine rel err {err:.3e}"
    err_j = np.abs(g - g_jnp).max() / np.abs(g_jnp).max()
    assert err_j < SNAP_GTOL, f"gradient vs jnp engine rel err {err_j:.3e}"
    # zero outside the exact-gradient region, as the reference masks it
    outside = np.ones(g.shape, bool)
    outside[JRingSpec.build(JGrid(**kw)).valid] = False
    assert np.all(g[outside] == 0) and np.all(g_snap[outside] == 0)


@pytest.mark.parametrize("nsrc,free_surface,in_ring", [(1, False, False), (2, True, True)])
def test_simulate_matches_reference_rings_engine(nsrc, free_surface, in_ring):
    """The rings engine's plain versions (forward with the ring tape, the
    reverse that reconstructs) against the reference's rings engine and the
    jnp engine; one case with a source inside the ring."""
    kw, dt, f0, c_max, c2, w, src_p, rcv_p = _setup(96, nsrc, free_surface)
    if in_ring:
        src_p[1, 0] = Grid(**kw).pad + 2  # row 2 of the interior: in the ring at order 8
    d_obs, ref = _jax_runs(kw, dt, f0, c_max, c2, w, src_p, rcv_p, mode="rings")
    sim = make_simulator_scanres(Grid(**kw), dt, f0, c_max, tape_mode="rings")
    si, ri = torch.tensor(src_p), torch.tensor(rcv_p)
    before = ks.scanres_forward.launches, ks.scanres_reverse.launches
    c = (torch.tensor(c2) * 1.01).requires_grad_()
    wt = torch.tensor(w).requires_grad_()
    r = sim(c, wt, si, ri) - torch.tensor(d_obs)
    J = 0.5 * torch.sum(r * r)
    g, gw = (x.numpy() for x in torch.autograd.grad(J, (c, wt)))
    J = float(J.detach())
    assert (ks.scanres_forward.launches, ks.scanres_reverse.launches) == before
    for name in ("rings", "jnp"):
        _, J_r, g_r, gw_r = ref[name]
        assert abs(J - J_r) / J_r < GTOL, name
        err = np.abs(g - g_r).max() / np.abs(g_r).max()
        assert err < GTOL, f"gradient vs {name} engine rel err {err:.3e}"
        werr = np.abs(gw - gw_r).max() / np.abs(gw_r).max()
        assert werr < GTOL, f"wavelet gradient vs {name} engine rel err {werr:.3e}"


def test_reverse_reconstructs_the_first_field():
    """The plain rings reverse ends on P_{-1} = 0 up to round-off."""
    kw, dt, f0, c_max, c2, w, src_p, rcv_p = _setup(64)
    grid = Grid(**kw)
    prof = tuple(torch.tensor(p, dtype=torch.float64)
                 for p in ks.strip_profiles(grid, dt, c_max, f0))
    args = (grid, torch.tensor(c2, dtype=torch.float64), prof)
    idx = (torch.tensor(src_p), torch.tensor(rcv_p))
    wt = torch.tensor(w, dtype=torch.float64)
    seis, tape, ppen, plast = ks.scanres_forward(*args, wt, *idx, tape="rings")
    _, _, p_first = ks.scanres_reverse(*args, wt, seis, tape, ppen, plast, *idx,
                                       return_field=True)
    valid = RingSpec.build(grid).valid
    assert float(p_first[valid].abs().max()) <= 1e-10 * float(plast.abs().max())


def test_tape_row_is_laplacian_of_previous_field():
    """Row t of the tape images lambda_t: it holds D2 lap(P_{t-1})."""
    kw, dt, f0, c_max, c2, w, src_p, rcv_p = _setup(24)
    grid = Grid(**kw)
    prof = tuple(torch.tensor(p) for p in ks.strip_profiles(grid, dt, c_max, f0))
    args = (grid, torch.tensor(c2), prof)
    idx = (torch.tensor(src_p), torch.tensor(rcv_p))
    _, tape, _, _ = ks.scanres_forward(*args, torch.tensor(w), *idx, tape="snap")
    _, _, _, p_last = ks.scanres_forward(*args, torch.tensor(w[:-1]), *idx, tape=None)
    assert torch.count_nonzero(tape[0]) == 0
    ref = ks.interior_lap(grid, p_last).to(torch.bfloat16)
    assert torch.equal(tape[-1], ref)
    # ring row t holds the ring cells of P_t, in RingSpec.extract order
    _, rows, _, p_nt = ks.scanres_forward(*args, torch.tensor(w), *idx, tape="rings")
    assert torch.equal(rows[-1], torch.cat(RingSpec.build(grid).extract(p_nt)))
    with pytest.raises(ValueError, match="unknown tape mode"):
        ks.scanres_forward(*args, torch.tensor(w), *idx, tape="full")


def test_wrappers_refuse_devices_without_kernel():
    kw, dt, f0, c_max, c2, w, src_p, rcv_p = _setup(8)
    grid = Grid(**kw)
    meta = torch.empty(c2.shape, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ks.scanres_forward(grid, meta, (), torch.empty(8, device="meta"),
                           torch.tensor(src_p), torch.tensor(rcv_p), tape="snap")
    with pytest.raises(ValueError, match="no kernel for device"):
        ks.scanres_reverse_snap(grid, meta, (), None, None,
                                torch.tensor(src_p), torch.tensor(rcv_p))
    with pytest.raises(ValueError, match="no kernel for device"):
        ks.scanres_reverse(grid, meta, (), None, None, None, None, None,
                           torch.tensor(src_p), torch.tensor(rcv_p))
