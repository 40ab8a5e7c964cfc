"""tpufwi_torch snapshot engine == tpufwi's, on the CPU.

The port's ``simulate`` (plain versions of the two kernels) against the
reference's ``make_simulator_pallas_scanres(tape_mode="snap")`` run in
interpret mode, as tests/test_scanres.py runs it, and against the jnp
boundary-saving engine. Tolerances are the reference suite's: seismogram
1e-5 of its max (fp32 summation order), J and wavelet gradient 1e-4, the
masked model gradient 1e-4 against the snapshot engine (same bf16 tape)
and SNAP_GTOL = 5e-3 against the jnp engine (bf16 tape rounding).
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


def _jax_runs(kw, dt, f0, c_max, c2, w, src_p, rcv_p):
    """(d_obs, {engine: (seis, J, g, gw)}) of the reference engines."""
    jg = JGrid(**kw)
    geom = JGeometry(src_idx=jnp.asarray(src_p), rcv_idx=jnp.asarray(rcv_p))
    sims = {
        "jnp": j_make_simulator(jg, dt, f0, c_max, dtype=jnp.float32),
        "snap": make_simulator_pallas_scanres(jg, dt, f0, c_max, rcv_rows=16,
                                              interpret=True, tape_mode="snap"),
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

    sim = make_simulator_scanres(Grid(**kw), dt, f0, c_max)
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


def test_tape_row_is_laplacian_of_previous_field():
    """Row t of the tape images lambda_t: it holds D2 lap(P_{t-1})."""
    kw, dt, f0, c_max, c2, w, src_p, rcv_p = _setup(24)
    grid = Grid(**kw)
    prof = tuple(torch.tensor(p) for p in ks.strip_profiles(grid, dt, c_max, f0))
    args = (grid, torch.tensor(c2), prof)
    idx = (torch.tensor(src_p), torch.tensor(rcv_p))
    _, tape, _, _ = ks.scanres_forward(*args, torch.tensor(w), *idx, with_tape=True)
    _, _, _, p_last = ks.scanres_forward(*args, torch.tensor(w[:-1]), *idx, with_tape=False)
    assert torch.count_nonzero(tape[0]) == 0
    ref = ks._interior_lap(grid, p_last).to(torch.bfloat16)
    assert torch.equal(tape[-1], ref)


def test_wrappers_refuse_devices_without_kernel():
    kw, dt, f0, c_max, c2, w, src_p, rcv_p = _setup(8)
    grid = Grid(**kw)
    meta = torch.empty(c2.shape, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ks.scanres_forward(grid, meta, (), torch.empty(8, device="meta"),
                           torch.tensor(src_p), torch.tensor(rcv_p), with_tape=True)
    with pytest.raises(ValueError, match="no kernel for device"):
        ks.scanres_reverse_snap(grid, meta, (), None, None,
                                torch.tensor(src_p), torch.tensor(rcv_p))
