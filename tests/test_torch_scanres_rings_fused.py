"""The fused rings reverse's walk (``scanres_reverse``, TPU kernel 3)
transcribed in plain torch, on the CPU, fp32.

The CUDA pass is the snapshot reverse's ``rev_fused`` (csrc/
acoustic2d_scanres.cu) in its rings form: besides the transposed step, a
tile images its own cells with the fp32 D2 laplacian of P_{t-1} (read over
its R cross, which no tile writes in the step) and rewrites its own cells of
P_t, in place, with P_{t-2}: the leapfrog backwards, the surface pinned,
its sources undone outside the ring and off the surface, then its ring
cells from tape row t-2 (zeros for t < 2). ``fused_reverse(...,
rings=...)`` (test_torch_scanres_fused.py) runs that walk with the plain
version's own functions on each tile's window, the tiles in turn and in
place, so it must equal ``scanres_reverse_plain`` bitwise, and through the
port's rings engine it must agree with the reference's jnp engine within
test_torch_scanres.py's tolerances.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_scanres import GTOL, _setup
from test_torch_scanres_fused import _assert_same, _case, fused_reverse

from tpufwi.acquisition import Geometry as JGeometry
from tpufwi.adjoint import make_simulator as j_make_simulator
from tpufwi.grid import Grid as JGrid
from tpufwi.propagators.boundary import RingSpec as JRingSpec

import tpufwi_torch.adjoint_scanres as adjoint_scanres
from tpufwi_torch.adjoint_scanres import make_simulator_scanres
from tpufwi_torch.grid import Grid
from tpufwi_torch.kernels import acoustic2d_scanres as ks

NAMES = ("gbar", "lam_src", "field")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rings_case(order, free_surface, nt, seed=0):
    """``test_torch_scanres_fused._case`` (coinciding sources, one in the
    boundary ring, with the free surface one on the surface row; coinciding
    receivers and one on a source cell), its plain forward's ring tape and
    last two fields, and a random receiver cotangent."""
    args, w, idx = _case(order, free_surface, nt=nt, seed=seed)
    seis, tape, ppen, plast, _ = ks.scanres_forward_plain(*args, w, *idx, "rings")
    ybar = torch.as_tensor(np.random.default_rng(order).standard_normal(tuple(seis.shape)),
                           dtype=torch.float32)
    return args, w, ybar, tape, ppen, plast, idx


def _walk(args, w, ybar, tape, ppen, plast, idx, **kw):
    return fused_reverse(*args, ybar, tape, *idx, rings=(w, ppen, plast), **kw)


@pytest.mark.parametrize("free_surface", [False, True])
@pytest.mark.parametrize("order", [2, 4, 8])
def test_rings_walk_equals_plain_bitwise(order, free_surface):
    args, w, ybar, tape, ppen, plast, idx = _rings_case(order, free_surface, nt=12)
    ref = ks.scanres_reverse_plain(*args, w, ybar, tape, ppen, plast, *idx, return_field=True)
    got = _walk(args, w, ybar, tape, ppen, plast, idx)
    assert float(ref[0].abs().max()) > 0.0 and float(ref[2].abs().max()) > 0.0
    _assert_same(got, ref, NAMES)


@pytest.mark.parametrize("free_surface", [False, True])
def test_rings_walk_small_tiles_and_ping_pong(free_surface):
    """On 8 x 6 tiles the rings walk still equals the plain reverse
    bitwise, and without the psibar / phibar ping-pong it does not."""
    args, w, ybar, tape, ppen, plast, idx = _rings_case(4, free_surface, nt=10)
    small = ks.ScanresPlan(8, 6, 0)
    ref = ks.scanres_reverse_plain(*args, w, ybar, tape, ppen, plast, *idx, return_field=True)
    _assert_same(_walk(args, w, ybar, tape, ppen, plast, idx, plan=small), ref, NAMES)
    bad = _walk(args, w, ybar, tape, ppen, plast, idx, plan=small, ping_pong=False)
    assert not torch.equal(bad[0], ref[0])


@pytest.mark.parametrize("nsrc,free_surface", [(1, False), (3, True)])
def test_rings_walk_matches_reference_jnp_engine(monkeypatch, nsrc, free_surface):
    """The walk as the port's rings engine's reverse (``cuda_scanres``'s
    functions, ``make_simulator_scanres(tape_mode="rings")``, the forward
    its plain version) against the reference's jnp engine,
    test_torch_scanres.py's problem and tolerances: J, the wavelet gradient
    and the masked model gradient GTOL (no tape rounding)."""
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

    plan = ks.ScanresPlan(32, 64, 0)  # few windows keep the 96 steps cheap

    def reverse(grid, c, prof, w_, ybar, tape, ppen, plast, si, ri):
        return fused_reverse(grid, c, prof, ybar, tape, si, ri, plan=plan,
                             rings=(w_, ppen, plast))[:2]

    monkeypatch.setattr(adjoint_scanres, "scanres_forward", ks.scanres_forward_plain)
    monkeypatch.setattr(adjoint_scanres, "scanres_reverse", reverse)
    sim = make_simulator_scanres(Grid(**kw), dt, f0, c_max, tape_mode="rings")
    si, ri = torch.tensor(src_p), torch.tensor(rcv_p)
    c = (torch.tensor(c2) * 1.01).requires_grad_()
    wt = torch.tensor(w).requires_grad_()
    r = sim(c, wt, si, ri) - torch.tensor(np.asarray(d_obs))
    J = 0.5 * torch.sum(r * r)
    g, gw = (x.numpy() for x in torch.autograd.grad(J, (c, wt)))
    assert abs(float(J) - float(J_j)) / float(J_j) < GTOL
    werr = np.abs(gw - np.asarray(gw_j)).max() / np.abs(np.asarray(gw_j)).max()
    assert werr < GTOL, f"wavelet gradient rel err {werr:.3e}"
    err = np.abs(g - g_j).max() / np.abs(g_j).max()
    assert err < GTOL, f"gradient vs jnp engine rel err {err:.3e}"


def test_rings_variants_and_launches():
    """On the CPU the rings reverse is the plain version (with the field it
    returns), with and without dependent launches, and launches nothing;
    one launch a step; the rings pass takes the most shared bytes."""
    args, w, ybar, tape, ppen, plast, idx = _rings_case(4, True, nt=6)
    r0 = ks.scanres_reverse.launches
    ref = ks.scanres_reverse_plain(*args, w, ybar, tape, ppen, plast, *idx, return_field=True)
    for dep in (True, False):
        _assert_same(ks.scanres_reverse(*args, w, ybar, tape, ppen, plast, *idx,
                                        return_field=True, dependent_launch=dep), ref, NAMES)
    assert ks.scanres_reverse.launches == r0
    assert ks.STEP_LAUNCHES == 1
    assert functools.reduce(max, (ks.fused_smem(4, k) for k in ks.FUSED_KERNELS)) == \
        ks.fused_smem(4, "rev_fused_rings")
