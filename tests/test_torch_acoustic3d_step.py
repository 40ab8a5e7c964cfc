"""tpufwi_torch's per-step 3D forward == tpufwi's, on the CPU.

The plain versions of ``leapfrog3d`` and ``strip3d`` and the steps built on
them against the reference's Pallas kernels run in interpret mode, on the
reference suite's own grids (tests/test_acoustic3d_pallas.py): (24, 20, 28)
pml 6 order 4, and (24, 30, 40) pml 8 order 8. The reference runs on its
block-extended layout and is cropped to the padded grid; its strip state
crosses through ``interop.strips3d_from_reference``. Tolerances, relative to
each output's max (fp32, sums in another order: torch's shifted sums
against the reference's block slices and HIGHEST-precision band products):

- the leapfrog against ``make_leapfrog3d_kernel`` and
  ``make_leapfrog3d_zsplit``: 1e-6;
- ``make_acoustic3d_step`` and ``make_acoustic3d_strip_step``, 40 steps
  with the Ricker source added outside the step: 1e-5;
- the fused step against ``make_acoustic3d_fused_step(by=8, bz=16)``, 30
  steps from the impulse, the field and every strip (each face's phi and
  psi): 1e-6 of its own max;
- one ``strip3d_plain`` call from a random state, converted, against one
  reference step: both faces of each axis, 1e-6;
- the strip-state interop round trip: exact;
- ``bench_3d`` on the CPU at a small grid: three finite positive ms/step,
  and ``full_step`` against ``full_step2`` and ``strip_step``: 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from tpufwi.cpml import build_profiles as j_build_profiles
from tpufwi.grid import Grid as JGrid
from tpufwi.kernels.acoustic3d_pallas import (
    crop_y,
    crop_yz,
    extend_y,
    extend_yz,
    make_leapfrog3d_kernel,
    make_leapfrog3d_zsplit,
)
from tpufwi.kernels.acoustic3d_pallas import make_acoustic3d_step as j_make_step
from tpufwi.kernels.acoustic3d_pallas import make_acoustic3d_strip_step as j_make_strip_step
from tpufwi.kernels.acoustic3d_strips_pallas import make_acoustic3d_fused_step as j_make_fused
from tpufwi.wavelets import ricker_np

from tpufwi_torch.bench import bench_3d
from tpufwi_torch.grid import Grid
from tpufwi_torch.interop import strips3d_from_reference, strips3d_to_reference
from tpufwi_torch.kernels import acoustic3d_step as k3s
from tpufwi_torch.kernels import acoustic3d_strips as k3f

SMALL = dict(shape=(24, 20, 28), h=(15.0, 15.0, 15.0), pml=6, order=4)
FUSED = dict(shape=(24, 30, 40), h=(10.0, 10.0, 10.0), pml=8, order=8)
BY, BZ = 8, 16  # the reference's blocks in its own tests


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


# ------------------------------------------------------------------ leapfrog


@pytest.fixture(scope="module")
def leap_case():
    """Random (p_prev, p, c2) on SMALL and both reference kernels' p_next."""
    jg = JGrid(**SMALL)
    rng = np.random.default_rng(0)
    shape = jg.padded_shape
    p, p_prev = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    c2 = (0.02 + 0.005 * rng.standard_normal(shape)).astype(np.float32)
    leap = make_leapfrog3d_kernel(jg, by=BY, interpret=True)
    zsplit = make_leapfrog3d_zsplit(jg, by=BY, bz=BZ, interpret=True)
    ext = lambda a: extend_yz(jnp.asarray(a), jg, by=BY, bz=BZ)  # noqa: E731
    ref = {
        "make_leapfrog3d_kernel": np.asarray(crop_y(leap(
            extend_y(jnp.asarray(p_prev), jg, BY), extend_y(jnp.asarray(p), jg, BY),
            extend_y(jnp.asarray(c2), jg, BY)), jg)),
        "make_leapfrog3d_zsplit": np.asarray(crop_yz(zsplit(ext(p_prev), ext(p), ext(c2)), jg)),
    }
    return (p_prev, p, c2), ref


@pytest.mark.parametrize("kernel", ["make_leapfrog3d_kernel", "make_leapfrog3d_zsplit"])
def test_leapfrog3d_matches_reference_kernels(leap_case, kernel):
    (p_prev, p, c2), ref = leap_case
    out = _t(p_prev)
    got = k3s.leapfrog3d(Grid(**SMALL), out, _t(p), _t(c2))
    assert got is out  # written over p_prev, as the reference aliases it
    assert _rel(got.numpy(), ref[kernel]) < 1e-6


def test_leapfrog3d_is_the_shifted_sum_stencil(leap_case):
    """Against a numpy loop of the taps: zero Dirichlet borders."""
    from tpufwi_torch.grid import D2_COEFFS

    (p_prev, p, c2), _ = leap_case
    grid = Grid(**SMALL)
    R = grid.radius
    pp = np.pad(p.astype(np.float64), R)
    lap = np.zeros(p.shape)
    for ax in range(3):
        for k, c in enumerate(D2_COEFFS[grid.order]):
            sl = [slice(R, R + n) for n in p.shape]
            sl[ax] = slice(k, k + p.shape[ax])
            lap += c / grid.h[ax] ** 2 * pp[tuple(sl)]
    ref = 2.0 * p - p_prev + c2 * lap
    got = k3s.leapfrog3d_plain(grid, _t(p_prev), _t(p), _t(c2))
    assert _rel(got.numpy(), ref) < 1e-6


# --------------------------------------------------------------------- steps


def _step_setup():
    jg = JGrid(**SMALL)
    c_max, f0, nt = 2500.0, 10.0, 40
    dt = jg.cfl_dt(c_max, safety=0.7)
    rng = np.random.default_rng(1)
    NY, NZ, NX = jg.padded_shape
    c2 = (((2000 + 100 * rng.standard_normal((NY, NZ, NX))) * dt) ** 2).astype(np.float32)
    w = ricker_np(f0, dt, nt).astype(np.float32)
    src = (NY // 2, NZ // 2, NX // 2)
    return jg, dt, c_max, f0, c2, w, src


@pytest.fixture(scope="module")
def step_refs():
    """The reference's two XLA-strip steps over 40 steps, the source added
    outside the step (as its suite does)."""
    jg, dt, c_max, f0, c2, w, src = _step_setup()
    profs = j_build_profiles(jg, dt, c_max, f0)
    a3 = tuple(jnp.asarray(p[0], jnp.float32) for p in profs)
    b3 = tuple(jnp.asarray(p[1], jnp.float32) for p in profs)
    c2j = jnp.asarray(c2)
    step = j_make_step(jg, dt, f0, c_max, interpret=True)

    def body(s, w_t):
        p_prev, p, phi, psi = step(s, c2j, a3, b3)
        return (p_prev, p.at[src].add(c2j[src] * w_t), phi, psi), None

    z = jnp.zeros(jg.padded_shape, jnp.float32)
    (_, p_full, _, _), _ = lax.scan(body, (z, z, (z, z, z), (z, z, z)), jnp.asarray(w))
    strip_step, zero_state = j_make_strip_step(jg, dt, f0, c_max, by=BY, interpret=True)
    c2e = extend_y(c2j, jg, BY)

    def body_s(s, w_t):
        p_prev, p, strips = strip_step(s, c2e)
        return (p_prev, p.at[src].add(c2e[src] * w_t), strips), None

    (_, p_strip, _), _ = lax.scan(body_s, zero_state(), jnp.asarray(w))
    return {"step": np.asarray(p_full), "strip_step": np.asarray(crop_y(p_strip, jg))}


@pytest.mark.parametrize("which", ["step", "strip_step"])
def test_steps_match_reference(step_refs, which):
    jg, dt, c_max, f0, c2, w, src = _step_setup()
    grid = Grid(**SMALL)
    c2t = _t(c2)
    if which == "step":
        step = k3s.make_acoustic3d_step(grid, dt, f0, c_max)
        profs = j_build_profiles(jg, dt, c_max, f0)  # the same numpy profiles
        a3 = tuple(_t(p[0]) for p in profs)
        b3 = tuple(_t(p[1]) for p in profs)
        z = lambda: torch.zeros(grid.padded_shape)  # noqa: E731
        state = (z(), z(), (z(), z(), z()), (z(), z(), z()))
        run = lambda s: step(s, c2t, a3, b3)  # noqa: E731
    else:
        step, zero_state = k3s.make_acoustic3d_strip_step(grid, dt, f0, c_max)
        state = zero_state("cpu")
        run = lambda s: step(s, c2t)  # noqa: E731
    for w_t in w:
        state = run(state)
        state[1][src] += c2t[src] * float(w_t)
    assert _rel(state[1].numpy(), step_refs[which]) < 1e-5


@pytest.fixture(scope="module")
def fused_ref():
    """30 reference fused steps from the impulse on FUSED: (c2, dt, p,
    strips as numpy)."""
    jg = JGrid(**FUSED)
    c_max, f0 = 3000.0, 10.0
    dt = jg.cfl_dt(c_max, safety=0.6)
    rng = np.random.default_rng(1)
    NY, NZ, NX = jg.padded_shape
    vp = 2500.0 + 200 * rng.standard_normal((NY, NZ, NX)).astype(np.float32)
    c2 = ((vp * dt) ** 2).astype(np.float32)
    step, zero_state = j_make_fused(jg, dt, f0, c_max, by=BY, bz=BZ, interpret=True)
    imp = np.zeros(jg.padded_shape, np.float32)
    imp[NY // 2, NZ // 2, NX // 2] = 1.0
    s0 = zero_state()
    state = (s0[0], extend_yz(jnp.asarray(imp), jg, by=BY, bz=BZ), s0[2])
    c2e = extend_yz(jnp.asarray(c2), jg, by=BY, bz=BZ)
    for _ in range(30):
        state = step(state, c2e)
    strips = tuple(tuple(np.asarray(s) for s in ax) for ax in state[2])
    return c2, dt, np.asarray(crop_yz(state[1], jg)), strips, jg, step


def _faces(grid, strips):
    """{(quantity, axis, side): the face's strip array} of packed strips."""
    S = grid.pml + grid.radius
    out = {}
    for q, views in zip(("phi", "psi"), k3f.strip_views(grid, torch.as_tensor(strips))):
        for ax, v in enumerate(views):
            for side in (0, 1):
                out[(q, ax, side)] = v.narrow(ax, side * S, S).numpy()
    return out


def test_fused_step_matches_reference(fused_ref):
    c2, dt, p_ref, strips_ref, _, _ = fused_ref
    grid = Grid(**FUSED)
    NY, NZ, NX = grid.padded_shape
    step, zero_state = k3f.make_acoustic3d_fused_step(grid, dt, 10.0, 3000.0)
    p_prev, p, strips = zero_state("cpu")
    p[NY // 2, NZ // 2, NX // 2] = 1.0
    state, c2t = (p_prev, p, strips), _t(c2)
    for _ in range(30):
        state = step(state, c2t)
    assert _rel(state[1].numpy(), p_ref) < 1e-6
    got = _faces(grid, state[2])
    ref = _faces(grid, strips3d_from_reference(strips_ref, grid))
    for key in ref:
        assert np.abs(ref[key]).max() > 0, key
        assert _rel(got[key], ref[key]) < 1e-6, key


def test_strip3d_one_step_matches_reference(fused_ref):
    """One reference fused step from a random state (zero on the block
    extension, as in a run) against leapfrog3d_plain then strip3d_plain fed
    the same state: the field and both faces of each axis."""
    c2, _, _, _, jg, step = fused_ref
    grid = Grid(**FUSED)
    rng = np.random.default_rng(7)
    shape = grid.padded_shape
    p_prev, p = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    strips = rng.standard_normal(2 * k3f.strip_cells(grid)).astype(np.float32)
    ext_shape = extend_yz(jnp.zeros(shape, jnp.float32), jg, by=BY, bz=BZ).shape
    ext = lambda a: extend_yz(jnp.asarray(a), jg, by=BY, bz=BZ)  # noqa: E731
    ref_strips = tuple(tuple(jnp.asarray(s) for s in ax)
                       for ax in strips3d_to_reference(strips, grid, ext_shape))
    _, pn_ref, strips_ref = step((ext(p_prev), ext(p), ref_strips), ext(c2))
    pn_ref = np.asarray(crop_yz(pn_ref, jg))
    strips_ref = tuple(tuple(np.asarray(s) for s in ax) for ax in strips_ref)

    st = torch.tensor(strips)
    pn = k3s.leapfrog3d_plain(grid, _t(p_prev), _t(p), _t(c2))
    prof = k3f.strip_prof_source(grid, jg.cfl_dt(3000.0, safety=0.6), 10.0, 3000.0)(pn)
    k3f.strip3d_plain(grid, _t(p), pn, st, prof, _t(c2))
    assert _rel(pn.numpy(), pn_ref) < 1e-6
    got = _faces(grid, st)
    ref = _faces(grid, strips3d_from_reference(strips_ref, grid))
    for key in ref:
        assert _rel(got[key], ref[key]) < 1e-6, key
        # the strips changed: the step did run on each face
        assert not np.array_equal(got[key], _faces(grid, strips)[key]), key


def test_strip_steps_refuse_a_free_surface():
    """The reference's per-step 3D steps have no free surface; the port's
    strip steps raise instead of running a surface they would not pin."""
    grid = Grid(**dict(SMALL, free_surface=True))
    for make in (k3s.make_acoustic3d_strip_step, k3f.make_acoustic3d_fused_step):
        with pytest.raises(ValueError, match="no free surface"):
            make(grid, 1e-3, 10.0, 2500.0)


# -------------------------------------------------------------------- interop


def test_strips3d_interop_round_trip():
    grid = Grid(**FUSED)
    rng = np.random.default_rng(3)
    strips = rng.standard_normal(2 * k3f.strip_cells(grid)).astype(np.float32)
    ext_shape = tuple(n + e for n, e in zip(grid.padded_shape, (8, 2, 0)))
    ref = strips3d_to_reference(strips, grid, ext_shape)
    S = grid.pml + grid.radius
    for ax, slabs in enumerate(ref):
        want = list(ext_shape)
        want[ax] = S
        assert all(s.shape == tuple(want) for s in slabs)
    assert np.array_equal(strips3d_from_reference(ref, grid), strips)
    back = strips3d_to_reference(strips3d_from_reference(ref, grid), grid, ext_shape)
    for ax in range(3):
        for a, b in zip(back[ax], ref[ax]):
            assert np.array_equal(a, b)


# ---------------------------------------------------------------------- bench


def test_bench_3d_on_the_cpu():
    dims = dict(ny=24, nz=20, nx=28, pml=6, order=4)
    out = bench_3d.bench_3d_step(**dims, nts=(2, 50), device="cpu")
    assert set(out) == set(bench_3d.MODES)
    for v in out.values():
        assert np.isfinite(v["ms_per_step"]) and v["ms_per_step"] > 0
        assert np.isfinite(v["gcups"]) and v["gcups"] > 0
    grid, dt = bench_3d.bench_grid(**dims)
    c2 = bench_3d.bench_c2(grid, dt, "cpu")
    runs = bench_3d.make_runs(grid, dt)
    p = {name: runs[name](c2, 20) for name in ("full_step", "full_step2", "strip_step")}
    assert _rel(p["full_step"].numpy(), p["full_step2"].numpy()) < 1e-5
    assert _rel(p["full_step"].numpy(), p["strip_step"].numpy()) < 1e-5


def test_bench_3d_refuses_a_slope_that_is_not_positive():
    assert bench_3d.per_step_seconds({8: 1.0, 40: 1.32}, (8, 40), "x") == pytest.approx(0.01)
    for t40 in (1.0, 0.9):
        with pytest.raises(RuntimeError, match="not positive"):
            bench_3d.per_step_seconds({8: 1.0, 40: t40}, (8, 40), "leapfrog")
