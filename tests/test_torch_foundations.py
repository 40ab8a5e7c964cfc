"""tpufwi_torch foundations == tpufwi, bit for bit where the values are
numpy (grid taps, CFL, CPML profiles, wavelets, the synthetic model, the
survey, the config tree) and to fp64 round-off where they go through torch
(filters, preconditioning, misfit). Also: the port imports no JAX."""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpufwi.config as jcfg
import tpufwi.cpml as jcpml
import tpufwi.filters as jfilters
import tpufwi.grid as jgrid
import tpufwi.io as jio
import tpufwi.misfit as jmisfit
import tpufwi.precondition as jprecond
import tpufwi.wavelets as jwavelets
from tpufwi.acquisition import split_spread_survey as j_survey
from tpufwi.kernels.acoustic2d_pallas import strip_profiles as j_strip_profiles

import tpufwi_torch.config as tcfg
import tpufwi_torch.cpml as tcpml
import tpufwi_torch.filters as tfilters
import tpufwi_torch.grid as tgrid
import tpufwi_torch.io as tio
import tpufwi_torch.misfit as tmisfit
import tpufwi_torch.precondition as tprecond
import tpufwi_torch.wavelets as twavelets
from tpufwi_torch.acquisition import split_spread_survey as t_survey
from tpufwi_torch.kernels.acoustic2d_scanres import strip_profiles as t_strip_profiles


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _grids(order, free_surface=False):
    kw = dict(shape=(48, 72), h=(10.0, 12.5), pml=10, order=order,
              free_surface=free_surface)
    return jgrid.Grid(**kw), tgrid.Grid(**kw)


@pytest.mark.parametrize("order", [2, 4, 8])
def test_grid_taps_cfl_and_padding(order):
    for table in ("D1_COEFFS", "D2_COEFFS"):
        assert np.array_equal(getattr(jgrid, table)[order], getattr(tgrid, table)[order])
    jg, tg = _grids(order)
    assert tg.padded_shape == jg.padded_shape and tg.pad == jg.pad
    assert tg.interior == jg.interior and tg.radius == tgrid.radius_for_order(order)
    for c_max, safety in ((2500.0, 0.7), (4700.0, 0.8)):
        assert tg.cfl_dt(c_max, safety) == jg.cfl_dt(c_max, safety)
        assert tgrid.cfl_dt(10.0, c_max, order, safety) == jgrid.cfl_dt(10.0, c_max, order, safety)
    vp = np.random.default_rng(order).uniform(1500, 3000, (48, 72))
    assert np.array_equal(tgrid.pad_model(vp, tg), jgrid.pad_model(vp, jg))
    padded = tgrid.pad_model(torch.tensor(vp), tg).numpy()
    assert np.array_equal(padded, jgrid.pad_model(vp, jg))
    with pytest.raises(ValueError, match="CFL"):
        tg.check_dt(1.0, 3000.0)


@pytest.mark.parametrize("free_surface", [False, True])
def test_cpml_profiles_bit_equal(free_surface):
    kw = dict(n=60, pml=12, radius=4, h=10.0, dt=1.1e-3, c_max=3200.0, f0=9.0,
              free_lo=free_surface)
    for stagger in (0.0, 0.5):
        a = jcpml.CpmlProfile.build(stagger=stagger, **kw)
        b = tcpml.CpmlProfile.build(stagger=stagger, **kw)
        for f in ("a", "b", "inv_kappa"):
            assert np.array_equal(getattr(a, f), getattr(b, f))
    jg, tg = _grids(8, free_surface)
    for pj, pt in zip(jcpml.build_profiles(jg, 1e-3, 3000.0, 10.0, dtype=np.float64),
                      tcpml.build_profiles(tg, 1e-3, 3000.0, 10.0, dtype=np.float64)):
        for x, y in zip(pj, pt):
            assert np.array_equal(x, y)
    for x, y in zip(j_strip_profiles(jg, 1e-3, 3000.0, 10.0),
                    t_strip_profiles(tg, 1e-3, 3000.0, 10.0)):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_ricker_and_marmousi_like_bit_equal():
    assert np.array_equal(jwavelets.ricker_np(12.0, 1e-3, 500),
                          twavelets.ricker_np(12.0, 1e-3, 500))
    assert np.array_equal(np.asarray(jwavelets.ricker(12.0, 1e-3, 500)),
                          twavelets.ricker(12.0, 1e-3, 500, device="cpu").numpy())
    vj, dxj = jio.marmousi_like(nz=60, nx=90, dx=12.5)
    vt, dxt = tio.marmousi_like(nz=60, nx=90, dx=12.5)
    assert dxj == dxt and np.array_equal(vj, vt)


def test_split_spread_survey_indices_equal():
    jg, tg = _grids(8)
    gj = j_survey(jg, 5, src_z=2, rcv_z=3, rcv_dx=2)
    gt = t_survey(tg, 5, src_z=2, rcv_z=3, rcv_dx=2, device="cpu")
    assert gt.src_idx.dtype == torch.int64 and gt.n_shots == 5
    assert np.array_equal(np.asarray(gj.src_idx), gt.src_idx.numpy())
    assert np.array_equal(np.asarray(gj.rcv_idx), gt.rcv_idx.numpy())
    assert np.array_equal(gt.shot(3).rcv_idx.numpy(), np.asarray(gj.rcv_idx[3]))


def test_config_tree_matches_reference():
    assert json.loads(tcfg.FwiConfig().to_json()) == json.loads(jcfg.FwiConfig().to_json())
    ov = ["acq.n_shots=8", "model.nz=351", "precond.use_illumination=false",
          'stages=[{"fmax": 3.0, "iterations": 2}, {"fmax": 5.0, "iterations": 2}]']
    tj = tcfg.FwiConfig().with_overrides(ov).to_json()
    assert json.loads(tj) == json.loads(jcfg.FwiConfig().with_overrides(ov).to_json())
    assert tcfg.FwiConfig.from_json(tj) == tcfg.FwiConfig().with_overrides(ov)


def test_filters_match_reference():
    nt, dt = 300, 2e-3
    assert np.array_equal(tfilters.lowpass_response(nt, dt, 7.0),
                          np.asarray(jfilters.lowpass_response(nt, dt, 7.0)))
    x = np.random.default_rng(1).standard_normal((3, nt, 11))
    ref = np.asarray(jfilters.lowpass(jnp.asarray(x), dt, 7.0, axis=1))
    got = tfilters.lowpass(torch.tensor(x), dt, 7.0, axis=1).numpy()
    assert np.abs(got - ref).max() < 1e-12 * np.abs(ref).max()
    ones = np.ones(nt + 1)
    assert np.allclose(tfilters.apply_response(torch.tensor(x[0]), ones).numpy(), x[0],
                       atol=1e-12)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(depth_power=1.0, dz=10.0, mask_top=4, smooth_sigma=1.5),
])
def test_precondition_matches_reference(kw):
    rng = np.random.default_rng(2)
    g = rng.standard_normal((40, 56))
    illum = rng.uniform(0.1, 2.0, (40, 56))
    ref = np.asarray(jprecond.precondition(jnp.asarray(g), illum=jnp.asarray(illum), **kw))
    got = tprecond.precondition(torch.tensor(g), illum=torch.tensor(illum), **kw).numpy()
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


def test_l2_misfit_and_unported_misfits():
    rng = np.random.default_rng(3)
    s, d, w = (rng.standard_normal((50, 7)) for _ in range(3))
    ref = float(jmisfit.l2_misfit(jnp.asarray(s), jnp.asarray(d), weights=jnp.asarray(w)))
    got = float(tmisfit.l2_misfit(torch.tensor(s), torch.tensor(d), weights=torch.tensor(w)))
    assert abs(got - ref) <= 1e-12 * abs(ref)
    assert set(tmisfit.MISFITS) == set(jmisfit.MISFITS)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmisfit.MISFITS["envelope"](torch.tensor(s), torch.tensor(d))


def test_import_pulls_in_no_jax():
    # modules already loaded at interpreter start do not count against the port
    code = (
        "import sys; before = set(sys.modules); "
        "import tpufwi_torch, tpufwi_torch.invert, tpufwi_torch.interop, "
        "tpufwi_torch.adjoint, tpufwi_torch.adjoint_step, tpufwi_torch.adjoint_scanres, "
        "tpufwi_torch.kernels.acoustic2d_scanres, tpufwi_torch.kernels.acoustic2d_step, "
        "chip_smoke; "
        "bad = sorted(m for m in set(sys.modules) - before "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'tpufwi')); "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    root = Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=root)
    assert res.returncode == 0, res.stdout + res.stderr


def test_port_sources_import_no_jax():
    """No module of the port and not chip_smoke.py names jax or tpufwi in
    an import statement, whether or not it runs at import time."""
    import ast

    root = Path(__file__).resolve().parents[1]
    files = sorted((root / "tpufwi_torch").rglob("*.py")) + [root / "chip_smoke.py"]
    assert len(files) > 20
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            bad += [(f.name, n) for n in names if n.split(".")[0] in ("jax", "jaxlib", "tpufwi")]
    assert bad == []


def test_grid_fields_round_trip_through_interop():
    from tpufwi_torch.interop import from_reference

    jg, _ = _grids(8, free_surface=True)
    src, rcv = np.array([[24, 30]]), np.array([[16, 20], [16, 40]])
    vp = np.full(jg.shape, 2000.0)
    grid, geom, vp_t, w_t = from_reference(dataclasses.asdict(jg), src, rcv, vp,
                                           np.ones(5), device="cpu", dtype=torch.float64)
    assert grid == tgrid.Grid(**dataclasses.asdict(jg)) and grid.free_surface
    assert geom.src_idx.dtype == torch.int64 and geom.nrec == 2
    assert vp_t.dtype == torch.float64 and w_t.shape == (5,)
