"""tpufwi_torch step twin and propagator == tpufwi.

The step twin against ``tpufwi.kernels.acoustic2d_jnp`` (fp64, <= 1e-12
relative) and against the fp64 NumPy oracle (< 1e-9 RMS, the bar of
tests/test_forward_equiv.py); the illumination against the reference's;
and the engine resolution of ``impl='auto'``: the snapshot engine on a
card when its tape fits, the rings engine with the reason when it does
not, and a raise with the reason wherever no ported engine fits.
"""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpufwi.kernels.acoustic2d_jnp as jstep
from tpufwi.acquisition import Geometry as JGeometry
from tpufwi.grid import Grid as JGrid
from tpufwi.kernels.oracle_numpy import oracle_forward
from tpufwi.propagators.acoustic2d import AcousticPropagator as JProp

import tpufwi_torch.kernels.acoustic2d_eager as tstep
from tpufwi_torch.acquisition import Geometry
from tpufwi_torch.cpml import build_profiles
from tpufwi_torch.grid import Grid
from tpufwi_torch.invert import FwiProblem
from tpufwi_torch.propagators.acoustic2d import AcousticPropagator


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _setup(free_surface=False, nsrc=1, nt=120):
    kw = dict(shape=(40, 56), h=(10.0, 10.0), pml=10, order=8, free_surface=free_surface)
    c_max, f0 = 2500.0, 14.0
    dt = Grid(**kw).cfl_dt(c_max, safety=0.7)
    rng = np.random.default_rng(4)
    vp = np.clip(2000 + 200 * rng.standard_normal(kw["shape"]), 1700, 2500)
    src = np.stack([np.full(nsrc, 20), np.linspace(16, 40, nsrc).astype(np.int64)], 1)
    rcv = np.stack([np.full(16, 3), np.arange(4, 52, 3)], 1)
    w = np.random.default_rng(5).standard_normal(nt) * np.hanning(nt)
    return kw, dt, f0, c_max, vp, src, rcv, w


@pytest.mark.parametrize("free_surface,nsrc", [(False, 1), (True, 3)])
def test_step_twin_matches_jnp_x64(free_surface, nsrc):
    kw, dt, f0, c_max, vp, src, rcv, w = _setup(free_surface, nsrc, nt=80)
    jg, tg = JGrid(**kw), Grid(**kw)
    c2 = (np.pad(vp, tg.pad, mode="edge") * dt) ** 2
    profs = build_profiles(tg, dt, c_max, f0, dtype=np.float64)
    src_p, rcv_p = src + tg.pad, rcv + tg.pad

    jp = jstep.AcousticParams(
        c2dt2=jnp.asarray(c2), a=tuple(jnp.asarray(p[0]) for p in profs),
        b=tuple(jnp.asarray(p[1]) for p in profs),
        src_idx=jnp.asarray(src_p), rcv_idx=jnp.asarray(rcv_p))
    jst = jstep.zero_state(jg.padded_shape, 2, jnp.float64)
    jf = jax.jit(jstep.make_acoustic_step(jg))
    tp = tstep.AcousticParams(
        c2dt2=torch.tensor(c2), a=tuple(torch.tensor(p[0]) for p in profs),
        b=tuple(torch.tensor(p[1]) for p in profs),
        src_idx=torch.tensor(src_p), rcv_idx=torch.tensor(rcv_p))
    tst = tstep.zero_state(tg.padded_shape, 2, torch.float64)
    tf = tstep.make_acoustic_step(tg)
    for t in range(len(w)):
        jst, jrec = jf(jst, jp, w[t])
        tst, trec = tf(tst, tp, float(w[t]))
        scale = float(jnp.abs(jst.p).max()) + 1e-300
        assert np.abs(trec.numpy() - np.asarray(jrec)).max() <= 1e-12 * scale
    for name in ("p_prev", "p"):
        ref = np.asarray(getattr(jst, name))
        assert np.abs(getattr(tst, name).numpy() - ref).max() <= 1e-12 * np.abs(ref).max()
    for ax in range(2):
        for name in ("phi", "psi"):
            ref = np.asarray(getattr(jst, name)[ax])
            got = getattr(tst, name)[ax].numpy()
            assert np.abs(got - ref).max() <= 1e-12 * (np.abs(ref).max() + 1e-300)


@pytest.mark.parametrize("free_surface", [False, True])
def test_forward_matches_numpy_oracle(free_surface):
    kw, dt, f0, c_max, vp, src, rcv, w = _setup(free_surface, nt=150)
    grid = Grid(**kw)
    seis_o, _ = oracle_forward(vp, JGrid(**kw), dt, w, src, rcv, f0)
    # the oracle sizes its CPML from max(vp); match it
    prop = AcousticPropagator(grid, dt, f0, float(vp.max()), dtype=torch.float64,
                              device="cpu")
    geom = Geometry.from_physical(grid, src, rcv, device="cpu")
    with torch.no_grad():
        seis = prop(torch.tensor(vp), geom, torch.tensor(w)).numpy()
    rms = np.sqrt(np.mean((seis - seis_o) ** 2)) / np.sqrt(np.mean(seis_o**2))
    assert rms < 1e-9, f"relative RMS {rms:.3e}"


def test_illumination_matches_reference():
    kw, dt, f0, c_max, vp, src, rcv, w = _setup(True, nt=100)
    jprop = JProp(JGrid(**kw), dt, f0, c_max, dtype=jnp.float64, impl="jnp")
    jg = JGeometry.from_physical(JGrid(**kw), src, rcv)
    ref = np.asarray(jprop.illumination(jnp.asarray(vp), jg, jnp.asarray(w)))
    prop = AcousticPropagator(Grid(**kw), dt, f0, c_max, dtype=torch.float64, device="cpu")
    got = prop.illumination(torch.tensor(vp),
                            Geometry.from_physical(Grid(**kw), src, rcv, device="cpu"),
                            torch.tensor(w)).numpy()
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


# ---- engine resolution (mirrors tests/test_engine_select.py) ----


def _prop(grid=None, **kw):
    grid = grid or Grid(shape=(60, 100), h=(10.0, 10.0), pml=10, order=8)
    dt = grid.cfl_dt(3000.0, safety=0.7)
    kw.setdefault("device", "cpu")
    return AcousticPropagator(grid, dt, 8.0, 3000.0, **kw)


def test_auto_is_eager_on_cpu():
    prop = _prop()
    assert prop.resolve_impl(nt=500) == "eager"
    assert prop.resolve_impl() == "eager"  # no tape to size on the CPU
    assert prop.resolve_note == "auto: CPU tensor -> exact eager engine"
    assert prop.fix_impl_for(nt=500) == "eager" and prop.impl == "eager"


def test_auto_raises_for_3d_grid():
    grid3 = Grid(shape=(24, 30, 40), h=(10.0,) * 3, pml=8, order=8)
    for device in ("cpu", "cuda"):
        prop = _prop(grid3, device=device)
        with pytest.raises(NotImplementedError, match="3D grid"):
            prop.resolve_impl(nt=100)


def test_auto_raises_for_fp64_on_cuda():
    prop = _prop(dtype=torch.float64, device="cuda")
    with pytest.raises(ValueError, match="fp32 only"):
        prop.resolve_impl(nt=100)
    with pytest.raises(ValueError, match="fp32 only"):
        _prop(dtype=torch.float64, device="cuda", impl="cuda_scansnap")


def test_auto_falls_back_to_rings_when_snap_tape_over_budget(monkeypatch):
    """The budget comes from the card's memory: two tapes in 80% of it.
    Past it, or with no wavelet length to size it, 'auto' takes the rings
    engine and says why (the reference's rule, acoustic2d.py:267-287)."""
    gib = 2**30
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(total_memory=80 * gib))
    prop = _prop(device="cuda")
    assert prop.snap_tape_budget_bytes() == 32 * gib
    NZ, NX = prop.grid.padded_shape
    nt_fit = prop.snap_tape_budget_bytes() // (NZ * NX * 2)
    assert prop.resolve_impl(nt=int(nt_fit)) == "cuda_scansnap"
    assert prop.resolve_note == "auto: CUDA snapshot engine"
    assert prop.resolve_impl(nt=int(nt_fit) + 1) == "cuda_scanres"
    assert "rings engine" in prop.resolve_note and "exceeds the 32.0 GiB" in prop.resolve_note
    assert prop.resolve_impl() == "cuda_scanres"
    assert "cannot be sized" in prop.resolve_note
    # the 5 m Marmousi2-scale survey of chip_smoke.py: a 46 GiB snapshot tape
    big = Grid(shape=(701, 3401), h=(5.0, 5.0), pml=20, order=8)
    big_prop = AcousticPropagator(big, big.cfl_dt(4700.0, 0.7), 12.0, 4700.0, device="cuda")
    nt = int(4.0 / big_prop.dt)
    assert big_prop.fix_impl_for(nt=nt) == "cuda_scanres" and big_prop.impl == "cuda_scanres"
    assert "46." in big_prop.resolve_note


def test_explicit_impl_checked_against_device():
    assert _prop(impl="eager").resolve_impl() == "eager"
    for impl in ("cuda_scansnap", "cuda_scanres", "cuda_step"):
        with pytest.raises(ValueError, match="CUDA device"):
            _prop(impl=impl)
        assert _prop(impl=impl, device="cuda").resolve_impl(nt=10) == impl
    with pytest.raises(ValueError, match="eager-engine option"):
        _prop(impl="cuda_scanres", device="cuda", tape_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="on the CPU"):
        _prop(impl="eager", device="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        _prop(impl="pallas")


def test_fwi_problem_pins_engine_and_python_loop():
    prop = _prop()
    grid = prop.grid
    geoms = Geometry.stack([
        Geometry.from_physical(grid, np.array([[2, x]]), np.array([[3, 10], [3, 20]]),
                               device="cpu")
        for x in (30, 60)
    ])
    nt = 32
    problem = FwiProblem(prop=prop, geoms=geoms, d_obs=torch.zeros((2, nt, 2)),
                         wavelet=torch.zeros(nt), dt=prop.dt)
    problem._build()
    assert prop.impl == "eager" and problem.shot_loop == "python"
    with pytest.raises(NotImplementedError, match="mesh"):
        FwiProblem(prop=prop, geoms=geoms, d_obs=torch.zeros((2, nt, 2)),
                   wavelet=torch.zeros(nt), dt=prop.dt, mesh=object())


def test_driver_jsonl_records_engine(tmp_path):
    from tpufwi_torch.config import AcqCfg, FwiConfig, OptCfg, PrecondCfg, PropCfg, StageCfg
    from tpufwi_torch.invert import build_synthetic_problem, invert

    cfg = FwiConfig(
        stages=(StageCfg(8.0, 1, "lbfgs"),),
        prop=PropCfg(order=4, pml=8, cfl_safety=0.7, dtype="float64"),
        acq=AcqCfg(n_shots=1, src_z=2, rcv_z=2, rcv_dx=4, f0=11.0, t_max=0.25),
        precond=PrecondCfg(use_illumination=False),
        opt=OptCfg(vmin=1500.0, vmax=2600.0),
        run_dir=str(tmp_path / "run"),
    )
    vp_true = np.full((30, 40), 2000.0)
    vp_true[18:, :] = 2250.0
    problem, vp0 = build_synthetic_problem(cfg, vp_true, dx=10.0, device="cpu")
    invert(problem, vp0, cfg)
    recs = [json.loads(line) for line in open(os.path.join(cfg.run_dir, "log.jsonl"))]
    eng = [r for r in recs if r.get("event") == "engine"]
    assert len(eng) == 1 and eng[0]["stage"] == 0
    assert eng[0]["engine"] == "eager"
    assert eng[0]["note"] == "auto: CPU tensor -> exact eager engine"
    its = [r for r in recs if "iter" in r and "event" not in r]
    assert len(its) == 1 and np.isfinite(its[0]["J"])
