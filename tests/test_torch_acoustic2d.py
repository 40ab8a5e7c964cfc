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


@pytest.mark.parametrize("free_surface", [False, True])
def test_forward_kernel_illumination_matches_reference(free_surface):
    """What every 2D CUDA engine's illumination runs: the whole-scan
    forward's illum mode, here its plain version in fp32, against the
    reference's (fp32, impl='jnp'); 1e-5 of max (fp32 sums in another
    order). The free surface pins P_t before it is summed."""
    from tpufwi_torch.adjoint_scanres import make_illumination, profile_source
    from tpufwi_torch.kernels.acoustic2d_scanres import scanres_forward_plain, strip_profiles

    kw, dt, f0, c_max, vp, src, rcv, w = _setup(free_surface, nsrc=2, nt=100)
    jprop = JProp(JGrid(**kw), dt, f0, c_max, dtype=jnp.float32, impl="jnp")
    jg = JGeometry.from_physical(JGrid(**kw), src, rcv)
    ref = np.asarray(jprop.illumination(jnp.asarray(vp, jnp.float32), jg,
                                        jnp.asarray(w, jnp.float32)))
    grid = Grid(**kw)
    c2 = torch.tensor((np.pad(vp, grid.pad, mode="edge") * dt) ** 2, dtype=torch.float32)
    prof = tuple(torch.tensor(p) for p in strip_profiles(grid, dt, c_max, f0))
    src_idx = torch.tensor(src + grid.pad)
    w_t = torch.tensor(w, dtype=torch.float32)
    acc = scanres_forward_plain(grid, c2, prof, w_t, src_idx, src_idx.new_zeros((0, 2)),
                                illum=True)[4]
    got = acc[grid.interior].numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    # the engines' entry point: the interior of the same accumulator, on
    # every 2D CUDA engine (cuda_scansnap, cuda_scanres, cuda_step, cuda_kstep)
    from tpufwi_torch.adjoint_kstep import make_simulator_kstep
    from tpufwi_torch.adjoint_scanres import make_simulator_scanres
    from tpufwi_torch.adjoint_step import make_simulator_step

    engine = make_illumination(grid, profile_source(grid, dt, f0, c_max))(c2, w_t, src_idx)
    assert torch.equal(engine, acc[grid.interior])
    sims = [make_simulator_scanres(grid, dt, f0, c_max, tape_mode=m) for m in ("snap", "rings")]
    sims += [make_simulator_step(grid, dt, f0, c_max), make_simulator_kstep(grid, dt, f0, c_max)]
    for sim in sims:
        assert torch.equal(sim.illumination(c2, w_t, src_idx), engine)


def test_illumination_raises_on_a_card_engine_without_a_kernel(monkeypatch):
    """No quiet fallback to the plain step twin on a CUDA device: an engine
    there without ``illumination`` raises (the engine is mocked: no card
    here)."""
    kw, dt, f0, c_max, vp, src, rcv, w = _setup(nt=8)
    grid = Grid(**kw)
    prop = AcousticPropagator(grid, dt, f0, c_max, device="cuda")
    monkeypatch.setattr(prop, "resolve_impl", lambda nt=None: "cuda_step")
    prop._sims["cuda_step"] = lambda *args: None  # an engine with no illumination
    twin = []
    monkeypatch.setattr(prop, "_twin_loop", lambda *a: twin.append(1) or iter(()))
    geom = Geometry.from_physical(grid, src, rcv, device="cpu")
    with pytest.raises(NotImplementedError, match="no illumination kernel"):
        prop.illumination(torch.tensor(vp), geom, torch.tensor(w))
    assert not twin


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


def test_auto_raises_for_3d_grid(monkeypatch):
    """A 3D grid runs the eager engine on the CPU; on the card 'auto' raises
    with the reason where no ported 3D engine fits (its ring tape over the
    card's budget), and never falls back to a slow engine."""
    grid3 = Grid(shape=(24, 30, 40), h=(10.0,) * 3, pml=8, order=8)
    assert _prop(grid3).resolve_impl(nt=100) == "eager"
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(total_memory=2**20))
    with pytest.raises(NotImplementedError, match="3D grid"):
        _prop(grid3, device="cuda").resolve_impl(nt=100)


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
        _prop(impl="pallas_kstep")  # the reference names no K-step engine


def test_reference_impl_names_select_counterparts():
    """A reference config's prop.impl drives the port: each reference
    engine name selects its counterpart and resolve_note says so; the
    counterpart is then checked against the device as usual."""
    from tpufwi_torch.propagators.elastic2d import ElasticPropagator

    grid3 = Grid(shape=(12, 14, 16), h=(10.0, 10.0, 10.0), pml=4, order=4)
    for name, impl in (("jnp", "eager"), ("pallas_scansnap", "cuda_scansnap"),
                       ("pallas_scanres", "cuda_scanres"), ("pallas", "cuda_step"),
                       ("pallas3d", "cuda3d"), ("pallas3d_bf16", "cuda3d_bf16")):
        kw = dict(device="cpu" if impl == "eager" else "cuda")
        prop = _prop(impl=name, grid=grid3 if "3d" in name else None, **kw)
        assert prop.resolve_impl(nt=10) == prop.impl == impl
        assert prop.resolve_note == f"{name} -> {impl}"
    with pytest.raises(ValueError, match="on the CPU"):
        _prop(impl="jnp", device="cuda")
    with pytest.raises(ValueError, match="CUDA device"):
        _prop(impl="pallas_scanres")
    grid = Grid(shape=(40, 56), h=(10.0, 10.0), pml=10, order=8)
    for name, impl in (("jnp", "eager"), ("pallas_scan", "cuda_escan"),
                       ("pallas", "cuda_estep")):
        prop = ElasticPropagator(grid, 5e-4, 12.0, 3000.0, impl=name,
                                 device="cpu" if impl == "eager" else "cuda")
        assert prop.resolve_impl(nt=10) == prop.impl == impl
        assert prop.resolve_note == f"{name} -> {impl}"
    with pytest.raises(ValueError, match="unknown elastic impl"):
        ElasticPropagator(grid, 5e-4, 12.0, 3000.0, impl="pallas3d", device="cuda")


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
