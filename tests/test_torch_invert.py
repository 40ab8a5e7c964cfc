"""tpufwi_torch inversion stack == tpufwi's, on the CPU.

A two-iteration, one-stage multiscale L-BFGS inversion (two shots,
illumination preconditioning) in both packages from the same start: J per
iteration within JTOL = 1e-4 relative. Both run exact engines (the port's
eager boundary-saving adjoint, the reference's jnp engine): in fp64 the two
runs agree to 1e-10 (measured 7e-14), so in fp32 J differs only by
summation order, which the line search carries into the next model
(measured 5.5e-6 and 3.3e-5; each engine's fp32 J sits ~2e-5 from its
fp64 J). The L-BFGS direction from the same history within
1e-6. A checkpoint written by ``tpufwi.invert`` resumes in the port. The
CLI runs end to end on the CPU when asked, and refuses to fall back to it.
"""

import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpufwi.invert as jinv
from tpufwi.config import FwiConfig as JFwiConfig
from tpufwi.optimize.lbfgs import LbfgsHistory as JHist
from tpufwi.optimize.lbfgs import lbfgs_direction as j_direction

import tpufwi_torch.invert as tinv
from tpufwi_torch.config import FwiConfig
from tpufwi_torch.interop import load_reference_checkpoint
from tpufwi_torch.optimize import LbfgsHistory, lbfgs_direction


JTOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cfg_json(impl, run_dir, iterations=2, dtype="float32"):
    return json.dumps(dict(
        stages=[dict(fmax=8.0, iterations=iterations)],
        prop=dict(order=8, pml=10, cfl_safety=0.7, dtype=dtype, impl=impl),
        acq=dict(n_shots=2, src_z=2, rcv_z=2, rcv_dx=3, f0=10.0, t_max=0.5),
        opt=dict(vmin=1500.0, vmax=2600.0),
        run_dir=run_dir,
    ))


def _vp_true():
    vp = np.full((40, 60), 2000.0)
    vp[22:, :] = 2300.0
    vp[12:20, 25:35] = 1800.0
    return vp


def _records(run_dir):
    with open(os.path.join(run_dir, "log.jsonl")) as f:
        return [json.loads(line) for line in f]


def _J(run_dir):
    return [r["J"] for r in _records(run_dir) if "event" not in r]


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The reference's 2-iteration run, with a copy of its checkpoint after
    iteration 0 for the resume test."""
    root = tmp_path_factory.mktemp("ref")
    cfg = JFwiConfig.from_json(_cfg_json("jnp", str(root / "run")))
    problem, vp0 = jinv.build_synthetic_problem(cfg, _vp_true(), dx=10.0)
    ck0 = str(root / "ckpt_iter0.npz")

    def keep_first(stage, it, vp):
        if it == 0:
            shutil.copy(os.path.join(cfg.run_dir, "ckpt.npz"), ck0)

    jinv.invert(problem, vp0, cfg, on_checkpoint=keep_first)
    return cfg.run_dir, np.asarray(vp0), ck0


def test_two_iterations_match_reference(reference_run, tmp_path):
    ref_dir, vp0_ref, _ = reference_run
    cfg = FwiConfig.from_json(_cfg_json("auto", str(tmp_path / "run")))
    problem, vp0 = tinv.build_synthetic_problem(cfg, _vp_true(), dx=10.0, device="cpu")
    assert np.array_equal(vp0.numpy(), vp0_ref)
    tinv.invert(problem, vp0, cfg)
    J_ref, J = _J(ref_dir), _J(cfg.run_dir)
    assert len(J) == len(J_ref) == 2 and J[1] < J[0]
    rel = np.abs(np.array(J) - np.array(J_ref)) / np.array(J_ref)
    assert rel.max() < JTOL, f"J per iteration rel err {rel}"
    recs = _records(cfg.run_dir)
    assert [r["engine"] for r in recs if r.get("event") == "engine"] == ["eager"]
    with np.load(os.path.join(cfg.run_dir, "ckpt.npz")) as ck, \
            np.load(os.path.join(ref_dir, "ckpt.npz")) as ck_ref:
        assert sorted(ck.files) == sorted(ck_ref.files)
        assert ck["S"].shape == ck_ref["S"].shape and int(ck["iter"]) == 1


def test_two_iterations_match_reference_x64(tmp_path):
    """The same inversion in fp64: the engines agree to round-off."""
    J = {}
    for name, cfg_cls, inv, impl, kw in (("ref", JFwiConfig, jinv, "jnp", {}),
                                         ("port", FwiConfig, tinv, "auto", {"device": "cpu"})):
        cfg = cfg_cls.from_json(_cfg_json(impl, str(tmp_path / name), dtype="float64"))
        problem, vp0 = inv.build_synthetic_problem(cfg, _vp_true(), dx=10.0, **kw)
        inv.invert(problem, vp0, cfg)
        J[name] = np.array(_J(cfg.run_dir))
    assert len(J["port"]) == 2
    assert np.abs(J["port"] - J["ref"]).max() <= 1e-10 * J["ref"].max()


def test_resume_reference_checkpoint(reference_run, tmp_path):
    """Both packages resume the reference's iteration-0 checkpoint (the
    stage's illumination is then taken at the resumed model, in both)."""
    _, _, ck0 = reference_run
    runs = {}
    for name, cfg_cls, inv, impl in (("ref", JFwiConfig, jinv, "jnp"),
                                     ("port", FwiConfig, tinv, "auto")):
        cfg = cfg_cls.from_json(_cfg_json(impl, str(tmp_path / name)))
        os.makedirs(cfg.run_dir)
        shutil.copy(ck0, os.path.join(cfg.run_dir, "ckpt.npz"))
        kw = dict(device="cpu") if inv is tinv else {}
        problem, vp0 = inv.build_synthetic_problem(cfg, _vp_true(), dx=10.0, **kw)
        inv.invert(problem, vp0, cfg, resume=True)
        runs[name] = [r for r in _records(cfg.run_dir) if "event" not in r]
    assert [r["iter"] for r in runs["port"]] == [r["iter"] for r in runs["ref"]] == [1]
    J, J_ref = runs["port"][0]["J"], runs["ref"][0]["J"]
    assert abs(J - J_ref) / J_ref < JTOL

    ck = load_reference_checkpoint(ck0, device="cpu")
    assert (ck.stage, ck.iter, len(ck.hist)) == (0, 0, 1)
    with np.load(ck0) as raw:
        assert np.array_equal(ck.vp.numpy(), raw["vp"])
        assert np.array_equal(ck.hist.pairs[0][0].numpy(), raw["S"][0])
        assert ck.hist.pairs[0][2] == float(raw["SY"][0]) and ck.alpha == float(raw["alpha"])


def test_lbfgs_direction_matches_reference():
    rng = np.random.default_rng(7)
    n, m = 500, 4
    S = rng.standard_normal((m, n)).astype(np.float32)
    Y = (S * rng.uniform(0.5, 2.0, n) + 0.1 * rng.standard_normal((m, n))).astype(np.float32)
    SY = np.einsum("ij,ij->i", S.astype(np.float64), Y.astype(np.float64))
    g = rng.standard_normal(n).astype(np.float32)
    d_ref = np.asarray(j_direction(JHist.from_arrays(S, Y, SY, m=m), jnp.asarray(g)))
    d = lbfgs_direction(LbfgsHistory.from_arrays(S, Y, SY, m=m), torch.tensor(g)).numpy()
    assert np.abs(d - d_ref).max() <= 1e-6 * np.abs(d_ref).max()


def test_cli_main_runs_on_cpu(tmp_path):
    run_dir = str(tmp_path / "cli")
    vp = tinv.main([
        "--device", "cpu", "model.nz=40", "model.nx=64", "acq.n_shots=1",
        "acq.t_max=0.3", "prop.pml=8", f"run_dir={run_dir}",
        'stages=[{"fmax": 6.0, "iterations": 1}]',
    ])
    assert tuple(vp.shape) == (40, 64) and bool(torch.isfinite(vp).all())
    assert os.path.exists(os.path.join(run_dir, "vp_final.npy"))
    assert [r["engine"] for r in _records(run_dir) if r.get("event") == "engine"] == ["eager"]
    with pytest.raises(NotImplementedError, match="physics"):
        tinv.main(["--device", "cpu", "physics=encoded", f"run_dir={run_dir}"])
    with pytest.raises(NotImplementedError, match="pad_nt"):
        tinv.main(["--device", "cpu", "pad_nt=128", "model.nz=40", "model.nx=64",
                   f"run_dir={run_dir}"])


def test_entry_points_default_to_cuda():
    import inspect

    from tpufwi_torch import acquisition, interop, wavelets
    from tpufwi_torch.propagators.acoustic2d import AcousticPropagator

    for fn in (AcousticPropagator.__init__, tinv.build_synthetic_problem,
               acquisition.Geometry.from_physical, acquisition.line_geometry,
               acquisition.split_spread_survey, interop.from_reference,
               interop.load_reference_checkpoint, wavelets.ricker):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__qualname__


def test_cli_main_without_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tinv.main(["model.nz=40", "model.nx=64", f"run_dir={tmp_path}"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        tinv.main(["--device", "cuda:0", "model.nz=40", "model.nx=64", f"run_dir={tmp_path}"])


def test_shot_loop_auto_is_the_python_loop(tmp_path):
    """The reference's default shot_loop="auto" resolves to the port's host
    loop, with the same loss; the loops the port lacks still raise."""
    import dataclasses

    cfg = FwiConfig.from_json(_cfg_json("auto", str(tmp_path / "run")))
    problem, vp0 = tinv.build_synthetic_problem(cfg, _vp_true(), dx=10.0, device="cpu")
    losses = {}
    for loop in ("auto", "python"):
        p = dataclasses.replace(problem, shot_loop=loop)
        assert p.shot_loop == "python"
        losses[loop] = float(p.stage_objectives(8.0)[1](vp0))
    assert losses["auto"] == losses["python"] > 0
    for loop in ("map", "unroll"):
        with pytest.raises(NotImplementedError, match=f"shot_loop='{loop}'"):
            dataclasses.replace(problem, shot_loop=loop)
    assert tinv.ElasticFwiProblem(prop=None, geoms=problem.geoms, d_obs=problem.d_obs,
                                  wavelet=problem.wavelet, dt=problem.dt,
                                  shot_loop="auto").shot_loop == "python"


def test_invert_writes_stage_figures(tmp_path):
    """As the reference's _invert_loop: figs/stageNN_vp.png after each stage
    (save_snapshots), in the checkpoint's run_dir."""
    pytest.importorskip("matplotlib")
    cfg = FwiConfig.from_json(_cfg_json("auto", str(tmp_path / "run"), iterations=1))
    cfg = cfg.with_overrides(['stages=[{"fmax": 6.0, "iterations": 1}, '
                              '{"fmax": 8.0, "iterations": 1}]',
                              "precond.use_illumination=false"])
    problem, vp0 = tinv.build_synthetic_problem(cfg, _vp_true(), dx=10.0, device="cpu")
    tinv.invert(problem, vp0, cfg)
    figs = sorted(os.listdir(os.path.join(cfg.run_dir, "figs")))
    assert figs == ["stage00_vp.png", "stage01_vp.png"]
    tinv.save_snapshots(cfg.run_dir, 2, vp0, g=torch.zeros(3, 4, 5))  # 3D: skipped
    assert sorted(os.listdir(os.path.join(cfg.run_dir, "figs"))) == figs + ["stage02_vp.png"]


def test_synthetic_start_model_of_a_3d_survey_keeps_no_water_layer(monkeypatch):
    """A 3D (y, z, x) model whose z=0 plane is water speed: the 2D water-
    layer rule does not apply, so the start model is the smoothed truth in
    every y-plane (the reference's vp_true.ndim == 2 guard)."""
    from scipy.ndimage import gaussian_filter

    from tpufwi_torch.acquisition import Geometry

    def survey(grid, n_shots, src_z, rcv_z, rcv_dx=1, device="cuda"):  # one 3D shot
        rcv = np.array([[y, rcv_z, x] for y in (2, 7) for x in range(0, 12, 3)])
        return Geometry.stack([Geometry.from_physical(grid, np.array([[5, src_z, 6]]), rcv,
                                                      device=device)])

    monkeypatch.setattr(tinv, "split_spread_survey", survey)
    cfg = FwiConfig().with_overrides(["acq.n_shots=1", "acq.t_max=0.02", "prop.order=4",
                                      "prop.pml=4", "opt.vmin=1400", "opt.vmax=2600"])
    vp = np.full((10, 10, 12), 2000.0)
    vp[:, 0, :] = 1500.0
    _, vp0 = tinv.build_synthetic_problem(cfg, vp, dx=10.0, device="cpu")
    smooth = np.clip(gaussian_filter(vp, sigma=12.0), 1400, 2600)
    assert np.allclose(vp0.numpy(), smooth)
    assert not np.array_equal(vp0[0].numpy(), vp[0])
