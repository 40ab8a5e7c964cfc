"""tpufwi_torch elastic inversion stack (``minimize_pytree``,
``ElasticFwiProblem``, ``invert_elastic``, the ``physics=elastic`` CLI) ==
tpufwi's, on the CPU.

- ``minimize_pytree`` on a quadratic with per-field bounds and scales: the
  reference's iterates to 1e-12 (fp64).
- The CLI (40 x 60 land model, 2 shots, one stage of 2 iterations, order 4)
  from the same start: J per iteration within JTOL = 1e-3 relative in fp32
  (measured 7.8e-6 and 6.6e-4: the reference's own fp32 and fp64 runs
  differ by 6e-4 at the second iteration, where J is ~1e-20 and the fp32
  gradient steers the line search) and 1e-10 in fp64 (measured 2e-14).
- A run resumed from ``ckpt_mp.npz`` ends bit-identical to the
  uninterrupted one; a checkpoint under other scales refuses to resume.
- The reference's ``ckpt_mp.npz`` loads through
  ``load_reference_mp_checkpoint``.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpufwi.invert as jinv
from tpufwi.optimize.driver import minimize_pytree as j_minimize_pytree

import tpufwi_torch.invert as tinv
from tpufwi_torch.config import FwiConfig, StageCfg
from tpufwi_torch.interop import load_reference_mp_checkpoint
from tpufwi_torch.optimize import minimize_pytree

JTOL = 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cfg_json(run_dir, dtype="float32"):
    return json.dumps(dict(
        physics="elastic", stages=[dict(fmax=8.0, iterations=2)],
        prop=dict(order=4, pml=10, cfl_safety=0.7, dtype=dtype),
        model=dict(nz=40, nx=60, dx=10.0),
        acq=dict(n_shots=2, src_z=2, rcv_z=2, rcv_dx=3, f0=10.0, t_max=0.45),
        run_dir=run_dir,
    ))


def _run(inv, root, dtype="float32"):
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "cfg.json")
    with open(path, "w") as f:
        f.write(_cfg_json(os.path.join(root, "run"), dtype))
    extra = ["--device", "cpu"] if inv is tinv else []
    inv.main(extra + ["--config", path])
    return os.path.join(root, "run")


def _records(run_dir):
    with open(os.path.join(run_dir, "log.jsonl")) as f:
        return [json.loads(line) for line in f]


def _J(run_dir):
    return np.array([r["J"] for r in _records(run_dir) if "event" not in r])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("elastic")
    return {name: _run(inv, str(root / name)) for name, inv in (("ref", jinv), ("port", tinv))}


def test_cli_matches_reference(runs):
    J, J_ref = _J(runs["port"]), _J(runs["ref"])
    assert len(J) == len(J_ref) == 2 and np.isfinite(J).all() and J[1] < J[0]
    rel = np.abs(J - J_ref) / J_ref
    assert rel.max() < JTOL, f"J per iteration rel err {rel}"
    engines = [r["engine"] for r in _records(runs["port"]) if r.get("event") == "engine"]
    assert engines == ["eager"]
    for name in ("vp", "vs", "rho"):
        m = np.load(os.path.join(runs["port"], f"{name}_final.npy"))
        assert m.shape == (40, 60) and np.isfinite(m).all()


def test_cli_matches_reference_x64(tmp_path):
    J = {name: _J(_run(inv, str(tmp_path / name), "float64"))
         for name, inv in (("ref", jinv), ("port", tinv))}
    assert len(J["port"]) == 2
    assert np.abs(J["port"] - J["ref"]).max() <= 1e-10 * J["ref"].max()


def test_resume_bit_identical(runs, tmp_path):
    """Stop after iteration 0 (its checkpoint written), resume: the final
    model equals the uninterrupted CLI run's bit for bit."""
    cfg = FwiConfig.from_json(_cfg_json(str(tmp_path / "run")))
    problem, m0, bounds, precond = tinv.build_synthetic_elastic_problem(cfg, device="cpu")

    class Stop(Exception):
        pass

    def stop_after_first(rec):
        if "event" not in rec:
            raise Stop

    kw = dict(bounds=bounds, lbfgs_m=cfg.opt.lbfgs_m, scales="auto", precond=precond,
              run_dir=cfg.run_dir)
    with pytest.raises(Stop):
        tinv.invert_multiparameter(problem, m0, cfg.stages, log_fn=stop_after_first, **kw)
    assert load_reference_mp_checkpoint(os.path.join(cfg.run_dir, "ckpt_mp.npz"),
                                        device="cpu").iter == 0
    m = tinv.invert_multiparameter(problem, m0, cfg.stages, resume=True, **kw)
    for name, leaf in zip(("vp", "vs", "rho"), m):
        ref = np.load(os.path.join(runs["port"], f"{name}_final.npy"))
        assert np.array_equal(leaf.numpy(), ref), name
    with pytest.raises(ValueError, match="different scales"):
        tinv.invert_multiparameter(problem, m0, cfg.stages, resume=True,
                                   **dict(kw, scales=[100.0, 100.0, 100.0]))


def test_reference_mp_checkpoint_loads(runs):
    path = os.path.join(runs["ref"], "ckpt_mp.npz")
    ck = load_reference_mp_checkpoint(path, device="cpu")
    with np.load(path) as raw, np.load(os.path.join(runs["port"], "ckpt_mp.npz")) as mine:
        assert sorted(raw.files) == sorted(mine.files)
        assert str(mine["scale_tag"]) == ck.scale_tag
        for i, leaf in enumerate(ck.m):
            assert np.array_equal(leaf.numpy(), raw[f"m{i}"])
        assert (ck.stage, ck.iter, len(ck.hist)) == (0, 1, raw["S"].shape[0])
        assert np.array_equal(ck.hist.pairs[0][0].numpy(), raw["S"][0])
        assert ck.alpha == float(raw["alpha"])


def test_minimize_pytree_matches_reference():
    rng = np.random.default_rng(11)
    shapes = ((5, 4), (3,), (2, 2))
    a = [rng.uniform(0.5, 3.0, s) * w for s, w in zip(shapes, (1e-6, 1.0, 1e4))]
    c = [rng.standard_normal(s) * w for s, w in zip(shapes, (3000.0, 1.0, 0.01))]
    x0 = [ci + rng.standard_normal(ci.shape) * w for ci, w in zip(c, (900.0, 0.7, 0.02))]
    bounds = [(-2500.0, 2500.0), (-1.0, 1.0), (-0.015, 0.02)]

    def run(mod, to, vg):
        its = []
        x, infos, _ = mod(vg, tuple(to(x) for x in x0), 6, bounds_tree=bounds,
                          scales_tree="auto", callback=lambda x, info: its.append(
                              [np.asarray(v) for v in x]))
        return its, [np.asarray(v) for v in x]

    def vg_j(x):
        f = sum(0.5 * jnp.sum(ai * (xi - ci) ** 2) for ai, xi, ci in zip(a, x, c))
        return f, tuple(ai * (xi - ci) for ai, xi, ci in zip(a, x, c))

    def vg_t(x):
        at, ct = [torch.tensor(v) for v in a], [torch.tensor(v) for v in c]
        f = sum(0.5 * torch.sum(ai * (xi - ci) ** 2) for ai, xi, ci in zip(at, x, ct))
        return f, tuple(ai * (xi - ci) for ai, xi, ci in zip(at, x, ct))

    its_j, x_j = run(j_minimize_pytree, jnp.asarray, jax.jit(vg_j))
    its_t, x_t = run(minimize_pytree, torch.tensor, vg_t)
    assert len(its_t) == len(its_j) == 6
    for xs_t, xs_j in zip(its_t + [x_t], its_j + [x_j]):
        for u, v in zip(xs_t, xs_j):
            assert np.abs(u - v).max() <= 1e-12 * max(np.abs(v).max(), 1.0)
    for u, (lo, hi) in zip(x_t, bounds):
        assert lo <= u.min() and u.max() <= hi


def test_elastic_stage_objectives_weights_and_raises():
    """(nt, nrec) trace weights broadcast over the component axis; source
    estimation, pad_nt and the mesh raise."""
    cfg = FwiConfig.from_json(_cfg_json("unused"))
    cfg = cfg.with_overrides(["acq.t_max=0.2", "acq.n_shots=1"])
    problem, m0, _, _ = tinv.build_synthetic_elastic_problem(cfg, device="cpu")
    vg, loss = problem.stage_objectives(None)
    J0, g0 = vg(m0)
    nt, nrec = problem.d_obs.shape[1:3]
    ones = dataclasses.replace(problem, trace_weights=torch.ones(nt, nrec))
    J1, g1 = ones.stage_objectives(None)[0](m0)
    assert float(J1) == float(J0) and all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert abs(float(loss(m0)) - float(J0)) <= 1e-6 * float(J0)
    with pytest.raises(NotImplementedError, match="source estimation"):
        problem.stage_wavelet(m0, None)
    with pytest.raises(NotImplementedError, match="source estimation"):
        tinv.invert_elastic(problem, m0, [StageCfg(None, 1, source_est=True)],
                            bounds=[(0, 1e9)] * 3)
    with pytest.raises(NotImplementedError, match="sharding.py"):
        dataclasses.replace(problem, mesh=object())
    with pytest.raises(NotImplementedError, match="pad_nt"):
        tinv.build_synthetic_elastic_problem(cfg.with_overrides(["pad_nt=128"]), device="cpu")
