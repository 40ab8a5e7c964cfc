"""Multiscale FWI driver and CLI (counterpart of ``tpufwi/invert.py`` for
``physics="acoustic"``, one device, a host loop over shots).

    for stage in cfg.stages:              # frequency continuation
        J, g = sum over shots of value_and_grad(vp)   # fwd + adjoint per shot
        g <- precondition(g)
        d <- L-BFGS direction; alpha <- Armijo line search (tape-free forwards)
        vp <- clip(vp + alpha d); checkpoint; log

Checkpoints (``<run_dir>/ckpt.npz``: vp, stage, iter, alpha, S, Y, SY) and
the JSONL records (``<run_dir>/log.jsonl``) have the reference's format, so
a run of either package resumes in the other.

Run: ``python -m tpufwi_torch.invert [--device cpu] [key=value ...]`` (on the
card unless ``--device cpu``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from .acquisition import Geometry, split_spread_survey
from .config import FwiConfig
from .filters import apply_response, lowpass, lowpass_response
from .grid import Grid
from .interop import load_reference_checkpoint
from .misfit import MISFITS
from .optimize import LbfgsHistory, minimize
from .precondition import precondition
from .propagators.acoustic2d import AcousticPropagator
from .wavelets import ricker


@dataclasses.dataclass
class FwiProblem:
    """Propagator + survey + observed data, with stage-filtered objectives.

    Shots run one after another from a host loop: one value-and-grad per
    shot, summed on the device."""

    prop: AcousticPropagator
    geoms: Geometry  # stacked: leading shot axis
    d_obs: torch.Tensor  # (nshot, nt, nrec)
    wavelet: torch.Tensor  # (nt,)
    dt: float
    mesh: Optional[object] = None
    shot_loop: str = "python"
    misfit: str = "l2"

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "shot sharding over a device mesh is not ported yet (ROADMAP Queue A item 8)")
        if self.shot_loop != "python":
            raise NotImplementedError(
                f"shot_loop={self.shot_loop!r}: the port loops shots from the host")

    @property
    def n_shots(self) -> int:
        return int(self.d_obs.shape[0])

    def _build(self):
        """Pin the propagator's engine once for this survey's wavelet length."""
        self.prop.fix_impl_for(nt=int(self.wavelet.shape[0]))
        self._misfit_fn = MISFITS[self.misfit]

    def _one_shot_loss(self, vp, i, d, w, h2):
        seis = apply_response(self.prop(vp, self.geoms.shot(i), w), h2, axis=0)
        return self._misfit_fn(seis, d)

    def stage_objectives(self, fmax: Optional[float], wavelet=None):
        """(value_and_grad(vp), loss(vp)) for one frequency stage: the
        forward runs the full-band wavelet and the synthetics are
        band-limited inside the misfit, exactly matching the filtered data."""
        if not hasattr(self, "_misfit_fn"):
            self._build()
        nt = int(self.wavelet.shape[0])
        if fmax is not None:
            d_f = lowpass(self.d_obs, self.dt, fmax, axis=1)
            h2 = torch.as_tensor(lowpass_response(nt, self.dt, fmax),
                                 dtype=self.d_obs.dtype, device=self.d_obs.device)
        else:
            d_f = self.d_obs
            h2 = torch.ones(nt + 1, dtype=self.d_obs.dtype, device=self.d_obs.device)
        w = self.wavelet if wavelet is None else wavelet

        def vg(vp):
            J, g = 0.0, None
            for i in range(self.n_shots):
                v = vp.detach().requires_grad_(True)
                Ji = self._one_shot_loss(v, i, d_f[i], w, h2)
                (gi,) = torch.autograd.grad(Ji, v)
                J = J + Ji.detach()
                g = gi if g is None else g + gi
            return J, g

        @torch.no_grad()
        def loss(vp):
            return sum(self._one_shot_loss(vp, i, d_f[i], w, h2)
                       for i in range(self.n_shots))

        return vg, loss

    def stage_illumination(self, vp, fmax: Optional[float]):
        """Total source illumination over shots (for preconditioning)."""
        w_f = self.wavelet if fmax is None else lowpass(self.wavelet, self.dt, fmax)
        return sum(self.prop.illumination(vp, self.geoms.shot(i), w_f)
                   for i in range(self.n_shots))


def invert(
    problem: FwiProblem,
    vp0: torch.Tensor,
    cfg: FwiConfig,
    resume: bool = False,
    log_fn: Optional[Callable[[dict], None]] = None,
    on_checkpoint: Optional[Callable[[int, int, np.ndarray], None]] = None,
) -> torch.Tensor:
    """Run the multiscale inversion described by ``cfg``; returns vp*.
    ``on_checkpoint(stage, iter, vp)`` fires after every ckpt.npz write."""
    run_dir = cfg.run_dir
    os.makedirs(run_dir, exist_ok=True)
    ckpt_path = os.path.join(run_dir, "ckpt.npz")
    log_path = os.path.join(run_dir, "log.jsonl")

    start_stage, start_iter, init_alpha = 0, 0, None
    vp = vp0
    hist = LbfgsHistory(m=cfg.opt.lbfgs_m)
    if resume and os.path.exists(ckpt_path):
        ck = load_reference_checkpoint(ckpt_path, device=vp0.device, dtype=vp0.dtype,
                                       lbfgs_m=cfg.opt.lbfgs_m)
        vp, start_stage, start_iter = ck.vp, ck.stage, ck.iter + 1
        init_alpha, hist = ck.alpha, ck.hist

    with open(log_path, "a") as logf:

        def log(rec: dict):
            logf.write(json.dumps(rec) + "\n")
            logf.flush()
            # log_fn takes per-iteration records; events go to the JSONL only
            if log_fn is not None and "event" not in rec:
                log_fn(rec)

        return _invert_loop(problem, vp, cfg, hist, init_alpha, start_stage, start_iter,
                            ckpt_path, log, on_checkpoint)


def _invert_loop(problem, vp, cfg, hist, init_alpha, start_stage, start_iter, ckpt_path,
                 log, on_checkpoint=None):
    bounds = (cfg.opt.vmin, cfg.opt.vmax)
    n_cells = int(np.prod(problem.prop.grid.shape))
    nshots = problem.n_shots
    deadline = time.time() + cfg.max_wall_s if cfg.max_wall_s else None
    # never stop before any progress in this invocation
    wall = dict(any_iter=False, stopped=False)
    rc = cfg.reg
    if rc.type and rc.weight != 0.0:
        raise NotImplementedError("regularization is not ported yet (ROADMAP Queue A item 12)")

    for si, stage in enumerate(cfg.stages):
        if si < start_stage:
            continue
        if deadline is not None and wall["any_iter"] and time.time() > deadline:
            log(dict(event="wall_budget_stop", stage=si, budget_s=cfg.max_wall_s))
            break
        it0 = start_iter if si == start_stage else 0
        if it0 >= stage.iterations:
            continue
        if stage.source_est:
            raise NotImplementedError(
                "source estimation is not ported yet (ROADMAP Queue A item 6)")
        vg, loss_only = problem.stage_objectives(stage.fmax)
        log(dict(event="engine", stage=si, engine=problem.prop.impl,
                 note=problem.prop.resolve_note))

        pc = cfg.precond
        illum = problem.stage_illumination(vp, stage.fmax) if pc.use_illumination else None
        sigma = stage.smooth_sigma if stage.smooth_sigma >= 0 else pc.smooth_sigma

        def pre(g):
            return precondition(
                g, illum=illum, illum_eps=pc.illum_eps, depth_power=pc.depth_power,
                dz=problem.prop.grid.h[0], mask_top=pc.mask_top, smooth_sigma=sigma,
                z_axis=0,
            )

        if si != start_stage or it0 == 0:
            hist.reset()  # fresh curvature at each new frequency band
            init_alpha = None

        def cb(x, info, _si=si, _it0=it0, _stage=stage):
            it = _it0 + info.it
            wall["any_iter"] = True
            stopping = deadline is not None and time.time() > deadline
            log(dict(
                stage=_si, fmax=_stage.fmax, iter=it, J=info.f, gnorm=info.gnorm,
                alpha=info.alpha, evals=info.n_evals, seconds=round(info.seconds, 3),
                shots_per_sec=round(nshots * info.n_evals / max(info.seconds, 1e-9), 2),
                cells=n_cells,
            ))
            every = cfg.checkpoint_every
            if (every > 0 and (it + 1) % every == 0) or it + 1 == _stage.iterations or stopping:
                S, Y, SY = hist.to_arrays()
                tmp = ckpt_path + ".tmp.npz"
                x_np = x.detach().cpu().numpy()
                np.savez(tmp, vp=x_np, stage=_si, iter=it,
                         alpha=info.alpha if info.alpha else -1.0, S=S, Y=Y, SY=SY)
                os.replace(tmp, ckpt_path)
                if on_checkpoint is not None:
                    on_checkpoint(_si, it, x_np)
            if stopping:
                wall["stopped"] = True
                log(dict(event="wall_budget_stop", stage=_si, iter=it,
                         budget_s=cfg.max_wall_s))
                return True
            return False

        vp, infos = minimize(
            vg, vp, iterations=stage.iterations - it0, method=stage.method,
            bounds=bounds, precond=pre, lbfgs_m=cfg.opt.lbfgs_m, callback=cb,
            loss_only=loss_only, hist=hist, init_alpha=init_alpha,
            linesearch=stage.linesearch,
        )
        if infos and infos[-1].alpha == 0.0:
            # a failed line search ends the stage without a callback
            log(dict(event="linesearch_failed", stage=si, iter=it0 + infos[-1].it,
                     J=infos[-1].f, gnorm=infos[-1].gnorm, evals=infos[-1].n_evals))
        init_alpha = None
        start_iter = 0
        if wall["stopped"]:
            break
    return vp


def build_synthetic_problem(cfg: FwiConfig, vp_true: np.ndarray, dx: float,
                            mesh=None, device="cuda"):
    """Survey + observed data from a true model; returns (problem, vp0) with
    vp0 a heavily smoothed start (water layer kept)."""
    from scipy.ndimage import gaussian_filter

    if cfg.pad_nt:
        raise NotImplementedError("pad_nt is not ported yet (ROADMAP Queue A item 6)")
    dtype = torch.float32 if cfg.prop.dtype == "float32" else torch.float64
    grid = Grid(shape=vp_true.shape, h=(dx,) * vp_true.ndim, pml=cfg.prop.pml,
                order=cfg.prop.order)
    c_max = float(cfg.opt.vmax)
    dt = grid.cfl_dt(c_max, safety=cfg.prop.cfl_safety)
    nt = int(cfg.acq.t_max / dt)
    w = ricker(cfg.acq.f0, dt, nt, dtype=dtype, device=device)
    prop = AcousticPropagator(grid, dt, cfg.acq.f0, c_max, dtype=dtype,
                              impl=cfg.prop.impl, device=device)
    geoms = split_spread_survey(grid, cfg.acq.n_shots, src_z=cfg.acq.src_z,
                                rcv_z=cfg.acq.rcv_z, rcv_dx=cfg.acq.rcv_dx, device=device)
    vp_t = torch.as_tensor(vp_true, dtype=dtype, device=device)
    with torch.no_grad():
        d_obs = torch.stack([prop(vp_t, geoms.shot(i), w) for i in range(cfg.acq.n_shots)])
    vp0_np = gaussian_filter(np.asarray(vp_true, np.float64), sigma=12.0)
    wd = int(np.sum(np.asarray(vp_true)[:, 0] <= 1500.0 + 1e-3))
    if wd > 0:
        vp0_np[:wd] = np.asarray(vp_true)[:wd]
    vp0 = torch.as_tensor(np.clip(vp0_np, cfg.opt.vmin, cfg.opt.vmax), dtype=dtype,
                          device=device)
    problem = FwiProblem(prop=prop, geoms=geoms, d_obs=d_obs, wavelet=w, dt=dt,
                         mesh=mesh, misfit=cfg.misfit)
    return problem, vp0


def main(argv=None):
    """CLI: ``python -m tpufwi_torch.invert [--config F] [--resume]
    [--device D] [dotted.key=value ...]``. Returns the final model."""
    import argparse

    from .io import marmousi_like

    ap = argparse.ArgumentParser(description="tpufwi_torch multiscale FWI driver")
    ap.add_argument("--config", type=str, default=None, help="JSON config path")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--mesh", type=int, default=0, help="shot-parallel devices (0=off)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (default cuda; cpu runs the exact eager engine)")
    ap.add_argument("overrides", nargs="*", help="dotted.key=value overrides")
    args = ap.parse_args(argv)

    cfg = FwiConfig()
    if args.config:
        with open(args.config) as f:
            cfg = FwiConfig.from_json(f.read())
    if args.overrides:
        cfg = cfg.with_overrides(args.overrides)
    if args.mesh:
        raise NotImplementedError(
            "--mesh: shot sharding is not ported yet (ROADMAP Queue A item 8)")
    if cfg.physics != "acoustic":
        raise NotImplementedError(
            f"physics={cfg.physics!r} is not ported yet (ROADMAP Queue A items 9-12)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the inversion runs on the card; "
                           "pass --device cpu to run on the CPU")

    vp_true, dx = marmousi_like(nz=cfg.model.nz, nx=cfg.model.nx, dx=cfg.model.dx)
    problem, vp0 = build_synthetic_problem(cfg, vp_true, dx, device=device)

    def echo(rec):
        print(
            f"[stage {rec['stage']} f<{rec['fmax']}Hz it {rec['iter']:3d}] "
            f"J={rec['J']:.4e} |g|={rec['gnorm']:.3e} a={rec['alpha']:.3g} "
            f"{rec['seconds']}s {rec['shots_per_sec']} shots/s"
        )

    vp = invert(problem, vp0, cfg, resume=args.resume, log_fn=echo)
    np.save(os.path.join(cfg.run_dir, "vp_final.npy"), vp.detach().cpu().numpy())
    print("final model saved to", os.path.join(cfg.run_dir, "vp_final.npy"))
    return vp


if __name__ == "__main__":
    main()
