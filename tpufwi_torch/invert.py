"""Multiscale FWI driver and CLI (counterpart of ``tpufwi/invert.py`` for
``physics="acoustic"`` and ``physics="elastic"``, one device, a host loop
over shots).

    for stage in cfg.stages:              # frequency continuation
        J, g = sum over shots of value_and_grad(vp)   # fwd + adjoint per shot
        g <- precondition(g)
        d <- L-BFGS direction; alpha <- Armijo line search (tape-free forwards)
        vp <- clip(vp + alpha d); checkpoint; log

Checkpoints (``<run_dir>/ckpt.npz``: vp, stage, iter, alpha, S, Y, SY;
``<run_dir>/ckpt_mp.npz`` for the multiparameter driver: m0, m1, ..., stage,
iter, alpha, S, Y, SY, scale_tag) and the JSONL records
(``<run_dir>/log.jsonl``) have the reference's format, so a run of either
package resumes in the other. Each iteration's record also gives the shots
it ran by kind, ``grad_shots`` (value-and-grad) and ``trial_shots``
(tape-free line-search trials), from the objectives' counters
(``profiling``); ``shots_per_sec`` counts every shot as the reference does.

Run: ``python -m tpufwi_torch.invert [--device cpu] [physics=elastic]
[key=value ...]`` (on the card unless ``--device cpu``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from . import profiling
from .acquisition import Geometry, split_spread_survey
from .config import FwiConfig
from .filters import apply_response, lowpass, lowpass_response
from .grid import Grid
from .interop import load_reference_checkpoint, load_reference_mp_checkpoint
from .misfit import MISFITS
from .optimize import LbfgsHistory, minimize, minimize_pytree, snap_scales_pow2
from .precondition import gaussian_smooth, precondition
from .propagators.acoustic2d import AcousticPropagator
from .propagators.elastic2d import ElasticPropagator, elastic_cfl_dt
from .wavelets import ricker


def resolve_shot_loop(shot_loop: str) -> str:
    """The reference's shot_loop names: "auto" resolves to "python", the
    port's only loop (shots one after another from the host); "map" and
    "unroll" raise."""
    if shot_loop == "auto":
        return "python"
    if shot_loop != "python":
        raise NotImplementedError(f"shot_loop={shot_loop!r}: the port loops shots from the host")
    return shot_loop


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
    shot_loop: str = "auto"  # resolved to "python" (resolve_shot_loop)
    misfit: str = "l2"

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "shot sharding over a device mesh is not ported yet (reference: tpufwi/sharding.py)")
        self.shot_loop = resolve_shot_loop(self.shot_loop)

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

        dev = self.d_obs.device

        def vg(vp):
            J, g = 0.0, None
            with profiling.span("objective.evaluation", kind="grad", shots=self.n_shots):
                for i in range(self.n_shots):
                    with profiling.span("objective.shot", device=dev, shot=i):
                        v = vp.detach().requires_grad_(True)
                        Ji = self._one_shot_loss(v, i, d_f[i], w, h2)
                        (gi,) = torch.autograd.grad(Ji, v)
                        J = J + Ji.detach()
                        g = gi if g is None else g + gi
                    profiling.count("grad_shots")
            return J, g

        @torch.no_grad()
        def loss(vp):
            J = 0
            with profiling.span("objective.evaluation", kind="loss", shots=self.n_shots):
                for i in range(self.n_shots):
                    with profiling.span("objective.shot", device=dev, shot=i):
                        J = J + self._one_shot_loss(vp, i, d_f[i], w, h2)
                    profiling.count("loss_shots")
            return J

        return vg, loss

    def stage_illumination(self, vp, fmax: Optional[float]):
        """Total source illumination over shots (for preconditioning)."""
        w_f = self.wavelet if fmax is None else lowpass(self.wavelet, self.dt, fmax)
        return sum(self.prop.illumination(vp, self.geoms.shot(i), w_f)
                   for i in range(self.n_shots))


def save_snapshots(run_dir: str, stage: int, vp, g=None):
    """QC plots per stage: the model and (optionally) the gradient as PNGs
    under <run_dir>/figs (``stageNN_vp.png``, ``stageNN_grad.png``), 2D
    arrays only. No-op where matplotlib cannot be imported."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:  # matplotlib is optional
        return
    figdir = os.path.join(run_dir, "figs")
    os.makedirs(figdir, exist_ok=True)
    arrs = [("vp", vp)] + ([("grad", g)] if g is not None else [])
    for name, a in arrs:
        a = np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a)
        if a.ndim != 2:
            continue
        fig, ax = plt.subplots(figsize=(10, 3))
        im = ax.imshow(a, aspect="auto", cmap="viridis" if name == "vp" else "seismic")
        fig.colorbar(im, ax=ax, shrink=0.8)
        ax.set_title(f"stage {stage}: {name}")
        fig.savefig(os.path.join(figdir, f"stage{stage:02d}_{name}.png"), dpi=110)
        plt.close(fig)


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
        raise NotImplementedError(
            "regularization is not ported yet (reference: tpufwi/regularize.py)")

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
                "source estimation is not ported yet (reference: tpufwi/source_estimation.py)")
        vg, loss_only = problem.stage_objectives(stage.fmax)
        log(dict(event="engine", stage=si, engine=problem.prop.impl,
                 note=problem.prop.resolve_note))

        pc = cfg.precond
        illum = problem.stage_illumination(vp, stage.fmax) if pc.use_illumination else None
        sigma = stage.smooth_sigma if stage.smooth_sigma >= 0 else pc.smooth_sigma
        # the depth axis: dim 0 of a 2D (z, x) grid, dim 1 of a 3D (y, z, x) one
        z_axis = 1 if problem.prop.grid.ndim == 3 else 0

        def pre(g):
            return precondition(
                g, illum=illum, illum_eps=pc.illum_eps, depth_power=pc.depth_power,
                dz=problem.prop.grid.h[z_axis], mask_top=pc.mask_top, smooth_sigma=sigma,
                z_axis=z_axis,
            )

        if si != start_stage or it0 == 0:
            hist.reset()  # fresh curvature at each new frequency band
            init_alpha = None

        # shots since the last record, by kind: gradients and line-search trials
        shots_seen = profiling.counters()

        def cb(x, info, _si=si, _it0=it0, _stage=stage):
            it = _it0 + info.it
            wall["any_iter"] = True
            stopping = deadline is not None and time.time() > deadline
            now = profiling.counters()
            log(dict(
                stage=_si, fmax=_stage.fmax, iter=it, J=info.f, gnorm=info.gnorm,
                alpha=info.alpha, evals=info.n_evals, seconds=round(info.seconds, 3),
                shots_per_sec=round(nshots * info.n_evals / max(info.seconds, 1e-9), 2),
                grad_shots=now["grad_shots"] - shots_seen["grad_shots"],
                trial_shots=now["loss_shots"] - shots_seen["loss_shots"],
                cells=n_cells,
            ))
            shots_seen.update(now)
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
        save_snapshots(os.path.dirname(ckpt_path), si, vp)
        if wall["stopped"]:
            break
    return vp


class _MpStagesMixin:
    """Shared machinery of the multiparameter problems (counterpart of the
    reference's ``_MpStagesMixin``): misfit selection, trace weights,
    stage-filtered objectives and host-looped forwards over a model tuple.
    Subclasses define the dataclass fields and ``_forward(m, geom, wavelet)
    -> seis``. Shots run one after another from a host loop; ``mesh``
    and ``shot_loop`` are taken as for ``FwiProblem``.

    Trace weights of lower rank than the seismogram (an (nt, nrec) mask
    against multicomponent elastic (nt, nrec, 2) data) broadcast over the
    trailing component axis; (nshot, nt, nrec) weights apply per shot."""

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "shot sharding over a device mesh is not ported yet (reference: tpufwi/sharding.py)")
        self.shot_loop = resolve_shot_loop(self.shot_loop)

    @property
    def n_shots(self) -> int:
        return int(self.d_obs.shape[0])

    def _build(self):
        """Pin the propagator's engine once for this survey's wavelet length."""
        prop = getattr(self, "prop", None)
        if prop is not None and prop.impl == "auto":
            prop.fix_impl_for(self.geoms, nt=int(self.wavelet.shape[0]))
        self._misfit_fn = MISFITS[self.misfit]

    def _one_loss(self, m, i, d, w, h2, wt):
        seis = apply_response(self._forward(m, self.geoms.shot(i), w), h2, axis=0)
        if wt is not None and wt.ndim < seis.ndim:
            wt = wt.reshape(wt.shape + (1,) * (seis.ndim - wt.ndim))
        return self._misfit_fn(seis, d, weights=wt)

    def stage_objectives(self, fmax: Optional[float], wavelet=None):
        """(value_and_grad(m), loss(m)) over the model tuple for one
        frequency stage: full-band forward, band limit inside the misfit.
        ``wavelet`` overrides the full-band source."""
        if not hasattr(self, "_misfit_fn"):
            self._build()
        nt = int(self.wavelet.shape[0])
        if fmax is not None:
            d_f = lowpass(self.d_obs, self.dt, fmax, axis=1)
            h2 = torch.as_tensor(lowpass_response(nt, self.dt, fmax),
                                 dtype=self.wavelet.dtype, device=self.wavelet.device)
        else:
            d_f = self.d_obs
            h2 = torch.ones(nt + 1, dtype=self.wavelet.dtype, device=self.wavelet.device)
        w = self.wavelet if wavelet is None else wavelet
        tw = self.trace_weights

        def weights(i):
            return tw[i] if tw is not None and tw.ndim == 3 else tw

        dev = self.d_obs.device

        def vg(m):
            J, g = 0.0, None
            with profiling.span("objective.evaluation", kind="grad", shots=self.n_shots):
                for i in range(self.n_shots):
                    with profiling.span("objective.shot", device=dev, shot=i):
                        mi = tuple(x.detach().requires_grad_(True) for x in m)
                        Ji = self._one_loss(mi, i, d_f[i], w, h2, weights(i))
                        gi = torch.autograd.grad(Ji, mi)
                        J = J + Ji.detach()
                        g = gi if g is None else tuple(a + b for a, b in zip(g, gi))
                    profiling.count("grad_shots")
            return J, g

        @torch.no_grad()
        def loss(m):
            J = 0
            with profiling.span("objective.evaluation", kind="loss", shots=self.n_shots):
                for i in range(self.n_shots):
                    with profiling.span("objective.shot", device=dev, shot=i):
                        J = J + self._one_loss(m, i, d_f[i], w, h2, weights(i))
                    profiling.count("loss_shots")
            return J

        return vg, loss

    @torch.no_grad()
    def forward_all(self, m, w) -> torch.Tensor:
        """(nshot, nt, ...) synthetics at model tuple ``m``, forward only."""
        return torch.stack([self._forward(m, self.geoms.shot(i), w)
                            for i in range(self.n_shots)])

    def stage_wavelet(self, m, fmax: Optional[float], eps_rel: float = 1e-4):
        raise NotImplementedError(
            "source estimation is not ported yet (reference: tpufwi/source_estimation.py)")


@dataclasses.dataclass
class ElasticFwiProblem(_MpStagesMixin):
    """Multiparameter (vp, vs, rho) FWI on the elastic P-SV engine:
    stage-filtered objectives over the model tuple, for
    ``minimize_pytree`` with per-field bounds."""

    prop: ElasticPropagator
    geoms: Geometry  # stacked: leading shot axis
    d_obs: torch.Tensor  # (nshot, nt, nrec, 2) or (nshot, nt, nrec)
    wavelet: torch.Tensor
    dt: float
    mesh: Optional[object] = None
    trace_weights: Optional[torch.Tensor] = None
    misfit: str = "l2"
    shot_loop: str = "auto"  # resolved to "python" (resolve_shot_loop)

    def _forward(self, m, g, w):
        vp_, vs_, rho_ = m
        return self.prop(vp_, vs_, rho_, g, w)


def invert_elastic(problem, m0, stages, bounds, lbfgs_m: int = 10,
                   log_fn: Optional[Callable[[dict], None]] = None, scales=None, precond=None,
                   run_dir: Optional[str] = None, resume: bool = False,
                   checkpoint_every: int = 1):
    """Multiscale multiparameter inversion over the model tuple ``m0``
    (e.g. (vp0, vs0, rho0)); returns the final tuple.

    ``bounds``: one (lo, hi) per field. ``scales="auto"`` nondimensionalizes
    each field by its bound range (see ``minimize_pytree``). ``precond``
    maps a gradient tuple to a preconditioned one. ``log_fn`` receives the
    per-stage ``engine`` event and one record per iteration.

    ``run_dir`` enables the checkpoint ``<run_dir>/ckpt_mp.npz`` (the model
    fields m0, m1, ..., the L-BFGS history, stage, iter, alpha and a hash of
    the scale vector, written every ``checkpoint_every`` iterations through
    os.replace); ``resume=True`` continues from it bit-identically, provided
    the call is otherwise the same. The history lives in the scaled space,
    so a checkpoint written under other scales refuses to resume."""
    ckpt_path = None
    start_stage, start_iter, init_alpha, hist = 0, 0, None, None
    m = tuple(m0)
    if scales == "auto":
        scales = [float(hi) - float(lo) for lo, hi in bounds]
    if scales is not None:
        scales = snap_scales_pow2(scales)
    scale_tag = hashlib.sha1(repr(scales).encode()).hexdigest()[:16]
    if run_dir is not None:
        os.makedirs(run_dir, exist_ok=True)
        ckpt_path = os.path.join(run_dir, "ckpt_mp.npz")
        if resume and os.path.exists(ckpt_path):
            ck = load_reference_mp_checkpoint(ckpt_path, device=m[0].device, dtype=m[0].dtype,
                                              lbfgs_m=lbfgs_m)
            if ck.scale_tag != scale_tag:
                raise ValueError("checkpoint was written with different scales; the "
                                 "L-BFGS history is in scaled space and cannot resume")
            m, start_stage, start_iter = ck.m, ck.stage, ck.iter + 1
            init_alpha, hist = ck.alpha, ck.hist

    for si, stage in enumerate(stages):
        if si < start_stage:
            continue
        it0 = start_iter if si == start_stage else 0
        if it0 >= stage.iterations:
            continue
        if si != start_stage or it0 == 0:
            hist = LbfgsHistory(m=lbfgs_m)  # fresh curvature per band
            init_alpha = None
        if stage.source_est:
            raise NotImplementedError(
                "source estimation is not ported yet (reference: tpufwi/source_estimation.py)")
        vg, loss = problem.stage_objectives(stage.fmax)
        prop = getattr(problem, "prop", None)
        if log_fn and prop is not None:
            log_fn(dict(event="engine", stage=si, engine=prop.impl, note=prop.resolve_note))

        def cb(x_tree, info, _si=si, _it0=it0, _stage=stage, _hist=hist):
            it = _it0 + info.it
            if ckpt_path is not None and (
                    (it + 1) % checkpoint_every == 0 or it + 1 == _stage.iterations):
                S, Y, SY = _hist.to_arrays()
                payload = {f"m{i}": leaf.detach().cpu().numpy() for i, leaf in enumerate(x_tree)}
                tmp = ckpt_path + ".tmp.npz"
                np.savez(tmp, stage=_si, iter=it, alpha=info.alpha if info.alpha else -1.0,
                         S=S, Y=Y, SY=SY, scale_tag=scale_tag, **payload)
                os.replace(tmp, ckpt_path)
            if log_fn:
                log_fn(dict(stage=_si, fmax=_stage.fmax, iter=it, J=info.f, gnorm=info.gnorm,
                            alpha=info.alpha, evals=info.n_evals,
                            seconds=round(info.seconds, 3)))

        m, infos, _ = minimize_pytree(
            vg, m, stage.iterations - it0, bounds_tree=bounds, scales_tree=scales,
            precond_tree=precond, method=stage.method, lbfgs_m=lbfgs_m, loss_only=loss,
            callback=cb, hist=hist, init_alpha=init_alpha,
        )
        init_alpha = None
        start_iter = 0
    return m


# the multiparameter problems share one contract; the name says so
invert_multiparameter = invert_elastic


def build_synthetic_problem(cfg: FwiConfig, vp_true: np.ndarray, dx: float,
                            mesh=None, device="cuda"):
    """Survey + observed data from a true model; returns (problem, vp0) with
    vp0 a heavily smoothed start (water layer kept)."""
    from scipy.ndimage import gaussian_filter

    if cfg.pad_nt:
        raise NotImplementedError(
            "pad_nt is not ported yet (reference: tpufwi/window.py and "
            "FwiProblem.with_canonical_nt in tpufwi/invert.py)")
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
    # the water layer of a 2D model; a 3D model keeps none
    wd = int(np.sum(np.asarray(vp_true)[:, 0] <= 1500.0 + 1e-3)) if vp_true.ndim == 2 else 0
    if wd > 0:
        vp0_np[:wd] = np.asarray(vp_true)[:wd]
    vp0 = torch.as_tensor(np.clip(vp0_np, cfg.opt.vmin, cfg.opt.vmax), dtype=dtype,
                          device=device)
    problem = FwiProblem(prop=prop, geoms=geoms, d_obs=d_obs, wavelet=w, dt=dt,
                         mesh=mesh, misfit=cfg.misfit)
    return problem, vp0


def build_synthetic_elastic_problem(cfg: FwiConfig, mesh=None, device="cuda", impl="auto",
                                    extra_rcv=None):
    """A joint (vp, vs) P-SV problem on the land variant of
    ``marmousi_like`` (no water: mu > 0 everywhere; vs = vp / 1.9, rho from
    Gardner's law), a vertical-force source and two-component receivers.
    Returns (problem, m0, bounds, precond): smooth starts for vp and vs,
    rho fixed at the truth, and the acquisition-row taper + smoothing
    preconditioner (without it the raw elastic gradient concentrates at the
    sources and receivers). ``impl`` is the ``ElasticPropagator``'s engine;
    ``extra_rcv`` (n, 2) physical (z, x) cells join every shot's surface
    receiver line (e.g. a borehole array, a VSP survey)."""
    from scipy.ndimage import gaussian_filter

    from .io import marmousi_like

    if cfg.pad_nt:
        raise NotImplementedError(
            "pad_nt is not ported yet (reference: tpufwi/window.py and "
            "FwiProblem.with_canonical_nt in tpufwi/invert.py)")
    dtype = torch.float32 if cfg.prop.dtype == "float32" else torch.float64
    vp_t, dx = marmousi_like(nz=cfg.model.nz, nx=cfg.model.nx, dx=cfg.model.dx,
                             water_depth_m=0.0)
    vp_t = np.asarray(vp_t, np.float64)
    vs_t = vp_t / 1.9
    rho_t = 310.0 * vp_t**0.25  # Gardner 1974
    vp_max = float(vp_t.max())
    grid = Grid(shape=vp_t.shape, h=(dx, dx), pml=cfg.prop.pml, order=cfg.prop.order)
    dt = elastic_cfl_dt(grid.h, vp_max, cfg.prop.order, safety=cfg.prop.cfl_safety)
    nt = int(cfg.acq.t_max / dt)
    w = ricker(cfg.acq.f0, dt, nt, dtype=dtype, device=device)
    prop = ElasticPropagator(grid, dt, cfg.acq.f0, vp_max, dtype=dtype, record="v",
                             source_type="force_z", impl=impl, device=device)
    nz, nx = grid.shape
    sx = np.linspace(6, nx - 7, cfg.acq.n_shots).astype(int)
    rx = np.arange(4, nx - 4, cfg.acq.rcv_dx)
    rcv = np.stack([np.full_like(rx, cfg.acq.rcv_z), rx], 1)
    if extra_rcv is not None:
        rcv = np.concatenate([rcv, np.asarray(extra_rcv, rcv.dtype).reshape(-1, 2)])
    geoms = Geometry.stack([
        Geometry.from_physical(grid, np.array([[cfg.acq.src_z, s]]), rcv, device=device)
        for s in sx])

    def on(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    vpj, vsj, rhoj = on(vp_t), on(vs_t), on(rho_t)
    with torch.no_grad():
        d_obs = torch.stack([prop(vpj, vsj, rhoj, geoms.shot(i), w)
                             for i in range(cfg.acq.n_shots)])
    problem = ElasticFwiProblem(prop=prop, geoms=geoms, d_obs=d_obs, wavelet=w, dt=dt,
                                mesh=mesh, misfit=cfg.misfit)
    vp0 = on(np.clip(gaussian_filter(vp_t, 12.0), cfg.opt.vmin, cfg.opt.vmax))
    vs0 = on(np.clip(gaussian_filter(vs_t, 12.0), cfg.opt.vmin / 1.9, cfg.opt.vmax / 1.9))
    m0 = (vp0, vs0, rhoj)
    bounds = [(cfg.opt.vmin, cfg.opt.vmax),
              (cfg.opt.vmin / 1.9, cfg.opt.vmax / 1.9),
              (float(rho_t.min()), float(rho_t.max()))]

    taper = np.ones(grid.shape)
    taper[: max(cfg.acq.src_z, cfg.acq.rcv_z) + 3, :] = 0.0
    taper_t = on(gaussian_filter(taper, 2.0))
    sig = cfg.precond.smooth_sigma or 1.5

    def precond(g):
        return (gaussian_smooth(g[0] * taper_t, sig), gaussian_smooth(g[1] * taper_t, sig),
                torch.zeros_like(g[2]))

    return problem, m0, bounds, precond


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
            "--mesh: shot sharding is not ported yet (reference: tpufwi/sharding.py)")
    if cfg.physics not in ("acoustic", "elastic"):
        raise NotImplementedError(
            f"physics={cfg.physics!r} is not ported yet (reference: its problem class in "
            "tpufwi/invert.py and its propagator under tpufwi/propagators/)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the inversion runs on the card; "
                           "pass --device cpu to run on the CPU")
    if cfg.physics == "elastic":
        return _main_elastic(cfg, resume=args.resume, device=device)

    vp_true, dx = marmousi_like(nz=cfg.model.nz, nx=cfg.model.nx, dx=cfg.model.dx)
    problem, vp0 = build_synthetic_problem(cfg, vp_true, dx, device=device)

    def echo(rec):
        print(
            f"[stage {rec['stage']} f<{rec['fmax']}Hz it {rec['iter']:3d}] "
            f"J={rec['J']:.4e} |g|={rec['gnorm']:.3e} a={rec['alpha']:.3g} "
            f"{rec['seconds']}s {rec['shots_per_sec']} shots/s "
            f"({rec['grad_shots']} gradient, {rec['trial_shots']} trial)"
        )

    vp = invert(problem, vp0, cfg, resume=args.resume, log_fn=echo)
    np.save(os.path.join(cfg.run_dir, "vp_final.npy"), vp.detach().cpu().numpy())
    print("final model saved to", os.path.join(cfg.run_dir, "vp_final.npy"))
    return vp


def _echo_mp(rec):
    if "event" in rec:  # e.g. the per-stage engine record
        print(f"[event {rec['event']}] "
              + json.dumps({k: v for k, v in rec.items() if k != "event"}))
        return
    print(f"[stage {rec['stage']} f<{rec['fmax']}Hz it {rec['iter']:3d}] "
          f"J={rec['J']:.4e} |g|={rec['gnorm']:.3e} a={rec['alpha']:.3g}")


def _main_elastic(cfg, resume=False, device="cuda"):
    """CLI lane for physics=elastic: joint (vp, vs) multiscale FWI on the
    synthetic land model, with checkpoint/resume and the JSONL log in
    cfg.run_dir. Returns the final (vp, vs, rho)."""
    problem, m0, bounds, precond = build_synthetic_elastic_problem(cfg, device=device)
    os.makedirs(cfg.run_dir, exist_ok=True)
    with open(os.path.join(cfg.run_dir, "log.jsonl"), "a") as logf:

        def log(rec):
            logf.write(json.dumps(rec) + "\n")
            logf.flush()
            _echo_mp(rec)

        m = invert_multiparameter(
            problem, m0, cfg.stages, bounds=bounds, lbfgs_m=cfg.opt.lbfgs_m, scales="auto",
            precond=precond, log_fn=log, run_dir=cfg.run_dir, resume=resume,
            checkpoint_every=cfg.checkpoint_every,
        )
    for name, leaf in zip(("vp", "vs", "rho"), m):
        np.save(os.path.join(cfg.run_dir, f"{name}_final.npy"), leaf.detach().cpu().numpy())
    print("final models saved to", cfg.run_dir)
    return m


if __name__ == "__main__":
    main()
