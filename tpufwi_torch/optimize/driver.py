"""Bound-constrained ``minimize`` driving L-BFGS with the Armijo line
search (counterpart of ``tpufwi/optimize/driver.py::minimize``). NLCG,
strong Wolfe and ``minimize_pytree`` are not ported yet (ROADMAP Queue A
item 6) and raise."""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Tuple

import torch

from .lbfgs import LbfgsHistory, lbfgs_direction
from .linesearch import backtracking_line_search


@dataclasses.dataclass
class IterInfo:
    it: int
    f: float
    gnorm: float
    alpha: float
    n_evals: int
    seconds: float


def minimize(
    value_and_grad: Callable,
    x0: torch.Tensor,
    iterations: int,
    method: str = "lbfgs",
    bounds: Optional[Tuple[float, float]] = None,
    precond: Optional[Callable] = None,
    lbfgs_m: int = 10,
    callback: Optional[Callable[[torch.Tensor, IterInfo], None]] = None,
    loss_only: Optional[Callable] = None,
    gtol: float = 0.0,
    hist: Optional[LbfgsHistory] = None,
    init_alpha: Optional[float] = None,
    linesearch: str = "armijo",
) -> Tuple[torch.Tensor, list]:
    """Minimize value_and_grad(x) -> (f, g) subject to box bounds.

    precond: g -> g~ before the direction update; loss_only: cheaper f(x)
    for line-search trials (for FWI the tape-free forward); callback: called
    after each accepted iterate, a truthy return stops after it; hist /
    init_alpha: externally owned L-BFGS history and step for resume.
    Returns (x_final, [IterInfo, ...]).
    """
    if method not in ("lbfgs", "gd"):
        if method == "nlcg":
            raise NotImplementedError("NLCG is not ported yet (ROADMAP Queue A item 6)")
        raise ValueError(f"unknown method {method!r}")
    if linesearch != "armijo":
        raise NotImplementedError(
            f"line search {linesearch!r} is not ported yet (ROADMAP Queue A item 6)")
    f_only = loss_only if loss_only is not None else (lambda x: value_and_grad(x)[0])

    def project(z):
        return torch.clamp(z, bounds[0], bounds[1]) if bounds is not None else z

    def first_step(d, x):
        # scale so the step changes x by ~1% of its range
        dmax = float(torch.max(torch.abs(d)))
        xscale = float(torch.max(torch.abs(x))) or 1.0
        return 0.01 * xscale / max(dmax, 1e-300)

    x = project(x0)
    if hist is None:
        hist = LbfgsHistory(m=lbfgs_m)
    infos: list = []
    f, g = value_and_grad(x)
    f = float(f)
    if precond is not None:
        g = precond(g)
    alpha_prev = init_alpha

    for it in range(iterations):
        t0 = time.time()
        d = lbfgs_direction(hist, g) if method == "lbfgs" else -g
        if method == "lbfgs" and len(hist) > 0:
            alpha0 = 1.0
        elif alpha_prev is not None:
            alpha0 = 2.0 * alpha_prev
        else:
            alpha0 = first_step(d, x)

        ls = backtracking_line_search(f_only, x, f, g, d, alpha0, bounds=bounds)
        if not ls.success:
            # reset memory and retry once with steepest descent
            hist.reset()
            d = -g
            ls = backtracking_line_search(f_only, x, f, g, d, first_step(d, x), bounds=bounds)
            if not ls.success:
                infos.append(IterInfo(it, f, float(torch.linalg.vector_norm(g)), 0.0,
                                      ls.n_evals, time.time() - t0))
                break

        x_new = ls.x_new
        f_new, g_new = value_and_grad(x_new)
        f_new = float(f_new)
        if precond is not None:
            g_new = precond(g_new)
        if method == "lbfgs":
            hist.update(x_new - x, g_new - g)
        alpha_prev = ls.alpha
        x, f, g = x_new, f_new, g_new
        gnorm = float(torch.linalg.vector_norm(g))
        info = IterInfo(it, f, gnorm, ls.alpha, ls.n_evals + 1, time.time() - t0)
        infos.append(info)
        if callback is not None and callback(x, info):
            break
        if gtol and gnorm < gtol:
            break
    return x, infos
