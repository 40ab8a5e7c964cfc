"""Bound-constrained ``minimize`` driving L-BFGS with the Armijo line
search, and ``minimize_pytree`` over a tuple of model fields (counterpart
of ``tpufwi/optimize/driver.py``). Bounds are scalars or tensors of the
model's shape (per-element). NLCG and strong Wolfe are not ported yet
(reference: ``tpufwi/optimize/nlcg.py``, ``tpufwi/optimize/linesearch.py``)
and raise."""

from __future__ import annotations

import dataclasses
import math
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
            raise NotImplementedError(
                "NLCG is not ported yet (reference: tpufwi/optimize/nlcg.py)")
        raise ValueError(f"unknown method {method!r}")
    if linesearch != "armijo":
        raise NotImplementedError(
            f"line search {linesearch!r} is not ported yet "
            "(reference: tpufwi/optimize/linesearch.py)")
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


def snap_scales_pow2(scales):
    """Snap each scale to the nearest power of two. Scaling only needs
    order-of-magnitude conditioning, and power-of-two factors make the
    u = x / s round trip bitwise exact in binary floating point, so a
    checkpoint of a scaled multiparameter run resumes bit-identically."""
    return [2.0 ** round(math.log2(float(s))) for s in scales]


def minimize_pytree(value_and_grad: Callable, x0_tree, iterations: int, bounds_tree=None,
                    scales_tree=None, **kw):
    """Multiparameter ``minimize`` over a tuple of model fields (e.g. the
    elastic (vp, vs, rho)), flattened with ``torch.cat``. ``bounds_tree``
    gives one (lo, hi) scalar pair per field; the box projection then acts
    per field through per-element bound vectors. Extra kwargs go to
    ``minimize``.

    ``scales_tree`` balances fields of very different magnitudes: the
    optimizer works on u = x / s per field (each s snapped to a power of
    two), so L-BFGS's identity initial Hessian and the line search's single
    step treat each field comparably. A list of positive scalars, "auto"
    for the bound range hi - lo per field (max |x0| per field without
    bounds), or None for none. ``precond_tree`` maps a gradient tuple to a
    preconditioned one (any per-field linear map commutes with the constant
    per-field scale); ``loss_only`` and ``callback`` receive the model
    tuple in original units.

    Returns (x_tree, infos, unravel) with ``unravel`` mapping the
    optimizer's flat scaled vector back to a model tuple."""
    leaves = tuple(x0_tree)
    shapes = [x.shape for x in leaves]
    sizes = [x.numel() for x in leaves]

    def ravel(tree):
        return torch.cat([x.reshape(-1) for x in tree])

    def unravel_x(v):
        return tuple(p.reshape(s) for p, s in zip(torch.split(v, sizes), shapes))

    def per_leaf_vec(vals):
        return ravel([torch.full_like(x, float(v)) for x, v in zip(leaves, vals)])

    flat0 = ravel(leaves)
    bounds = None
    if bounds_tree is not None:
        if len(bounds_tree) != len(leaves):
            raise ValueError("bounds_tree must give (lo, hi) per model field")
        bounds = (per_leaf_vec([b[0] for b in bounds_tree]),
                  per_leaf_vec([b[1] for b in bounds_tree]))

    if scales_tree == "auto":
        if bounds_tree is not None:
            scales_tree = [float(hi) - float(lo) for lo, hi in bounds_tree]
        else:
            scales_tree = [max(float(torch.max(torch.abs(x))), 1e-30) for x in leaves]
    if scales_tree is not None:
        if len(scales_tree) != len(leaves):
            raise ValueError("scales_tree must give one scale per model field")
        if any(not (float(s) > 0.0) for s in scales_tree):
            raise ValueError(f"scales must be positive, got {scales_tree}")
        svec = per_leaf_vec(snap_scales_pow2(scales_tree))
        flat0 = flat0 / svec
        if bounds is not None:
            bounds = (bounds[0] / svec, bounds[1] / svec)

        def unravel(u):
            return unravel_x(u * svec)

        def grad_to_u(g):  # chain rule: df/du = df/dx * s
            return g * svec
    else:
        unravel = unravel_x

        def grad_to_u(g):
            return g

    def vg_flat(v):
        f, g = value_and_grad(unravel(v))
        return f, grad_to_u(ravel(g))

    precond_tree = kw.pop("precond_tree", None)
    if precond_tree is not None:
        if kw.get("precond") is not None:
            raise ValueError("pass precond_tree or precond, not both")
        kw["precond"] = lambda gv: ravel(precond_tree(unravel_x(gv)))
    loss_only = kw.pop("loss_only", None)
    if loss_only is not None:
        kw["loss_only"] = lambda v: loss_only(unravel(v))
    cb_user = kw.pop("callback", None)
    if cb_user is not None:
        kw["callback"] = lambda v, info: cb_user(unravel(v), info)

    x, infos = minimize(vg_flat, flat0, iterations, bounds=bounds, **kw)
    return unravel(x), infos, unravel
