"""Backtracking-Armijo line search (counterpart of
``tpufwi/optimize/linesearch.py::backtracking_line_search``). The strong
Wolfe search is not ported yet (ROADMAP Queue A item 6)."""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch


class LineSearchResult(NamedTuple):
    alpha: float
    x_new: torch.Tensor
    f_new: float
    n_evals: int
    success: bool


def _dot64(a: torch.Tensor, b: torch.Tensor) -> float:
    """float64 inner product: fp32 model gradients can be ~1e-23, whose
    squared sums underflow fp32 accumulation and break the descent test."""
    return float(torch.dot(a.reshape(-1).double(), b.reshape(-1).double()))


def backtracking_line_search(
    f: Callable[[torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    fx: float,
    g: torch.Tensor,
    d: torch.Tensor,
    alpha0: float = 1.0,
    c1: float = 1e-4,
    shrink: float = 0.5,
    max_evals: int = 12,
    bounds: Optional[Tuple[float, float]] = None,
) -> LineSearchResult:
    """Armijo backtracking on the projected step: find alpha with
    f(P(x + alpha d)) <= fx + c1 <g, P(x + alpha d) - x>. The first
    backtrack takes the parabola minimizer, safeguarded to [0.1, 0.5] alpha."""

    def project(z):
        return torch.clamp(z, bounds[0], bounds[1]) if bounds is not None else z

    gd = _dot64(g, d)
    if gd >= 0.0:
        return LineSearchResult(0.0, x, fx, 0, False)

    alpha = float(alpha0)
    n = 0
    while n < max_evals:
        x_trial = project(x + alpha * d)
        f_trial = float(f(x_trial))
        n += 1
        decrease = _dot64(g, x_trial - x)
        if math.isfinite(f_trial) and f_trial <= fx + c1 * decrease and decrease < 0.0:
            return LineSearchResult(alpha, x_trial, f_trial, n, True)
        # far outside the trust region: dive fast (the safeguarded parabola
        # can only shrink 10x per evaluation)
        if not math.isfinite(f_trial) or f_trial > 100.0 * abs(fx) + 1e-300:
            alpha *= 1e-3
            continue
        denom = f_trial - fx - alpha * gd
        if denom > 0.0:
            alpha_new = -0.5 * alpha * alpha * gd / denom
            alpha = float(min(max(alpha_new, 0.1 * alpha), 0.5 * alpha))
        else:
            alpha *= shrink
    return LineSearchResult(0.0, x, fx, n, False)
