"""Misfit functionals (counterpart of ``tpufwi/misfit.py``). The adjoint
source comes from autograd through the residual."""

from __future__ import annotations

import torch


def l2_misfit(seis: torch.Tensor, d_obs: torch.Tensor, weights=None) -> torch.Tensor:
    """0.5 * ||R p - d||^2, optionally trace-weighted."""
    r = seis - d_obs
    if weights is not None:
        r = r * weights
    return 0.5 * torch.sum(r * r)


def _not_ported(name):
    def f(*args, **kwargs):
        raise NotImplementedError(
            f"misfit {name!r} is not ported yet (ROADMAP Queue A item 6)")
    return f


#: Functional registry (FwiProblem.misfit): f(seis, d_obs, weights=None).
MISFITS = {"l2": l2_misfit}
MISFITS.update({name: _not_ported(name)
                for name in ("normalized_l2", "envelope", "w2", "traveltime")})
