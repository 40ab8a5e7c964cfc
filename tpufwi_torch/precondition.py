"""Gradient preconditioning (counterpart of ``tpufwi/precondition.py``):
illumination division, depth weighting, top masking and Gaussian
smoothing. The smoothing is a separable explicit stencil (no cuDNN)."""

from __future__ import annotations

import numpy as np
import torch

from .kernels.stencils import apply_stencil


def gaussian_smooth(g: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur with static sigma (in cells)."""
    if sigma <= 0:
        return g
    r = max(1, int(3.0 * sigma + 0.5))
    x = np.arange(-r, r + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    taps = tuple(float(v) for v in k)
    for ax in range(g.ndim):
        g = apply_stencil(g, taps, ax)
    return g


def precondition(
    g: torch.Tensor,
    illum: torch.Tensor | None = None,
    illum_eps: float = 1e-3,
    depth_power: float = 0.0,
    dz: float = 1.0,
    mask_top: int = 0,
    smooth_sigma: float = 0.0,
    z_axis: int = 0,
) -> torch.Tensor:
    """The standard FWI gradient preconditioning chain: divide by
    ``illum + illum_eps * max(illum)``, multiply by ``(z*dz)^depth_power``,
    zero the first ``mask_top`` z cells, smooth by ``smooth_sigma`` cells."""
    if illum is not None:
        g = g / (illum + illum_eps * torch.max(illum))
    if depth_power != 0.0:
        nz = g.shape[z_axis]
        z = (torch.arange(nz, dtype=g.dtype, device=g.device) + 1.0) * dz
        shape = [1] * g.ndim
        shape[z_axis] = nz
        g = g * (z**depth_power).reshape(shape)
    if mask_top > 0:
        g = g.index_fill(z_axis, torch.arange(mask_top, device=g.device), 0.0)
    if smooth_sigma > 0:
        g = gaussian_smooth(g, smooth_sigma)
    return g
