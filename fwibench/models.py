"""The benchmark's inputs, made on the device from the seed: the true
velocity models, the start models and the perturbation of each evaluation.

The generators are the port's synthetic models (``tpufwi_torch/io.py``
``marmousi_like`` and ``overthrust_like``), copied formula for formula and
run in float64 on the device; the smoothing is scipy's ``gaussian_filter``
(reflected edges, truncated at 4 sigma) written as shifted sums. A
generator is found by the name a configuration gives.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def gaussian(x: torch.Tensor, sigma: float, axes=None) -> torch.Tensor:
    """Separable Gaussian smoothing with scipy's mode="reflect" (the edge
    sample repeated) and truncate=4."""
    radius = int(4.0 * sigma + 0.5)
    k = np.arange(-radius, radius + 1, dtype=np.float64)
    wts = np.exp(-0.5 * k**2 / sigma**2)
    wts /= wts.sum()
    for ax in range(x.ndim) if axes is None else axes:
        n = x.shape[ax]
        i = np.arange(-radius, n + radius)
        i = np.where(i < 0, -i - 1, i)
        i = np.where(i >= n, 2 * n - i - 1, i)
        xp = x.index_select(ax, torch.as_tensor(i, device=x.device))
        out = torch.zeros_like(x)
        for j, wt in enumerate(wts):
            out.add_(xp.narrow(ax, j, n), alpha=float(wt))
        x = out
    return x


def marmousi_like(shape, dx: float, seed: int, device, water_depth_m: float = 450.0):
    """Marmousi2-scale 2D model (z, x): water layer, dipping folded layers,
    two fault systems, a low-velocity wedge and a fast salt-like body."""
    nz, nx = shape
    rng = np.random.default_rng(seed)
    f64 = dict(dtype=torch.float64, device=device)
    z = torch.arange(nz, **f64)[:, None] * dx
    x = torch.arange(nx, **f64)[None, :] * dx
    fold = (120.0 * torch.sin(2 * math.pi * x / (nx * dx / 3.0))
            + 80.0 * torch.sin(2 * math.pi * x / (nx * dx / 7.0) + 1.3) + 0.06 * x)
    zw = z + fold
    zw = zw + 180.0 * (x > (nx // 3) * dx) - 240.0 * (x > ((2 * nx) // 3) * dx)
    bounds = np.sort(rng.uniform(0, nz * dx * 1.6, 24))
    dv = rng.uniform(-220.0, 420.0, 24)
    vp = 1600.0 + 0.55 * zw
    for b, d in zip(bounds, dv):
        vp = vp + float(d) * (zw > float(b))
    cz, cx = 0.55 * nz * dx, 0.42 * nx * dx
    wedge = torch.exp(-(((z - cz) / 260.0) ** 2 + ((x - cx) / 900.0) ** 2))
    vp = vp - 420.0 * (wedge > 0.45)
    sz, sx = 0.8 * nz * dx, 0.72 * nx * dx
    salt = ((z - sz) / 420.0) ** 2 + ((x - sx) / 1500.0) ** 2 < 1.0
    vp = torch.where(salt, 4450.0 + 0.02 * zw, vp)
    vp = gaussian(vp, 1.0)
    vp[:int(water_depth_m / dx)] = 1500.0
    return vp.clamp(1480.0, 4700.0)


def overthrust_like(shape, dx: float, seed: int, device):
    """SEG/EAGE-Overthrust-scale 3D model in the engines' (y, z, x) layout:
    thrusted folded layers over a faulted basement."""
    ny, nz, nx = shape
    rng = np.random.default_rng(seed)
    f64 = dict(dtype=torch.float64, device=device)
    y = torch.arange(ny, **f64)[:, None, None] * dx
    z = torch.arange(nz, **f64)[None, :, None] * dx
    x = torch.arange(nx, **f64)[None, None, :] * dx
    fold = (150.0 * torch.sin(2 * math.pi * x / (nx * dx / 2.5) + 0.7)
            + 120.0 * torch.cos(2 * math.pi * y / (ny * dx / 2.0)) + 0.1 * x)
    zw = z + fold
    zw = zw + 300.0 * ((x > 0.5 * nx * dx) & (y > 0.3 * ny * dx))
    bounds = np.sort(rng.uniform(0, nz * dx * 1.8, 16))
    dv = rng.uniform(-250.0, 500.0, 16)
    vp = 2200.0 + 0.6 * zw
    for b, d in zip(bounds, dv):
        vp = vp + float(d) * (zw > float(b))
    return gaussian(vp, 1.0).clamp(2000.0, 6000.0)


GENERATORS = {"marmousi_like": marmousi_like, "overthrust_like": overthrust_like}


def true_model(cfg: dict, shape, seed: int, device) -> torch.Tensor:
    """The configuration's true model, fp32."""
    return GENERATORS[cfg["model"]["generator"]](shape, cfg["h_m"], seed, device).float()


def start_model(cfg: dict, vp_true: torch.Tensor) -> torch.Tensor:
    """The smoothed start: ``smooth_sigma`` cells, then the water layer
    (cells at the water speed in the first column, 2D) or the top
    ``keep_top`` rows (3D) pinned to the truth, clipped to the bounds."""
    s = cfg["start"]
    lo, hi = cfg["bounds"]
    vp0 = gaussian(vp_true.double(), float(s["smooth_sigma"]))
    z_axis = vp_true.ndim - 2
    keep = int(s.get("keep_top", 0))
    if s.get("keep_water"):
        keep = int((vp_true[:, 0] <= 1500.0 + 1e-3).sum())
    if keep:
        top = [slice(None)] * vp_true.ndim
        top[z_axis] = slice(0, keep)
        vp0[tuple(top)] = vp_true.double()[tuple(top)]
    return vp0.clamp(lo, hi).float()


def evaluation_seed(seed: int, e: int) -> int:
    """A 64-bit generator seed for evaluation e of a run."""
    return int(np.random.SeedSequence([int(seed), int(e)]).generate_state(1, np.uint64)[0])


def perturbed(vp0: torch.Tensor, seed: int, e: int, amplitude: float, bounds):
    """Evaluation e's model: vp0 (1 + amplitude u), u uniform in [-1, 1)
    from the seed, clipped to the bounds."""
    gen = torch.Generator(device=vp0.device)
    gen.manual_seed(evaluation_seed(seed, e))
    u = torch.rand(vp0.shape, generator=gen, device=vp0.device, dtype=vp0.dtype)
    return (vp0 * (1.0 + amplitude * (2.0 * u - 1.0))).clamp(*bounds)
