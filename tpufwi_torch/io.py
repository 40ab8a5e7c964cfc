"""Synthetic model generator (counterpart of ``tpufwi/io.py::marmousi_like``).

The other loaders and generators of the reference are not ported yet
(ROADMAP Queue A item 2).
"""

from __future__ import annotations

import numpy as np


def marmousi_like(
    nz: int = 176,
    nx: int = 851,
    dx: float = 10.0,
    seed: int = 2024,
    water_depth_m: float = 450.0,
):
    """Synthetic Marmousi2-scale 2D model: water layer, dipping folded
    layers, two fault systems, a low-velocity wedge and a fast salt-like
    body, deterministic given ``seed``. Returns (vp [m/s] float64, dx)."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    z = np.arange(nz)[:, None] * dx
    x = np.arange(nx)[None, :] * dx

    # folded, dipping stratigraphy: depth coordinate warped by smooth folds
    fold = (
        120.0 * np.sin(2 * np.pi * x / (nx * dx / 3.0))
        + 80.0 * np.sin(2 * np.pi * x / (nx * dx / 7.0) + 1.3)
        + 0.06 * x
    )
    zw = z + fold

    # two normal faults: lateral shifts of the warped depth
    f1 = nx // 3
    f2 = (2 * nx) // 3
    throw1, throw2 = 180.0, -240.0
    zw = zw + throw1 * (x > f1 * dx) + throw2 * (x > f2 * dx)

    # layered velocity: compaction trend + layer sequence
    n_layers = 24
    bounds = np.sort(rng.uniform(0, nz * dx * 1.6, n_layers))
    dv = rng.uniform(-220.0, 420.0, n_layers)
    vp = 1600.0 + 0.55 * zw
    for b, d in zip(bounds, dv):
        vp = vp + d * (zw > b)

    # low-velocity gas wedge and a fast salt-like body
    cz, cx = 0.55 * nz * dx, 0.42 * nx * dx
    wedge = np.exp(-(((z - cz) / 260.0) ** 2 + ((x - cx) / 900.0) ** 2))
    vp = vp - 420.0 * (wedge > 0.45)
    sz, sx = 0.8 * nz * dx, 0.72 * nx * dx
    salt = ((z - sz) / 420.0) ** 2 + ((x - sx) / 1500.0) ** 2 < 1.0
    vp = np.where(salt, 4450.0 + 0.02 * zw, vp)

    vp = gaussian_filter(vp, 1.0)
    wd = int(water_depth_m / dx)
    vp[:wd] = 1500.0
    return np.clip(vp, 1480.0, 4700.0), dx
