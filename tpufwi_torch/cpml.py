"""CPML (convolutional perfectly-matched layer) absorbing boundary profiles.

Counterpart of ``tpufwi/cpml.py``: the same numpy float64 formulas
(Komatitsch & Martin 2007; Pasalic & McGarry 2010, second-order form):

    d(l)     = d0 * (l/L)^p,     d0 = -(p+1) * c_max * ln(R0) / (2 L)
    alpha(l) = pi * f0 * (1 - l/L)
    kappa(l) = 1 + (kappa_max - 1) * (l/L)^p
    b        = exp(-(d/kappa + alpha) * dt)
    a        = d * (b - 1) / (kappa * (d + kappa * alpha))

``a`` and ``b`` are zero in the interior, so the memory variables stay
identically zero outside the layer.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class CpmlProfile:
    """Per-axis 1-D CPML recursion coefficients on the padded grid (float64
    arrays of length ``n_padded``): ``a`` (update weight), ``b`` (decay) and
    ``inv_kappa`` (stretching), zero / zero / one in the interior."""

    a: np.ndarray
    b: np.ndarray
    inv_kappa: np.ndarray

    @staticmethod
    def build(
        n: int,
        pml: int,
        radius: int,
        h: float,
        dt: float,
        c_max: float,
        f0: float,
        p: float = 2.0,
        r0: float = 1e-6,
        kappa_max: float = 1.0,
        free_lo: bool = False,
        free_hi: bool = False,
        stagger: float = 0.0,
    ) -> "CpmlProfile":
        """Profiles for one axis of physical size ``n`` (padded by
        ``pml + radius`` per side). ``free_lo``/``free_hi`` disable the layer
        on that side (free surface); ``stagger`` offsets the evaluation
        points by that many cells."""
        n_pad = n + 2 * (pml + radius)
        if pml == 0:  # no absorbing layer: zero Dirichlet box
            z = np.zeros(n_pad)
            return CpmlProfile(a=z, b=z, inv_kappa=np.ones(n_pad))
        L = pml * h
        d0 = -(p + 1.0) * c_max * np.log(r0) / (2.0 * L)

        # distance into the PML from the inner interface; ghost cells get
        # the full depth (they are zero-Dirichlet anyway)
        idx = np.arange(n_pad, dtype=np.float64) + float(stagger)
        lo_interface = pml + radius
        hi_interface = pml + radius + n - 1
        depth = np.zeros(n_pad)
        if not free_lo:
            depth_lo = (lo_interface - idx) * h
            depth = np.where(idx < lo_interface, np.clip(depth_lo, 0.0, L), depth)
        if not free_hi:
            depth_hi = (idx - hi_interface) * h
            depth = np.where(idx > hi_interface, np.clip(depth_hi, 0.0, L), depth)

        x = depth / L
        d = d0 * x**p
        alpha = np.pi * f0 * (1.0 - x)
        kappa = 1.0 + (kappa_max - 1.0) * x**p

        b = np.exp(-(d / kappa + alpha) * dt)
        denom = kappa * (d + kappa * alpha)
        a = np.where(denom > 0.0, d * (b - 1.0) / np.where(denom > 0, denom, 1.0), 0.0)

        inside = x > 0.0
        a = np.where(inside, a, 0.0)
        b = np.where(inside, b, 0.0)
        inv_kappa = np.where(inside, 1.0 / kappa, 1.0)
        return CpmlProfile(a=a, b=b, inv_kappa=inv_kappa)

    def broadcast(self, axis: int, ndim: int, dtype=np.float32) -> Tuple[np.ndarray, ...]:
        """(a, b, inv_kappa) reshaped to broadcast along ``axis``."""
        shape = [1] * ndim
        shape[axis] = self.a.shape[0]
        return (
            self.a.reshape(shape).astype(dtype),
            self.b.reshape(shape).astype(dtype),
            self.inv_kappa.reshape(shape).astype(dtype),
        )


def build_profiles(grid, dt: float, c_max: float, f0: float, dtype=np.float32, **kw):
    """Broadcast-ready (a, b, inv_kappa) numpy triples for every axis; the
    low z side honours ``grid.free_surface``."""
    out = []
    z_axis = 0 if grid.ndim == 2 else 1
    for ax in range(grid.ndim):
        prof = CpmlProfile.build(
            n=grid.shape[ax],
            pml=grid.pml,
            radius=grid.radius,
            h=grid.h[ax],
            dt=dt,
            c_max=c_max,
            f0=f0,
            free_lo=(grid.free_surface and ax == z_axis),
            **kw,
        )
        out.append(prof.broadcast(ax, grid.ndim, dtype=dtype))
    return out
