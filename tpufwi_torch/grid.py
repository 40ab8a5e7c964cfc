"""Grid geometry, CPML padding arithmetic and CFL stability checks.

Counterpart of ``tpufwi/grid.py``. The tap tables and every derived number
are numpy float64 and equal the reference bit for bit; only ``pad_model``
also accepts a torch tensor.

Conventions: 2D arrays are indexed ``(z, x)`` with x the contiguous axis.
A "padded" grid is the physical grid extended by ``pml + radius`` cells on
every side (``pml`` absorbing cells plus ``radius = order // 2`` ghost
cells held at zero).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import numpy as np
import torch

# Second-derivative centred FD coefficients (full symmetric taps), per order;
# divide by h**2 when applying.
D2_COEFFS = {
    2: np.array([1.0, -2.0, 1.0]),
    4: np.array([-1.0 / 12, 4.0 / 3, -5.0 / 2, 4.0 / 3, -1.0 / 12]),
    8: np.array(
        [
            -1.0 / 560,
            8.0 / 315,
            -1.0 / 5,
            8.0 / 5,
            -205.0 / 72,
            8.0 / 5,
            -1.0 / 5,
            8.0 / 315,
            -1.0 / 560,
        ]
    ),
}

# First-derivative centred FD coefficients; divide by h when applying.
D1_COEFFS = {
    2: np.array([-0.5, 0.0, 0.5]),
    4: np.array([1.0 / 12, -2.0 / 3, 0.0, 2.0 / 3, -1.0 / 12]),
    8: np.array(
        [
            1.0 / 280,
            -4.0 / 105,
            1.0 / 5,
            -4.0 / 5,
            0.0,
            4.0 / 5,
            -1.0 / 5,
            4.0 / 105,
            -1.0 / 280,
        ]
    ),
}

# Staggered-grid first-derivative coefficients (Levander 1988), for the
# elastic kernels: ``D f[i+1/2] = sum_k c[k] * (f[i+1+k] - f[i-k]) / h``.
D1_STAGGERED_COEFFS = {
    2: np.array([1.0]),
    4: np.array([9.0 / 8, -1.0 / 24]),
    8: np.array([1225.0 / 1024, -245.0 / 3072, 49.0 / 5120, -5.0 / 7168]),
}


def radius_for_order(order: int) -> int:
    """Stencil half-width for a given spatial FD order."""
    if order not in D2_COEFFS:
        raise ValueError(f"unsupported FD order {order}; choose from {sorted(D2_COEFFS)}")
    return order // 2


def cfl_dt(
    h: Sequence[float] | float,
    c_max: float,
    order: int = 4,
    safety: float = 0.8,
    ndim: int = 2,
) -> float:
    """Largest stable leapfrog timestep: ``dt <= 2 / (c_max sqrt(S sum 1/h^2))``
    with ``S`` the sum of absolute 2nd-derivative weights, scaled by
    ``safety``."""
    if np.isscalar(h):
        h = [float(h)] * ndim
    s = float(np.abs(D2_COEFFS[order]).sum())
    bound = 2.0 / (c_max * math.sqrt(s * sum(1.0 / hd**2 for hd in h)))
    return float(safety * bound)


@dataclasses.dataclass(frozen=True)
class Grid:
    """Physical grid plus absorbing-boundary bookkeeping.

    shape: physical (unpadded) shape; h: spacing per axis in metres;
    pml: CPML thickness in cells; order: spatial FD order (2, 4 or 8);
    free_surface: pressure-release plane at the first physical z row.
    """

    shape: Tuple[int, ...]
    h: Tuple[float, ...]
    pml: int = 20
    order: int = 4
    free_surface: bool = False

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))
        h = self.h
        if np.isscalar(h):
            h = (float(h),) * len(self.shape)
        object.__setattr__(self, "h", tuple(float(x) for x in h))
        if len(self.h) != len(self.shape):
            raise ValueError("h must have one spacing per axis")
        radius_for_order(self.order)  # validate

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def radius(self) -> int:
        return radius_for_order(self.order)

    @property
    def pad(self) -> int:
        """Total padding per side: CPML + stencil ghost cells."""
        return self.pml + self.radius

    @property
    def padded_shape(self) -> Tuple[int, ...]:
        return tuple(s + 2 * self.pad for s in self.shape)

    @property
    def interior(self) -> Tuple[slice, ...]:
        """Slices selecting the physical grid inside a padded array."""
        return tuple(slice(self.pad, self.pad + s) for s in self.shape)

    def cfl_dt(self, c_max: float, safety: float = 0.8) -> float:
        return cfl_dt(self.h, c_max, self.order, safety, self.ndim)

    def check_dt(self, dt: float, c_max: float) -> None:
        limit = self.cfl_dt(c_max, safety=1.0)
        if dt > limit:
            raise ValueError(
                f"dt={dt:.6g} exceeds the CFL stability limit {limit:.6g}"
                f" (c_max={c_max}, h={self.h}, order={self.order})"
            )


def pad_model(field, grid: Grid):
    """Edge-replicate a physical-grid field out to the padded grid (numpy
    array in, numpy out; torch tensor in, differentiable torch out)."""
    pad = grid.pad
    if isinstance(field, np.ndarray):
        return np.pad(field, [(pad, pad)] * grid.ndim, mode="edge")
    if grid.ndim not in (2, 3):
        raise NotImplementedError("the port pads 2D and 3D fields only")
    lead = (None,) * (grid.ndim - 1)  # replicate padding wants (N, C,) leading dims in 3D
    out = torch.nn.functional.pad(field[lead], (pad,) * (2 * grid.ndim), mode="replicate")
    return out[(0,) * (grid.ndim - 1)]
