"""Exact-gradient region of a padded grid (the part of
``tpufwi/propagators/boundary.py::RingSpec`` that ``mask_valid`` needs).

The gradient is exact on the physical interior shrunk by the stencil
radius and defined as zero on the outermost radius-wide frame and in the
padding.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..grid import Grid


@dataclasses.dataclass(frozen=True)
class RingSpec:
    valid: Tuple[slice, ...]

    @staticmethod
    def build(grid: Grid) -> "RingSpec":
        pad, r = grid.pad, grid.radius
        for n in grid.shape:
            if n <= 4 * r:
                raise ValueError(
                    f"grid extent {n} too small for ring width {r} (need > {4*r})"
                )
        return RingSpec(valid=tuple(slice(pad + r, pad + n - r) for n in grid.shape))

    def mask_valid(self, g: torch.Tensor) -> torch.Tensor:
        """Zero ``g`` outside the exact-gradient region."""
        out = torch.zeros_like(g)
        out[self.valid] = g[self.valid]
        return out
