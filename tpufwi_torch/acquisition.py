"""Shot geometry (counterpart of ``tpufwi/acquisition.py``).

Indices are int64 tensors of *padded-grid* cells. A stacked survey is one
``Geometry`` whose index tensors carry a leading shot axis; ``shot(i)``
slices one shot out of it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .grid import Grid


@dataclasses.dataclass(frozen=True)
class Geometry:
    """src_idx: (..., nsrc, ndim), rcv_idx: (..., nrec, ndim) int64 padded
    indices, with an optional leading shot axis."""

    src_idx: torch.Tensor
    rcv_idx: torch.Tensor

    @staticmethod
    def from_physical(grid: Grid, src, rcv, device="cuda") -> "Geometry":
        """Build from (n, ndim) physical-grid cell indices, axis order as the
        array layout; raises on indices outside the physical grid."""
        src = np.atleast_2d(np.asarray(src, dtype=np.int64))
        rcv = np.atleast_2d(np.asarray(rcv, dtype=np.int64))
        for name, arr in (("src", src), ("rcv", rcv)):
            if arr.shape[1] != grid.ndim:
                raise ValueError(f"{name} must be (n, {grid.ndim})")
            if (arr < 0).any() or (arr >= np.array(grid.shape)).any():
                raise ValueError(f"{name} indices outside the physical grid")
        pad = grid.pad
        return Geometry(
            src_idx=torch.as_tensor(src + pad, device=device),
            rcv_idx=torch.as_tensor(rcv + pad, device=device),
        )

    @property
    def nrec(self) -> int:
        return self.rcv_idx.shape[-2]

    @property
    def n_shots(self) -> int:
        return self.src_idx.shape[0] if self.src_idx.ndim == 3 else 1

    def shot(self, i: int) -> "Geometry":
        return Geometry(src_idx=self.src_idx[i], rcv_idx=self.rcv_idx[i])

    @staticmethod
    def stack(geoms) -> "Geometry":
        return Geometry(
            src_idx=torch.stack([g.src_idx for g in geoms]),
            rcv_idx=torch.stack([g.rcv_idx for g in geoms]),
        )


def line_geometry(
    grid: Grid,
    src_z: int,
    src_x: int,
    rcv_z: int,
    rcv_x0: int = 0,
    rcv_x1: int | None = None,
    rcv_dx: int = 1,
    device="cuda",
) -> Geometry:
    """One source and a horizontal receiver line (2D)."""
    if rcv_x1 is None:
        rcv_x1 = grid.shape[1]
    rx = np.arange(rcv_x0, rcv_x1, rcv_dx, dtype=np.int64)
    rcv = np.stack([np.full_like(rx, rcv_z), rx], axis=1)
    return Geometry.from_physical(grid, np.array([[src_z, src_x]]), rcv, device=device)


def split_spread_survey(
    grid: Grid,
    n_shots: int,
    src_z: int,
    rcv_z: int,
    rcv_dx: int = 1,
    device="cuda",
) -> Geometry:
    """n_shots sources evenly spread along x, each recorded by the same full
    receiver line; returns a stacked Geometry with a leading shot axis."""
    nx = grid.shape[1]
    sx = np.linspace(0, nx - 1, n_shots + 2)[1:-1].round().astype(np.int64)
    return Geometry.stack([
        line_geometry(grid, src_z, int(x), rcv_z, rcv_dx=rcv_dx, device=device)
        for x in sx
    ])
