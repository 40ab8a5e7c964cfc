"""Carry the reference package's parameters and state across to the port.

Everything crosses as numpy arrays and plain numbers, so this module needs
neither package's runtime objects: pass ``dataclasses.asdict`` of a
reference ``Grid`` and ``np.asarray`` of its arrays.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

import numpy as np
import torch

from .acquisition import Geometry
from .grid import Grid
from .optimize import LbfgsHistory


def from_reference(grid_fields: Mapping, src_idx, rcv_idx, vp, wavelet,
                   device="cuda", dtype=torch.float32):
    """(Grid, Geometry, vp, wavelet) of the port from the reference's grid
    fields (shape, h, pml, order, free_surface), its grid-padded source and
    receiver indices (with or without a leading shot axis), its
    physical-grid velocity and its wavelet."""
    grid = Grid(**dict(grid_fields))
    geom = Geometry(
        src_idx=torch.as_tensor(np.asarray(src_idx), dtype=torch.int64, device=device),
        rcv_idx=torch.as_tensor(np.asarray(rcv_idx), dtype=torch.int64, device=device),
    )
    vp_t = torch.as_tensor(np.asarray(vp), dtype=dtype, device=device)
    w_t = torch.as_tensor(np.asarray(wavelet), dtype=dtype, device=device)
    return grid, geom, vp_t, w_t


class Checkpoint(NamedTuple):
    vp: torch.Tensor
    stage: int
    iter: int
    alpha: float | None  # None: no accepted step stored
    hist: LbfgsHistory


def load_reference_checkpoint(path, device="cuda", dtype=torch.float32,
                              lbfgs_m: int = 10) -> Checkpoint:
    """Read a ``ckpt.npz`` (keys vp, stage, iter, alpha, S, Y, SY) as written
    by ``tpufwi.invert`` or by this package's ``invert``."""
    with np.load(path, allow_pickle=False) as ck:
        alpha = float(ck["alpha"])
        return Checkpoint(
            vp=torch.as_tensor(ck["vp"], dtype=dtype, device=device),
            stage=int(ck["stage"]),
            iter=int(ck["iter"]),
            alpha=alpha if alpha >= 0 else None,
            hist=LbfgsHistory.from_arrays(ck["S"], ck["Y"], ck["SY"], m=lbfgs_m,
                                          dtype=dtype, device=device),
        )
