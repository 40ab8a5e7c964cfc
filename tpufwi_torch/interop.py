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
from .kernels.acoustic2d_scanres import strip_depth
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


def from_reference_elastic(grid_fields: Mapping, src_idx, rcv_idx, vp, vs, rho, wavelet,
                           device="cuda", dtype=torch.float32):
    """(Grid, Geometry, vp, vs, rho, wavelet) of the port from the
    reference's grid fields, its grid-padded indices, its physical-grid
    (vp, vs, rho) and its wavelet, for ``ElasticPropagator``."""
    grid, geom, vp_t, w_t = from_reference(grid_fields, src_idx, rcv_idx, vp, wavelet,
                                           device=device, dtype=dtype)
    vs_t, rho_t = (torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
                   for x in (vs, rho))
    return grid, geom, vp_t, vs_t, rho_t, w_t


class MpCheckpoint(NamedTuple):
    m: tuple  # the model fields, in order
    stage: int
    iter: int
    alpha: float | None  # None: no accepted step stored
    hist: LbfgsHistory
    scale_tag: str  # hash of the scale vector the history was made under


def load_reference_mp_checkpoint(path, device="cuda", dtype=torch.float32,
                                 lbfgs_m: int = 10) -> MpCheckpoint:
    """Read a ``ckpt_mp.npz`` (keys m0, m1, ..., stage, iter, alpha, S, Y,
    SY, scale_tag) as written by ``tpufwi.invert.invert_elastic`` or by this
    package's ``invert_elastic``."""
    with np.load(path, allow_pickle=False) as ck:
        n = sum(1 for k in ck.files if k[0] == "m" and k[1:].isdigit())
        alpha = float(ck["alpha"])
        return MpCheckpoint(
            m=tuple(torch.as_tensor(ck[f"m{i}"], dtype=dtype, device=device)
                    for i in range(n)),
            stage=int(ck["stage"]),
            iter=int(ck["iter"]),
            alpha=alpha if alpha >= 0 else None,
            hist=LbfgsHistory.from_arrays(ck["S"], ck["Y"], ck["SY"], m=lbfgs_m,
                                          dtype=dtype, device=device),
            scale_tag=str(ck["scale_tag"]),
        )


# the zero borders of the reference's 2D whole-scan buffers (sublane- and
# lane-aligned: tpufwi/kernels/acoustic2d_pallas.py PZ, PX)
PZ, PX = 8, 128


def probe2d_from_reference(grid: Grid, seed_ext, c2_ext) -> tuple:
    """The reference's 2D probe inputs (``scripts/exp_2d_scanres.py``: the
    seed and C on its extended (NZ + 2 PZ, NX + 2 PX) layout) cropped to the
    padded grid, as fp32 numpy arrays (seed, c2) for
    ``kernels/probes.py::scan_probe``."""
    NZ, NX = grid.padded_shape
    out = []
    for a in (seed_ext, c2_ext):
        a = np.asarray(a, np.float32)
        if a.shape != (NZ + 2 * PZ, NX + 2 * PX):
            raise ValueError(f"probe2d_from_reference: {a.shape} is not the extended layout "
                             f"{(NZ + 2 * PZ, NX + 2 * PX)} of {grid.padded_shape}")
        out.append(np.ascontiguousarray(a[PZ:PZ + NZ, PX:PX + NX]))
    return tuple(out)


def strips3d_from_reference(strips, grid: Grid) -> np.ndarray:
    """The reference's v1 3D strip state (``make_acoustic3d_strip_step`` /
    ``make_acoustic3d_fused_step``: per axis y, z, x the slabs (phi_lo,
    psi_lo, phi_hi, psi_hi), each S deep along its axis, on the reference's
    block-extended arrays) as the port's packed ``strips``
    (``kernels/acoustic3d_strips.py``): one flat fp32 array, cropped to the
    padded grid."""
    NY, NZ, NX = grid.padded_shape
    crop = (slice(NY), slice(NZ), slice(NX))
    phis, psis = [], []
    for ax, slabs in enumerate(strips):
        keep = list(crop)
        keep[ax] = slice(None)
        phi_lo, psi_lo, phi_hi, psi_hi = (np.asarray(s)[tuple(keep)] for s in slabs)
        phis.append(np.concatenate([phi_lo, phi_hi], axis=ax).ravel())
        psis.append(np.concatenate([psi_lo, psi_hi], axis=ax).ravel())
    return np.concatenate(phis + psis).astype(np.float32)


def strips3d_to_reference(strips, grid: Grid, extended_shape=None) -> tuple:
    """The port's packed ``strips`` (numpy) as the reference's v1 strip
    state: per axis the slabs (phi_lo, psi_lo, phi_hi, psi_hi), zero-padded
    to ``extended_shape`` (the reference's block-extended field shape; the
    padded grid's by default). The inverse of ``strips3d_from_reference``."""
    NY, NZ, NX = grid.padded_shape
    S = strip_depth(grid)
    ext = tuple(extended_shape or grid.padded_shape)
    flat = np.asarray(strips, np.float32).reshape(-1)
    quantities, off = [], 0
    for _ in range(2):
        per_axis = []
        for ax in range(3):
            shape = [NY, NZ, NX]
            shape[ax] = 2 * S
            n = shape[0] * shape[1] * shape[2]
            arr = flat[off:off + n].reshape(shape)
            off += n
            pad = [(0, e - s) for e, s in zip(ext, (NY, NZ, NX))]
            pad[ax] = (0, 0)
            lo, hi = np.split(arr, 2, axis=ax)
            per_axis.append((np.pad(lo, pad), np.pad(hi, pad)))
        quantities.append(per_axis)
    phis, psis = quantities
    return tuple((phis[ax][0], psis[ax][0], phis[ax][1], psis[ax][1]) for ax in range(3))
