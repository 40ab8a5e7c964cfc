"""Boundary-ring tape: extract and impose the wavefield frame each time step
(counterpart of ``tpufwi/propagators/boundary.py``).

The reverse pass of the boundary-saving adjoint reconstructs the source
wavefield by reverse time-stepping, storing only O(nt * perimeter * radius)
boundary rings instead of the full wavefield.

The ring is the width-``radius`` frame at the outer edge of the interior
(just inside the CPML). Forward updates at interior cells deeper than
``radius`` from the CPML are pure leapfrog, so the reverse recursion is
exact there provided the ring cells are re-imposed from the tape every
step. The gradient is therefore exact on the interior shrunk by ``radius``
and defined as zero on the outermost ``radius``-wide frame of the physical
model and in the padding (``mask_valid``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..grid import Grid


@dataclasses.dataclass(frozen=True)
class RingSpec:
    """Static slicing plan for the boundary ring of a padded grid.

    The frame is tiled by 2*ndim non-overlapping slabs via onion peeling:
    the slab for axis d spans the already-peeled extent on axes < d, the
    full interior on axes > d, and the width-r low/high strips on axis d.
    Slab i covers axis i // 2 (low face for even i, high for odd)."""

    slices: Tuple[Tuple[slice, ...], ...]
    valid: Tuple[slice, ...]  # region where reconstruction/gradient is exact
    tape_dtype: object = None  # None = store rings at wavefield dtype

    @staticmethod
    def build(grid: Grid, width: int | None = None, tape_dtype=None) -> "RingSpec":
        """``width`` overrides the ring thickness (default: the stencil
        radius). ``tape_dtype`` (e.g. ``torch.bfloat16``) stores the ring
        tape compressed: ``extract`` rounds to it, ``impose`` casts back to
        the wavefield dtype; reconstruction is then inexact at ~bf16 eps on
        the ring."""
        pad, r = grid.pad, (grid.radius if width is None else int(width))
        for n in grid.shape:
            if n <= 4 * r:
                raise ValueError(
                    f"grid extent {n} too small for ring width {r} (need > {4*r})"
                )
        slabs = []
        for d in range(grid.ndim):
            base = [slice(pad + r, pad + ni - r) if i < d else slice(pad, pad + ni)
                    for i, ni in enumerate(grid.shape)]
            lo, hi = list(base), list(base)
            lo[d] = slice(pad, pad + r)
            hi[d] = slice(pad + grid.shape[d] - r, pad + grid.shape[d])
            slabs += [tuple(lo), tuple(hi)]
        valid = tuple(slice(pad + r, pad + n - r) for n in grid.shape)
        return RingSpec(slices=tuple(slabs), valid=valid, tape_dtype=tape_dtype)

    def _slab_dims(self, i: int) -> Tuple[int, ...]:
        return tuple(sl.stop - sl.start for sl in self.slices[i])

    def _slab_size(self, i: int) -> int:
        n = 1
        for d in self._slab_dims(i):
            n *= d
        return n

    def extract(self, p: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """The slabs of ``p``, each flattened to 1D (in ``tape_dtype``)."""
        out = []
        for s in self.slices:
            slab = p[s].reshape(-1)
            out.append(slab if self.tape_dtype is None else slab.to(self.tape_dtype))
        return tuple(out)

    def impose(self, p: torch.Tensor, rings) -> torch.Tensor:
        """A copy of ``p`` with its ring cells set from ``rings``."""
        p = p.clone()
        for i, (s, r) in enumerate(zip(self.slices, rings)):
            p[s] = r.reshape(self._slab_dims(i)).to(p.dtype)
        return p

    def zeros_like_rings(self, shape, dtype, device="cpu") -> Tuple[torch.Tensor, ...]:
        return tuple(torch.zeros((self._slab_size(i),), dtype=dtype, device=device)
                     for i in range(len(self.slices)))

    def mask_valid(self, g: torch.Tensor) -> torch.Tensor:
        """Zero ``g`` outside the exact-gradient region."""
        out = torch.zeros_like(g)
        out[self.valid] = g[self.valid]
        return out

    def tape_bytes_per_step(self, dtype_bytes: int = 4) -> int:
        return sum(self._slab_size(i) for i in range(len(self.slices))) * dtype_bytes

    def flat_index(self, padded_shape, device="cpu") -> torch.Tensor:
        """(n_ring,) int64 indices of the ring cells into the flattened
        padded grid, slab after slab in ``extract`` order: the layout of one
        row of the whole-scan and single-step engines' ring tapes."""
        idx = torch.arange(int(torch.tensor(padded_shape).prod()),
                           device=device).reshape(tuple(padded_shape))
        return torch.cat([idx[s].reshape(-1) for s in self.slices])
