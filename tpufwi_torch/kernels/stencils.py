"""Shift-and-scale stencils for the plain torch twins (counterpart of
``tpufwi/kernels/stencils.py``).

Built from zero padding and slices, never ``conv2d``: cuDNN runs fp32
convolutions in TF32 by default, which keeps about three decimal digits.
"""

from __future__ import annotations

import torch


def apply_stencil(f: torch.Tensor, taps, axis: int) -> torch.Tensor:
    """``out[i] = sum_k taps[k] * f[i + k - r]`` along ``axis`` (static
    python-float taps, odd length), zero outside."""
    r = len(taps) // 2
    axis = axis % f.ndim
    pad = [0, 0] * f.ndim
    pad[2 * (f.ndim - 1 - axis)] = r  # F.pad lists the last axis first
    pad[2 * (f.ndim - 1 - axis) + 1] = r
    fp = torch.nn.functional.pad(f, pad)
    n = f.shape[axis]
    out = None
    for k, c in enumerate(taps):
        if c == 0.0:
            continue
        term = c * fp.narrow(axis, k, n)
        out = term if out is None else out + term
    return out


def scaled_taps(coeffs, h: float, power: int = 1):
    """Static tuple of python-float taps scaled by 1/h**power."""
    return tuple(float(c) / float(h) ** power for c in coeffs)
