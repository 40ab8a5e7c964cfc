"""Zero-phase low-pass filtering for multiscale frequency continuation
(counterpart of ``tpufwi/filters.py``).

The response is a numpy Butterworth magnitude-squared (zero phase), applied
as a linear convolution through ``torch.fft`` along the time axis, so the
op is linear and differentiable.
"""

from __future__ import annotations

import numpy as np
import torch


def lowpass_response(nt: int, dt: float, fmax: float, order: int = 6) -> np.ndarray:
    """|H(f)|^2 of a Butterworth low-pass for apply_response() on length-nt
    signals, sampled at the rfft frequencies of the 2*nt padded length."""
    f = np.fft.rfftfreq(2 * nt, float(dt))
    return 1.0 / (1.0 + (f / float(fmax)) ** (2 * order))


def apply_response(x: torch.Tensor, h2, axis: int = 0) -> torch.Tensor:
    """Apply a real spectral response sampled at ``rfftfreq(2*nt, dt)`` as a
    linear (2x zero-padded) convolution along ``axis``. An all-ones ``h2``
    is an exact identity."""
    nt = x.shape[axis]
    h2 = torch.as_tensor(h2, dtype=x.dtype, device=x.device)
    shape = [1] * x.ndim
    shape[axis] = h2.shape[0]
    X = torch.fft.rfft(x, n=2 * nt, dim=axis) * h2.reshape(shape)
    return torch.fft.irfft(X, n=2 * nt, dim=axis).to(x.dtype).narrow(axis, 0, nt)


def lowpass(x: torch.Tensor, dt: float, fmax: float, order: int = 6, axis: int = 0):
    """Zero-phase Butterworth low-pass along ``axis`` (default: time)."""
    return apply_response(x, lowpass_response(x.shape[axis], dt, fmax, order), axis=axis)
