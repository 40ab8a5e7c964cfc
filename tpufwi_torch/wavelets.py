"""Source time functions (counterpart of ``tpufwi/wavelets.py``)."""

from __future__ import annotations

import numpy as np
import torch


def ricker_np(f0: float, dt: float, nt: int, t0: float | None = None) -> np.ndarray:
    """Ricker wavelet ``(1 - 2 pi^2 f0^2 tau^2) exp(-pi^2 f0^2 tau^2)`` as
    numpy float64; ``t0`` defaults to ``1.5 / f0``."""
    if t0 is None:
        t0 = 1.5 / f0
    t = np.arange(nt) * dt - t0
    arg = (np.pi * f0 * t) ** 2
    return (1.0 - 2.0 * arg) * np.exp(-arg)


def ricker(f0: float, dt: float, nt: int, t0: float | None = None,
           dtype=torch.float32, device="cuda") -> torch.Tensor:
    """:func:`ricker_np` as a tensor of ``dtype`` on ``device``."""
    return torch.as_tensor(ricker_np(f0, dt, nt, t0), dtype=dtype, device=device)
