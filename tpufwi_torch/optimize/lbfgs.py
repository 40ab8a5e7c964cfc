"""L-BFGS two-loop recursion with bounded history (counterpart of
``tpufwi/optimize/lbfgs.py``). Pairs failing ``s'y > eps |s| |y|`` are
skipped."""

from __future__ import annotations

from collections import deque
from typing import Deque, Tuple

import numpy as np
import torch


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


class LbfgsHistory:
    def __init__(self, m: int = 10, curvature_eps: float = 1e-10):
        self.m = m
        self.curvature_eps = curvature_eps
        self.pairs: Deque[Tuple[torch.Tensor, torch.Tensor, float]] = deque(maxlen=m)

    def update(self, s: torch.Tensor, y: torch.Tensor) -> bool:
        """Push a new (s, y) pair; returns False if rejected (bad curvature)."""
        sy, ns, ny = torch.stack(
            [_dot(s, y), torch.linalg.vector_norm(s), torch.linalg.vector_norm(y)]
        ).tolist()  # one host sync for the accept/reject decision
        if not (sy > self.curvature_eps * ns * ny) or ns == 0.0 or ny == 0.0:
            return False
        self.pairs.append((s, y, sy))
        return True

    def reset(self):
        self.pairs.clear()

    def __len__(self):
        return len(self.pairs)

    def to_arrays(self):
        """Stacked (S, Y, SY) numpy arrays for np.savez checkpointing."""
        if not self.pairs:
            return np.zeros((0,)), np.zeros((0,)), np.zeros((0,))
        S = np.stack([s.detach().cpu().numpy() for s, _, _ in self.pairs])
        Y = np.stack([y.detach().cpu().numpy() for _, y, _ in self.pairs])
        SY = np.asarray([sy for _, _, sy in self.pairs])
        return S, Y, SY

    @staticmethod
    def from_arrays(S, Y, SY, m: int = 10, dtype=torch.float32, device="cpu") -> "LbfgsHistory":
        h = LbfgsHistory(m=m)
        for i in range(len(SY)):
            h.pairs.append((
                torch.as_tensor(S[i], dtype=dtype, device=device),
                torch.as_tensor(Y[i], dtype=dtype, device=device),
                float(SY[i]),
            ))
        return h


def lbfgs_direction(hist: LbfgsHistory, g: torch.Tensor) -> torch.Tensor:
    """Two-loop recursion: d = -H_k g with a gamma-scaled initial Hessian;
    every dot stays on the device."""
    q = g
    alphas = []
    for s, y, sy in reversed(hist.pairs):
        rho = 1.0 / sy
        a = rho * _dot(s, q)
        q = q - a * y
        alphas.append((a, rho))
    if hist.pairs:
        s, y, sy = hist.pairs[-1]
        gamma = sy / _dot(y, y)
    else:
        gamma = 1.0
    r = gamma * q
    for (s, y, sy), (a, rho) in zip(hist.pairs, reversed(alphas)):
        b = rho * _dot(y, r)
        r = r + (a - b) * s
    return -r
