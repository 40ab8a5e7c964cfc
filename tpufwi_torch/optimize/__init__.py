"""Optimizers (counterpart of ``tpufwi/optimize``)."""

from .driver import IterInfo, minimize
from .lbfgs import LbfgsHistory, lbfgs_direction
from .linesearch import backtracking_line_search

__all__ = [
    "IterInfo",
    "LbfgsHistory",
    "backtracking_line_search",
    "lbfgs_direction",
    "minimize",
]
