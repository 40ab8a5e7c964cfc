"""tpufwi_torch: the PyTorch + CUDA port of tpufwi (2D acoustic FWI).

The JAX package ``tpufwi`` is the reference this port is tested against;
this package imports ``torch`` and never ``jax``. Importing it needs
neither CUDA nor nvcc: the CUDA kernels are built at first use on a card.
"""

from .acquisition import Geometry, line_geometry, split_spread_survey
from .grid import Grid, cfl_dt
from .propagators.acoustic2d import AcousticPropagator
from .wavelets import ricker, ricker_np

__all__ = [
    "AcousticPropagator",
    "Geometry",
    "Grid",
    "cfl_dt",
    "line_geometry",
    "ricker",
    "ricker_np",
    "split_spread_survey",
]
