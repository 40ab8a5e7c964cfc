"""Boundary-saving elastic adjoint on the per-step CUDA kernels (counterpart
of ``tpufwi/propagators/elastic2d.py::make_elastic_simulator_fused``; the
engine ``"cuda_estep"``).

Same contract and math as ``adjoint_elastic_scan.make_elastic_simulator_scan``,
with each time step four kernel calls from a Python loop
(``kernels/elastic2d_step.py``):

  forward:  estep_v   (stage V, velocity image)
            estep_s   (stage S, sources, stress image, receivers, ring row)
  backward: estep_rs  (receiver injection, stress-image transpose, source
                       cotangent; reconstruction, imaging and transpose of
                       stage S; velocity-image transpose), then
            estep_rv  (the same for stage V)

in the reference engine's order of operations. Tape contract: row t holds
rings(state after step t), the reverse step t imposes row t-1 (zeros for
t = 0), as in ``cuda_escan``. The whole-scan engine launches the same
kernels in the same order from one C call per propagation; this one pays a
Python and ctypes call per stage and step. ``impl='auto'`` never picks it:
the port gathers receivers by index, so no receiver-slab contract sends a
survey here, as none sends the reference's 2D acoustic 'auto' to its
single-step engine. On CPU tensors the same loops run the kernels' plain
versions.
"""

from __future__ import annotations

import torch

from .grid import Grid
from .kernels.acoustic2d_scanres import ring_plan
from .kernels.elastic2d_scan import _check
from .kernels.elastic2d_step import (
    estep_forward,
    estep_rs,
    estep_rv,
    inner,
    zero_elastic_reverse_state,
)
from .propagators.elastic2d import make_elastic_function


def estep_reverse(grid, dt, mats, profiles, wavelet, ybar, tape, finals, src_idx, rcv_idx,
                  source_type="pressure", record="v"):
    """The per-step reverse loop, with ``escan_reverse``'s contract:
    (grads, srcrow) from the tape and final fields of
    ``estep_forward(..., tape=True)`` and the seismogram's cotangent."""
    dev, dtype = mats[0].device, mats[0].dtype
    nt, nrec, nsrc = wavelet.shape[0], rcv_idx.shape[0], src_idx.shape[0]
    if dev.type == "cuda":  # index bounds: one host sync per propagation
        _check("estep_reverse", grid, mats, profiles, (wavelet, ybar, tape), src_idx, rcv_idx,
               source_type, record)
    n_ring = ring_plan(grid, dev)[0].shape[0]
    if tuple(tape.shape) != (nt, 5 * n_ring):
        raise ValueError(f"estep_reverse: tape must be ({nt}, {5 * n_ring})")
    state = zero_elastic_reverse_state(grid, dtype, dev)
    inner(grid, state.fields).copy_(torch.stack(finals))
    srcrow = torch.empty((nt, nsrc), dtype=dtype, device=dev)
    chain = torch.empty(2 * nrec, dtype=torch.int32, device=dev)
    for t in reversed(range(nt)):
        row = tape[t - 1] if t >= 1 else None
        estep_rs(grid, dt, mats, profiles, state, wavelet, ybar, t, src_idx, rcv_idx, srcrow,
                 row, source_type, record, chain, init_chain=t == nt - 1)
        estep_rv(grid, dt, mats, profiles, state, row)
    return tuple(state.grads), srcrow


def make_elastic_simulator_fused(grid: Grid, dt: float, f0: float, c_max: float,
                                 source_type: str = "pressure", record: str = "v"):
    """``simulate(lam, lam2mu, mu_xz, buoy_x, buoy_z, wavelet, src_idx,
    rcv_idx) -> seis`` with the per-step custom backward. Indices are
    grid-padded (nsrc, 2) and (nrec, 2)."""
    if grid.ndim != 2:
        raise ValueError("the per-step elastic engine is 2D")
    return make_elastic_function(grid, dt, f0, c_max, estep_forward, estep_reverse,
                                 source_type, record)
