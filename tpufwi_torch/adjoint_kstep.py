"""K-step boundary-saving adjoint engine (``cuda_kstep``; counterpart of
``tpufwi/adjoint_pallas_kstep.py::make_simulator_pallas_kstep``).

The single-step engine (``adjoint_step.py``) with K time steps per kernel
call: ``kstep_forward`` and ``kstep_reverse`` (``kernels/acoustic2d_kstep.py``)
each run K steps in one cooperative launch, so a propagation costs ceil(nt
/ K) host calls each way instead of nt and 2 nt. The forward takes steps in
chunks of K from t = 0 and the reverse in chunks of K down from t = nt - 1;
the last call of each runs the nt mod K steps that remain, so the gradient
is exactly that of the nt-step problem without the reference's zero-source
padding of nt to a multiple of K. Receivers are gathered by index: there is
no ``rcv_rows`` window and no NaN poisoning. ``impl='auto'`` never picks it.
On CPU tensors the same loops run the kernels' plain versions.
"""

from __future__ import annotations

from .adjoint_step import step_simulator
from .grid import Grid
from .kernels.acoustic2d_kstep import kstep_forward, kstep_reverse


def make_simulator_kstep(grid: Grid, dt: float, f0: float, c_max: float, K: int = 4):
    """``simulate(c2dt2, wavelet, src_idx, rcv_idx) -> seis (nt, nrec)``,
    differentiable in ``c2dt2`` and ``wavelet``, K steps per kernel call."""
    if K < 2:
        raise ValueError(f"the K-step engine needs K >= 2 (K={K}); one step per call is "
                         "cuda_step, with merged_reverse for the merged reverse step")

    def forward_loop(c2dt2, prof, wavelet, src_idx, rcv_idx, cur, prev, cpml, seis, tape):
        nt = wavelet.shape[0]
        for t0 in range(0, nt, K):
            k = min(K, nt - t0)
            kstep_forward(grid, c2dt2, prof, cur, prev, cpml, wavelet, t0, k, src_idx, rcv_idx,
                          seis, tape)
            if k % 2:
                cur, prev = prev, cur
        return prev, cur

    def reverse_loop(c2dt2, prof, wavelet, ybar, src_idx, rcv_idx, p_t, p_tp1, q, q_other, adj,
                     gbar, lam_src, tape, chain):
        top = wavelet.shape[0]
        while top > 0:
            k = min(K, top)
            kstep_reverse(grid, c2dt2, prof, p_t, p_tp1, q, q_other, adj, gbar, wavelet, ybar,
                          top - k, k, src_idx, rcv_idx, lam_src, tape, chain,
                          init_chain=top == wavelet.shape[0])
            if k % 2:
                p_t, p_tp1 = p_tp1, p_t
                q, q_other = q_other, q
            top -= k

    return step_simulator(grid, dt, f0, c_max, "cuda_kstep", forward_loop, reverse_loop)
