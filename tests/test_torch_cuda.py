"""The CUDA scanres kernels == their plain torch versions, on the card.

Skips without a CUDA device. Imports no JAX, so it runs where only the
port is installed: ``python -m pytest tests/test_torch_cuda.py -m cuda
--noconftest`` (the suite's conftest imports jax).
Tolerances, explained by fp32 summation order (FMA chains against torch's
separate products): seismogram and final fields 1e-5 of their max; tape
within one bf16 ulp of its max; gradient and lambda at the sources 1e-4 of
their max, the reverse fed the same tape and cotangent in both runs.
"""

import numpy as np
import pytest
import torch

from tpufwi_torch.grid import Grid
from tpufwi_torch.kernels import acoustic2d_scanres as ks
from tpufwi_torch.wavelets import ricker_np

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(device, order, nsrc, free_surface, dup, nt=64):
    grid = Grid(shape=(48, 72), h=(10.0, 12.0), pml=10, order=order,
                free_surface=free_surface)
    c_max, f0 = 2500.0, 14.0
    dt = grid.cfl_dt(c_max, safety=0.7)
    rng = np.random.default_rng(order + nsrc)
    vp = np.clip(2000 + 200 * rng.standard_normal(grid.shape), 1700, 2500)
    c2 = (np.pad(vp, grid.pad, mode="edge") * dt) ** 2
    src = np.stack([np.full(nsrc, 24), np.linspace(20, 52, nsrc).astype(np.int64)], 1)
    if free_surface:
        src[0, 0] = 0  # a source on the pinned surface row is overwritten
    rx = np.arange(5, 65, 3)
    rcv = np.stack([np.full(rx.size, 5), rx], 1)
    if dup:  # coinciding receivers: injected in a fixed order
        rcv = np.concatenate([rcv, rcv[::4]])
    prof = ks.strip_profiles(grid, dt, c_max, f0)

    def on(x, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=device)

    args = (grid, on(c2), tuple(on(p) for p in prof))
    w = on(ricker_np(f0, dt, nt))
    idx = (on(src + grid.pad, torch.int64), on(rcv + grid.pad, torch.int64))
    return args, w, idx


def _rel(a, b):
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


@pytest.mark.parametrize("order,nsrc,free_surface,dup", [
    (8, 1, False, False), (8, 3, True, True), (4, 2, False, True),
])
def test_kernels_match_plain(device, order, nsrc, free_surface, dup):
    args, w, idx = _case(device, order, nsrc, free_surface, dup)
    nt = w.shape[0]
    f0, r0 = ks.scanres_forward.launches, ks.scanres_reverse_snap.launches
    seis, tape, ppen, plast = ks.scanres_forward(*args, w, *idx, with_tape=True)
    seis_p, tape_p, ppen_p, plast_p = ks.scanres_forward_plain(*args, w, *idx, True)
    torch.cuda.synchronize()
    assert ks.scanres_forward.launches - f0 == nt
    for got, ref in ((seis, seis_p), (ppen, ppen_p), (plast, plast_p)):
        assert _rel(got, ref) <= 1e-5
    ulp = float(tape_p.float().abs().max()) * 2.0**-7
    assert float((tape.float() - tape_p.float()).abs().max()) <= ulp

    ybar = seis_p.contiguous()
    g, ls = ks.scanres_reverse_snap(*args, ybar, tape_p, *idx)
    g_p, ls_p = ks.scanres_reverse_snap_plain(*args, ybar, tape_p, *idx)
    torch.cuda.synchronize()
    assert ks.scanres_reverse_snap.launches - r0 == nt
    assert _rel(g, g_p) <= 1e-4 and _rel(ls, ls_p) <= 1e-4


def test_cuda_wrapper_raises_instead_of_falling_back(device):
    args, w, idx = _case(device, 8, 1, False, False, nt=8)
    grid, c2, prof = args
    with pytest.raises(ValueError, match="fp32"):
        ks.scanres_forward(grid, c2.double(), prof, w, *idx, with_tape=True)
    with pytest.raises(ValueError, match="outside the padded grid"):
        ks.scanres_forward(grid, c2, prof, w, idx[0] + 10_000, idx[1], with_tape=True)
