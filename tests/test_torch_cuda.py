"""The CUDA kernels == their plain torch versions, on the card.

Skips without a CUDA device. Imports no JAX, so it runs where only the
port is installed: ``python -m pytest tests/test_torch_cuda.py -m cuda
--noconftest`` (the suite's conftest imports jax).
Tolerances, explained by fp32 summation order (FMA chains against torch's
separate products): seismogram and final fields 1e-5 of their max, the
ring tape 1e-5 of the field's max; snapshot tape within one bf16 ulp of
its max; gradient and lambda at the sources 1e-4 of their max, each
reverse fed the same tape and cotangent in both runs; the single-step
kernels, each fed its plain version's inputs at every step, with
chip_smoke.py's tolerances.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from tpufwi_torch.grid import Grid
from tpufwi_torch.kernels import acoustic2d_scanres as ks
from tpufwi_torch.propagators.boundary import RingSpec
from tpufwi_torch.wavelets import ricker_np

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(device, order, nsrc, free_surface, dup, nt=64, in_ring=False):
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
    if in_ring:  # a source in the boundary ring: the tape wins in the reverse
        src[-1, 0] = grid.radius - 1
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
    seis, tape, ppen, plast = ks.scanres_forward(*args, w, *idx, tape="snap")
    seis_p, tape_p, ppen_p, plast_p = ks.scanres_forward_plain(*args, w, *idx, "snap")
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
        ks.scanres_forward(grid, c2.double(), prof, w, *idx, tape="snap")
    with pytest.raises(ValueError, match="outside the padded grid"):
        ks.scanres_forward(grid, c2, prof, w, idx[0] + 10_000, idx[1], tape="rings")
    seis, tape, ppen, plast = ks.scanres_forward(grid, c2, prof, w, *idx, tape="rings")
    with pytest.raises(ValueError, match="tape"):
        ks.scanres_reverse(grid, c2, prof, w, seis, tape[:-1], ppen, plast, *idx)


CASES = [(8, 1, False, False, False), (8, 3, True, True, True), (4, 2, False, True, True)]


@pytest.mark.parametrize("order,nsrc,free_surface,dup,in_ring", CASES)
def test_rings_kernels_match_plain(device, order, nsrc, free_surface, dup, in_ring):
    # nt = 160: the wave reaches every receiver. Before it arrives the data
    # and the gradient are the 1e-6 precursor, below the fp32 round-off of
    # the reconstruction (there even fp32 and fp64 plain runs differ by 26%)
    args, w, idx = _case(device, order, nsrc, free_surface, dup, nt=160, in_ring=in_ring)
    nt = w.shape[0]
    f0, r0 = ks.scanres_forward.launches, ks.scanres_reverse.launches
    seis, rings, ppen, plast = ks.scanres_forward(*args, w, *idx, tape="rings")
    seis_p, rings_p, ppen_p, plast_p = ks.scanres_forward_plain(*args, w, *idx, "rings")
    torch.cuda.synchronize()
    assert ks.scanres_forward.launches - f0 == nt
    assert tuple(rings.shape) == (nt, RingSpec.build(args[0]).tape_bytes_per_step() // 4)
    for got, ref in ((seis, seis_p), (ppen, ppen_p), (plast, plast_p)):
        assert _rel(got, ref) <= 1e-5
    # the ring rows are field values: their error is held to the field's
    # scale, not to the ring's own maximum
    scale = max(float(rings_p.abs().max()), float(plast_p.abs().max()))
    assert float((rings - rings_p).abs().max()) <= 1e-5 * scale

    ybar = seis_p.contiguous()
    g, ls, p0 = ks.scanres_reverse(*args, w, ybar, rings_p, ppen_p, plast_p, *idx,
                                   return_field=True)
    g_p, ls_p, p0_p = ks.scanres_reverse_plain(*args, w, ybar, rings_p, ppen_p, plast_p, *idx,
                                               return_field=True)
    torch.cuda.synchronize()
    assert ks.scanres_reverse.launches - r0 == nt
    assert _rel(g, g_p) <= 1e-4 and _rel(ls, ls_p) <= 1e-4
    # the reconstruction ends on P_{-1}, zero in exact arithmetic
    assert float((p0 - p0_p).abs().max()) <= 1e-5 * float(plast_p.abs().max())


@pytest.mark.parametrize("order,nsrc,free_surface,dup,in_ring", CASES)
def test_step_kernels_match_plain(device, order, nsrc, free_surface, dup, in_ring):
    args, w, idx = _case(device, order, nsrc, free_surface, dup, nt=48, in_ring=in_ring)
    rel, _, _, _ = chip_smoke.step_kernels_vs_plain(args, w, *idx, w.shape[0])
    for name, err in rel.items():
        assert err <= chip_smoke.TOL[name], (name, err)
