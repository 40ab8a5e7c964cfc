"""The CUDA kernels == their plain torch versions, on the card (2D acoustic
whole-scan, single-step and K-step, elastic whole-scan and per-step, 3D
acoustic whole-scan and per-step, the 3D bench, and the machine-model
probes and their scripts), and the port's spans on the card.

Skips without a CUDA device. Imports no JAX, so it runs where only the
port is installed: ``python -m pytest tests/test_torch_cuda.py -m cuda
--noconftest`` (the suite's conftest imports jax).
Tolerances, explained by fp32 summation order (FMA chains against torch's
separate products): seismogram and final fields 1e-5 of their max, the
ring tape 1e-5 of the field's max; snapshot tape within one bf16 ulp of
its max; gradient and lambda at the sources 1e-4 of their max, each
reverse fed the same tape and cotangent in both runs; the single-step
kernels, each fed its plain version's inputs at every step, with
chip_smoke.py's tolerances. Each whole-scan kernel is also held bitwise
against its per-step oracle, the per-step engine that launches the same
passes a step at a time (chip_smoke.py's ``scanres_*_steps``;
``estep_forward`` and ``estep_reverse``).
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


def _case(device, order, nsrc, free_surface, dup, nt=64, in_ring=False, shape=(48, 72)):
    grid = Grid(shape=shape, h=(10.0, 12.0), pml=10, order=order,
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
    seis, tape, ppen, plast, _ = ks.scanres_forward(*args, w, *idx, tape="snap")
    seis_p, tape_p, ppen_p, plast_p, _ = ks.scanres_forward_plain(*args, w, *idx, "snap")
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


# physical shapes: padded 76 x 100 at order 8 (no axis a multiple of the
# fused passes' 16 x 32 tile) and 64 x 128 (whole tiles)
@pytest.mark.parametrize("shape", [(48, 72), (36, 100)])
@pytest.mark.parametrize("free_surface", [False, True])
@pytest.mark.parametrize("order", [2, 4, 8])
def test_scanres_fused_matches_split_bitwise(device, order, free_surface, shape):
    """scanres_forward's and scanres_reverse_snap's fused steps, with
    dependent launches and in plain stream order, against the same passes
    launched a step at a time (the single-step engine's, per-step oracles
    chip_smoke.scanres_forward_steps / scanres_reverse_snap_steps),
    bitwise: the forward in each mode (no tape, snapshot tape, ring tape,
    illumination without receivers: its fields and illumination) on every
    output, with three sources (one in the ring, one on the surface row
    with the free surface) and coinciding receivers; the reverse on gbar
    and lam_src, fed the fused forward's snapshot tape and a random
    receiver cotangent; each fused call counts nt launches."""
    args, w, (si, ri) = _case(device, order, 3, free_surface, True, nt=96, in_ring=True,
                              shape=shape)
    nt = w.shape[0]
    modes = [dict(tape=None), dict(tape="snap"), dict(tape="rings"), dict(illum=True)]
    f0 = ks.scanres_forward.launches
    for kw in modes:
        ref = chip_smoke.scanres_forward_steps(args, w, si, ri, **kw)
        assert float(ref[3].abs().max()) > 0.0
        rcv = ri[:0] if kw.get("illum") else ri
        for dep in (True, False):
            fused = ks.scanres_forward(*args, w, si, rcv, dependent_launch=dep, **kw)
            for name, a, b in zip(("seis", "tape", "penult", "last", "illum"), fused, ref):
                if rcv is ri or name != "seis":
                    assert (a is None) == (b is None), (kw, name)
                    assert a is None or torch.equal(a, b), (kw, dep, name)
    torch.cuda.synchronize()
    assert ks.scanres_forward.launches - f0 == 2 * len(modes) * nt
    seis, snap, _, _, _ = ks.scanres_forward(*args, w, si, ri, tape="snap")
    gen = torch.Generator(device=device).manual_seed(order)
    ybar = torch.randn(seis.shape, generator=gen, device=device)
    r0 = ks.scanres_reverse_snap.launches
    g_s, ls_s = chip_smoke.scanres_reverse_snap_steps(args, ybar, snap, si, ri)
    assert float(g_s.abs().max()) > 0.0
    for dep in (True, False):
        g_f, ls_f = ks.scanres_reverse_snap(*args, ybar, snap, si, ri, dependent_launch=dep)
        assert torch.equal(g_f, g_s), (dep, float((g_f - g_s).abs().max()))
        assert torch.equal(ls_f, ls_s), dep
    torch.cuda.synchronize()
    assert ks.scanres_reverse_snap.launches - r0 == 2 * nt


def test_scanres_tiles_script_on_the_card(device):
    """The tile sweep at two tiles and a short nt: every tile's steps
    bitwise equal to the engine's own build, positive times, and the
    engine's own library and tile restored after it."""
    from tpufwi_torch.bench import scanres_tiles

    before = (ks.LIBRARY, ks.TILE_Z, ks.TILE_X, ks.TILE_ROWS)
    out = scanres_tiles.main(["16,32,8,6", "32,32,8,4", "--nt", "64"])
    assert len(out) == 4 and all(line["bitwise"] for line in out)
    assert all(ms > 0 for line in out for kernel in ("forward", "reverse", "illumination")
               for ms in line[kernel].values())
    assert (ks.LIBRARY, ks.TILE_Z, ks.TILE_X, ks.TILE_ROWS) == before


def test_cuda_wrapper_raises_instead_of_falling_back(device):
    args, w, idx = _case(device, 8, 1, False, False, nt=8)
    grid, c2, prof = args
    with pytest.raises(ValueError, match="fp32"):
        ks.scanres_forward(grid, c2.double(), prof, w, *idx, tape="snap")
    with pytest.raises(ValueError, match="outside the padded grid"):
        ks.scanres_forward(grid, c2, prof, w, idx[0] + 10_000, idx[1], tape="rings")
    seis, tape, ppen, plast, _ = ks.scanres_forward(grid, c2, prof, w, *idx, tape="rings")
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
    seis, rings, ppen, plast, _ = ks.scanres_forward(*args, w, *idx, tape="rings")
    seis_p, rings_p, ppen_p, plast_p, _ = ks.scanres_forward_plain(*args, w, *idx, "rings")
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


# physical shapes: padded 76 x 100 at order 8 (no axis a multiple of the
# fused step's 16 x 32 tile) and 64 x 128 (whole tiles)
@pytest.mark.parametrize("shape", [(48, 72), (36, 100)])
@pytest.mark.parametrize("free_surface", [False, True])
@pytest.mark.parametrize("order", [2, 4, 8])
def test_scanres_rings_fused_matches_split_bitwise(device, order, free_surface, shape):
    """scanres_reverse's fused step, with dependent launches and in plain
    stream order, against its per-step oracle (cuda_step's merged reverse
    step, chip_smoke.scanres_reverse_steps), bitwise on gbar, lam_src and
    the reconstructed P_{-1}: three sources (one in the boundary ring, one
    on the surface row with the free surface, one on a receiver cell),
    coinciding receivers, fed the kernel forward's ring tape and last
    fields and a random receiver cotangent; each call counts nt launches."""
    args, w, (si, ri) = _case(device, order, 3, free_surface, True, nt=96, in_ring=True,
                              shape=shape)
    ri = torch.cat([ri, si[1:2]])
    seis, rings, ppen, plast, _ = ks.scanres_forward(*args, w, si, ri, tape="rings")
    gen = torch.Generator(device=device).manual_seed(order)
    ybar = torch.randn(seis.shape, generator=gen, device=device)
    r0 = ks.scanres_reverse.launches
    ref = chip_smoke.scanres_reverse_steps(args, w, ybar, rings, ppen, plast, si, ri,
                                           return_field=True)
    assert float(ref[0].abs().max()) > 0.0
    for dep in (True, False):
        got = ks.scanres_reverse(*args, w, ybar, rings, ppen, plast, si, ri, return_field=True,
                                 dependent_launch=dep)
        for name, a, b in zip(("gbar", "lam_src", "field"), got, ref):
            assert torch.equal(a, b), (dep, name, float((a - b).abs().max()))
    torch.cuda.synchronize()
    assert ks.scanres_reverse.launches - r0 == 2 * w.shape[0]


@pytest.mark.parametrize("order,nsrc,free_surface,dup,in_ring", CASES)
def test_step_kernels_match_plain(device, order, nsrc, free_surface, dup, in_ring):
    args, w, idx = _case(device, order, nsrc, free_surface, dup, nt=48, in_ring=in_ring)
    rel, _, _, _ = chip_smoke.step_kernels_vs_plain(args, w, *idx, w.shape[0])
    for name, err in rel.items():
        assert err <= chip_smoke.TOL[name], (name, err)


# ------------------------------------------------------- K-step (20, 21, 7)


@pytest.mark.parametrize("order,nsrc,free_surface,dup,in_ring,nt", [
    (8, 1, False, False, False, 64), (8, 3, True, True, True, 63), (4, 2, False, True, True, 62),
])
def test_kstep_kernels_match_plain(device, order, nsrc, free_surface, dup, in_ring, nt):
    """kstep_forward and kstep_reverse (K = 4; nt 63 and 62 end on a call of
    3 and 2 steps), fused_reverse_step and leapfrog, each fed its plain
    version's state, with chip_smoke.py's tolerances; the K-step wrappers
    count steps, the others calls."""
    args, w, idx = _case(device, order, nsrc, free_surface, dup, nt=nt, in_ring=in_ring)
    names = ("kstep_forward", "kstep_reverse", "fused_reverse_step", "leapfrog")
    before = [chip_smoke.wrapper(k).launches for k in names]
    rel, _, _, _ = chip_smoke.kstep_kernels_vs_plain(args, w, *idx, nt)
    torch.cuda.synchronize()
    assert [chip_smoke.wrapper(k).launches - b for k, b in zip(names, before)] \
        == [nt, nt, nt, 8]
    for name, errs in rel.items():
        for out, err in errs.items():
            assert err <= chip_smoke.TOL[out], (name, out, err)


@pytest.mark.parametrize("free_surface", [False, True])
def test_kstep_and_merged_gradients_match_cuda_step(device, free_surface):
    """cuda_kstep (K = 4 over nt = 150: a last call of 2 steps) and the
    merged cuda_step against the split cuda_step: seismogram and the
    gradients in c2 and the wavelet within chip_smoke.py's STEP_GTOL (the
    same kernels in the same order: bitwise equality is expected)."""
    from tpufwi_torch.adjoint_kstep import make_simulator_kstep
    from tpufwi_torch.adjoint_step import make_simulator_step

    (grid, c2, _), w, idx = _case(device, 8, 2, free_surface, True, nt=150, in_ring=True)
    dt = grid.cfl_dt(2500.0, safety=0.7)
    out = []
    for sim in (make_simulator_step(grid, dt, 14.0, 2500.0),
                make_simulator_step(grid, dt, 14.0, 2500.0, merged_reverse=True),
                make_simulator_kstep(grid, dt, 14.0, 2500.0)):
        args = [x.clone().requires_grad_(True) for x in (c2, w)]
        seis = sim(*args, *idx)
        out.append((seis.detach(), *torch.autograd.grad(0.5 * (seis**2).sum(), args)))
    for got in out[1:]:
        for a, b in zip(got, out[0]):
            assert _rel(a, b) <= chip_smoke.STEP_GTOL


def test_kstep_wrappers_raise_instead_of_falling_back(device):
    from tpufwi_torch.kernels import acoustic2d_kstep as kk
    from tpufwi_torch.kernels import acoustic2d_step as kst

    (grid, c2, prof), w, (si, ri) = _case(device, 8, 1, False, False, nt=8)
    R = grid.radius
    NZ, NX = grid.padded_shape
    z = lambda *s: torch.zeros(s, device=device)  # noqa: E731
    f, cpml, q, adj = z(2, NZ + 2 * R, NX + 2 * R), z(4, NZ + 2 * R, NX + 2 * R), \
        z(2, NZ + 2 * R, NX + 2 * R), z(kst.ADJ_PLANES, NZ + 2 * R, NX + 2 * R)
    seis, gacc, lam = z(8, ri.shape[0]), z(NZ, NX), z(8, 1)
    with pytest.raises(ValueError, match="outside"):
        kk.kstep_forward(grid, c2, prof, f[1], f[0], cpml, w, 6, 4, si, ri, seis)
    with pytest.raises(ValueError, match="tape"):
        kk.kstep_forward(grid, c2, prof, f[1], f[0], cpml, w, 0, 4, si, ri, seis, z(8, 3))
    with pytest.raises(ValueError, match="chain"):
        kk.kstep_reverse(grid, c2, prof, f[0], f[1], q[0], q[1], adj, gacc, w, seis, 4, 4, si,
                         ri, lam)
    with pytest.raises(ValueError, match="ring_row"):
        kst.fused_reverse_step(grid, c2, prof, f[0], f[1], q[0], q[1], adj, gacc, w, seis, 7,
                               si, ri, lam, z(3), torch.zeros(2 * ri.shape[0], dtype=torch.int32,
                                                             device=device))
    with pytest.raises(ValueError, match="fp32"):
        kst.leapfrog(grid, c2.double(), f[0], f[1])


# ------------------------------------------------------------ elastic (8-9)


def _elastic_case(device, source_type, record, free_surface, order, nt, shape=(40, 56),
                  edge=False):
    from tpufwi_torch.propagators.elastic2d import ElasticPropagator, elastic_cfl_dt

    grid = Grid(shape=shape, h=(10.0, 12.0), pml=8, order=order, free_surface=free_surface)
    rng = np.random.default_rng(order + nt)
    vp = np.clip(2300 + 150 * rng.standard_normal(grid.shape), 2000, 2600)
    dt = elastic_cfl_dt(grid.h, 2600.0, order, safety=0.7)
    prop = ElasticPropagator(grid, dt, 14.0, 2600.0, source_type=source_type, record=record,
                             device="cpu")
    mats = tuple(m.to(device).contiguous() for m in prop.material_fields(
        *(torch.as_tensor(x) for x in (vp, vp / 1.8, 1000.0 + 0.3 * vp))))
    prof = tuple(torch.as_tensor(p, device=device).contiguous()
                 for p in ks.strip_profiles(grid, dt, 2600.0, 14.0))
    # a surface source and a surface receiver line (in the boundary ring),
    # a deeper source, and coinciding receivers
    src = np.array([[2, 20], [24, 33]]) + grid.pad
    rx = np.arange(4, 52, 3)
    rcv = np.concatenate([np.stack([np.full(rx.size, 2), rx], 1), [[2, 4], [9, 30]]]) + grid.pad
    if edge:  # two sources and three receivers on a cell of the top ring row (the surface's,
        # on the velocity image's rows), a receiver on the bottom-left ring corner
        top = np.array([0, 20]) + grid.pad
        src = np.stack([top, src[1], top])
        rcv = np.concatenate([[top], rcv, [top, [shape[0] - 1 + grid.pad, grid.pad], top]])
    w = torch.as_tensor(ricker_np(14.0, dt, nt), dtype=torch.float32, device=device)
    idx = tuple(torch.as_tensor(a, dtype=torch.int64, device=device) for a in (src, rcv))
    return (grid, dt, mats, prof), w, idx


@pytest.mark.parametrize("free_surface", [False, True])
@pytest.mark.parametrize("source_type,record,order", [
    ("force_z", "v", 8), ("pressure", "p", 4), ("pressure", "v", 8), ("force_z", "p", 4),
])
def test_elastic_kernels_match_plain(device, source_type, record, order, free_surface):
    """escan_forward / escan_reverse against their plain versions; the
    reverse fed the plain forward's tape, final fields and seismogram."""
    from tpufwi_torch.kernels import elastic2d_scan as ke

    args, w, idx = _elastic_case(device, source_type, record, free_surface, order, nt=120)
    nt = w.shape[0]
    kind = (source_type, record)
    f0, r0 = ke.escan_forward.launches, ke.escan_reverse.launches
    seis, tape, finals = ke.escan_forward(*args, w, *idx, *kind, tape=True)
    seis_p, tape_p, finals_p = ke.escan_forward_plain(*args, w, *idx, *kind, tape=True)
    seis_n, tape_n, _ = ke.escan_forward(*args, w, *idx, *kind, tape=False)
    torch.cuda.synchronize()
    assert ke.escan_forward.launches - f0 == 2 * nt and tape_n is None
    assert _rel(seis, seis_p) <= 1e-5 and _rel(seis_n, seis_p) <= 1e-5
    for got, ref in zip(finals, finals_p):
        assert _rel(got, ref) <= 1e-5
    scale = max(float(f.abs().max()) for f in finals_p)
    assert float((tape - tape_p).abs().max()) <= 1e-5 * scale

    ybar = seis_p.contiguous()
    g, srcrow = ke.escan_reverse(*args, w, ybar, tape_p, finals_p, *idx, *kind)
    g_p, srcrow_p = ke.escan_reverse_plain(*args, w, ybar, tape_p, finals_p, *idx, *kind)
    torch.cuda.synchronize()
    assert ke.escan_reverse.launches - r0 == nt
    for name, got, ref in zip(("lam", "lam2mu", "mu_xz", "buoy_x", "buoy_z"), g, g_p):
        assert _rel(got, ref) <= 1e-4, name
    assert _rel(srcrow, srcrow_p) <= 1e-4


# physical shapes: padded 56 x 72 (neither axis a multiple of the fused
# passes' 16 x 32 tile, several tiles each way) and 64 x 128 (whole tiles)
@pytest.mark.parametrize("shape", [(40, 56), (48, 112)])
@pytest.mark.parametrize("free_surface", [False, True])
@pytest.mark.parametrize("source_type,record", [("force_z", "v"), ("pressure", "p")])
@pytest.mark.parametrize("order", [2, 4, 8])
def test_escan_fused_matches_split_bitwise(device, order, source_type, record, free_surface,
                                            shape):
    """escan_reverse's fused passes, with dependent launches and in plain
    stream order, against its per-step oracle (the per-step engine's
    estep_reverse), bitwise on the five gradient planes and srcrow, fed the
    kernel forward's tape and final fields and a random receiver cotangent;
    each call counts nt launches."""
    from tpufwi_torch.adjoint_elastic_step import estep_reverse
    from tpufwi_torch.kernels import elastic2d_scan as ke

    args, w, idx = _elastic_case(device, source_type, record, free_surface, order, nt=120,
                                 shape=shape)
    kind = (source_type, record)
    seis, tape, finals = ke.escan_forward(*args, w, *idx, *kind, tape=True)
    gen = torch.Generator(device=device).manual_seed(order)
    ybar = torch.randn(seis.shape, generator=gen, device=device)
    r0 = ke.escan_reverse.launches
    g_s, sr_s = estep_reverse(*args, w, ybar, tape, finals, *idx, *kind)
    assert float(g_s[0].abs().max()) > 0.0
    for dep in (True, False):
        g_f, sr_f = ke.escan_reverse(*args, w, ybar, tape, finals, *idx, *kind,
                                     dependent_launch=dep)
        for name, a, b in zip(("lam", "lam2mu", "mu_xz", "buoy_x", "buoy_z"), g_f, g_s):
            assert torch.equal(a, b), (dep, name, float((a - b).abs().max()))
        assert torch.equal(sr_f, sr_s), dep
    torch.cuda.synchronize()
    assert ke.escan_reverse.launches - r0 == 2 * w.shape[0]


@pytest.mark.parametrize("nt", [1, 2, 33])
@pytest.mark.parametrize("free_surface", [False, True])
@pytest.mark.parametrize("source_type,record", [
    ("force_z", "v"), ("pressure", "p"), ("pressure", "v"), ("force_z", "p"),
])
@pytest.mark.parametrize("order", [2, 8])
def test_escan_fused_edge_cases_match_split_bitwise(device, order, source_type, record,
                                                    free_surface, nt):
    """The fused reverse's glue, in the owner threads of er_s and er_v,
    against its per-step oracle (estep_reverse) bitwise on the five
    gradient planes and srcrow where it is hardest to keep the per-step
    engine's order: two sources
    and three receivers on one cell (the chains), sources and receivers on
    ring cells, a source on the free surface's row (its force undone by
    er_v's surface tile row after the image), and nt 1 and 2 (er_setup's first step,
    the zero ring row at t = 0). At nt 1 a pressure source recorded by v
    receivers leaves every output zero (no stress cotangent reaches the
    source or the stress imaging, and sigma before the step is zero), so
    only the other cases must read nonzero."""
    from tpufwi_torch.adjoint_elastic_step import estep_reverse
    from tpufwi_torch.kernels import elastic2d_scan as ke

    args, w, idx = _elastic_case(device, source_type, record, free_surface, order, nt=nt,
                                 edge=True)
    kind = (source_type, record)
    seis, tape, finals = ke.escan_forward(*args, w, *idx, *kind, tape=True)
    gen = torch.Generator(device=device).manual_seed(order + nt)
    ybar = torch.randn(seis.shape, generator=gen, device=device)
    g_s, sr_s = estep_reverse(*args, w, ybar, tape, finals, *idx, *kind)
    if nt > 1 or kind != ("pressure", "v"):
        assert max(float(x.abs().max()) for x in (*g_s, sr_s)) > 0.0
    for dep in (True, False):
        g_f, sr_f = ke.escan_reverse(*args, w, ybar, tape, finals, *idx, *kind,
                                     dependent_launch=dep)
        for name, a, b in zip(("lam", "lam2mu", "mu_xz", "buoy_x", "buoy_z"), g_f, g_s):
            assert torch.equal(a, b), (dep, name, float((a - b).abs().max()))
        assert torch.equal(sr_f, sr_s), dep


@pytest.mark.parametrize("free_surface", [False, True])
@pytest.mark.parametrize("dependent_launch", [True, False])
def test_escan_reverse_launches_as_planned(device, dependent_launch, free_surface):
    """The elastic library's kernels of one short reverse call in a
    torch.profiler window, with dependent launches and in plain stream
    order: ``reverse_launches`` a step times nt, plus the call's own."""
    import collections
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpufwi_torch.kernels import elastic2d_scan as ke

    nt = 12
    args, w, idx = _elastic_case(device, "force_z", "v", free_surface, 8, nt=nt)
    seis, tape, finals = ke.escan_forward(*args, w, *idx, "force_z", "v", tape=True)
    ybar = seis.contiguous()

    def run():
        ke.escan_reverse(*args, w, ybar, tape, finals, *idx, "force_z", "v",
                         dependent_launch=dependent_launch)
        torch.cuda.synchronize()

    run()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
    ours = collections.Counter(
        m.group(1) for e in prof.events() if e.device_type == DeviceType.CUDA
        for m in [re.search(r"::(e[fr]?_\w+?)[<(]", e.name)] if m)
    assert sum(ours.values()) == ke.reverse_launches(free_surface, nt=nt), ours


@pytest.mark.parametrize("dependent_launch", [True, False])
def test_escan_reverse_free_surface_step_is_two_launches(device, dependent_launch):
    """A free-surface reverse step on the card is 2 launches, er_s and er_v,
    whose surface tile row runs the images: the profiler's kernels of a
    12-step call (pressure source, p record) are er_s and er_v 12 times
    each and the call's er_setup and er_image_s_t once, nothing else."""
    import collections
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpufwi_torch.kernels import elastic2d_scan as ke

    nt = 12
    args, w, idx = _elastic_case(device, "pressure", "p", True, 8, nt=nt)
    seis, tape, finals = ke.escan_forward(*args, w, *idx, "pressure", "p", tape=True)
    ybar = seis.contiguous()

    def run():
        ke.escan_reverse(*args, w, ybar, tape, finals, *idx, "pressure", "p",
                         dependent_launch=dependent_launch)
        torch.cuda.synchronize()

    run()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
    ours = collections.Counter(
        m.group(1) for e in prof.events() if e.device_type == DeviceType.CUDA
        for m in [re.search(r"::(e[fr]?_\w+?)[<(]", e.name)] if m)
    assert ours == {"er_s": nt, "er_v": nt, "er_setup": 1, "er_image_s_t": 1}, ours
    assert (sum(ours.values()) - 2) / nt == ke.reverse_launches(True) == 2


@pytest.mark.parametrize("shape", [(40, 56), (48, 112)])
@pytest.mark.parametrize("free_surface", [False, True])
@pytest.mark.parametrize("source_type,record", [("force_z", "v"), ("pressure", "p")])
@pytest.mark.parametrize("order", [2, 4, 8])
def test_escan_forward_fused_matches_split_bitwise(device, order, source_type, record,
                                                   free_surface, shape):
    """escan_forward's fused step, with dependent launches and in plain
    stream order, against its per-step oracle (the per-step engine's
    estep_forward), bitwise on the seismogram, the ring tape and the five
    final fields, and without the tape on the seismogram; coinciding
    sources, coinciding receivers and a receiver on a source cell; each
    call counts nt launches."""
    from tpufwi_torch.kernels import elastic2d_scan as ke
    from tpufwi_torch.kernels.elastic2d_step import estep_forward

    args, w, (si, ri) = _elastic_case(device, source_type, record, free_surface, order,
                                      nt=120, shape=shape)
    si = torch.cat([si, si[:1]])
    ri = torch.cat([ri, si[1:2]])
    kind = (source_type, record)
    f0 = ke.escan_forward.launches
    ref = estep_forward(*args, w, si, ri, *kind, tape=True)
    assert float(ref[0].abs().max()) > 0.0
    for dep in (True, False):
        seis, tape, finals = ke.escan_forward(*args, w, si, ri, *kind, tape=True,
                                              dependent_launch=dep)
        assert torch.equal(seis, ref[0]), (dep, "seis", float((seis - ref[0]).abs().max()))
        assert torch.equal(tape, ref[1]), (dep, "tape", float((tape - ref[1]).abs().max()))
        for name, a, b in zip(("vx", "vz", "sxx", "szz", "sxz"), finals, ref[2]):
            assert torch.equal(a, b), (dep, name, float((a - b).abs().max()))
    seis_n, tape_n, _ = ke.escan_forward(*args, w, si, ri, *kind)
    assert tape_n is None and torch.equal(seis_n, ref[0])
    torch.cuda.synchronize()
    assert ke.escan_forward.launches - f0 == 3 * w.shape[0]


def test_elastic_wrapper_raises_instead_of_falling_back(device):
    from tpufwi_torch.kernels import elastic2d_scan as ke

    (grid, dt, mats, prof), w, idx = _elastic_case(device, "force_z", "v", False, 4, nt=8)
    with pytest.raises(ValueError, match="fp32"):
        ke.escan_forward(grid, dt, (mats[0].double(),) + mats[1:], prof, w, *idx)
    seis, tape, finals = ke.escan_forward(grid, dt, mats, prof, w, *idx, tape=True)
    with pytest.raises(ValueError, match="tape"):
        ke.escan_reverse(grid, dt, mats, prof, w, seis, tape[:-1].contiguous(), finals, *idx)


# ------------------------------------------------------- elastic (10-11)


@pytest.mark.parametrize("source_type,record,order,free_surface", [
    ("force_z", "v", 8, False), ("pressure", "p", 8, True), ("pressure", "v", 4, False),
    ("force_z", "p", 4, True),
])
def test_estep_kernels_match_plain(device, source_type, record, order, free_surface):
    """The four per-step kernels, each fed its plain version's state at
    every step, with chip_smoke.py's tolerances; one launch per call."""
    from tpufwi_torch.kernels import elastic2d_step as kes

    args, w, idx = _elastic_case(device, source_type, record, free_surface, order, nt=60)
    nt = w.shape[0]
    before = [getattr(kes, k).launches for k in chip_smoke.ESTEP_NAMES]
    rel, _, _, _ = chip_smoke.estep_kernels_vs_plain(args, w, *idx, nt, source_type, record)
    torch.cuda.synchronize()
    assert [getattr(kes, k).launches - b for k, b in zip(chip_smoke.ESTEP_NAMES, before)] \
        == [nt] * 4
    for name, err in rel.items():
        assert err <= chip_smoke.ETOL[chip_smoke.ESTEP_TOL[name]], (name, err)


def test_estep_wrapper_raises_instead_of_falling_back(device):
    from tpufwi_torch.kernels import elastic2d_step as kes

    (grid, dt, mats, prof), w, (si, ri) = _elastic_case(device, "force_z", "v", False, 8, nt=8)
    state = kes.zero_elastic_step_state(grid, device=device)
    with pytest.raises(ValueError, match="fp32"):
        kes.estep_v(grid, dt, (mats[0].double(),) + mats[1:], prof, state)
    with pytest.raises(ValueError, match="state.mem"):
        kes.estep_v(grid, dt, mats, prof, state._replace(mem=state.mem[:4]))
    seis = torch.zeros((8, ri.shape[0], 2), device=device)
    with pytest.raises(ValueError, match="ring_row"):
        kes.estep_s(grid, dt, mats, prof, state, w, 0, si, ri, seis, seis[0, 0], "force_z", "v")
    with pytest.raises(ValueError, match="seis"):
        kes.estep_s(grid, dt, mats, prof, state, w, 0, si, ri, seis[:, :, 0].contiguous(),
                    None, "force_z", "v")
    rstate = kes.zero_elastic_reverse_state(grid, device=device)
    srcrow = torch.zeros((8, si.shape[0]), device=device)
    with pytest.raises(ValueError, match="chain"):
        kes.estep_rs(grid, dt, mats, prof, rstate, w, seis, 7, si, ri, srcrow, None, "force_z",
                     "v")
    with pytest.raises(ValueError, match="contiguous fp32"):
        kes.estep_rv(grid, dt, mats, prof, rstate._replace(fields=rstate.fields.cpu()))


@pytest.mark.parametrize("source_type,record,free_surface", [
    ("force_z", "v", False), ("pressure", "p", True),
])
def test_estep_gradient_matches_escan(device, source_type, record, free_surface):
    """cuda_estep's seismogram and five material and wavelet gradients
    against cuda_escan's: the same kernels in the same order (bitwise
    equal expected), bound at 1e-5 of the maximum."""
    from tpufwi_torch.adjoint_elastic_scan import make_elastic_simulator_scan
    from tpufwi_torch.adjoint_elastic_step import make_elastic_simulator_fused

    (grid, dt, mats, _), w, idx = _elastic_case(device, source_type, record, free_surface, 8,
                                                nt=150)
    out = []
    for make in (make_elastic_simulator_scan, make_elastic_simulator_fused):
        sim = make(grid, dt, 14.0, 2600.0, source_type, record)
        args = [x.clone().requires_grad_(True) for x in (*mats, w)]
        seis = sim(*args, *idx)
        out.append((seis.detach(), torch.autograd.grad(0.5 * (seis**2).sum(), args)))
    (seis_a, g_a), (seis_b, g_b) = out
    assert _rel(seis_b, seis_a) <= 1e-5
    for a, b in zip(g_a, g_b):
        assert _rel(b, a) <= 1e-5


def test_marine_shot_escan_matches_estep_bitwise_and_counts_image_steps(device):
    """One marine shot (a water layer, vs = 0, over the solid; the free
    surface; a pressure source; pressure records) through cuda_escan and
    cuda_estep, which run the same per-cell bodies: the seismogram and the
    five material and wavelet gradients bitwise equal. Inside
    ``profiling.recording()`` the reverse call raises ``escan_image_steps``
    by nt, the forward leaves it, and both kernel spans say free_surface."""
    from tpufwi_torch import profiling
    from tpufwi_torch.adjoint_elastic_scan import make_elastic_simulator_scan
    from tpufwi_torch.adjoint_elastic_step import make_elastic_simulator_fused
    from tpufwi_torch.propagators.elastic2d import ElasticPropagator

    nt, water = 300, 12
    (grid, dt, _, _), w, idx = _elastic_case(device, "pressure", "p", True, 8, nt=nt)
    rng = np.random.default_rng(7)
    vp = np.clip(2300 + 150 * rng.standard_normal(grid.shape), 2000, 2600)
    vs, rho = vp / 1.8, 1000.0 + 0.3 * vp
    vp[:water], vs[:water], rho[:water] = 1500.0, 0.0, 1000.0
    prop = ElasticPropagator(grid, dt, 14.0, 2600.0, source_type="pressure", record="p",
                             device="cpu")
    mats = tuple(m.to(device).contiguous() for m in prop.material_fields(
        *(torch.as_tensor(x) for x in (vp, vs, rho))))
    assert float(mats[2][: grid.pad + water - 1].abs().max()) == 0.0  # mu_xz: the water's
    out = []
    for make in (make_elastic_simulator_scan, make_elastic_simulator_fused):
        sim = make(grid, dt, 14.0, 2600.0, "pressure", "p")
        args = [x.clone().requires_grad_(True) for x in (*mats, w)]
        profiling.clear()
        with profiling.recording():
            seis = sim(*args, *idx)
            c0 = profiling.counters()["escan_image_steps"]
            J = 0.5 * (seis**2).sum()
            grads = torch.autograd.grad(J, args)
            c1 = profiling.counters()["escan_image_steps"]
        torch.cuda.synchronize()
        out.append((seis.detach(), grads, c1 - c0, profiling.spans()))
    (seis_a, g_a, steps_a, spans_a), (seis_b, g_b, steps_b, _) = out
    assert seis_a.shape == (nt, idx[1].shape[0]) and float(seis_a.abs().max()) > 0.0
    assert torch.equal(seis_a, seis_b)
    for name, a, b in zip(("lam", "lam2mu", "mu_xz", "buoy_x", "buoy_z", "wavelet"), g_a, g_b):
        assert float(a.abs().max()) > 0.0, name
        assert torch.equal(a, b), (name, float((a - b).abs().max()))
    assert (steps_a, steps_b) == (nt, 0)  # the per-step engine runs no escan_reverse
    kernels = [s for s in spans_a if s.name.startswith("kernels.")]
    assert sorted(s.name for s in kernels) == ["kernels.forward", "kernels.reverse"]
    assert all(s.attrs["free_surface"] is True for s in kernels)
    (rev,) = [s for s in kernels if s.name == "kernels.reverse"]
    assert rev.delta("escan_image_steps") == nt
    profiling.clear()


def test_elastic_objective_agrees_with_the_plain_reference_and_records_its_spans(device):
    """The benchmark's elastic comparison at a small size: a two-shot land
    survey's objective on cuda_escan (``ElasticFwiProblem`` over
    ``ElasticPropagator(impl="auto")``) against ``fwibench/reference_elastic.py``
    in fp32 (seismograms, J, the vp / vs / rho gradients), within the limits of
    ``checks/marmousi2_elastic.survey_grad.json``. The material map and the
    gradient finish record device spans inside ``profiling.recording()``, under
    the propagator call and the engine's reverse, and nothing outside it."""
    from fwibench import check, reference, reference_elastic, spec
    from tpufwi_torch import profiling
    from tpufwi_torch.acquisition import Geometry
    from tpufwi_torch.invert import ElasticFwiProblem
    from tpufwi_torch.propagators.elastic2d import ElasticPropagator

    limits = spec.load_json(spec.HERE / "checks" / "marmousi2_elastic.survey_grad.json")["limits"]
    shape, h, f0, band, nt, vmax = (120, 300), (10.0, 10.0), 12.0, 5.0, 1200, 4700.0
    grid = Grid(shape=shape, h=h, pml=20, order=8)
    dt = reference_elastic.cfl_dt(h, vmax, 8, 0.7)
    z = torch.arange(shape[0], dtype=torch.float64, device=device)[:, None]
    x = torch.arange(shape[1], dtype=torch.float64, device=device)[None, :]
    vp = 1800.0 + 12.0 * z + 150.0 * torch.sin(x / 40.0) * (z > 50)
    true = tuple(f.float() for f in (vp, vp / 1.9, 310.0 * vp**0.25))
    m = tuple((f * (1.0 + 0.01 * torch.cos(x / 25.0 + z / 15.0))).float()
              for f in (vp, vp / 1.9, 310.0 * vp**0.25))
    src = np.array([[[2, 60]], [[2, 237]]])
    rcv = np.stack([np.full(73, 2), np.arange(4, 296, 4)], 1)
    prop = ElasticPropagator(grid, dt, f0, vmax, source_type="force_z", record="v",
                             device=device)
    geoms = Geometry.stack([Geometry.from_physical(grid, s, rcv, device=device) for s in src])
    w_np = ricker_np(f0, dt, nt)
    w = torch.as_tensor(w_np, dtype=torch.float32, device=device)
    with torch.no_grad():
        d_obs = torch.stack([prop(*true, geoms.shot(i), w) for i in range(2)])
    vg, _ = ElasticFwiProblem(prop=prop, geoms=geoms, d_obs=d_obs, wavelet=w,
                              dt=dt).stage_objectives(band)
    assert prop.impl == "cuda_escan"
    profiling.clear()
    vg(m)
    torch.cuda.synchronize()
    assert profiling.spans() == []
    with profiling.recording():
        J, g = vg(m)
        with torch.no_grad():
            seis = torch.stack([prop(*m, geoms.shot(i), w) for i in range(2)])
    torch.cuda.synchronize()
    spans = profiling.spans()
    ids = {s.id: s for s in spans}
    mats = [s for s in spans if s.name == "propagator.materials"]
    finish = [s for s in spans if s.name == "engine.finish"]
    assert len(mats) == 4 and len(finish) == 2  # two shots of vg, two forwards
    assert {ids[s.parent].name for s in mats} == {"propagator.call"}
    assert {ids[s.parent].name for s in finish} == {"engine.reverse"}
    assert all(s.device_s > 0 for s in mats + finish)
    profiling.clear()

    med = reference_elastic.Medium(shape, h, 20, 8, dt, vmax, f0, device=device)
    sv = reference_elastic.make_survey(med, src, np.repeat(rcv[None], 2, 0), w_np,
                                       reference.lowpass_response(nt, dt, band))
    d_f = reference.lowpass(reference_elastic.forward(sv, true)[0], sv.h2, axis=1)
    J_r, g_r, seis_r = reference_elastic.value_and_grad(sv, m, d_f, segment=64)
    got = check.readings(seis, J, g, (seis_r, J_r, g_r))
    assert all(got[k] <= limits[k] for k in got), got


def test_5m_rings_shot_agrees_with_the_plain_reference_and_carries_its_counts(device):
    """The 5 m cell's survey (``marmousi2_acoustic_5m``) on the card: at 701
    x 3401 (749 x 3449 padded) 'auto' resolves to cuda_scanres for the
    cell's nt 9684, the bf16 snapshot tape being over budget; one mid-line
    shot at nt 512 on that engine against ``fwibench/reference.py``'s
    ``value_and_grad`` in fp32 with an fp32 tape (seismograms, J, the vp
    gradient), at the truth times 1 + 3% of a smooth pattern, which the
    direct wave in the water sees within the 512 steps. Tolerances, from
    fp32 summation order (FMA chains against torch's separate products)
    over 512 steps: seismograms 1e-5, J 1e-4, gradient 1e-4. (At the cell's
    +-0.5% random perturbation of the start, which keeps the water, the
    early traces' residual is so small that J and the gradient read their
    rounding hundreds of times magnified: J 2.6e-4, gradient 7.6e-4.) Both kernel
    spans carry the pass's counts: the padded grid, radius, strip depth,
    sources, receivers and the rings tape."""
    from fwibench import check, models, reference, spec
    from tpufwi_torch import profiling
    from tpufwi_torch.acquisition import Geometry
    from tpufwi_torch.filters import apply_response
    from tpufwi_torch.propagators.acoustic2d import AcousticPropagator

    tol = {"seis_err": 1e-5, "J_err": 1e-4, "grad_err": 1e-4}
    c = spec.load_cell("marmousi2_acoustic_5m.survey_grad")
    cfg, nt, seed = c.config, 512, 2**31 + 3
    dt = reference.cfl_dt(c.h, cfg["c_max_mps"], cfg["order"], cfg["cfl"])
    vp_true = models.true_model(cfg, c.shape, seed, device)
    z = torch.arange(c.shape[0], dtype=torch.float32, device=device)[:, None]
    x = torch.arange(c.shape[1], dtype=torch.float32, device=device)[None, :]
    m = (vp_true * (1.0 + 0.03 * torch.cos(x / 50.0 + z / 30.0))).clamp(*cfg["bounds"])
    w_np = reference.ricker(cfg["f0_hz"], dt, nt)
    h2_np = reference.lowpass_response(nt, dt, cfg["band_hz"])
    src, rcv = spec.geometry(c)
    src = src[len(src) // 2]
    grid = Grid(shape=c.shape, h=c.h, pml=cfg["pml"], order=cfg["order"])
    prop = AcousticPropagator(grid, dt, cfg["f0_hz"], cfg["c_max_mps"], device=device)
    assert prop.fix_impl_for(nt=cfg["nt"]) == "cuda_scanres", prop.resolve_note
    assert "snapshot ineligible" in prop.resolve_note
    geom = Geometry.from_physical(grid, src, rcv, device=device)
    w = torch.as_tensor(w_np, dtype=torch.float32, device=device)
    h2 = torch.as_tensor(h2_np, dtype=torch.float32, device=device)
    with torch.no_grad():
        d = prop(vp_true, geom, w)
    v = m.clone().requires_grad_(True)
    profiling.clear()
    with profiling.recording():
        s = prop(v, geom, w)
        J = 0.5 * ((apply_response(s, h2) - apply_response(d, h2)) ** 2).sum()
        (g,) = torch.autograd.grad(J, v)
    torch.cuda.synchronize()
    kernels = {k.name: k for k in profiling.spans() if k.name.startswith("kernels.")}
    profiling.clear()
    counted = dict(nt=nt, NZ=749, NX=3449, radius=4, strip=24, nsrc=1, nrec=1701, tape="rings")
    for name, wrapper in (("kernels.forward", "scanres_forward"),
                          ("kernels.reverse", "scanres_reverse")):
        a = kernels[name].attrs
        assert a["wrapper"] == wrapper and {k: a[k] for k in counted} == counted, a

    med = reference.Medium(c.shape, c.h, cfg["pml"], cfg["order"], dt, cfg["c_max_mps"],
                           cfg["f0_hz"], device=device)
    sv = reference.make_survey(med, src[None], rcv[None], w_np, h2_np)
    d_f = reference.lowpass(reference.forward(sv, vp_true)[0], sv.h2, axis=1)
    J_r, g_r, seis_r = reference.value_and_grad(sv, m, d_f, tape_dtype=torch.float32,
                                                segment=int(c.check["segment"]))
    got = check.readings(s.detach()[None], J.detach(), (g,), (seis_r, J_r, (g_r,)))
    print(f"5 m shot at nt {nt} against the reference: {got}")
    assert float(J_r.sum()) > 0.0 and float(g_r.abs().max()) > 0.0
    assert all(got[k] <= tol[k] for k in tol), got


# ------------------------------------------------------------- 3D (12-17)


def _a3d_case(device, order, free_surface, nt, shape=(20, 24, 28), pml=6):
    """A surface source (in the boundary ring) and a deeper one, a receiver
    carpet at depth 3 with a coinciding pair; with the free surface a source
    and a receiver on the pinned surface row (positions clipped into thin
    grids)."""
    grid = Grid(shape=shape, h=(10.0, 11.0, 12.0), pml=pml, order=order,
                free_surface=free_surface)
    c_max, f0 = 2600.0, 18.0
    dt = grid.cfl_dt(c_max, safety=0.7)
    rng = np.random.default_rng(order + nt)
    vp = np.clip(2200 + 150 * rng.standard_normal(grid.shape), 1900, 2600)
    src = np.array([[10, 2, 14], [12, 13, 9]])
    rcv = [[y, 3, x] for y in range(3, 18, 4) for x in range(3, 26, 4)] + [[7, 3, 7]]
    if free_surface:
        src[1, 1] = 0
        rcv.append([11, 0, 5])
    top = np.array(shape) - 1
    return chip_smoke.a3d_inputs(device, grid, vp, dt, f0, c_max, nt, np.minimum(src, top),
                                 np.minimum(np.array(rcv), top))


@pytest.mark.parametrize("order,free_surface", [(8, False), (8, True), (4, True), (2, False)])
def test_a3d_kernels_match_plain(device, order, free_surface):
    """a3d_forward (no tape, fp32 and bf16 tapes, illumination) and
    a3d_reverse (fp32 and bf16 tapes), their tiled cell passes (the
    default), against their plain versions, with chip_smoke.py's
    tolerances; each wrapper counts nt launches per call."""
    from tpufwi_torch.kernels import acoustic3d_scan as k3

    args, w, si, ri = _a3d_case(device, order, free_surface, nt=100)
    nt = w.shape[0]
    f0, r0 = k3.a3d_forward.launches, k3.a3d_reverse.launches
    errs, _ = chip_smoke.a3d_kernels_vs_plain(args, w, si, ri, reps=1)
    torch.cuda.synchronize()
    # four forward and two reverse variants, each a warm-up and a timed call
    assert k3.a3d_forward.launches - f0 == 8 * nt
    assert k3.a3d_reverse.launches - r0 == 4 * nt
    for name, err in errs.items():
        assert err <= chip_smoke.A3D_TOL[name], (name, err)


# (physical shape, pml): padded 37 x 29 x 53 at every order (every padded
# dimension odd); padded 97 x 41 x 57 at order 8, its interior box (the
# physical grid less R a side: 73 x 17 x 33) one past a multiple of the
# plan's (16, 32) tile in z and x. Shell-heavy: an empty box (a physical
# extent of 2R: the whole grid is shell tiles, and no ring tape fits); a
# box of one full (16, 32) tile; slabs of 13 cells and rows of 88 (2 tiles
# and 24), padded 40 x 55 x 88
A3D_RAGGED = {
    "odd": {8: ((25, 17, 41), 2), 4: ((25, 17, 41), 4), 2: ((27, 19, 43), 4)},
    "tile_plus_one": {8: ((81, 25, 41), 4)},
    "empty_box": {8: ((20, 8, 28), 6), 2: ((21, 2, 30), 3)},
    "one_tile_box": {4: ((20, 20, 36), 3)},
    "ragged_slabs": {8: ((22, 37, 70), 5), 2: ((22, 37, 70), 11)},
}


@pytest.mark.parametrize("cy", ["plan", "one_chunk", 7])
@pytest.mark.parametrize("order,free_surface,shape", [
    (8, False, None), (8, True, None), (4, True, None), (2, False, None), (2, True, None),
    (8, True, "odd"), (4, False, "odd"), (2, True, "odd"), (8, False, "tile_plus_one"),
    (8, True, "tile_plus_one"), (8, False, "empty_box"), (2, True, "empty_box"),
    (4, True, "one_tile_box"), (8, True, "ragged_slabs"), (2, False, "ragged_slabs"),
])
def test_a3d_tiled_matches_gather_bitwise(device, monkeypatch, order, free_surface, shape, cy):
    """The tiled cell passes, one walk each over the grid (the reverse's
    second with the line pass's terms as operands), against the gather ones
    (variant="gather", after the same line pass), bitwise on every output:
    the seismogram and both
    last fields with and without the tape, the fp32 and bf16 tape rows, the
    illumination, and the reverse's gradient, lambda at the sources (fp32
    and bf16 tapes) and reconstructed P_{-1}; with the free surface a source
    and receivers on the pinned row, and on ragged and shell-heavy grids
    (with an empty box, where no ring tape fits, the forward without tape
    and with illumination). These fields fit the L2, so the plan's chunks
    are 1 plane deep: the walk is also run in one chunk of the whole box (of
    the grid when the box is empty) and in chunks of 7 with a ragged last
    one."""
    from tpufwi_torch.kernels import acoustic3d_scan as k3

    kw = {} if shape is None else dict(zip(("shape", "pml"), A3D_RAGGED[shape][order]))
    args, w, si, ri = _a3d_case(device, order, free_surface, nt=48, **kw)
    if cy != "plan":
        plan = k3.a3d_tile_plan
        NY = args[0].padded_shape[0]
        monkeypatch.setattr(k3, "a3d_tile_plan", lambda grid: plan(grid)._replace(
            cy=NY if cy == "one_chunk" else cy))
    diffs, _ = chip_smoke.a3d_variants_bitwise(args, w, si, ri, reps=1)
    torch.cuda.synchronize()
    assert len(diffs) == (4 if shape == "empty_box" else 15)
    assert all(d == 0.0 for d in diffs.values()), diffs


def test_a3d_shell_tiled_cells_counts_the_tiled_shell(device):
    """a3d_shell_tiled_cells rises by the shell's cells x nt at each tiled
    a3d_forward and a3d_reverse call, and stays where it was under
    variant="gather"."""
    from tpufwi_torch import profiling
    from tpufwi_torch.kernels import acoustic3d_scan as k3

    args, w, si, ri = _a3d_case(device, 8, False, nt=16)
    nt, grid = w.shape[0], args[0]
    per_call = k3.shell_cells(grid) * nt
    assert per_call == (40 * 44 * 48 - 12 * 16 * 20) * nt

    def count():
        return profiling.counters()["a3d_shell_tiled_cells"]

    c0 = count()
    seis, tape, ppen, plast, _ = k3.a3d_forward(*args, w, si, ri, torch.float32)
    assert count() - c0 == per_call
    k3.a3d_reverse(*args, w, seis.contiguous(), tape, ppen, plast, si, ri)
    assert count() - c0 == 2 * per_call
    c1 = count()
    seis, tape, ppen, plast, _ = k3.a3d_forward(*args, w, si, ri, torch.float32,
                                                variant="gather")
    k3.a3d_reverse(*args, w, seis.contiguous(), tape, ppen, plast, si, ri, variant="gather")
    torch.cuda.synchronize()
    assert count() == c1


def test_a3d_tcpml_cells_counts_the_line_pass(device):
    """a3d_tcpml_cells rises by the term cells x nt at each a3d_reverse call,
    tiled or gather (both run the line pass), and a3d_forward leaves it."""
    from tpufwi_torch import profiling
    from tpufwi_torch.kernels import acoustic3d_scan as k3

    args, w, si, ri = _a3d_case(device, 8, False, nt=16)
    nt, grid = w.shape[0], args[0]
    per_call = k3.term_cells(grid) * nt
    # (40, 44, 48) padded, S + R = 14: every axis 28 cells of its line
    assert per_call == 28 * (44 * 48 + 40 * 48 + 40 * 44) * nt

    def count():
        return profiling.counters()["a3d_tcpml_cells"]

    c0 = count()
    seis, tape, ppen, plast, _ = k3.a3d_forward(*args, w, si, ri, torch.float32)
    assert count() == c0
    for n, variant in enumerate(k3.VARIANTS, 1):
        k3.a3d_reverse(*args, w, seis.contiguous(), tape, ppen, plast, si, ri, variant=variant)
        assert count() - c0 == n * per_call
    torch.cuda.synchronize()


# (shape, pml, order): the main path's order at a small grid, orders 4 and 2
# on odd extents, and axes shorter than 2R, whose two term bands overlap
A3D_LINES = [((20, 24, 28), 6, 8), ((25, 17, 41), 4, 4), ((27, 19, 43), 4, 2),
             ((6, 3, 29), 3, 8)]


def _a3d_pass_inputs(device, shape, pml, order, seed=0):
    from tpufwi_torch.kernels import acoustic3d_scan as k3
    from tpufwi_torch.kernels.acoustic2d_scanres import strip_profiles

    grid = Grid(shape=shape, h=(10.0, 11.0, 12.0), pml=pml, order=order)
    dt = grid.cfl_dt(2600.0, safety=0.7)
    prof = tuple(torch.as_tensor(p, device=device)
                 for p in strip_profiles(grid, dt, 2600.0, 18.0))
    g = torch.Generator(device=device).manual_seed(seed)
    N, ns = grid.padded_shape, k3.strip_cells(grid)
    lam, lam_next = (torch.randn(N, device=device, generator=g) for _ in range(2))
    c2 = torch.rand(N, device=device, generator=g) * 0.3
    w, pbar = (torch.randn(ns, device=device, generator=g) for _ in range(2))
    return grid, lam, lam_next, c2, prof, w, pbar


@pytest.mark.parametrize("shape,pml,order", A3D_LINES)
def test_a3d_line_pass_matches_plain_fp64(device, shape, pml, order):
    """The line pass alone (a3d_lines: phibar' and each axis's term D2 w -
    D1 y at every cell within S + R of a face) against its plain version in
    fp64 on the same inputs, within 1e-5 of each output's max (fp32 against
    fp64: the measured error is ~1e-7); the slots no cell owns stay zero."""
    from tpufwi_torch.kernels import acoustic3d_scan as k3

    grid, lam, _, c2, prof, w, pbar = _a3d_pass_inputs(device, shape, pml, order)
    pb, t = k3.a3d_lines(grid, lam, c2, prof, w, pbar)
    pb_p, t_p = k3.a3d_lines_plain(grid, lam.double(), c2.double(), prof, w.double(),
                                   pbar.double())
    torch.cuda.synchronize()
    assert t.numel() == k3.strip_cells(grid, k3.term_depth(grid))
    for got, ref in ((pb, pb_p), (t, t_p)):
        assert _rel(got, ref) <= 1e-5
    assert torch.equal(t[t_p == 0], torch.zeros_like(t[t_p == 0]))


@pytest.mark.parametrize("shape,pml,order", A3D_LINES[:3])
def test_a3d_second_pass_walk_matches_gather_bitwise(device, shape, pml, order):
    """The reverse's second cell pass alone (a3d_reverse_pass), the tiled
    walk against its gather variant, bitwise, from the line pass's terms on
    random inputs, one launch and three in a row."""
    from tpufwi_torch.kernels import acoustic3d_scan as k3

    grid, lam, lam_next, c2, prof, w, pbar = _a3d_pass_inputs(device, shape, pml, order, 1)
    base = k3.pass_buffers(grid, lam, c2, prof, other=lam_next, w=w, pbar=pbar)
    k3.a3d_reverse_pass(grid, "lines", base)
    for reps in (1, 3):
        out = {}
        for name in ("walk", "gather"):
            buf = k3.PassBuffers(base.lam, base.other.clone(), base.c2, base.prof, base.strips)
            for _ in range(reps):
                k3.a3d_reverse_pass(grid, name, buf)
            out[name] = buf.other
        torch.cuda.synchronize()
        assert torch.equal(out["walk"], out["gather"])
        assert not torch.equal(out["walk"], base.other)


def test_a3d_walks_hold_two_blocks_an_sm(device):
    """At the 3D main path's order and strip depth every tiled walk runs
    within 64 registers a thread and two blocks an SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor at its largest ring),
    r3_cells2_tiled within 96 KB of shared memory (RESIDENT)."""
    from tpufwi_torch.kernels import acoustic3d_scan as k3

    grid = Grid(shape=(400, 160, 560), h=(25.0,) * 3, pml=10, order=8)
    occ = k3.walk_occupancy(grid)
    assert set(occ) == set(k3.RINGS)
    for kernel, (regs, smem, blocks) in occ.items():
        assert regs <= 64 and blocks == k3.RESIDENT, (kernel, occ[kernel])
        assert smem == k3.ring_bytes(grid.radius, kernel, k3.strip_depth(grid))
    assert occ["r3_cells2_tiled"][1] <= 96 * 1024


def test_a3d_wrapper_raises_instead_of_falling_back(device):
    from tpufwi_torch.kernels import acoustic3d_scan as k3

    (grid, c2, prof), w, si, ri = _a3d_case(device, 8, False, nt=8)
    with pytest.raises(ValueError, match="fp32"):
        k3.a3d_forward(grid, c2.double(), prof, w, si, ri)
    with pytest.raises(ValueError, match="outside the padded grid"):
        k3.a3d_forward(grid, c2, prof, w, si + 10_000, ri)
    with pytest.raises(ValueError, match="variant"):
        k3.a3d_forward(grid, c2, prof, w, si, ri, variant="tiles")
    seis, tape, ppen, plast, _ = k3.a3d_forward(grid, c2, prof, w, si, ri, torch.float32)
    with pytest.raises(ValueError, match="variant"):
        k3.a3d_reverse(grid, c2, prof, w, seis, tape, ppen, plast, si, ri, variant="gathered")
    with pytest.raises(ValueError, match="tape"):
        k3.a3d_reverse(grid, c2, prof, w, seis, tape[:-1].contiguous(), ppen, plast, si, ri)
    with pytest.raises(ValueError, match="tape"):
        k3.a3d_reverse(grid, c2, prof, w, seis, tape.double(), ppen, plast, si, ri)
    buf = k3.pass_buffers(grid, ppen, c2, prof)
    with pytest.raises(ValueError, match="pass"):
        k3.a3d_reverse_pass(grid, "shell", buf)


def test_scanres_illumination_matches_plain(device):
    """The whole-scan forward's illum mode (what every 2D CUDA engine's
    illumination runs, with no receivers) against its plain version, with
    chip_smoke.py's tolerance, on the free surface."""
    args, w, (si, ri) = _case(device, 8, 2, True, False, nt=96)
    f0 = ks.scanres_forward.launches
    il = ks.scanres_forward(*args, w, si, ri[:0], illum=True)[4]
    il_p = ks.scanres_forward_plain(*args, w, si, ri[:0], illum=True)[4]
    torch.cuda.synchronize()
    assert ks.scanres_forward.launches - f0 == w.shape[0]
    assert _rel(il, il_p) <= chip_smoke.TOL["illum"]


# --------------------------------------------------- 3D per-step (14, 19, 22)


def _a3d_step_case(device, order, pml):
    grid = Grid(shape=(20, 24, 28), h=(10.0, 11.0, 12.0), pml=pml, order=order)
    dt = grid.cfl_dt(2600.0, safety=0.7)
    rng = np.random.default_rng(order + pml)
    c2 = ((2200 + 150 * rng.standard_normal(grid.padded_shape)) * dt) ** 2
    return grid, chip_smoke.a3d_step_case(grid, dt, 18.0, 2600.0, c2, device)


@pytest.mark.parametrize("order,pml", [(8, 6), (4, 7), (2, 5)])
def test_a3d_step_kernels_match_plain(device, order, pml):
    """leapfrog3d and strip3d, each fed its plain version's state at every
    step of 24 from a random state (every face active, no two alike), with
    chip_smoke.py's tolerances; one launch per call each."""
    from tpufwi_torch.kernels import acoustic3d_step as k3s
    from tpufwi_torch.kernels import acoustic3d_strips as k3f

    grid, (c2, prof) = _a3d_step_case(device, order, pml)
    l0, s0 = k3s.leapfrog3d.launches, k3f.strip3d.launches
    rel, _, _ = chip_smoke.a3d_step_kernels_vs_plain(grid, c2, prof, 24)
    assert (k3s.leapfrog3d.launches - l0, k3f.strip3d.launches - s0) == (24, 24)
    for kernel, outs in rel.items():
        for out, err in outs.items():
            assert err <= chip_smoke.A3D_STEP_TOL[out], (kernel, out, err)


def test_a3d_step_wrappers_raise_instead_of_falling_back(device):
    from tpufwi_torch.kernels import acoustic3d_step as k3s
    from tpufwi_torch.kernels import acoustic3d_strips as k3f

    grid, (c2, prof) = _a3d_step_case(device, 8, 6)
    p_prev, p, strips = k3f.zero_strip_state(grid, device)
    with pytest.raises(ValueError, match="fp32"):
        k3s.leapfrog3d(grid, p_prev.double(), p, c2)
    with pytest.raises(ValueError, match="distinct"):
        k3s.leapfrog3d(grid, p, p, c2)
    with pytest.raises(ValueError, match="strips and prof"):
        k3f.strip3d(grid, p, p_prev, strips[:-1], prof, c2)
    with pytest.raises(ValueError, match="fp32"):
        k3f.strip3d(grid, p[:, :, :-1], p_prev, strips, prof, c2)


def test_bench_3d_on_the_card(device):
    """Three positive ms/step at a small grid (enough steps that the slope
    is the card's work), and the fused step against the torch-op strips and
    full_step2 over 40 steps from the impulse within 1e-5 of max."""
    from tpufwi_torch.bench import bench_3d

    dims = dict(ny=40, nz=32, nx=48, pml=8, order=8)
    out = bench_3d.bench_3d_step(**dims, nts=(8, 200), device=device)
    assert all(np.isfinite(v["ms_per_step"]) and v["ms_per_step"] > 0 for v in out.values())
    grid, dt = bench_3d.bench_grid(**dims)
    c2 = bench_3d.bench_c2(grid, dt, device)
    runs = bench_3d.make_runs(grid, dt)
    fused = runs["full_step"](c2, 40)
    for name in ("strip_step", "full_step2"):
        assert _rel(fused, runs[name](c2, 40)) <= chip_smoke.A3D_STEP_TOL["bench"], name


# ------------------------------------------------------- the machine-model probes


def _probe_arrays(device, shape=(48, 256, 37), seed=0):
    """pp, p, c2 and eight (NY, NZ, 24) arrays: inner, first and last
    blocks along y and z, an odd NX."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rand = lambda *s: torch.randn(s, generator=gen, device=device)  # noqa: E731
    return rand(*shape), rand(*shape), rand(*shape), [rand(*shape[:2], 24) for _ in range(8)]


@pytest.mark.parametrize("strips", [False, True])
def test_scan_probe_matches_plain(device, strips):
    from tpufwi_torch.bench import exp_2d_scanres
    from tpufwi_torch.kernels import probes as kp

    grid, dt = exp_2d_scanres.probe_grid(20, 110)
    c2, prof, seed = exp_2d_scanres.probe_inputs(grid, dt, device)
    for nt in (31, 32):  # P_nt in either buffer
        args = (grid, c2, prof, seed, 0.999 * seed, nt, strips)
        n0 = kp.scan_probe.launches
        got = kp.scan_probe(*args)
        assert kp.scan_probe.launches - n0 == nt
        assert _rel(got, kp.scan_probe_plain(*args)) <= chip_smoke.PROBE_TOL["scan_probe"]


def test_3d_probes_match_plain(device):
    from tpufwi_torch.kernels import probes as kp

    pp, p, c2, small = _probe_arrays(device)
    tol = chip_smoke.PROBE_TOL["3d"]
    for K in kp.TAP_KS:
        assert _rel(kp.tap_probe(p, K), kp.tap_probe_plain(p, K)) <= tol, K
    for variant in kp.COPY_VARIANTS:
        assert torch.equal(kp.stream_copy(p, variant), p + 1.0), variant
    odd = p[:3, :5, :7].contiguous()  # 105 values: a float4 loop and a tail
    assert torch.equal(kp.stream_copy(odd), odd + 1.0)
    for staged in (False, True):
        for c in (c2, p):  # distinct, and aliased as the reference passes them
            got = kp.stream_step5(pp, p, c, staged)
            assert _rel(got, kp.stream_step5_plain(pp, p, c, staged)) <= tol, staged
    o, so = kp.stream_step5x(pp, p, c2, small)
    o_p, so_p = kp.stream_step5x_plain(pp, p, c2, small)
    for got, ref in zip((o,) + so, (o_p,) + so_p):
        assert _rel(got, ref) <= tol
    n = (kp.tap_probe.launches, kp.stream_copy.launches, kp.stream_step5.launches,
         kp.stream_step5x.launches)
    kp.tap_probe(p, 5), kp.stream_copy(p), kp.stream_step5(pp, p, c2), kp.stream_step5x(
        pp, p, c2, small)
    assert (kp.tap_probe.launches, kp.stream_copy.launches, kp.stream_step5.launches,
            kp.stream_step5x.launches) == tuple(v + 1 for v in n)


def test_stream_copy_variants_bitwise(device):
    """Every copy variant is bitwise p + 1, into a new array and into out=:
    at the probe arrays' shape, at an array whose bytes end inside the bulk
    variant's 16 KB chunk, and (the flat walks) on 105 values, a float4
    walk and a tail of one."""
    from tpufwi_torch.kernels import probes as kp

    _, p, _, _ = _probe_arrays(device)
    ragged = torch.randn((16, 64, 849), device=device)  # 212.25 chunks of 16 KB
    odd = p[:3, :5, :7].contiguous()
    for variant in kp.COPY_VARIANTS:
        by, bz = kp.COPY_TILES[variant]
        for x in (p, ragged) + ((odd,) if (by, bz) == (1, 1) else ()):
            if x.shape[0] % by or x.shape[1] % bz:  # rows of (8, 128), (4, 256)
                continue
            ref = x + 1.0
            assert torch.equal(kp.stream_copy(x, variant), ref), (variant, tuple(x.shape))
            out = torch.full_like(x, float("nan"))
            assert kp.stream_copy(x, variant, out=out) is out
            assert torch.equal(out, ref), (variant, tuple(x.shape))
    with pytest.raises(ValueError, match="out"):
        kp.stream_copy(p, out=p[:, :, :-1])


def test_probe_wrappers_raise_instead_of_falling_back(device):
    from tpufwi_torch.bench import exp_2d_scanres
    from tpufwi_torch.kernels import probes as kp

    pp, p, c2, small = _probe_arrays(device)
    with pytest.raises(ValueError, match="fp32"):
        kp.tap_probe(p.double(), 25)
    with pytest.raises(ValueError, match="K must be"):
        kp.tap_probe(p, 9)
    with pytest.raises(ValueError, match="multiples"):
        kp.stream_step5(pp[:40], p[:40], c2[:40])
    with pytest.raises(ValueError, match="variant"):
        kp.stream_copy(p, "rows2x2")
    with pytest.raises(ValueError, match="aligned"):
        kp.stream_copy(torch.empty(p.numel() + 1, device=device)[1:].view(p.shape), "vec4")
    with pytest.raises(ValueError, match="eight"):
        kp.stream_step5x(pp, p, c2, small[:7])
    grid, dt = exp_2d_scanres.probe_grid(20, 110)
    c2d, prof, seed = exp_2d_scanres.probe_inputs(grid, dt, device)
    with pytest.raises(ValueError, match="fp32"):
        kp.scan_probe(grid, c2d.double(), prof, seed, seed, 4)
    with pytest.raises(ValueError, match="strip profiles"):
        kp.scan_probe(grid, c2d, prof[:3] + (prof[3][:, :, :-1].contiguous(),), seed, seed, 4)


def test_probe_scripts_on_the_card(device):
    """Both probe scripts at small sizes: positive times, and the JSON lines."""
    from tpufwi_torch.bench import exp_2d_scanres, exp_3d_lap

    out2 = exp_2d_scanres.main(["40", "200", "--nts", "64", "512"])
    assert all(v["us_per_step"] > 0 for v in out2.values())
    out3 = exp_3d_lap.main(["merged", "stream", "--dims", "40", "30", "48"])
    # the tap probe's K-slope where the card paces it: on the (96, 128, 96)
    # array a call is host-bound (~20 us) and the slope between K = 5 and 25
    # is noise; on (448, 256, 448) a call moves 0.2 GB, ~0.4 ms
    taps = exp_3d_lap.main(["taps", "--dims", "400", "150", "400"])
    assert taps["taps"]["per_tap_ms"] > 0
    assert all(v["ms_per_call"] > 0 for v in out3["stream"].values())
    assert all(v["leapfrog"] > 0 for v in out3["merged"].values())


# ----------------------------------------------------------- the port's spans


def test_kernel_span_agrees_with_events_around_the_wrapper(device):
    """kernels.forward's device time, from events around the C entry point
    alone, against events around the whole wrapper call: the two end
    together, and the wrapper's interval is longer only by the device's
    wait for the host's set-up outside the C call (the index checks drain
    the stream, then the host allocates), at most that set-up's host time."""
    import time

    from tpufwi_torch import profiling

    args, w, idx = _case(device, 8, 1, False, False, nt=1200, shape=(351, 1701))
    ks.scanres_forward(*args, w, *idx, tape="snap")  # warm the library and the allocator
    torch.cuda.synchronize()
    profiling.clear()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profiling.recording():
        t0 = time.perf_counter()
        a.record()
        ks.scanres_forward(*args, w, *idx, tape="snap")
        b.record()
        host = time.perf_counter() - t0
    torch.cuda.synchronize()
    (k,) = profiling.spans()
    outer = a.elapsed_time(b) * 1e-3
    set_up = host - (k.t1_ns - k.t0_ns) * 1e-9
    assert k.name == "kernels.forward" and k.attrs["nt"] == 1200
    assert k.attrs["tape_bytes"] == 1200 * int(np.prod(args[0].padded_shape)) * 2  # bf16
    assert 0 < k.device_s <= outer <= k.device_s + set_up + 2e-4, (k.device_s, outer, set_up)
    profiling.clear()


def test_no_program_span_on_the_device_timeline(device):
    """One 2D value-and-grad shot inside torch.profiler: every span is a host
    range, none has a twin among the device events, and the shot's device
    time holds its kernels'."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpufwi_torch import profiling
    from tpufwi_torch.acquisition import Geometry
    from tpufwi_torch.invert import FwiProblem
    from tpufwi_torch.propagators.acoustic2d import AcousticPropagator

    grid = Grid(shape=(120, 300), h=(10.0, 10.0), pml=20, order=8)
    dt = grid.cfl_dt(3000.0, safety=0.7)
    prop = AcousticPropagator(grid, dt, 12.0, 3000.0, impl="cuda_scansnap", device=device)
    geoms = Geometry.stack([Geometry.from_physical(
        grid, [[2, 150]], [[2, x] for x in range(0, 300, 2)], device=device)])
    w = torch.as_tensor(ricker_np(12.0, dt, 400), dtype=torch.float32, device=device)
    vp = torch.full(grid.shape, 2500.0, device=device)
    vp[60:] = 3000.0
    with torch.no_grad():
        d = prop(vp, geoms.shot(0), w)[None]
    vg, _ = FwiProblem(prop=prop, geoms=geoms, d_obs=d, wavelet=w, dt=dt).stage_objectives(8.0)
    vg(vp * 0.98)  # warm
    torch.cuda.synchronize()
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        vg(vp * 0.98)
        torch.cuda.synchronize()
    on_device, on_host = set(), set()
    for ev in prof.profiler.kineto_results.events():
        (on_device if ev.device_type() == DeviceType.CUDA else on_host).add(ev.name())
    # every span but the elastic propagator's two
    assert set(profiling.SPANS) - {"propagator.materials", "engine.finish"} <= on_host
    assert not on_device & set(profiling.SPANS), on_device & set(profiling.SPANS)
    spans = profiling.spans()
    (shot,) = [s for s in spans if s.name == "objective.shot"]
    kernels = [s for s in spans if s.name.startswith("kernels.")]
    assert len(kernels) == 2 and sum(k.device_s for k in kernels) <= shot.device_s
    profiling.clear()
