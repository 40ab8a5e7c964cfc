"""tpufwi_torch's machine-model probes == the reference's, on the CPU.

- The 2D probe: ``kernels/probes.py::scan_probe_plain`` against the JAX
  ``make_probe`` of ``scripts/exp_2d_scanres.py`` (loaded with importlib; no
  package holds it), run in Pallas interpret mode at a (20, 110) grid, pml
  12, order 8 (padded 52 x 142, so the reference's (8, 128) output window
  fits), nt 32: P0 (leapfrog only) and P1 (the CPML strips, MXU precision
  HIGHEST), within 1e-5 of the window's max (fp32 sums in another order:
  torch's shifted sums against the reference's shift sums and banded
  matrix products).
- The 3D probes: the plain versions against a numpy transcription of the
  reference's kernel bodies and block index maps (``scripts/exp_3d_lap.py``
  :202-220 taps, :308-344 step5 / step5s, :415-426 step5x), at the
  reference's block sizes (16, 64) on small arrays with inner, first and
  last (clamped) blocks, within 1e-6 of max. The reference builds these
  kernels as closures at fixed full sizes, so its JAX functions cannot run
  small. The transcription's scratch margins are zero, the port's contract
  (the TPU never writes them).
- Both probe scripts' ``main`` with ``--device cpu`` at small sizes print
  their JSON lines, and a slope that is not positive raises.
- ``interop.probe2d_from_reference`` crops the reference's extended layout
  exactly.
"""

import functools
import importlib.util
import itertools
import json
from pathlib import Path

import jax
import jax.experimental.pallas as jpl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufwi.grid import Grid as JGrid
from tpufwi.kernels.acoustic2d_pallas import PX, PZ, ext_shape, to_ext
from tpufwi.kernels.acoustic2d_pallas import strip_profiles as j_strip_profiles

from tpufwi_torch.bench import bench_3d, exp_2d_scanres, exp_3d_lap
from tpufwi_torch.grid import Grid
from tpufwi_torch.interop import probe2d_from_reference
from tpufwi_torch.kernels import probes as kp
from tpufwi_torch.kernels.acoustic2d_scanres import strip_profiles

ROOT = Path(__file__).resolve().parents[1]
GRID2D = dict(shape=(20, 110), h=(10.0, 10.0), pml=12, order=8)
NT2D = 32
C_MAX, F0 = 4700.0, 12.0


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


# ---------------------------------------------------------------- 2D probe


@pytest.fixture(scope="module")
def probe2d_ref():
    """The reference probe's inputs on its extended layout and its (8,
    128) windows for P0 and P1 (HIGHEST), run as the script builds them.
    Loading the script sets jax's compilation-cache directory (:32-36); the
    suite's conftest has the cache off, so nothing is written, and the
    setting is restored. Its kernel runs with x64 off (its fori_loop carry
    is i32) and ``pallas_call`` wrapped with ``interpret=True``, also
    restored."""
    cache_dir = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location("exp_2d_scanres_ref",
                                                  ROOT / "scripts" / "exp_2d_scanres.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    grid = JGrid(**GRID2D)
    dt = grid.cfl_dt(C_MAX, safety=0.7)
    EZ, EX = ext_shape(grid)
    NZ, NX = grid.padded_shape
    seed = np.zeros((EZ, EX), np.float32)
    seed[PZ:PZ + NZ, PX:PX + NX] = 1e-3 * np.random.default_rng(0).standard_normal((NZ, NX))
    pallas_call = jpl.pallas_call
    jpl.pallas_call = functools.partial(pallas_call, interpret=True)
    try:
        with jax.enable_x64(False):
            c2 = to_ext(jnp.full((NZ, NX), (2500.0 * dt) ** 2, jnp.float32), "edge")
            prof = j_strip_profiles(grid, dt, C_MAX, F0)
            out = {strips: np.asarray(mod.make_probe(
                grid, NT2D, jax.lax.Precision.HIGHEST if strips else None)(
                    c2, *prof, jnp.asarray(seed)))
                for strips in (False, True)}
    finally:
        jpl.pallas_call = pallas_call
    return dt, seed, np.asarray(c2), out


@pytest.mark.parametrize("strips", [False, True], ids=["P0", "P1"])
def test_scan_probe_matches_reference(probe2d_ref, strips):
    dt, seed_ext, c2_ext, out = probe2d_ref
    grid = Grid(**GRID2D)
    seed, c2 = (torch.as_tensor(a) for a in probe2d_from_reference(grid, seed_ext, c2_ext))
    prof = tuple(torch.as_tensor(a) for a in strip_profiles(grid, dt, C_MAX, F0))
    p = kp.scan_probe(grid, c2, prof, seed, 0.999 * seed, NT2D, strips)
    assert kp.scan_probe.launches == 0  # the CPU path runs the plain version
    assert _rel(p[:8, :128], out[strips]) <= 1e-5
    # the window lies in the top CPML strip: the two probes differ there
    assert _rel(out[True], out[False]) > 0.1


def test_probe2d_from_reference_round_trip():
    grid = Grid(**GRID2D)
    rng = np.random.default_rng(3)
    seed, c2 = (rng.standard_normal(grid.padded_shape).astype(np.float32) for _ in range(2))
    with jax.enable_x64(False):
        ext = [np.asarray(to_ext(jnp.asarray(a), mode)) for a, mode in
               ((seed, "constant"), (c2, "edge"))]
    got = probe2d_from_reference(grid, *ext)
    assert np.array_equal(got[0], seed) and np.array_equal(got[1], c2)
    with pytest.raises(ValueError, match="extended layout"):
        probe2d_from_reference(grid, seed, c2)


# ------------------------------------------------------------- 3D probes


def _ref_taps(x, K):
    """run_vmem_tap_bw.make's kernel (:202-220), block by block, on a zero
    scratch."""
    BY, BZ, NX = 16, 64, x.shape[2]
    r, H8 = 4, 8
    out = np.empty_like(x)
    for gz in range(x.shape[1] // BZ):
        for gy in range(x.shape[0] // BY):
            scr = np.zeros((BY + 2 * r, BZ + 2 * H8, NX + 256), np.float32)
            scr[r:r + BY, H8:H8 + BZ, 128:128 + NX] = x[gy * BY:(gy + 1) * BY,
                                                         gz * BZ:(gz + 1) * BZ]
            acc = None
            for k in range(K):
                dy, dz, dx = 0, 0, 0
                if k % 3 == 0:
                    dy = k % (2 * r + 1)
                elif k % 3 == 1:
                    dz = k % (2 * r + 1)
                else:
                    dx = k % (2 * r + 1)
                t = np.float32(0.1 + 0.01 * k) * scr[
                    dy:dy + BY, H8 + dz - r:H8 + dz - r + BZ, 128 + dx - r:128 + dx - r + NX]
                acc = t if acc is None else acc + t
            out[gy * BY:(gy + 1) * BY, gz * BZ:(gz + 1) * BZ] = acc
    return out


def _ref_step5(pp, p, c2, staged=False):
    """k_step5 / k_step5s (:328-344) over run_stream_bw's grid and index
    maps (:308-323); the halo slabs come from ``p``."""
    BY, BZ, H = 16, 64, 8
    NY, NZ, _ = p.shape
    nyb, nzb = NY // BY, NZ // BZ
    YB8, ZB8 = BY // 8, BZ // 8
    out = np.empty_like(p)
    for gz in range(nzb):
        for gy in range(nyb):
            ys, zs = slice(gy * BY, (gy + 1) * BY), slice(gz * BZ, (gz + 1) * BZ)
            iylo = max(gy * YB8 - 1, 0)
            iyhi = min((gy + 1) * YB8, nyb * YB8 - 1)
            izlo = max(gz * ZB8 - 1, 0)
            izhi = min((gz + 1) * ZB8, nzb * ZB8 - 1)
            ylo = p[iylo * H:(iylo + 1) * H, zs]
            yhi = p[iyhi * H:(iyhi + 1) * H, zs]
            zlo = p[ys, izlo * H:(izlo + 1) * H]
            zhi = p[ys, izhi * H:(izhi + 1) * H]
            if staged:
                o = pp[ys, zs] + c2[ys, zs] + p[ys, zs]
            else:
                o = pp[ys, zs] + p[ys, zs] + c2[ys, zs]
            o[0:H] = o[0:H] + ylo
            o[BY - H:BY] = o[BY - H:BY] + yhi
            o[:, 0:H] = o[:, 0:H] + zlo
            o[:, BZ - H:BZ] = o[:, BZ - H:BZ] + zhi
            out[ys, zs] = o
    return out


def _arrays(shape, n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("K", kp.TAP_KS)
def test_tap_probe_matches_reference(K):
    (x,) = _arrays((32, 128, 12), 1)
    got = kp.tap_probe(torch.as_tensor(x), K)
    assert kp.tap_probe.launches == 0
    assert _rel(got, _ref_taps(x, K)) <= 1e-6


@pytest.mark.parametrize("aliased", [False, True], ids=["distinct", "aliased"])
@pytest.mark.parametrize("staged", [False, True], ids=["step5", "step5s"])
def test_stream_step5_matches_reference(staged, aliased):
    pp, p, c2 = _arrays((48, 192, 12), 3, seed=1)
    if aliased:  # the reference's own call: p passed as C too (:495)
        c2 = p
    got = kp.stream_step5(*map(torch.as_tensor, (pp, p, c2)), staged=staged)
    assert _rel(got, _ref_step5(pp, p, c2, staged)) <= 1e-6


@pytest.mark.parametrize("aliased", [False, True], ids=["distinct", "aliased"])
def test_stream_step5x_matches_reference(aliased):
    pp, p, c2 = _arrays((48, 192, 12), 3, seed=2)
    small = _arrays((48, 192, kp.SS), 8, seed=3)
    if aliased:  # the reference's call: one small array eight times (:453-454)
        small = [small[0]] * 8
    o, so = kp.stream_step5x(*map(torch.as_tensor, (pp, p, c2)),
                             [torch.as_tensor(s) for s in small])
    assert _rel(o, _ref_step5(pp, p, c2)) <= 1e-6
    for i in range(4):  # k_step5x: o_i = s_i + s_{i+4} (:423-426)
        assert np.array_equal(so[i].numpy(), small[i] + small[i + 4])


def test_stream_copy_plain():
    (x,) = _arrays((16, 64, 5), 1)
    for variant in kp.COPY_VARIANTS:
        assert np.array_equal(kp.stream_copy(torch.as_tensor(x), variant).numpy(), x + 1.0)


def test_stream_copy_into_out():
    """``out=`` takes the result (the smoke times the copy and torch.add
    into preallocated arrays alike); the default variant is a flat walk."""
    (x,) = _arrays((16, 64, 5), 1)
    out = torch.full(x.shape, np.nan)
    assert kp.stream_copy(torch.as_tensor(x), out=out) is out
    assert np.array_equal(out.numpy(), x + 1.0)
    assert kp.COPY_TILES[kp.COPY_DEFAULT] == (1, 1)


# ---------------------------------------------------------------- scripts


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


@pytest.fixture
def positive_slope(monkeypatch):
    """Time the scripts' runs by a count, not by the CPU's clock: each run
    still runs, and takes nt times the number of runs so far "seconds", so
    every nt-slope (and the tap probe's K-slope) is positive whatever the
    load. These tests check the scripts' output lines, not their times; the
    scripts' raise on a slope that is not positive is tested below."""
    calls = itertools.count(1)

    def run_seconds(run, arg, nt):
        run(arg, nt)
        return 1e-3 * nt * next(calls)

    monkeypatch.setattr(bench_3d, "run_seconds", run_seconds)


def test_exp_2d_scanres_main_on_cpu(capsys, positive_slope):
    out = exp_2d_scanres.main(["20", "110", "--nts", "2", "6", "--reps", "1", "--device", "cpu"])
    lines = _json_lines(capsys.readouterr().out)
    assert [line["probe"] for line in lines] == ["P0_leapfrog_only", "P1_strips_fp32"]
    assert all(line["device"] == "cpu" and line["us_per_step"] > 0 for line in lines)
    p1 = out["P1_strips_fp32"]
    assert p1["strip_cost_us"] == p1["us_per_step"] - out["P0_leapfrog_only"]["us_per_step"]


def test_exp_3d_lap_main_on_cpu(capsys, positive_slope):
    out = exp_3d_lap.main(["--dims", "4", "6", "5", "--nts", "1", "3", "--reps", "1",
                           "--device", "cpu"])
    probes = [line["probe"] for line in _json_lines(capsys.readouterr().out)]
    assert probes.count("merged") == len(exp_3d_lap.ORDERS)
    assert {"tap_K5", "tap_K25", "tap", "step5", "step5s", "step5x"} <= set(probes)
    # the row tiles that do not divide the (64, 64, 53) array are skipped;
    # the flat walks (vec4, oneshot, bulk) run on any array
    assert {p for p in probes if p.startswith("copy_")} == {"copy_vec4", "copy_rows16x64",
                                                            "copy_oneshot", "copy_bulk"}
    assert exp_3d_lap.probe_shape() == (864, 256, 849)  # the reference's arrays
    assert [v["taps"] for v in out["merged"].values()] == [25, 13, 7]


@pytest.mark.parametrize("script", ["2d", "3d"])
def test_probe_scripts_raise_on_a_slope_that_is_not_positive(monkeypatch, script):
    monkeypatch.setattr(bench_3d, "run_seconds", lambda run, arg, nt: 1.0 / nt)
    with pytest.raises(RuntimeError, match="not positive"):
        if script == "2d":
            exp_2d_scanres.main(["20", "110", "--nts", "2", "6", "--reps", "1", "--device", "cpu"])
        else:
            exp_3d_lap.main(["taps", "--dims", "4", "6", "5", "--nts", "1", "3", "--reps", "1",
                             "--device", "cpu"])
