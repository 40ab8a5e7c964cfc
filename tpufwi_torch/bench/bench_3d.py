"""3D step throughput at SEG/EAGE Overthrust scale (counterpart of
``tpufwi/bench/bench_3d.py``).

    python -m tpufwi_torch.bench.bench_3d [ny nz nx] [--device cpu]

Times cell updates per second of three ways of stepping the 3D acoustic
wave equation from an impulse at the grid's centre:

- ``leapfrog``: the bare leapfrog kernel ``leapfrog3d`` (the reference's
  ``"leapfrog"`` mode, TPU kernel ``make_leapfrog3d_zsplit``);
- ``full_step``: ``leapfrog3d`` then the six-face CPML strip kernel
  ``strip3d`` (``make_acoustic3d_fused_step``; the reference's
  ``"full_step"``, its z-split leapfrog and ``make_strip3d_z/x/y``);
- ``full_step2``: the whole-scan forward kernel ``a3d_forward`` with no
  tape and no receivers (the reference's ``"full_step2"``, its merged
  engine). One source at the centre with ``w[0] = 1 / C[centre]`` and zeros
  after makes P_0 the impulse, so the kernel's P_t is the other modes'
  state after t steps; a run of nt steps is nt + 1 of its steps.

The grid is the reference's: (ny, nz, nx) at 25 m, pml 20, order 8 (padded
849 x 235 x 849 = 169,388,235 cells at the default, each field 678 MB),
C = ((3000 + 100 N(0, 1)) dt)^2 from ``numpy.random.default_rng(0)`` on the
padded grid, dt the CFL step at 6000 m/s and safety 0.7. Method, the
reference's: the slope between nt = 8 and 40 steps of the median of 3
timed runs each (after one untimed run), so the per-run constants (state
set-up, the final reduction, the host's launch latency) cancel. Each run
ends in a host read of sum(p^2), which waits for the card. A slope that is
not positive is noise larger than the work, and raises instead of being
printed as a measurement. On the card every mode launches the port's
kernels; with ``--device cpu`` the same loops run their plain versions.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..grid import Grid
from ..kernels.acoustic2d_scanres import strip_profiles
from ..kernels.acoustic3d_scan import a3d_forward
from ..kernels.acoustic3d_step import leapfrog3d, make_acoustic3d_strip_step
from ..kernels.acoustic3d_strips import make_acoustic3d_fused_step

MODES = ("leapfrog", "full_step", "full_step2")
C_MAX, F0 = 6000.0, 8.0


def bench_grid(ny=801, nz=187, nx=801, pml=20, order=8):
    """(grid, dt) of the benchmark."""
    grid = Grid(shape=(ny, nz, nx), h=(25.0,) * 3, pml=pml, order=order)
    return grid, grid.cfl_dt(C_MAX, safety=0.7)


def bench_c2(grid: Grid, dt: float, device="cuda"):
    """The benchmark's C = (vp dt)^2 on the padded grid, fp32."""
    rng = np.random.default_rng(0)
    vp = (3000.0 + 100.0 * rng.standard_normal(grid.padded_shape)).astype(np.float32)
    return torch.as_tensor((vp * np.float32(dt)) ** 2, device=device)


def make_runs(grid: Grid, dt: float):
    """{mode: run(c2, nt) -> the field after nt steps from the impulse}, for
    the three ``MODES`` and ``"strip_step"``: the leapfrog kernel with the
    strips in torch ops (``make_acoustic3d_strip_step``), the reference
    the fused step is held against."""
    NY, NZ, NX = grid.padded_shape
    centre = (NY // 2, NZ // 2, NX // 2)
    fused, zero_state = make_acoustic3d_fused_step(grid, dt, F0, C_MAX)
    strip_step, _ = make_acoustic3d_strip_step(grid, dt, F0, C_MAX)

    def start(c2):
        p_prev, p, strips = zero_state(c2.device)
        p[centre] = 1.0
        return p_prev, p, strips

    def leapfrog(c2, nt):
        p_prev, p, _ = start(c2)
        for _ in range(nt):
            p_prev, p = p, leapfrog3d(grid, p_prev, p, c2)
        return p

    def stepper(step):
        def run(c2, nt):
            state = start(c2)
            for _ in range(nt):
                state = step(state, c2)
            return state[1]

        return run

    def full_step2(c2, nt):
        dev = c2.device
        prof = tuple(torch.as_tensor(a, device=dev)
                     for a in strip_profiles(grid, dt, C_MAX, F0))
        w = torch.zeros(nt + 1, dtype=torch.float32, device=dev)
        w[0] = 1.0 / c2[centre]
        src = torch.tensor([centre], dtype=torch.int64, device=dev)
        no_rcv = torch.zeros((0, 3), dtype=torch.int64, device=dev)
        return a3d_forward(grid, c2, prof, w, src, no_rcv)[3]

    return {"leapfrog": leapfrog, "full_step": stepper(fused), "full_step2": full_step2,
            "strip_step": stepper(strip_step)}


def per_step_seconds(times, nts, name):
    """The nt-slope of {nt: seconds}; raises when it is not positive."""
    slope = (times[nts[1]] - times[nts[0]]) / (nts[1] - nts[0])
    if not slope > 0:
        raise RuntimeError(f"{name}: nt-slope {slope:.3e} s/step is not positive: the timing "
                           "noise exceeds the work; take more steps (nts)")
    return slope


def run_seconds(run, arg, nt):
    """Host seconds of ``run(arg, nt)`` and a host read of the sum of the
    squares of what it returns, which waits for the card."""
    if arg.device.type == "cuda":
        torch.cuda.synchronize(arg.device)
    t0 = time.perf_counter()
    p = run(arg, nt)
    float((p * p).sum())  # waits for the card
    return time.perf_counter() - t0


def median(ts):
    return sorted(ts)[len(ts) // 2]


def slope_seconds(run, arg, nts, reps, name, pick=median):
    """Seconds per step of ``run(arg, nt)``: the slope between the two
    ``nts`` of ``pick`` of ``reps`` timed runs each, after one untimed run
    (``per_step_seconds``: raises when not positive)."""
    times = {}
    for nt in nts:
        run_seconds(run, arg, nt)
        times[nt] = pick([run_seconds(run, arg, nt) for _ in range(reps)])
    return per_step_seconds(times, nts, name)


def bench_3d_step(ny=801, nz=187, nx=801, pml=20, order=8, nts=(8, 40), reps=3, which=MODES,
                  device="cuda"):
    """{mode: {"ms_per_step", "gcups"}} for each mode of ``which``, printed
    as the reference prints them; cells are the padded grid's."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench_3d: no CUDA device (--device cpu runs the plain versions)")
    grid, dt = bench_grid(ny, nz, nx, pml, order)
    c2 = bench_c2(grid, dt, device)
    cells = c2.numel()
    runs = make_runs(grid, dt)
    out = {}
    for name in which:
        per_step = slope_seconds(runs[name], c2, nts, reps, name)
        out[name] = {"ms_per_step": per_step * 1e3, "gcups": cells / per_step / 1e9}
        print(f"{name}: {per_step * 1e3:.4f} ms/step = {out[name]['gcups']:.2f} Gcu/s "
              f"({cells / 1e6:.0f}M cells)", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dims", nargs="*", type=int, help="ny nz nx (default 801 187 801)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dims = args.dims or [801, 187, 801]
    if len(dims) != 3:
        ap.error("give ny nz nx, or nothing")
    return bench_3d_step(*dims, device=args.device)


if __name__ == "__main__":
    main()
