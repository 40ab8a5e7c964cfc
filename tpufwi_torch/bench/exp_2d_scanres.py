"""The 2D whole-scan machine-model probe (counterpart of
``scripts/exp_2d_scanres.py``).

    python -m tpufwi_torch.bench.exp_2d_scanres [nz nx] [--nts A B] [--device cpu]

Times, per time step, the 2D acoustic step without and with its CPML strip
work (``kernels/probes.py::scan_probe``), at the reference's geometry:
``Grid((351, 1701), h=10, pml=12, order=8)`` (padded 383 x 1733), c_max
4700 m/s, f0 12 Hz, dt the CFL step at safety 0.7, C = (2500 dt)^2
everywhere, the seed 1e-3 N(0, 1) from ``numpy.random.default_rng(0)`` on
the padded grid; P_{-1} = seed, P_0 = 0.999 seed, no sources.

- ``P0_leapfrog_only``: the bare leapfrog, one launch a step;
- ``P1_strips_fp32``: the whole-scan forward's strip and cell kernels, and
  ``strip_cost_us`` = P1 - P0, the strip work the production forward pays.

The reference's P1 ran at two MXU precisions (``highest``, ``default``);
that switch has no counterpart: the card computes in fp32 FMA, and a
matmul or convolution here would risk TF32, the hazard ROADMAP names.
Method, the reference's: the slope between nt = 256 and 1280 steps of the
minimum of 5 timed runs each (after one untimed run); each run ends in a
host read of the field's sum of squares, which waits for the card. A
slope that is not positive raises. Prints one JSON line per probe, with
the device it ran on. ``--device cpu`` runs the plain versions (use a
small grid and short ``--nts``).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..grid import Grid
from ..kernels.acoustic2d_scanres import strip_profiles
from ..kernels.probes import scan_probe
from .bench_3d import slope_seconds

SHAPE = (351, 1701)
H, ORDER, PML = 10.0, 8, 12
C_MAX, F0, VP = 4700.0, 12.0, 2500.0
NTS = (256, 1280)
REPS = 5
PROBES = (("P0_leapfrog_only", False), ("P1_strips_fp32", True))


def probe_grid(nz=SHAPE[0], nx=SHAPE[1]):
    """(grid, dt) of the probe."""
    grid = Grid(shape=(nz, nx), h=(H, H), pml=PML, order=ORDER)
    return grid, grid.cfl_dt(C_MAX, safety=0.7)


def probe_inputs(grid: Grid, dt: float, device="cuda"):
    """(c2, profiles, seed) on ``device``: the reference's uniform C, strip
    profiles and seed on the padded grid."""
    NZ, NX = grid.padded_shape
    seed = 1e-3 * np.random.default_rng(0).standard_normal((NZ, NX))
    c2 = torch.full((NZ, NX), float(np.float32((VP * dt) ** 2)), device=device)
    prof = tuple(torch.as_tensor(a, device=device) for a in strip_profiles(grid, dt, C_MAX, F0))
    return c2, prof, torch.as_tensor(seed.astype(np.float32), device=device)


def us_per_step(grid, c2, prof, seed, strips, nts=NTS, reps=REPS, name="probe"):
    """The probe's nt-slope of the minimum of ``reps`` timed runs, in us
    per step; a run is P_nt from (seed, 0.999 seed)."""
    def run(p, nt):
        return scan_probe(grid, c2, prof, p, 0.999 * p, nt, strips)

    return 1e6 * slope_seconds(run, seed, nts, reps, name, pick=min)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dims", nargs="*", type=int, help="nz nx (default 351 1701)")
    ap.add_argument("--nts", nargs=2, type=int, default=NTS)
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.dims and len(args.dims) != 2:
        ap.error("give nz nx, or nothing")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("exp_2d_scanres: no CUDA device (--device cpu runs the plain "
                           "versions)")
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    grid, dt = probe_grid(*(args.dims or SHAPE))
    c2, prof, seed = probe_inputs(grid, dt, device)
    out = {}
    for probe, strips in PROBES:
        us = us_per_step(grid, c2, prof, seed, strips, tuple(args.nts), args.reps, probe)
        line = {"probe": probe, "us_per_step": us, "device": name}
        if strips:
            line["strip_cost_us"] = us - out["P0_leapfrog_only"]["us_per_step"]
        out[probe] = line
        print(json.dumps(line), flush=True)
    return out


if __name__ == "__main__":
    main()
