"""The 3D machine-model probes (counterpart of ``scripts/exp_3d_lap.py``).

    python -m tpufwi_torch.bench.exp_3d_lap [merged|taps|stream|all ...]
        [--dims ny nz nx] [--nts A B] [--reps N] [--device cpu]

What bounds the 3D step kernels on this card, measured at full SEG/EAGE
Overthrust width (``bench_3d.bench_grid``: 801 x 187 x 801 at 25 m, pml 20,
padded 849 x 235 x 849). The probe arrays are the padded grid with y and
z rounded up to the reference's blocks (16, 64): (864, 256, 849) fp32.

- ``taps``: ``kernels/probes.py::tap_probe`` at K = 5 and 25 taps; ms per
  call, and from the K-slope the ms per tap and the effective shared-memory
  read rate (one array's bytes per tap).
- ``stream``: ``stream_copy`` in each of its variants (flat float4 walks:
  a grid-stride loop, a one-shot grid, a TMA bulk pipeline; scalar rows over the (16, 64), (8, 128) and (4, 256) (y, z) tiles, each
  where it divides the array, as the reference skips the others),
  ``stream_step5`` unstaged and staged, and ``stream_step5x``; ms per call
  and GB/s, counting each input read once and each output written once (8
  B/cell for the copy; 16 B/cell for step5, whose halos re-read p; step5x
  also twelve (NY, NZ, 24) streams). The inputs are distinct arrays (the
  reference passed p as C too, and one small array eight times: on the
  card's 50 MB L2 that aliasing would inflate the rate).
- ``merged``: the port's 3D step kernels at orders 8, 4 and 2 (25, 13 and 7
  stencil taps) on the bench grid: ``a3d_forward`` with no tape and no
  receivers from the impulse (``bench_3d``'s ``full_step2``) and
  ``leapfrog3d`` (its ``leapfrog``).

Without a mode, all three run. The reference's ``run_full`` block-shape
variants and its ``x_face`` MXU / VPU / off A/B are TPU tilings and MXU
choices, with no counterpart here (the port has no block extension).
Method, the reference's: the slope between nt = 8 and 40 calls of the
median of 3 timed runs each (after one untimed run); each run ends in a
host read of a sum over its last output. A slope that is not positive
raises. Inputs come from a seeded ``torch.Generator`` on the device.
Prints one JSON line per measurement, with the device it ran on.
``--device cpu`` runs the plain versions (use small ``--dims`` and
``--nts``).
"""

from __future__ import annotations

import argparse
import json

import torch

from ..kernels.probes import (
    BY,
    BZ,
    COPY_TILES,
    SS,
    TAP_KS,
    stream_copy,
    stream_step5,
    stream_step5x,
    tap_probe,
)
from . import bench_3d

MODES = ("merged", "taps", "stream")
ORDERS = (8, 4, 2)
DIMS = (801, 187, 801)
NTS = (8, 40)
REPS = 3


def probe_shape(ny=DIMS[0], nz=DIMS[1], nx=DIMS[2]):
    """The bench grid's padded shape with y and z rounded up to (BY, BZ)."""
    NY, NZ, NX = bench_3d.bench_grid(ny, nz, nx)[0].padded_shape
    return (-(-NY // BY) * BY, -(-NZ // BZ) * BZ, NX)


def randn(shape, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device)


def stream_bytes(shape):
    """{probe: bytes one call must move}: inputs read once, outputs written
    once."""
    NY, NZ, NX = shape
    cells = NY * NZ * NX
    return {"copy": 8 * cells, "step5": 16 * cells, "step5x": 16 * cells + 12 * 4 * NY * NZ * SS}


def _emit(line, device):
    line["device"] = device
    print(json.dumps(line), flush=True)
    return line


def run_taps(shape, device, name, nts=NTS, reps=REPS):
    x = randn(shape, 0, device)
    per = {}
    for K in TAP_KS:
        def run(v, nt, K=K):
            for _ in range(nt):
                v = tap_probe(v, K)
            return v

        per[K] = bench_3d.slope_seconds(run, x, nts, reps, f"tap_probe K={K}")
        _emit({"probe": f"tap_K{K}", "ms_per_call": 1e3 * per[K]}, name)
    per_tap = bench_3d.per_step_seconds(per, TAP_KS, "tap_probe's K-slope")
    return _emit({"probe": "tap", "per_tap_ms": 1e3 * per_tap,
                  "shared_read_GBps": x.numel() * 4 / per_tap / 1e9}, name)


def run_stream(shape, device, name, nts=NTS, reps=REPS):
    nbytes = stream_bytes(shape)
    x = randn(shape, 0, device)
    c2 = randn(shape, 1, device)
    small = [randn(shape[:2] + (SS,), 2 + i, device) for i in range(8)]
    out = {}

    def measure(probe, run, kind):
        per = bench_3d.slope_seconds(run, x, nts, reps, probe)
        out[probe] = _emit({"probe": probe, "ms_per_call": 1e3 * per,
                            "GBps": nbytes[kind] / per / 1e9}, name)

    # the copies write into two preallocated outputs in turn, as the
    # library call they are held against does (no allocation a step)
    outs = (torch.empty_like(x), torch.empty_like(x))
    for variant, (by, bz) in COPY_TILES.items():
        if shape[0] % by or shape[1] % bz:  # as the reference skips them (:374-375)
            continue

        def copy(v, nt, variant=variant):
            for i in range(nt):
                v = stream_copy(v, variant, out=outs[i % 2])
            return v

        measure(f"copy_{variant}", copy, "copy")

    def stepper(step):
        def run(v, nt):
            pp, p = v, 0.5 * v
            for _ in range(nt):
                pp, p = p, step(pp, p)
            return p

        return run

    measure("step5", stepper(lambda pp, p: stream_step5(pp, p, c2)), "step5")
    measure("step5s", stepper(lambda pp, p: stream_step5(pp, p, c2, staged=True)), "step5")
    measure("step5x", stepper(lambda pp, p: stream_step5x(pp, p, c2, small)[0]), "step5x")
    return out


def run_merged(dims, device, name, nts=NTS, reps=REPS):
    out = {}
    for order in ORDERS:
        res = bench_3d.bench_3d_step(*dims, order=order, nts=nts, reps=reps,
                                     which=("full_step2", "leapfrog"), device=device)
        out[order] = _emit({"probe": "merged", "order": order, "taps": 3 * order + 1,
                            **{mode: v["ms_per_step"] for mode, v in res.items()}}, name)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("modes", nargs="*", choices=MODES + ("all",), default="all")
    ap.add_argument("--dims", nargs=3, type=int, default=DIMS, help="ny nz nx of the bench grid")
    ap.add_argument("--nts", nargs=2, type=int, default=NTS)
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("exp_3d_lap: no CUDA device (--device cpu runs the plain versions)")
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    modes = MODES if "all" in args.modes else tuple(m for m in MODES if m in args.modes)
    shape = probe_shape(*args.dims)
    nts = tuple(args.nts)
    out = {}
    if "merged" in modes:
        out["merged"] = run_merged(args.dims, device, name, nts, args.reps)
    if "taps" in modes:
        out["taps"] = run_taps(shape, device, name, nts, args.reps)
    if "stream" in modes:
        out["stream"] = run_stream(shape, device, name, nts, args.reps)
    return out


if __name__ == "__main__":
    main()
