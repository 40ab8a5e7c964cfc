"""The fused elastic forward's material loads before or after its wait on
the step before it, timed on the card.

    python -m tpufwi_torch.bench.escan_forward_loads [--nt N]

``escan_forward(variant="fused")`` launches each step's stage V and
``ef_s_fused`` as programmatic dependents of the kernel before them; the
engine's ``ef_s_fused`` copies the three material planes it reads (no step
writes them) before it waits (``griddepcontrol.wait``), so those copies
overlap stage V's drain. This script builds a second elastic library from a source that
defines ``TPUFWI_EF_WAIT_FIRST 1`` (the wait ahead of every load) and
includes the engine's, then, at the elastic main path's grid (the land
model, 351 x 1701 at 10 m, order 8, pml 20: padded 399 x 1749; a force
source and a receiver line at depth 2, every other column; nt steps with
the ring tape), holds the two builds bitwise against each other and
against the split passes, and times ms a step of each by CUDA events in
the same calls, in the order engine, wait-first, wait-first, engine, two
rounds. Prints one JSON line per round, with the card's name and power
limit. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess

import numpy as np
import torch

from ..adjoint_scanres import profile_source
from ..grid import Grid
from ..io import marmousi_like
from ..kernels import elastic2d_scan as ke
from ..kernels.build import BUILD_DIR, CSRC, Library
from ..propagators.elastic2d import ElasticPropagator, elastic_cfl_dt
from ..wavelets import ricker_np


def wait_first_library() -> Library:
    """The elastic entry points with ``ef_s_fused``'s wait ahead of its
    copies."""
    stem = "elastic2d_wait_first"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = BUILD_DIR / f"{stem}.cu"
    src.write_text("#define TPUFWI_EF_WAIT_FIRST 1\n"
                   f'#include "{CSRC / "elastic2d_scan.cu"}"\n'
                   f'#include "{CSRC / "elastic2d_step.cu"}"\n')
    return Library(stem, (src,), (*ke.LIBRARY.sources, *ke.LIBRARY.headers), ke.LIBRARY.declare)


def main_path_shot(dev, nt):
    """(grid, dt, mats, profiles), wavelet, src_idx, rcv_idx of one mid-line
    surface shot on the elastic main path's grid."""
    vp, dx = marmousi_like(nz=351, nx=1701, dx=10.0, water_depth_m=0.0)
    grid = Grid(shape=vp.shape, h=(dx, dx), pml=20, order=8)
    vp_max, f0 = float(vp.max()), 12.0
    dt = elastic_cfl_dt(grid.h, vp_max, 8, safety=0.7)

    def on(x, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=dev)

    prop = ElasticPropagator(grid, dt, f0, vp_max, source_type="force_z", record="v",
                             device=dev)
    mats = tuple(m.contiguous() for m in prop.material_fields(
        *(on(x) for x in (vp, vp / 1.9, 310.0 * vp**0.25))))
    rx = np.arange(4, vp.shape[1] - 4, 2)
    src = on(np.array([[2, vp.shape[1] // 2]]) + grid.pad, torch.int64)
    rcv = on(np.stack([np.full(rx.size, 2), rx], 1) + grid.pad, torch.int64)
    return ((grid, dt, mats, profile_source(grid, dt, f0, vp_max)(mats[0])),
            on(ricker_np(f0, dt, nt)), src, rcv)


def ms_per_step(fn, nt, calls=3):
    """ms a step of ``calls`` calls of ``fn`` by CUDA events, after one."""
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(calls):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / calls / nt


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nt", type=int, default=512)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("escan_forward_loads times the CUDA kernels: it needs a card")
    libs = {"engine": ke.LIBRARY, "wait first": wait_first_library()}
    for lib in libs.values():
        lib.load()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda", 0)
    nt = args.nt
    shot, w, si, ri = main_path_shot(dev, nt)
    fn = functools.partial(ke.escan_forward, *shot, w, si, ri, "force_z", "v", tape=True)
    ref = fn(variant="split")
    library = ke.LIBRARY
    out = []
    try:
        for rnd in range(2):
            line = {"round": rnd, "nt": nt, "card": smi}
            for name in ("engine", "wait first", "wait first", "engine"):
                ke.LIBRARY = libs[name]
                line.setdefault(name, []).append(ms_per_step(fn, nt))
                got = fn()
                line[f"{name} bitwise"] = all(
                    torch.equal(a, b) for a, b in zip((got[0], got[1], *got[2]),
                                                      (ref[0], ref[1], *ref[2])))
            print(json.dumps(line), flush=True)
            out.append(line)
    finally:
        ke.LIBRARY = library
    if not all(line[f"{n} bitwise"] for line in out for n in libs):
        raise RuntimeError("a build's fused forward differs from the split passes")
    return out


if __name__ == "__main__":
    main()
