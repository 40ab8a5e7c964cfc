"""Tile sweep of the 2D whole-scan engine's fused steps on the card.

    python -m tpufwi_torch.bench.scanres_tiles [tz,tx,rows,minblocks ...] [--nt N]

``scanres_forward`` and ``scanres_reverse_snap`` run one shared-memory tiled
kernel a time step on the tile that
``csrc/acoustic2d_scanres.cu`` is built for (``TPUFWI_SCAN_TILE``: tz x tx
cells, a block of tx x rows threads, at least minblocks blocks an SM).
This script builds one library per tile given (default: the engine's tile
and four others) from a source that defines ``TPUFWI_SCAN_TILE`` and
includes the engine's, then, per tile, at the main path's grid (Marmousi-
like 351 x 1701 at 10 m, order 8, pml 20: padded 399 x 1749; one surface
shot, a receiver every other column, nt steps): holds the steps bitwise
against the engine's own build (a tile changes no arithmetic: the snapshot
forward's seismogram, tape and fields; the reverse's gradient and lambda
at the sources; the illumination), and times ms a step by CUDA events,
with dependent launches and in plain stream order, in the same calls, two
rounds over the tiles. Prints one JSON line per tile and round, with the
card's name. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import functools
import json
import threading

import numpy as np
import torch

from ..grid import Grid
from ..io import marmousi_like
from ..kernels import acoustic2d_scanres as ks
from ..kernels.build import BUILD_DIR, CSRC, Library, declare_all
from ..wavelets import ricker_np

DEFAULT_TILES = ((16, 32, 8, 6), (32, 32, 8, 4), (16, 64, 8, 3), (32, 32, 16, 3),
                 (64, 32, 8, 3))


def tile_library(tile) -> Library:
    """The whole-scan entry points built for ``tile`` (their own library)."""
    stem = "scanres_tile_" + "_".join(map(str, tile))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = BUILD_DIR / f"{stem}.cu"
    src.write_text(f"#define TPUFWI_SCAN_TILE {', '.join(map(str, tile))}\n"
                   f'#include "{CSRC / "acoustic2d_scanres.cu"}"\n')
    return Library(stem, (src,), (CSRC / "acoustic2d_scanres.cu", *ks.LIBRARY.headers),
                   lambda lib: declare_all(lib, ks.SCAN_SIGNATURES))


def main_path_shot(dev, nt):
    """(grid, c2, profiles), wavelet, src_idx, rcv_idx of one mid-line
    surface shot on the main path's grid."""
    vp, dx = marmousi_like(nz=351, nx=1701, dx=10.0)
    grid = Grid(shape=vp.shape, h=(dx, dx), pml=20, order=8)
    c_max, f0 = 4700.0, 12.0
    dt = grid.cfl_dt(c_max, safety=0.7)
    rx = np.arange(0, vp.shape[1], 2)
    src = np.array([[2, vp.shape[1] // 2]]) + grid.pad
    rcv = np.stack([np.full(rx.size, 2), rx], 1) + grid.pad

    def on(x, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=dev)

    c2 = on((np.pad(np.asarray(vp), grid.pad, mode="edge") * dt) ** 2)
    prof = tuple(on(p) for p in ks.strip_profiles(grid, dt, c_max, f0))
    return (grid, c2, prof), on(ricker_np(f0, dt, nt)), on(src, torch.int64), on(rcv, torch.int64)


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
    ap.add_argument("tiles", nargs="*", help="tz,tx,rows,minblocks")
    ap.add_argument("--nt", type=int, default=512)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("scanres_tiles times the CUDA kernels: it needs a card")
    tiles = [tuple(int(v) for v in t.split(",")) for t in args.tiles] or list(DEFAULT_TILES)
    libs = {tile: tile_library(tile) for tile in tiles}
    errors = []

    def build(lib):
        try:
            lib.load()
        except Exception as exc:  # reported after every build ended
            errors.append(f"{lib.stem}: {exc}")

    threads = [threading.Thread(target=build, args=(lib,)) for lib in libs.values()]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise RuntimeError("; ".join(errors))
    dev = torch.device("cuda", 0)
    nt = args.nt
    shot, w, si, ri = main_path_shot(dev, nt)
    fwd_ref = ks.scanres_forward(*shot, w, si, ri, tape="snap")
    ybar, snap = fwd_ref[0].contiguous(), fwd_ref[1]
    rev_ref = ks.scanres_reverse_snap(*shot, ybar, snap, si, ri)
    il_ref = ks.scanres_forward(*shot, w, si, ri[:0], illum=True)[4]
    runs = {"dependent launch": True, "stream order": False}
    library, tile_z, tile_x, tile_rows = ks.LIBRARY, ks.TILE_Z, ks.TILE_X, ks.TILE_ROWS
    out = []
    try:
        for rnd in range(2):
            for tile, lib in libs.items():
                ks.LIBRARY = lib
                ks.TILE_Z, ks.TILE_X, ks.TILE_ROWS = tile[:3]
                calls = {
                    "forward": functools.partial(ks.scanres_forward, *shot, w, si, ri,
                                                 tape="snap"),
                    "reverse": functools.partial(ks.scanres_reverse_snap, *shot, ybar, snap,
                                                 si, ri),
                    "illumination": functools.partial(ks.scanres_forward, *shot, w, si, ri[:0],
                                                      illum=True)}
                line = {"tile": list(tile), "round": rnd, "nt": nt,
                        "device": torch.cuda.get_device_name(0)}
                for name, fn in calls.items():
                    line[name] = {label: ms_per_step(functools.partial(
                        fn, dependent_launch=dep), nt) for label, dep in runs.items()}
                line["bitwise"] = (
                    all(torch.equal(a, b) for a, b in zip(calls["forward"](), fwd_ref)
                        if a is not None)
                    and all(torch.equal(a, b) for a, b in zip(calls["reverse"](), rev_ref))
                    and torch.equal(calls["illumination"]()[4], il_ref))
                print(json.dumps(line), flush=True)
                out.append(line)
    finally:
        ks.LIBRARY = library
        ks.TILE_Z, ks.TILE_X, ks.TILE_ROWS = tile_z, tile_x, tile_rows
    if not all(line["bitwise"] for line in out):
        raise RuntimeError("a tile's steps differ from the engine's own build")
    return out


if __name__ == "__main__":
    main()
