"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA card.

    python3 chip_smoke.py

Four phases, each printing its own lines; any failure exits non-zero.
  1. device: the card's name and power limit (nvidia-smi); no CUDA -> exit 1
  2. build: nvcc builds the scanres kernels from tpufwi_torch/csrc
  3. kernels vs plain: each CUDA kernel against its plain torch version on
     the card, at the main path's padded grid (399 x 1749), nt = 512, 1 shot
     and the kernels' time for one shot's forward + adjoint at nt = 4842
  4. main path: tpufwi_torch.invert.main on the card at the Marmousi2-scale
     grid (351 x 1701 at 10 m, order 8, pml 20, t_max 4 s: nt = 4842),
     8 shots, stages 3 Hz and 5 Hz of 2 L-BFGS iterations each
The second-to-last line is the kernels' JSON record, the last one
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

NT_CHECK = 512
MAIN_OVERRIDES = [
    "model.nz=351", "model.nx=1701", "model.dx=10", "acq.n_shots=8",
    'stages=[{"fmax": 3.0, "iterations": 2}, {"fmax": 5.0, "iterations": 2}]',
]
TOL = {"seis": 1e-5, "fields": 1e-5, "gbar": 1e-4, "lam_src": 1e-4}  # of max|ref|
KERNEL_SOURCE = "tpufwi_torch/csrc/acoustic2d_scanres.cu"
REPLACES = {
    "scanres_forward": "tpufwi/kernels/acoustic2d_pallas_scanres.py:586",
    "scanres_reverse_snap": "tpufwi/kernels/acoustic2d_pallas_scanres.py:1112",
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def rel_err(got, ref) -> float:
    return float((got.double() - ref.double()).abs().max() / ref.double().abs().max())


def timed_ms(fn, reps=1, warmup=True):
    """Mean wall time of fn() on the card in ms, by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if warmup:
        fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def phase_device() -> str:
    if not torch.cuda.is_available():
        print("no CUDA device: the smoke needs an NVIDIA card", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
    return smi


def phase_build():
    from tpufwi_torch.kernels import acoustic2d_scanres as ks

    t0 = time.perf_counter()
    ks.load_library()
    secs = time.perf_counter() - t0
    print(f"[build] kernels ready in {secs:.1f} s (nvcc {ks.build_seconds} s)", flush=True)
    for log in sorted(ks.BUILD_DIR.glob("build_*.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {line.strip()}", flush=True)
    return ks


def one_shot(ks, dev, nz=351, nx=1701, t_max=None, nt=None):
    """The main path's kernel inputs for one mid-line surface shot:
    (grid, c2, profiles), wavelet, src_idx, rcv_idx on ``dev``, and
    (vp, dt, f0, c_max)."""
    from tpufwi_torch.grid import Grid
    from tpufwi_torch.io import marmousi_like
    from tpufwi_torch.wavelets import ricker_np

    vp, dx = marmousi_like(nz=nz, nx=nx, dx=10.0)
    grid = Grid(shape=vp.shape, h=(dx, dx), pml=20, order=8)
    c_max, f0 = 4700.0, 12.0
    dt = grid.cfl_dt(c_max, safety=0.7)
    nt = nt or int(t_max / dt)
    rx = np.arange(0, nx, 2)
    src = np.array([[2, nx // 2]]) + grid.pad
    rcv = np.stack([np.full(rx.size, 2), rx], 1) + grid.pad

    def on(x, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=dev)

    c2 = on((np.pad(vp, grid.pad, mode="edge") * dt) ** 2)
    prof = tuple(on(p) for p in ks.strip_profiles(grid, dt, c_max, f0))
    w = on(ricker_np(f0, dt, nt))
    return (grid, c2, prof), w, on(src, torch.int64), on(rcv, torch.int64), (on(vp), dt, f0, c_max)


def phase_shot(ks, dev, smi):
    """Kernel time of one shot's forward (with tape) + adjoint at the main
    path's nt (t_max = 4 s), and of the shot's illumination (plain step
    twin, what the preconditioner runs per shot and stage)."""
    from tpufwi_torch.acquisition import Geometry
    from tpufwi_torch.propagators.acoustic2d import AcousticPropagator

    args, w, si, ri, (vp, dt, f0, c_max) = one_shot(ks, dev, t_max=4.0)
    nt = w.shape[0]

    def fwd_adj():
        seis, tape, _, _ = ks.scanres_forward(*args, w, si, ri, with_tape=True)
        return ks.scanres_reverse_snap(*args, seis, tape, si, ri)

    ms, (g, _) = timed_ms(fwd_adj, reps=2)
    fwd_ms, _ = timed_ms(lambda: ks.scanres_forward(*args, w, si, ri, with_tape=False))
    prop = AcousticPropagator(args[0], dt, f0, c_max, device=dev)
    illum_ms, illum = timed_ms(lambda: prop.illumination(vp, Geometry(si, ri), w),
                               warmup=False)
    if not (bool(torch.isfinite(g).all()) and bool(torch.isfinite(illum).all())):
        fail("one-shot gradient or illumination is not finite")
    print(f"[shot] {smi}: nt {nt}: forward+adjoint {ms / 1e3:.3f} s/shot, "
          f"tape-free forward {fwd_ms / 1e3:.3f} s/shot, "
          f"illumination (plain twin) {illum_ms / 1e3:.3f} s/shot", flush=True)


def phase_kernels(ks, dev, nz=351, nx=1701, nt=NT_CHECK):
    args, w, si, ri, _ = one_shot(ks, dev, nz, nx, nt=nt)
    grid = args[0]

    plain_fwd_ms, (seis_p, tape_p, ppen_p, plast_p) = timed_ms(
        lambda: ks.scanres_forward_plain(*args, w, si, ri, True))
    fwd_ms, (seis, tape, ppen, plast) = timed_ms(
        lambda: ks.scanres_forward(*args, w, si, ri, with_tape=True), reps=3)
    ybar = seis_p.contiguous()
    plain_rev_ms, (g_p, ls_p) = timed_ms(
        lambda: ks.scanres_reverse_snap_plain(*args, ybar, tape_p, si, ri))
    rev_ms, (g, ls) = timed_ms(
        lambda: ks.scanres_reverse_snap(*args, ybar, tape_p, si, ri), reps=3)

    errs_f = {"seis": rel_err(seis, seis_p),
              "fields": max(rel_err(ppen, ppen_p), rel_err(plast, plast_p))}
    tape_err = float((tape.float() - tape_p.float()).abs().max())
    tape_ulp = float(tape_p.float().abs().max()) * 2.0**-7  # one bf16 ulp at max
    errs_r = {"gbar": rel_err(g, g_p), "lam_src": rel_err(ls, ls_p)}
    NZ, NX = grid.padded_shape
    print(f"[kernels] grid {NZ}x{NX} nt {nt}: forward {fwd_ms / nt:.4f} ms/step "
          f"(plain {plain_fwd_ms / nt:.4f}), reverse {rev_ms / nt:.4f} ms/step "
          f"(plain {plain_rev_ms / nt:.4f})", flush=True)
    print(f"[kernels] rel err {json.dumps({**errs_f, **errs_r})}; tape max err "
          f"{tape_err:.3e} vs 1 bf16 ulp {tape_ulp:.3e}", flush=True)
    for name, err in {**errs_f, **errs_r}.items():
        if not err <= TOL[name]:
            fail(f"{name} disagrees with the plain version: {err:.3e} > {TOL[name]:.0e}")
    if not tape_err <= tape_ulp:
        fail(f"tape disagrees with the plain version: {tape_err:.3e} > {tape_ulp:.3e}")
    return [
        dict(name="scanres_forward", route="cuda", source=KERNEL_SOURCE,
             replaces=REPLACES["scanres_forward"], max_abs_err=float(
                 (seis.double() - seis_p.double()).abs().max()),
             ms=fwd_ms / nt, plain_ms=plain_fwd_ms / nt),
        dict(name="scanres_reverse_snap", route="cuda", source=KERNEL_SOURCE,
             replaces=REPLACES["scanres_reverse_snap"], max_abs_err=float(
                 (g.double() - g_p.double()).abs().max()),
             ms=rev_ms / nt, plain_ms=plain_rev_ms / nt),
    ]


def phase_main(ks, smi, device="cuda", overrides=tuple(MAIN_OVERRIDES)):
    from tpufwi_torch import invert
    from tpufwi_torch.config import FwiConfig
    from tpufwi_torch.grid import Grid

    run_dir = "smoke_out"
    if os.path.exists(os.path.join(run_dir, "log.jsonl")):
        os.remove(os.path.join(run_dir, "log.jsonl"))
    ks.scanres_forward.launches = 0
    ks.scanres_reverse_snap.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    vp = invert.main(["--device", device, f"run_dir={run_dir}", *overrides])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"scanres_forward": ks.scanres_forward.launches,
                "scanres_reverse_snap": ks.scanres_reverse_snap.launches}
    peak = torch.cuda.max_memory_allocated()

    with open(os.path.join(run_dir, "log.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    its = [r for r in recs if "event" not in r]
    engines = [r["engine"] for r in recs if r.get("event") == "engine"]
    cfg = FwiConfig().with_overrides(list(overrides))
    n_shots = cfg.acq.n_shots
    shape = (cfg.model.nz, cfg.model.nx)
    dt = Grid(shape=shape, h=cfg.model.dx, order=cfg.prop.order).cfl_dt(
        cfg.opt.vmax, cfg.prop.cfl_safety)
    nt = int(cfg.acq.t_max / dt)
    # forward evaluations: observed data, then per stage the first
    # value-and-grad and per iteration the line-search trials + one
    # value-and-grad (a retried line search adds uncounted trials)
    fwd_min = n_shots * (1 + len(cfg.stages) + sum(r["evals"] for r in its))
    rev = n_shots * (len(cfg.stages) + len(its))
    print(f"[main] {smi}: {wall:.1f} s total, peak memory {peak / 2**30:.2f} GiB, "
          f"launches {json.dumps(launches)} (nt {nt})", flush=True)
    for r in its:
        print(f"[main] stage {r['stage']} f<{r['fmax']} Hz it {r['iter']}: J={r['J']:.6e} "
              f"{r['seconds']} s/iter {r['shots_per_sec']} shots/s evals {r['evals']}",
              flush=True)

    if engines != ["cuda_scansnap"] * len(cfg.stages):
        fail(f"engine records {engines}, expected cuda_scansnap per stage")
    if len(its) != sum(s.iterations for s in cfg.stages):
        fail(f"{len(its)} iterations logged")
    for si in range(len(cfg.stages)):
        J = [r["J"] for r in its if r["stage"] == si]
        if not all(np.isfinite(J)) or not all(b < a for a, b in zip(J, J[1:])):
            fail(f"stage {si}: J not finite and falling: {J}")
    if min(launches.values()) <= 0:
        fail(f"a kernel of the main path never launched: {launches}")
    if launches["scanres_reverse_snap"] != nt * rev:
        fail(f"reverse launches {launches['scanres_reverse_snap']} != nt x {rev}")
    fwd = launches["scanres_forward"]
    if fwd % nt or fwd // nt < fwd_min:
        fail(f"forward launches {fwd} not nt x (>= {fwd_min}) evaluations")
    print(f"[main] evaluations: forward {fwd // nt} (>= {fwd_min}), reverse {rev}", flush=True)
    vp_np = vp.detach().cpu().numpy()
    if vp_np.shape != shape or not np.isfinite(vp_np).all() or not (
            cfg.opt.vmin <= vp_np.min() and vp_np.max() <= cfg.opt.vmax):
        fail(f"final model is not finite, of shape {shape}, within the bounds")
    return launches


def main() -> int:
    smi = phase_device()
    dev = torch.device("cuda", 0)
    ks = phase_build()
    kernels = phase_kernels(ks, dev)
    phase_shot(ks, dev, smi)
    launches = phase_main(ks, smi)
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms")
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": [{key: k[key] for key in order} for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
