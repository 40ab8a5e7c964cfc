"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero.
  1. device: the card's name and power limit (nvidia-smi); no CUDA -> exit 1
  2. build: one nvcc call builds all six kernels from tpufwi_torch/csrc
  3. kernels vs plain: each CUDA kernel against its plain torch version on
     the card, at the main path's padded grid (399 x 1749), nt = 512, one
     shot: the whole-scan forward (snapshot and ring tapes), the snapshot
     and rings reverses, and the three single-step kernels step by step
  4. shot: one shot's forward + adjoint and illumination at nt = 4842
  5. gradients: one shot at nt = 4842 through the three CUDA engines:
     cuda_scanres against cuda_scansnap and cuda_step against cuda_scanres,
     and the rings reverse's reconstruction error
  6. over budget: the 5 m Marmousi2-scale survey (701 x 3401, nt = 9684),
     whose snapshot tape exceeds the card's budget, resolves to the rings
     engine and gives a finite gradient
  7. main paths: tpufwi_torch.invert.main on the card at the Marmousi2-scale
     grid (351 x 1701 at 10 m, order 8, pml 20, t_max 4 s: nt = 4842):
     a. snapshot engine (auto), 8 shots, stages 3 and 5 Hz of 2 iterations
     b. rings engine, 8 shots, one 3 Hz stage of 2 iterations
     c. single-step engine, 4 shots, one 3 Hz stage of 2 iterations,
        without the illumination preconditioner (a plain-twin loop that no
        kernel of this engine runs)
     each with every launch counter set to 0 just before it and read after
The second-to-last line is the kernels' JSON record, the last one
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

NT_CHECK = 512
GRID_10M = ["model.nz=351", "model.nx=1701", "model.dx=10"]
PATHS = {
    "snap": dict(engine="cuda_scansnap", kernels=("scanres_forward", "scanres_reverse_snap"),
                 overrides=GRID_10M + [
                     "acq.n_shots=8",
                     'stages=[{"fmax": 3.0, "iterations": 2}, {"fmax": 5.0, "iterations": 2}]']),
    "rings": dict(engine="cuda_scanres", kernels=("scanres_forward", "scanres_reverse"),
                  overrides=GRID_10M + [
                      "acq.n_shots=8", "prop.impl=cuda_scanres",
                      'stages=[{"fmax": 3.0, "iterations": 2}]']),
    "step": dict(engine="cuda_step",
                 kernels=("fused_forward_step", "recon_step", "fused_adjoint_step"),
                 overrides=GRID_10M + [
                     "acq.n_shots=4", "prop.impl=cuda_step", "precond.use_illumination=false",
                     'stages=[{"fmax": 3.0, "iterations": 2}]']),
}
# of max|plain|: fp32 summation order (FMA chains against torch's separate
# products), the reverses fed the same tape and cotangent as their plain
# versions, each single-step kernel fed its plain version's inputs
TOL = {"seis": 1e-5, "fields": 1e-5, "rings": 1e-5, "gbar": 1e-4, "lam_src": 1e-4,
       "recon": 1e-5, "lapw": 1e-5, "adjoint": 1e-5}
SNAP_GTOL, STEP_GTOL = 5e-3, 1e-4  # engine against engine, on the valid region
SCANRES_SRC = "tpufwi_torch/csrc/acoustic2d_scanres.cu"
STEP_SRC = "tpufwi_torch/csrc/acoustic2d_step.cu"
KERNELS = {  # name: (source, the TPU kernel's pallas_call)
    "scanres_forward": (SCANRES_SRC, "tpufwi/kernels/acoustic2d_pallas_scanres.py:586"),
    "scanres_reverse_snap": (SCANRES_SRC, "tpufwi/kernels/acoustic2d_pallas_scanres.py:1112"),
    "scanres_reverse": (SCANRES_SRC, "tpufwi/kernels/acoustic2d_pallas_scanres.py:879"),
    "fused_forward_step": (STEP_SRC, "tpufwi/kernels/acoustic2d_pallas.py:309"),
    "recon_step": (STEP_SRC, "tpufwi/kernels/acoustic2d_pallas_bwd.py:110"),
    "fused_adjoint_step": (STEP_SRC, "tpufwi/kernels/acoustic2d_pallas_bwd.py:289"),
}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
FP32_FLOPS = 67e12  # outside the tensor cores


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


def kernel_modules():
    from tpufwi_torch.kernels import acoustic2d_scanres as ks
    from tpufwi_torch.kernels import acoustic2d_step as kst

    return ks, kst


def wrapper(name):
    ks, kst = kernel_modules()
    return getattr(ks, name, None) or getattr(kst, name)


def reset_launches():
    for name in KERNELS:
        wrapper(name).launches = 0


def read_launches(names=KERNELS):
    return {name: wrapper(name).launches for name in names}


# ------------------------------------------------------------------ bounds


def step_counts(grid, nrec, nsrc, n_ring):
    """Operations and bytes of one time step of each kernel's function, as
    the algorithm needs them: each input read once, each output written
    once (for a whole-scan kernel, its once-per-shot inputs and outputs
    spread over the nt steps by the caller)."""
    NZ, NX = grid.padded_shape
    taps = 2 * grid.radius + 1
    S = grid.pml + grid.radius
    SE = S + grid.radius
    cells, strips, ext = NZ * NX, 2 * S * (NX + NZ), 2 * SE * (NX + NZ)
    fwd = cells * (4 * taps + 4) + strips * (2 * taps + 8) + ext * (2 * taps + 1) + 2 * nsrc
    rev = cells * (4 * taps + 6) + strips * (3 * taps + 6) + ext * 4 * taps + 2 * nsrc
    recon = cells * (4 * taps + 4) + 2 * nsrc
    f = 4  # fp32 bytes
    return {
        # per step, plus once per shot (c2, final fields or gradient)
        "scanres_forward_snap": (fwd, nrec * f + cells * 2, 3 * cells * f),
        "scanres_forward_rings": (fwd, nrec * f + n_ring * f, 3 * cells * f),
        "scanres_reverse_snap": (rev, nrec * f + nsrc * f + cells * 2, 2 * cells * f),
        "scanres_reverse": (rev + recon, nrec * f + nsrc * f + n_ring * f, 4 * cells * f),
        # one call: the fields and strip state in and out
        "fused_forward_step": (fwd, 4 * cells * f + 4 * strips * f + (nrec + n_ring) * f, 0),
        "recon_step": (recon, 5 * cells * f + n_ring * f, 0),
        "fused_adjoint_step": (rev, 8 * cells * f + 4 * strips * f + (nrec + nsrc) * f, 0),
    }


def bound(counts, nt):
    """(bound_ms per step, bound_by) from (flops, bytes per step, bytes per shot)."""
    flops, per_step, per_shot = counts
    t_ops = flops / FP32_FLOPS
    t_bytes = (per_step + per_shot / nt) / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def entry(name, max_abs_err, ms, plain_ms, counts, nt):
    source, replaces = KERNELS[name]
    bound_ms, bound_by = bound(counts, nt)
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                max_abs_err=max_abs_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


# ------------------------------------------------------------------ phases


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
    ks, _ = kernel_modules()
    t0 = time.perf_counter()
    ks.load_library()
    secs = time.perf_counter() - t0
    print(f"[build] kernels ready in {secs:.1f} s (nvcc {ks.build_seconds} s)", flush=True)
    # registers and spills of each kernel at order 8 (R = 4), from ptxas -v
    kernel, spill = None, ""
    for log in sorted(ks.BUILD_DIR.glob("build_*.log")):
        for line in log.read_text().splitlines():
            m = re.search(r"Compiling entry function '\w*?_(acoustic2d_\w+?)_cu_[0-9a-f]{8}"
                          r"(\d+)(\w+)", line)
            if m:
                name = m.group(3)[:int(m.group(2))]
                order = re.match(r"ILi(\d)E", m.group(3)[int(m.group(2)):])
                at_r4 = order is None or order.group(1) == "4"
                kernel = f"{m.group(1)}.cu {name}" if at_r4 else None
            elif kernel and "spill" in line:
                spill = line.split(":", 1)[-1].strip()
            elif kernel and "registers" in line:
                print(f"[build] {kernel}: {line.split(':', 1)[-1].strip()}; {spill}", flush=True)
                kernel = None


def one_shot(dev, nz=351, nx=1701, dx=10.0, t_max=None, nt=None):
    """The main path's kernel inputs for one mid-line surface shot:
    (grid, c2, profiles), wavelet, src_idx, rcv_idx on ``dev``, and
    (vp, dt, f0, c_max)."""
    from tpufwi_torch.grid import Grid
    from tpufwi_torch.io import marmousi_like
    from tpufwi_torch.kernels.acoustic2d_scanres import strip_profiles
    from tpufwi_torch.wavelets import ricker_np

    vp, dx = marmousi_like(nz=nz, nx=nx, dx=dx)
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
    prof = tuple(on(p) for p in strip_profiles(grid, dt, c_max, f0))
    w = on(ricker_np(f0, dt, nt))
    return (grid, c2, prof), w, on(src, torch.int64), on(rcv, torch.int64), (on(vp), dt, f0, c_max)


class _Err:
    """Running max |kernel - plain| and max |plain| on the card (no sync)."""

    def __init__(self, dev):
        self.d = torch.zeros((), dtype=torch.float64, device=dev)
        self.r = torch.zeros((), dtype=torch.float64, device=dev)

    def add(self, got, ref):
        self.d = torch.maximum(self.d, (got.double() - ref.double()).abs().max())
        self.r = torch.maximum(self.r, ref.double().abs().max())

    def rel(self):
        return float(self.d / self.r) if float(self.r) > 0 else float(self.d)

    def abs(self):
        return float(self.d)


def step_kernels_vs_plain(args, w, si, ri, nt):
    """Kernels 4-6 against their plain versions over nt steps: at each step
    the kernel gets the plain version's inputs (so each kernel is held on
    its own), and the plain state carries on. Returns ({output: rel err},
    {kernel: max abs err}, {kernel: plain ms per call}, (ring tape, P_{nt-2},
    P_{nt-1}) of the plain run, in the halo layout)."""
    ks, kst = kernel_modules()
    grid, c2, prof = args
    dev, R = c2.device, grid.radius
    NZ, NX = grid.padded_shape
    halo = (NZ + 2 * R, NX + 2 * R)
    n_ring = ks.ring_plan(grid, dev)[0].shape[0]
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)  # noqa: E731
    errs = {k: _Err(dev) for k in ("seis", "fields", "rings", "recon", "lapw", "adjoint",
                                   "gbar", "lam_src")}
    plain_ev = {k: [] for k in ("fused_forward_step", "recon_step", "fused_adjoint_step")}

    def plain(name, fn, *a, **kw):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn(*a, **kw)
        e1.record()
        plain_ev[name].append((e0, e1))

    # forward: kernel 4
    fp, fk = z(2, *halo), z(2, *halo)
    cp, ck = z(4, *halo), z(4, *halo)
    seis_p, seis_k = z(nt, ri.shape[0]), z(nt, ri.shape[0])
    tape_p, tape_k = z(nt, n_ring), z(nt, n_ring)
    cur, prev = 1, 0
    for t in range(nt):
        fk.copy_(fp)
        ck.copy_(cp)
        kst.fused_forward_step(grid, c2, prof, fk[cur], fk[prev], ck, w, t, si, ri, seis_k,
                               tape_k[t])
        plain("fused_forward_step", kst.fused_forward_step_plain, grid, c2, prof, fp[cur],
              fp[prev], cp, w, t, si, ri, seis_p, tape_p[t])
        errs["fields"].add(fk[prev], fp[prev])
        errs["fields"].add(ck, cp)
        cur, prev = prev, cur
    errs["seis"].add(seis_k, seis_p)
    errs["rings"].add(tape_k, tape_p)
    final = (tape_p, fp[prev].clone(), fp[cur].clone())

    # reverse: kernels 5 and 6, imaging with the plain reconstruction's lapw
    ybar = seis_p.contiguous()
    pp, pk = torch.stack([fp[prev], fp[cur]]), z(2, *halo)  # P_{t-1}, P_t
    qp, qk = z(2, *halo), z(2, *halo)
    ap, ak = z(kst.ADJ_PLANES, *halo), z(kst.ADJ_PLANES, *halo)
    lap_p, lap_k = z(NZ, NX), z(NZ, NX)
    gp, gk = z(NZ, NX), z(NZ, NX)
    lsp, lsk = z(nt, si.shape[0]), z(nt, si.shape[0])
    chain = torch.empty(2 * ri.shape[0], dtype=torch.int32, device=dev)
    p_t, p_tp1, q, qo = 0, 1, 0, 1
    for t in reversed(range(nt)):
        row = tape_p[t - 2] if t >= 2 else None
        pk.copy_(pp)
        kst.recon_step(grid, c2, pk[p_t], pk[p_tp1], lap_k, w, t, si, row)
        plain("recon_step", kst.recon_step_plain, grid, c2, pp[p_t], pp[p_tp1], lap_p, w, t,
              si, row)
        errs["recon"].add(pk[p_tp1], pp[p_tp1])
        errs["lapw"].add(lap_k, lap_p)
        qk.copy_(qp)
        ak.copy_(ap)
        gk.copy_(gp)
        kst.fused_adjoint_step(grid, c2, prof, qk[q], qk[qo], ak, lap_p, gk, ybar, t, si, ri,
                               lsk, chain, init_chain=t == nt - 1)
        plain("fused_adjoint_step", kst.fused_adjoint_step_plain, grid, c2, prof, qp[q], qp[qo],
              ap, lap_p, gp, ybar, t, si, ri, lsp)
        errs["adjoint"].add(qk, qp)
        errs["adjoint"].add(ak[[1, 3, 5, 7]], ap[[1, 3, 5, 7]])
        errs["gbar"].add(gk, gp)
        p_t, p_tp1, q, qo = p_tp1, p_t, qo, q
    errs["lam_src"].add(lsk, lsp)
    torch.cuda.synchronize()
    plain_ms = {k: sum(a.elapsed_time(b) for a, b in ev) / len(ev) for k, ev in plain_ev.items()}
    rel = {k: e.rel() for k, e in errs.items()}
    abs_err = {"fused_forward_step": errs["seis"].abs(), "recon_step": errs["recon"].abs(),
               "fused_adjoint_step": errs["gbar"].abs()}
    return rel, abs_err, plain_ms, final


def time_step_kernels(args, w, si, ri, nt, final):
    """Kernel-only loops of kernels 4, 5 and 6 at nt steps: ms per call on
    the card (host-bound where the Python call outlasts the kernels), and
    the host's own time per call (enqueue rate)."""
    _, kst = kernel_modules()
    grid, c2, prof = args
    dev, R = c2.device, grid.radius
    NZ, NX = grid.padded_shape
    halo = (NZ + 2 * R, NX + 2 * R)
    tape, ppen, plast = final
    f = torch.zeros((2, *halo), device=dev)
    cpml = torch.zeros((4, *halo), device=dev)
    seis = torch.zeros((nt, ri.shape[0]), device=dev)
    rows = torch.zeros_like(tape)

    def fwd():
        for t in range(nt):
            kst.fused_forward_step(grid, c2, prof, f[(t + 1) % 2], f[t % 2], cpml, w, t, si, ri,
                                   seis, rows[t])

    lapw = torch.zeros((NZ, NX), device=dev)
    p = torch.stack([ppen, plast])

    def recon():
        for t in reversed(range(nt)):
            kst.recon_step(grid, c2, p[(nt - 1 - t) % 2], p[(nt - t) % 2], lapw, w, t, si,
                           tape[t - 2] if t >= 2 else None)

    q = torch.zeros((2, *halo), device=dev)
    adj = torch.zeros((kst.ADJ_PLANES, *halo), device=dev)
    gacc = torch.zeros((NZ, NX), device=dev)
    lam = torch.zeros((nt, si.shape[0]), device=dev)
    chain = torch.empty(2 * ri.shape[0], dtype=torch.int32, device=dev)
    ybar = torch.randn((nt, ri.shape[0]), device=dev)

    def adjoint():
        for t in reversed(range(nt)):
            kst.fused_adjoint_step(grid, c2, prof, q[(nt - 1 - t) % 2], q[(nt - t) % 2], adj,
                                   lapw, gacc, ybar, t, si, ri, lam, chain,
                                   init_chain=t == nt - 1)

    out = {}
    for name, fn in (("fused_forward_step", fwd), ("recon_step", recon),
                     ("fused_adjoint_step", adjoint)):
        ms, _ = timed_ms(fn)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host_ms = 1e3 * (time.perf_counter() - t0) / nt
        torch.cuda.synchronize()
        out[name] = (ms / nt, host_ms)
    return out


def phase_kernels(dev, smi, nz=351, nx=1701, nt=NT_CHECK, quiet=False):
    if not quiet:  # torch's and the kernels' first-use costs out of the timings
        phase_kernels(dev, smi, nz, nx, nt=8, quiet=True)
    ks, _ = kernel_modules()
    args, w, si, ri, _ = one_shot(dev, nz, nx, nt=nt)
    grid = args[0]
    NZ, NX = grid.padded_shape
    counts = step_counts(grid, ri.shape[0], si.shape[0], ks.ring_plan(grid, dev)[0].shape[0])
    entries, errs = [], {}

    # kernel 1, both tape modes
    plain_fwd_ms, (seis_p, snap_p, ppen_p, plast_p) = timed_ms(
        lambda: ks.scanres_forward_plain(*args, w, si, ri, "snap"), warmup=False)
    fwd_ms, (seis, snap, ppen, plast) = timed_ms(
        lambda: ks.scanres_forward(*args, w, si, ri, tape="snap"), reps=3)
    plain_rf_ms, (_, rings_p, rpen_p, rlast_p) = timed_ms(
        lambda: ks.scanres_forward_plain(*args, w, si, ri, "rings"), warmup=False)
    rf_ms, (seis_r, rings, rpen, rlast) = timed_ms(
        lambda: ks.scanres_forward(*args, w, si, ri, tape="rings"), reps=3)
    errs["fwd"] = {"seis": max(rel_err(seis, seis_p), rel_err(seis_r, seis_p)),
                   "fields": max(rel_err(ppen, ppen_p), rel_err(plast, plast_p),
                                 rel_err(rpen, rpen_p), rel_err(rlast, rlast_p)),
                   "rings": rel_err(rings, rings_p)}
    snap_err = float((snap.float() - snap_p.float()).abs().max())
    snap_ulp = float(snap_p.float().abs().max()) * 2.0**-7  # one bf16 ulp at max
    fwd_abs = float((torch.cat([seis, seis_r]).double()
                     - torch.cat([seis_p, seis_p]).double()).abs().max())
    entries.append(entry("scanres_forward", fwd_abs, fwd_ms / nt, plain_fwd_ms / nt,
                         counts["scanres_forward_snap"], nt))
    rings_bound = bound(counts["scanres_forward_rings"], nt)

    # kernels 2 and 3, fed the plain forward's tapes and fields
    ybar = seis_p.contiguous()
    plain_rev_ms, (g_p, ls_p) = timed_ms(
        lambda: ks.scanres_reverse_snap_plain(*args, ybar, snap_p, si, ri), warmup=False)
    rev_ms, (g, ls) = timed_ms(
        lambda: ks.scanres_reverse_snap(*args, ybar, snap_p, si, ri), reps=3)
    errs["rev_snap"] = {"gbar": rel_err(g, g_p), "lam_src": rel_err(ls, ls_p)}
    entries.append(entry("scanres_reverse_snap", float((g.double() - g_p.double()).abs().max()),
                         rev_ms / nt, plain_rev_ms / nt, counts["scanres_reverse_snap"], nt))
    plain_rr_ms, (gr_p, lsr_p, p0_p) = timed_ms(
        lambda: ks.scanres_reverse_plain(*args, w, ybar, rings_p, rpen_p, rlast_p, si, ri,
                                         return_field=True), warmup=False)
    rr_ms, (gr, lsr, p0) = timed_ms(
        lambda: ks.scanres_reverse(*args, w, ybar, rings_p, rpen_p, rlast_p, si, ri,
                                   return_field=True), reps=3)
    errs["rev_rings"] = {"gbar": rel_err(gr, gr_p), "lam_src": rel_err(lsr, lsr_p),
                         "recon": float((p0 - p0_p).abs().max() / rlast_p.abs().max())}
    entries.append(entry("scanres_reverse", float((gr.double() - gr_p.double()).abs().max()),
                         rr_ms / nt, plain_rr_ms / nt, counts["scanres_reverse"], nt))

    # kernels 4-6, step by step
    step_rel, step_abs, step_plain_ms, final = step_kernels_vs_plain(args, w, si, ri, nt)
    errs["step"] = step_rel
    step_ms = time_step_kernels(args, w, si, ri, nt, final)
    for name in ("fused_forward_step", "recon_step", "fused_adjoint_step"):
        entries.append(entry(name, step_abs[name], step_ms[name][0], step_plain_ms[name],
                             counts[name], nt))

    if quiet:
        return entries
    print(f"[kernels] {smi}: grid {NZ}x{NX} nt {nt}, ms per step, kernel (plain; bound):",
          flush=True)
    for e in entries:
        print(f"[kernels]   {e['name']}: {e['ms']:.5f} ({e['plain_ms']:.4f}; "
              f"{e['bound_ms']:.5f} by {e['bound_by']})", flush=True)
    print(f"[kernels]   scanres_forward with the ring tape: {rf_ms / nt:.5f} "
          f"({plain_rf_ms / nt:.4f}; {rings_bound[0]:.5f} by {rings_bound[1]})", flush=True)
    for name, (ms, host_ms) in step_ms.items():
        print(f"[kernels]   {name}: host time per call {host_ms:.5f} ms", flush=True)
    print(f"[kernels] rel err {json.dumps(errs)}; snapshot max err {snap_err:.3e} vs 1 bf16 "
          f"ulp {snap_ulp:.3e}", flush=True)
    for group in errs.values():
        for name, err in group.items():
            if not err <= TOL[name]:
                fail(f"{name} disagrees with the plain version: {err:.3e} > {TOL[name]:.0e}")
    if not snap_err <= snap_ulp:
        fail(f"snapshot tape disagrees with the plain version: {snap_err:.3e} > {snap_ulp:.3e}")
    return entries


def phase_shot(dev, smi):
    """Kernel time of one shot's forward (with tape) + adjoint at the main
    path's nt (t_max = 4 s), and of the shot's illumination (plain step
    twin, what the preconditioner runs per shot and stage)."""
    ks, _ = kernel_modules()
    from tpufwi_torch.acquisition import Geometry
    from tpufwi_torch.propagators.acoustic2d import AcousticPropagator

    args, w, si, ri, (vp, dt, f0, c_max) = one_shot(dev, t_max=4.0)
    nt = w.shape[0]

    def fwd_adj():
        seis, tape, _, _ = ks.scanres_forward(*args, w, si, ri, tape="snap")
        return ks.scanres_reverse_snap(*args, seis, tape, si, ri)

    def fwd_adj_rings():
        seis, tape, ppen, plast = ks.scanres_forward(*args, w, si, ri, tape="rings")
        return ks.scanres_reverse(*args, w, seis, tape, ppen, plast, si, ri)

    ms, (g, _) = timed_ms(fwd_adj, reps=2)
    rings_ms, (gr, _) = timed_ms(fwd_adj_rings, reps=2)
    fwd_ms, _ = timed_ms(lambda: ks.scanres_forward(*args, w, si, ri, tape=None))
    prop = AcousticPropagator(args[0], dt, f0, c_max, device=dev)
    illum_ms, illum = timed_ms(lambda: prop.illumination(vp, Geometry(si, ri), w),
                               warmup=False)
    if not all(bool(torch.isfinite(x).all()) for x in (g, gr, illum)):
        fail("one-shot gradient or illumination is not finite")
    print(f"[shot] {smi}: nt {nt}: forward+adjoint {ms / 1e3:.3f} s/shot (snapshot), "
          f"{rings_ms / 1e3:.3f} s/shot (rings), tape-free forward {fwd_ms / 1e3:.3f} s/shot, "
          f"illumination (plain twin) {illum_ms / 1e3:.3f} s/shot", flush=True)


def _value_and_grad(prop, vp, geom, w, d):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    v = vp.detach().clone().requires_grad_(True)
    J = 0.5 * ((prop(v, geom, w) - d) ** 2).sum()
    (g,) = torch.autograd.grad(J, v)
    torch.cuda.synchronize()
    return float(J.detach()), g, time.perf_counter() - t0


def phase_gradients(dev, smi):
    """One shot's gradient through the three CUDA engines at nt = 4842,
    against each other on the valid region, and the rings reverse's
    reconstruction error."""
    ks, _ = kernel_modules()
    from tpufwi_torch.acquisition import Geometry
    from tpufwi_torch.propagators.acoustic2d import AcousticPropagator
    from tpufwi_torch.propagators.boundary import RingSpec

    args, w, si, ri, (vp_true, dt, f0, c_max) = one_shot(dev, t_max=4.0)
    grid = args[0]
    nt = w.shape[0]
    geom = Geometry(si, ri)
    valid = tuple(slice(s.start - grid.pad, s.stop - grid.pad) for s in RingSpec.build(grid).valid)
    vp0 = torch.nn.functional.avg_pool2d(vp_true[None, None], 9, 1, 4,
                                         count_include_pad=False)[0, 0].contiguous()
    props = {impl: AcousticPropagator(grid, dt, f0, c_max, impl=impl, device=dev)
             for impl in ("cuda_scansnap", "cuda_scanres", "cuda_step")}
    with torch.no_grad():
        d = props["cuda_scanres"](vp_true, geom, w)
    out = {}
    for impl, prop in props.items():
        _value_and_grad(prop, vp0, geom, w, d)  # warm-up
        out[impl] = _value_and_grad(prop, vp0, geom, w, d)
    g = {k: v[1][valid] for k, v in out.items()}
    err_snap = rel_err(g["cuda_scanres"], g["cuda_scansnap"])
    err_step = rel_err(g["cuda_step"], g["cuda_scanres"])
    J_err = abs(out["cuda_step"][0] - out["cuda_scanres"][0]) / max(out["cuda_scanres"][0], 1e-30)
    seis, tape, ppen, plast = ks.scanres_forward(*args, w, si, ri, tape="rings")
    _, _, p_first = ks.scanres_reverse(*args, w, seis, tape, ppen, plast, si, ri,
                                       return_field=True)
    pv = RingSpec.build(grid).valid
    recon_abs = float(p_first[pv].abs().max())
    recon_rel = recon_abs / float(plast.abs().max())
    step_extra = (out["cuda_step"][2] - out["cuda_scanres"][2]) / (3 * nt)
    print(f"[gradients] {smi}: nt {nt}, one shot value-and-grad: "
          + ", ".join(f"{k} {v[2]:.3f} s (J {v[0]:.6e})" for k, v in out.items()), flush=True)
    print(f"[gradients] valid-region max rel err: cuda_scanres vs cuda_scansnap {err_snap:.3e} "
          f"(bound {SNAP_GTOL:.0e}), cuda_step vs cuda_scanres {err_step:.3e} (bound "
          f"{STEP_GTOL:.0e}), J {J_err:.3e}; cuda_step costs {1e3 * step_extra:.4f} ms more per "
          f"step call than cuda_scanres", flush=True)
    print(f"[gradients] reconstruction at t = 0: max |P_-1| on the valid region "
          f"{recon_abs:.3e} (exact 0), {recon_rel:.3e} of max |P_nt-1|", flush=True)
    if not all(bool(torch.isfinite(v[1]).all()) for v in out.values()):
        fail("a gradient is not finite")
    if not err_snap <= SNAP_GTOL:
        fail(f"cuda_scanres vs cuda_scansnap gradient {err_snap:.3e} > {SNAP_GTOL:.0e}")
    if not (err_step <= STEP_GTOL and J_err <= STEP_GTOL):
        fail(f"cuda_step vs cuda_scanres gradient {err_step:.3e} or J {J_err:.3e} "
             f"> {STEP_GTOL:.0e}")


def phase_over_budget(dev, smi):
    """The 5 m survey whose snapshot tape the card cannot hold: 'auto'
    takes the rings engine; one value-and-grad."""
    from tpufwi_torch.acquisition import Geometry
    from tpufwi_torch.propagators.acoustic2d import AcousticPropagator
    from tpufwi_torch.propagators.boundary import RingSpec

    args, w, si, ri, (vp, dt, f0, c_max) = one_shot(dev, nz=701, nx=3401, dx=5.0, t_max=4.0)
    grid = args[0]
    nt = w.shape[0]
    NZ, NX = grid.padded_shape
    prop = AcousticPropagator(grid, dt, f0, c_max, impl="auto", device=dev)
    impl = prop.fix_impl_for(nt=nt)
    print(f"[over budget] {smi}: {grid.shape[0]}x{grid.shape[1]} at 5 m (padded {NZ}x{NX}), "
          f"nt {nt}, {ri.shape[0]} receivers: impl {impl} ({prop.resolve_note})", flush=True)
    if impl != "cuda_scanres" or "snapshot ineligible" not in prop.resolve_note:
        fail(f"the over-budget survey resolved to {impl}: {prop.resolve_note}")
    torch.cuda.reset_peak_memory_stats()
    J, g, secs = _value_and_grad(prop, vp, Geometry(si, ri), w, torch.zeros((), device=dev))
    peak = torch.cuda.max_memory_allocated()
    snap = nt * NZ * NX * 2
    ring = nt * RingSpec.build(grid).tape_bytes_per_step()
    print(f"[over budget] snapshot tape avoided {snap / 2**30:.2f} GiB; ring tape "
          f"{ring / 2**30:.3f} GiB ({ring} bytes); value-and-grad {secs:.3f} s/shot; peak "
          f"memory {peak / 2**30:.2f} GiB; J {J:.6e}", flush=True)
    if not (np.isfinite(J) and bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0):
        fail("the over-budget gradient is not finite and nonzero")


def phase_main(smi, path, device="cuda"):
    from tpufwi_torch import invert
    from tpufwi_torch.config import FwiConfig
    from tpufwi_torch.grid import Grid

    spec = PATHS[path]
    overrides = spec["overrides"]
    run_dir = os.path.join("smoke_out", path)
    if os.path.exists(os.path.join(run_dir, "log.jsonl")):
        os.remove(os.path.join(run_dir, "log.jsonl"))
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    vp = invert.main(["--device", device, f"run_dir={run_dir}", *overrides])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
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
    mine = {k: launches[k] for k in spec["kernels"]}
    print(f"[main {path}] {smi}: {wall:.1f} s total, peak memory {peak / 2**30:.2f} GiB, "
          f"launches {json.dumps(mine)} (nt {nt})", flush=True)
    for r in its:
        print(f"[main {path}] stage {r['stage']} f<{r['fmax']} Hz it {r['iter']}: "
              f"J={r['J']:.6e} {r['seconds']} s/iter {r['shots_per_sec']} shots/s "
              f"evals {r['evals']}", flush=True)

    if engines != [spec["engine"]] * len(cfg.stages):
        fail(f"engine records {engines}, expected {spec['engine']} per stage")
    if len(its) != sum(s.iterations for s in cfg.stages):
        fail(f"{len(its)} iterations logged")
    for si in range(len(cfg.stages)):
        J = [r["J"] for r in its if r["stage"] == si]
        if not all(np.isfinite(J)) or not all(b < a for a, b in zip(J, J[1:])):
            fail(f"stage {si}: J not finite and falling: {J}")
    if min(mine.values()) <= 0:
        fail(f"a kernel of the {path} path never launched: {mine}")
    others = {k: v for k, v in launches.items() if k not in mine and v}
    if others:
        fail(f"the {path} path launched kernels of another engine: {others}")
    fwd_name, *rev_names = spec["kernels"]
    for name in rev_names:
        if launches[name] != nt * rev:
            fail(f"{name} launches {launches[name]} != nt x {rev}")
    fwd = launches[fwd_name]
    if fwd % nt or fwd // nt < fwd_min:
        fail(f"forward launches {fwd} not nt x (>= {fwd_min}) evaluations")
    print(f"[main {path}] evaluations: forward {fwd // nt} (>= {fwd_min}), reverse {rev}",
          flush=True)
    vp_np = vp.detach().cpu().numpy()
    if vp_np.shape != shape or not np.isfinite(vp_np).all() or not (
            cfg.opt.vmin <= vp_np.min() and vp_np.max() <= cfg.opt.vmax):
        fail("final model is not finite, of shape {shape}, within the bounds")
    return mine


def main() -> int:
    smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    kernels = phase_kernels(dev, smi)
    phase_shot(dev, smi)
    phase_gradients(dev, smi)
    phase_over_budget(dev, smi)
    launches = dict.fromkeys(KERNELS, 0)
    for path in PATHS:
        for name, n in phase_main(smi, path).items():
            launches[name] += n
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms")
    for k in kernels:
        k["launches"] = launches[k["name"]]
    if min(k["launches"] for k in kernels) <= 0:
        fail("a kernel was launched on no main path")
    print(json.dumps({"kernels": [{key: k[key] for key in order} for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
