"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero.
  1. device: the card's name and power limit (nvidia-smi); no CUDA -> exit 1
  2. build: four nvcc calls, started together, build the acoustic library
     (ten kernels), the elastic library (six kernels: two whole-scan, four
     per-step), the 3D library (two whole-scan kernels and the two
     per-step ones) and the probes library (the five machine-model probes)
     from tpufwi_torch/csrc
  3. kernels vs plain: each CUDA kernel against its plain torch version on
     the card, at the main path's padded grid (399 x 1749), nt = 512, one
     shot: the whole-scan forward (snapshot and ring tapes, illumination),
     the snapshot and rings reverses, and the three single-step kernels
     step by step; the whole-scan kernels' fused steps (one shared-memory
     tiled kernel a step), with dependent launches and in plain stream
     order, against their per-step oracles (the single-step engine's passes
     a step at a time) in the same calls, in every forward mode, bitwise on
     every output, with ms a step (CUDA events), host us a step (nt-slope)
     and torch.profiler's device us and launches a step;
     then (phase_kstep_kernels) the K-step forward and reverse (K = 4), the
     merged reverse step and the bare leapfrog, each fed its plain
     version's state, with a free-surface case at nt = 128; ms per call and
     per step (CUDA events), host ms per call, device ms (torch.profiler)
  4. shot: one shot's forward + adjoint and illumination at nt = 4842 (the
     illumination on the forward kernel, beside its plain version); the
     snapshot and rings forward + adjoint and the illumination also on the
     per-step oracles, bitwise against the fused steps' gradients and
     illumination
  5. gradients: one shot at nt = 4842 through the CUDA engines:
     cuda_scanres against cuda_scansnap, cuda_step against cuda_scanres,
     cuda_kstep against cuda_step and the merged cuda_step against the
     split one (bitwise equality reported), and the rings reverse's
     reconstruction error
  6. over budget: the 5 m Marmousi2-scale survey (701 x 3401, nt = 9684),
     whose snapshot tape exceeds the card's budget, resolves to the rings
     engine and gives a finite gradient; its forward's and reverse's device
     us a step by CUDA events
  7. main paths: tpufwi_torch.invert.main on the card at the Marmousi2-scale
     grid (351 x 1701 at 10 m, order 8, pml 20, t_max 4 s: nt = 4842):
     a. snapshot engine (auto), 4 shots, stages 3 and 5 Hz of 2 iterations
     b. rings engine, 4 shots, one 3 Hz stage of 2 iterations
     c. single-step engine, 4 shots, one 3 Hz stage of 2 iterations,
        without the illumination preconditioner (every 2D engine's
        illumination is the whole-scan forward kernel's, which the launch
        check would count as another engine's)
     d. K-step engine (prop.impl=cuda_kstep), as c
     e. the single-step engine with the merged reverse step, as c, through
        tpufwi_torch.invert.invert from Python with
        AcousticPropagator(impl="cuda_step", merged_reverse=True)
     each with every launch counter set to 0 just before it and read after
  8. elastic kernels vs plain: escan_forward (with and without the ring
     tape) and escan_reverse against their plain versions at the elastic
     main path's grid (399 x 1749 padded), order 8, force_z source, v
     record, nt = 512; and a pressure / p-record free-surface case, nt = 128;
     at both, escan_forward and escan_reverse (also launched in plain
     stream order) and their per-step oracles (estep_forward,
     estep_reverse) in the same calls, bitwise against each other, with
     each one's ms per step (CUDA events) and host ms per call, and
     torch.profiler's device us and launches per step of each pass
  9. elastic shot: one shot's forward and value-and-grad on cuda_escan at
     nt = 4885, its ring-tape bytes and peak memory
 10. elastic per-step kernels vs plain: estep_v, estep_s, estep_rs and
     estep_rv, each fed its plain version's state at every step, at the
     elastic main path's grid, force_z / v, nt = 512, and a pressure /
     p-record free-surface case, nt = 128; each kernel's ms per call (CUDA
     events), host ms per call and device ms per call (torch.profiler)
 11. elastic per-step shot: one shot at nt = 4885 through cuda_estep and
     cuda_escan: seismograms, forward_fused and the five material gradients
     against each other within 1e-5 of max; times and peak memory
 11b. marine shot: one shot of the marine cell (the water layer, the free
     surface, a pressure source, hydrophones) at nt = 4885 through cuda_escan
     and cuda_estep, the seismogram and gradients bitwise equal and
     escan_image_steps raised by nt; the reverse alone by CUDA events (with
     dependent launches and in stream order) and its passes' device us and
     launches a step (2, the images in er_s / er_v); the land code of er_s /
     er_v against its recorded SASS digest, and no pass spilling
 12. 3D kernels vs plain: a3d_forward (no tape, fp32 and bf16 ring tapes,
     illumination) and a3d_reverse (fed the plain forward's tape, fields and
     seismogram; fp32 and bf16 tapes) against their plain versions at the 3D
     main path's padded grid (428 x 188 x 588), one surface shot, nt = 64;
     and a free-surface case on a smaller grid, nt = 128; at both, the
     tiled cell passes (the default: one walk of 2.5D tiles over the whole
     grid each, the tiles that reach the CPML staging their strip values or,
     in the reverse's second pass, copying the line pass's terms) against
     the gather ones (variant="gather"), bitwise on every output, with each
     variant's ms per step and torch.profiler's device us per pass; the
     reverse's line pass (r3_lines) and second cell pass (the walk
     r3_cells2_tiled, its gather r3_cells2) alone at the main grid, us a
     launch by CUDA events, the walk bitwise against the gather; and each
     walk's registers and blocks an SM
 13. full Overthrust: one shot on the SEG/EAGE Overthrust grid (801 x 187 x
     801 at 25 m, padded 829 x 215 x 829, nt = 3028): 'auto' resolves to the
     bf16 ring tape; a tape-free forward and a value-and-grad
 14. main path elastic: tpufwi_torch.invert.main physics=elastic on the card
     (351 x 1701 land model at 10 m, order 8, pml 20, t_max 4 s: nt = 4885),
     8 shots, one 3 Hz stage of 2 iterations, counters reset just before
 15. main path elastic per-step: tpufwi_torch.invert.invert_elastic with
     ElasticPropagator(impl="cuda_estep") on a VSP survey of the same land
     model: 4 surface shots, the surface line every 4 cells and a borehole
     at x = nx / 2 from z = 10 to 340 every 2 cells, one 3 Hz stage of 2
     iterations, counters reset just before
 16. main path 3D: tpufwi_torch.invert.invert on a 3D FwiProblem, the
     large-scale single-card survey of scripts/overthrust_ms.py
     (overthrust_like 160 x 400 x 560 at 25 m, order 8, pml 10, nt 900,
     cut to 8 surface shots, 3,420 receivers), one 3 Hz stage of 2
     iterations with the illumination preconditioner, counters reset just
     before
 17. 3D per-step kernels vs plain: leapfrog3d and strip3d, each fed its
     plain version's state at every step, at the 3D main path's padded grid
     (428 x 188 x 588) from a random state, nt = 64, and a small grid with
     order 4 and pml 7 at nt = 16; ms per call (CUDA events), host ms per
     call, device ms per call (torch.profiler)
 18. bench_3d: tpufwi_torch.bench.bench_3d.main() at full SEG/EAGE
     Overthrust width (801 x 187 x 801 at 25 m, pml 20, order 8: padded 849
     x 235 x 849), counters set to 0 just before and read just after (the
     launches of leapfrog3d and strip3d); then the two kernels against their
     plain versions at that grid, and full_step against the leapfrog kernel
     with torch-op strips and against full_step2 (a3d_forward) over 40 steps
     from the impulse
 19. probes: the port's probe scripts tpufwi_torch.bench.exp_2d_scanres and
     exp_3d_lap (all modes) at the reference's full sizes, counters set to
     0 just before and read just after (the probes' launches: no engine
     runs them); then each probe kernel against its plain version at full
     size (the 2D probe at nt 256 with and without its strips, the tap
     probe at K = 5 and 25, every copy variant, step5 staged and not,
     step5x), and their times: ms per call (CUDA events), host ms per call,
     plain ms, bound, GB/s, ms per tap, the 2D strip cost, and the copy's
     library call (torch.add); every copy variant (the grid-stride, one-shot
     and TMA bulk walks among them) and torch.add write into one
     preallocated output, each copy held bitwise against p + 1
The second-to-last line is the kernels' JSON record, the last one
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import functools
import hashlib
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
                     "acq.n_shots=4",
                     'stages=[{"fmax": 3.0, "iterations": 2}, {"fmax": 5.0, "iterations": 2}]']),
    "rings": dict(engine="cuda_scanres", kernels=("scanres_forward", "scanres_reverse"),
                  overrides=GRID_10M + [
                      "acq.n_shots=4", "prop.impl=cuda_scanres",
                      'stages=[{"fmax": 3.0, "iterations": 2}]']),
    "step": dict(engine="cuda_step",
                 kernels=("fused_forward_step", "recon_step", "fused_adjoint_step"),
                 overrides=GRID_10M + [
                     "acq.n_shots=4", "prop.impl=cuda_step", "precond.use_illumination=false",
                     'stages=[{"fmax": 3.0, "iterations": 2}]']),
    "kstep": dict(engine="cuda_kstep", kernels=("kstep_forward", "kstep_reverse"),
                  overrides=GRID_10M + [
                      "acq.n_shots=4", "prop.impl=cuda_kstep", "precond.use_illumination=false",
                      'stages=[{"fmax": 3.0, "iterations": 2}]']),
    # driven through invert() with AcousticPropagator(merged_reverse=True),
    # which no config key selects; observed data before the counters reset
    "step_merged": dict(engine="cuda_step", kernels=("fused_forward_step", "fused_reverse_step"),
                        merged_reverse=True,
                        overrides=GRID_10M + [
                            "acq.n_shots=4", "prop.impl=cuda_step",
                            "precond.use_illumination=false",
                            'stages=[{"fmax": 3.0, "iterations": 2}]']),
}
K_CHECK = 4  # steps per K-step call: cuda_kstep's K
# of max|plain|: fp32 summation order (FMA chains against torch's separate
# products), the reverses fed the same tape and cotangent as their plain
# versions, each single-step kernel fed its plain version's inputs
TOL = {"seis": 1e-5, "fields": 1e-5, "rings": 1e-5, "gbar": 1e-4, "lam_src": 1e-4,
       "recon": 1e-5, "lapw": 1e-5, "adjoint": 1e-5, "illum": 1e-5}
SNAP_GTOL, STEP_GTOL = 5e-3, 1e-4  # engine against engine, on the valid region
SCANRES_SRC = "tpufwi_torch/csrc/acoustic2d_scanres.cu"
STEP_SRC = "tpufwi_torch/csrc/acoustic2d_step.cu"
ESCAN_SRC = "tpufwi_torch/csrc/elastic2d_scan.cu"
ESTEP_SRC = "tpufwi_torch/csrc/elastic2d_step.cu"
A3D_SRC = "tpufwi_torch/csrc/acoustic3d_scan.cu"
KSTEP_SRC = "tpufwi_torch/csrc/acoustic2d_kstep.cu"
STEP3D_SRC = "tpufwi_torch/csrc/acoustic3d_step.cu"
PROBE2D_SRC = "tpufwi_torch/csrc/acoustic2d_probe.cu"
PROBE3D_SRC = "tpufwi_torch/csrc/acoustic3d_probes.cu"
KERNELS = {  # name: (source, the TPU kernel's pallas_call)
    "scanres_forward": (SCANRES_SRC, "tpufwi/kernels/acoustic2d_pallas_scanres.py:586"),
    "scanres_reverse_snap": (SCANRES_SRC, "tpufwi/kernels/acoustic2d_pallas_scanres.py:1112"),
    "scanres_reverse": (SCANRES_SRC, "tpufwi/kernels/acoustic2d_pallas_scanres.py:879"),
    "fused_forward_step": (STEP_SRC, "tpufwi/kernels/acoustic2d_pallas.py:309"),
    "recon_step": (STEP_SRC, "tpufwi/kernels/acoustic2d_pallas_bwd.py:110"),
    "fused_adjoint_step": (STEP_SRC, "tpufwi/kernels/acoustic2d_pallas_bwd.py:289"),
    "kstep_forward": (KSTEP_SRC, "tpufwi/kernels/acoustic2d_pallas_kstep.py:282"),
    "kstep_reverse": (KSTEP_SRC, "tpufwi/kernels/acoustic2d_pallas_kstep.py:555"),
    "fused_reverse_step": (KSTEP_SRC, "tpufwi/kernels/acoustic2d_pallas_bwd.py:502"),
    # no engine runs it (nor does the reference's): its launches are its
    # kernel phase's leapfrog run (LEAPFROG_ROUTE)
    "leapfrog": (STEP_SRC, "tpufwi/kernels/acoustic2d_pallas.py:386"),
    "escan_forward": (ESCAN_SRC, "tpufwi/kernels/elastic2d_pallas_scan.py:398"),
    "escan_reverse": (ESCAN_SRC, "tpufwi/kernels/elastic2d_pallas_scan.py:907"),
    "estep_v": (ESTEP_SRC, "tpufwi/kernels/elastic2d_pallas.py:218"),
    "estep_s": (ESTEP_SRC, "tpufwi/kernels/elastic2d_pallas.py:228"),
    "estep_rs": (ESTEP_SRC, "tpufwi/kernels/elastic2d_pallas_bwd.py:328"),
    "estep_rv": (ESTEP_SRC, "tpufwi/kernels/elastic2d_pallas_bwd.py:352"),
    # one kernel for each pair: the y/z face kernels ride in the same launches
    "a3d_forward": (A3D_SRC, "; ".join(
        f"tpufwi/kernels/acoustic3d_fused2.py:{n}" for n in (1116, 167, 259))),
    # the reconstruction (15) fused into the transposed step (16, 17)
    "a3d_reverse": (A3D_SRC, "; ".join(
        f"tpufwi/kernels/acoustic3d_bwd_pallas.py:{n}" for n in (321, 851, 419, 521))),
    # rows 19 and 14: one function, tiled two ways for the TPU
    "leapfrog3d": (STEP3D_SRC, "tpufwi/kernels/acoustic3d_pallas.py:175; "
                               "tpufwi/kernels/acoustic3d_pallas.py:336"),
    # row 22: the y, z and x faces in one entry point
    "strip3d": (STEP3D_SRC, "; ".join(
        f"tpufwi/kernels/acoustic3d_strips_pallas.py:{n}" for n in (126, 196, 282))),
    # the machine-model probes: no engine runs them (PROBE_ROUTE)
    "scan_probe": (PROBE2D_SRC, "scripts/exp_2d_scanres.py:208"),
    "tap_probe": (PROBE3D_SRC, "scripts/exp_3d_lap.py:225"),
    # copy1 and its block-shape sweep
    "stream_copy": (PROBE3D_SRC, "scripts/exp_3d_lap.py:349; scripts/exp_3d_lap.py:380"),
    # step5 and step5s
    "stream_step5": (PROBE3D_SRC, "scripts/exp_3d_lap.py:356; scripts/exp_3d_lap.py:360"),
    "stream_step5x": (PROBE3D_SRC, "scripts/exp_3d_lap.py:435"),
}
PROBE_NAMES = ("scan_probe", "tap_probe", "stream_copy", "stream_step5", "stream_step5x")
LEAPFROG_ROUTE = (f"cuda; launches from its kernel phase's leapfrog run of {NT_CHECK} steps, "
                  "not a main path: no engine runs it, in the port or the reference")
PROBE_ROUTE = ("cuda; launches from the probe scripts (exp_2d_scanres, exp_3d_lap, all modes), "
               "counted from 0 just before them, not a main path: no engine runs them, in the "
               "port or the reference")
ELASTIC_MAIN = GRID_10M + ["physics=elastic", "acq.n_shots=8",
                           'stages=[{"fmax": 3.0, "iterations": 2}]']
ESTEP_NAMES = ("estep_v", "estep_s", "estep_rs", "estep_rv")
# the per-step engine's main path: the elastic lane's land model with 4
# surface shots, the surface receiver line every 4 cells and a borehole at
# x = nx / 2 from z = 10 to 340 every 2 cells (a VSP survey: its receivers
# span 331 rows, past the reference's 16-row whole-scan slab, so the
# reference's 'auto' takes its per-step engine)
ESTEP_MAIN = GRID_10M + ["physics=elastic", "acq.n_shots=4", "acq.rcv_dx=4",
                         'stages=[{"fmax": 3.0, "iterations": 2}]']
ESTEP_BOREHOLE = (10, 341, 2)
# of max|plain| per output: fp32 summation order, the reverse fed the plain
# forward's tape, final fields and seismogram
ETOL = {"seis": 1e-5, "finals": 1e-5, "tape": 1e-5, "grads": 1e-4, "srcrow": 1e-4}
# of max|plain| per output (fp32 summation order; the reverse fed the plain
# forward's tape, fp32 or the same rounded to bf16, final fields and
# seismogram); "tape_bf16" in bf16 ulps at the tape's max: the kernel's
# bf16 rows against its own fp32 rows rounded to nearest even, which the
# same field arithmetic makes exactly equal (a truncating conversion would
# miss by ~0.7; against the plain rows a value the fp32 order moves across
# a rounding tie would flip by one ulp of its own); "recon" the
# reconstructed P_{-1} against the last field
A3D_TOL = {"seis": 1e-5, "fields": 1e-5, "tape": 1e-5, "tape_bf16": 0.0, "illum": 1e-5,
           "gbar": 1e-4, "lam_src": 1e-4, "gbar_bf16": 1e-4, "lam_src_bf16": 1e-4,
           "recon": 1e-4}
# the kernels' bf16-tape gradient against their fp32-tape gradient, norm
# relative on the valid region, a surface shot (its source in the ring);
# the CPU test measured 1.8e-2 at its small grid (tests/test_torch_acoustic3d.py)
A3D_BF16_GTOL = 5e-2
MAIN3D = dict(model=(160, 400, 560), nt=900, shots=(2, 4), fmax=3.0, iterations=2,
              mask_top=5, vmin=2000.0, vmax=6000.0)
# of max|plain| per output, each per-step 3D kernel fed its plain version's
# state at every step (fp32 summation order); "bench" the bench's full_step
# field against the torch-op strips' and against full_step2's after
# BENCH_CHECK_NT steps from the impulse
A3D_STEP_TOL = {"fields": 1e-5, "strips": 1e-5, "bench": 1e-5}
BENCH_CHECK_NT = 40
# of max|plain|: the 2D probe after 256 steps (fp32 FMA chains against
# torch's separate products, as TOL["fields"]); the 3D probes one call
# (sums in the same order; the taps FMA against products and sums)
PROBE_TOL = {"scan_probe": 1e-5, "3d": 1e-6}
PROBE_NT = 256
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


def kstep_module():
    from tpufwi_torch.kernels import acoustic2d_kstep as kk

    return kk


def elastic_module():
    from tpufwi_torch.kernels import elastic2d_scan as ke

    return ke


def estep_module():
    from tpufwi_torch.kernels import elastic2d_step as kes

    return kes


def a3d_module():
    from tpufwi_torch.kernels import acoustic3d_scan as k3

    return k3


def a3d_step_modules():
    from tpufwi_torch.kernels import acoustic3d_step as k3s
    from tpufwi_torch.kernels import acoustic3d_strips as k3f

    return k3s, k3f


def probes_module():
    from tpufwi_torch.kernels import probes as kp

    return kp


def wrapper(name):
    ks, kst = kernel_modules()
    for mod in (ks, kst, kstep_module(), elastic_module(), estep_module(), a3d_module(),
                *a3d_step_modules(), probes_module()):
        if hasattr(mod, name):
            return getattr(mod, name)
    raise KeyError(name)


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
        # no receivers; the (NZ, NX) sum read and written once per shot
        "scanres_forward_illum": (fwd + 2 * cells, 0, 5 * cells * f),
        "scanres_reverse_snap": (rev, nrec * f + nsrc * f + cells * 2, 2 * cells * f),
        "scanres_reverse": (rev + recon, nrec * f + nsrc * f + n_ring * f, 4 * cells * f),
        # one call: the fields and strip state in and out
        "fused_forward_step": (fwd, 4 * cells * f + 4 * strips * f + (nrec + n_ring) * f, 0),
        "recon_step": (recon, 5 * cells * f + n_ring * f, 0),
        "fused_adjoint_step": (rev, 8 * cells * f + 4 * strips * f + (nrec + nsrc) * f, 0),
        # rows 5 and 6 in one call: p_t, p_tp1, q, q_other, C and gacc in
        # (C once), p_tp1, q_other and gacc out, q out at the receivers
        # only, the strip duals in and out
        "fused_reverse_step": (rev + recon, 9 * cells * f + 4 * strips * f
                               + (2 * nrec + nsrc + n_ring) * f, 0),
        # a K-step call: per step its rows; per call (spread over its steps
        # by the caller, bound(counts, k)) the state in and out once: two
        # fields and C in, two fields out, the strip state in and out
        # (forward); two fields, two lambdas, C and gacc in, the same less C
        # out, the strip duals in and out (reverse)
        "kstep_forward": (fwd, (nrec + n_ring) * f, 5 * cells * f + 4 * strips * f),
        "kstep_reverse": (rev + recon, (nrec + nsrc + n_ring) * f,
                          11 * cells * f + 4 * strips * f),
        # p and C in, p_other in and out, Lap(p) out
        "leapfrog": (recon - 2 * nsrc, 5 * cells * f, 0),
    }


def elastic_step_counts(grid, nrec_cols, nsrc, n_ring):
    """Operations and bytes of one elastic time step, as step_counts: per
    cell 8 staggered derivatives of R taps (a subtraction and an FMA per
    tap) and the updates; per CPML strip cell its 4 memories (forward) or
    duals and strip imaging (reverse); the reverse also reconstructs,
    images and runs the 8 transposed derivatives. ``nrec_cols``: recorded
    values per step (2 nrec for record "v")."""
    NZ, NX = grid.padded_shape
    R = grid.radius
    S = grid.pml + grid.radius
    cells, strips = NZ * NX, 2 * S * (NX + NZ)
    fwd = cells * (16 * R + 20) + strips * 12 + 2 * nsrc
    rev = cells * (32 * R + 60) + strips * 20 + 4 * nsrc
    f = 4
    # the per-step kernels: each stage half its step's operations, and per
    # call its state in and out of device memory (a memory or dual plane
    # only on its strips): stage V reads vx, vz, the three stresses, bx, bz
    # and writes vx, vz; stage S reads the five fields, lam, lam2mu, mu_xz
    # and writes the stresses; R-S reads the five fields, the five
    # cotangents, three materials and three gradients and writes three
    # stresses, two cotangents and three gradients; R-V reads the same
    # fields and cotangents, bx, bz and two gradients and writes two
    # velocities, three cotangents and two gradients
    mem = 4 * strips * f  # four strip planes in and out
    return {
        "escan_forward_rings": (fwd, (1 + nrec_cols + 5 * n_ring) * f, 10 * cells * f),
        "escan_forward": (fwd, (1 + nrec_cols) * f, 10 * cells * f),
        # the same function with its state streamed from device memory once
        # a step: the five fields in and out, the five materials, the eight
        # strip memories in and out
        "escan_forward_streamed": (fwd, 15 * cells * f + 2 * mem
                                   + (1 + nrec_cols + 5 * n_ring) * f, 0),
        "escan_reverse": (rev, (1 + nrec_cols + nsrc + 5 * n_ring) * f, 15 * cells * f),
        "estep_v": (fwd // 2 - nsrc, 9 * cells * f + mem, 0),
        "estep_s": (fwd // 2 + nsrc, 11 * cells * f + mem + (1 + nrec_cols + 5 * n_ring) * f, 0),
        "estep_rs": (rev // 2, 24 * cells * f + mem + (1 + nrec_cols + nsrc + 3 * n_ring) * f, 0),
        "estep_rv": (rev // 2, 21 * cells * f + mem + 2 * n_ring * f, 0),
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
    """The four libraries' nvcc calls at once, then each kernel's registers
    and spills (the stencil kernels' at order 8, R = 4) from ptxas -v."""
    import threading

    ks, _ = kernel_modules()
    libs = (ks.LIBRARY, elastic_module().LIBRARY, a3d_module().LIBRARY,
            probes_module().LIBRARY)
    errors = []

    def build(lib):
        try:
            lib.load()
        except Exception as exc:  # reported below, after both builds ended
            errors.append(f"{lib.stem}: {exc}")

    t0 = time.perf_counter()
    threads = [threading.Thread(target=build, args=(lib,)) for lib in libs]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    secs = time.perf_counter() - t0
    if errors:
        fail("build failed: " + "; ".join(errors))
    print(f"[build] kernels ready in {secs:.1f} s (nvcc "
          + ", ".join(f"{lib.stem} {lib.build_seconds} s" for lib in libs) + ")", flush=True)
    for lib in libs:
        for mangled, (regs, st, ld) in (ptxas_resources(lib.log, "") if lib.log.exists()
                                        else {}).items():
            m = re.search(r"_((?:acoustic|elastic)[23]d_\w+?)_cu_[0-9a-f]{8}(\d+)(\w+)", mangled)
            if not m:
                continue
            name = m.group(3)[:int(m.group(2))]
            order = re.match(r"ILi([124])E", m.group(3)[int(m.group(2)):])
            if order is None or order.group(1) == "4":
                print(f"[build] {m.group(1)}.cu {name}: {regs} registers, spill stores {st} B, "
                      f"loads {ld} B", flush=True)


def one_shot(dev, nz=351, nx=1701, dx=10.0, t_max=None, nt=None, free_surface=False):
    """The main path's kernel inputs for one mid-line surface shot:
    (grid, c2, profiles), wavelet, src_idx, rcv_idx on ``dev``, and
    (vp, dt, f0, c_max)."""
    from tpufwi_torch.grid import Grid
    from tpufwi_torch.io import marmousi_like
    from tpufwi_torch.kernels.acoustic2d_scanres import strip_profiles
    from tpufwi_torch.wavelets import ricker_np

    vp, dx = marmousi_like(nz=nz, nx=nx, dx=dx)
    grid = Grid(shape=vp.shape, h=(dx, dx), pml=20, order=8, free_surface=free_surface)
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

    def add(self, got, ref, scale=None):
        """``scale``: the reference's magnitude, when not max |ref|."""
        self.d = torch.maximum(self.d, (got.double() - ref.double()).abs().max())
        self.r = torch.maximum(self.r, ref.double().abs().max() if scale is None
                               else scale.double())

    def rel(self):
        return float(self.d / self.r) if float(self.r) > 0 else float(self.d)

    def abs(self):
        return float(self.d)


class _Held:
    """Kernels held against their plain versions call by call: before each
    call the kernel's state is set to the plain one's, so each kernel is
    held on its own while the plain state carries on; the plain calls are
    timed by CUDA events."""

    def __init__(self, names):
        self.ev = {name: [] for name in names}

    def call(self, name, kernel, plain, state=()):
        """``state``: (kernel's, plain's) tensor pairs, copied before the call."""
        for dst, src in state:
            dst.copy_(src)
        kernel()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        plain()
        e1.record()
        self.ev[name].append((e0, e1))

    def plain_ms(self):
        """Mean ms per plain call of each kernel."""
        torch.cuda.synchronize()
        return {name: sum(a.elapsed_time(b) for a, b in ev) / len(ev)
                for name, ev in self.ev.items()}


def time_loops(loops, nt, nt_prof=64):
    """Times of kernel-only loops. ``loops(m)`` gives {kernel: (fn, calls,
    pattern)}, fn running the kernel's calls over m steps. Per kernel, at
    nt steps: (calls, ms per call on the card by CUDA events (the host's
    pace where the Python call outlasts the kernels), the host's own ms per
    call (enqueue rate), the device's us per call summed over the CUDA
    kernels ``pattern`` captures by torch.profiler at nt_prof steps (None
    when it sees no device time), the profiler's rows)."""
    out = {}
    for name, (fn, calls, pattern) in loops(nt).items():
        ms, _ = timed_ms(fn)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host_ms = 1e3 * (time.perf_counter() - t0) / calls
        torch.cuda.synchronize()
        pfn, pcalls, _ = loops(min(nt_prof, nt))[name]
        rows = device_us_per_step(pfn, pcalls, pattern)
        out[name] = (calls, ms / calls, host_ms, sum(us for _, us in rows) or None, rows)
    return out


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
    held = _Held(("fused_forward_step", "recon_step", "fused_adjoint_step"))

    # forward: kernel 4
    fp, fk = z(2, *halo), z(2, *halo)
    cp, ck = z(4, *halo), z(4, *halo)
    seis_p, seis_k = z(nt, ri.shape[0]), z(nt, ri.shape[0])
    tape_p, tape_k = z(nt, n_ring), z(nt, n_ring)
    cur, prev = 1, 0
    for t in range(nt):
        held.call(
            "fused_forward_step",
            lambda: kst.fused_forward_step(grid, c2, prof, fk[cur], fk[prev], ck, w, t, si, ri,
                                           seis_k, tape_k[t]),
            lambda: kst.fused_forward_step_plain(grid, c2, prof, fp[cur], fp[prev], cp, w, t, si,
                                                 ri, seis_p, tape_p[t]),
            ((fk, fp), (ck, cp)))
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
        held.call("recon_step",
                  lambda: kst.recon_step(grid, c2, pk[p_t], pk[p_tp1], lap_k, w, t, si, row),
                  lambda: kst.recon_step_plain(grid, c2, pp[p_t], pp[p_tp1], lap_p, w, t, si,
                                               row),
                  ((pk, pp),))
        errs["recon"].add(pk[p_tp1], pp[p_tp1])
        errs["lapw"].add(lap_k, lap_p)
        held.call("fused_adjoint_step",
                  lambda: kst.fused_adjoint_step(grid, c2, prof, qk[q], qk[qo], ak, lap_p, gk,
                                                 ybar, t, si, ri, lsk, chain,
                                                 init_chain=t == nt - 1),
                  lambda: kst.fused_adjoint_step_plain(grid, c2, prof, qp[q], qp[qo], ap, lap_p,
                                                       gp, ybar, t, si, ri, lsp),
                  ((qk, qp), (ak, ap), (gk, gp)))
        errs["adjoint"].add(qk, qp)
        errs["adjoint"].add(ak[[1, 3, 5, 7]], ap[[1, 3, 5, 7]])
        errs["gbar"].add(gk, gp)
        p_t, p_tp1, q, qo = p_tp1, p_t, qo, q
    errs["lam_src"].add(lsk, lsp)
    plain_ms = held.plain_ms()
    rel = {k: e.rel() for k, e in errs.items()}
    abs_err = {"fused_forward_step": errs["seis"].abs(), "recon_step": errs["recon"].abs(),
               "fused_adjoint_step": errs["gbar"].abs()}
    return rel, abs_err, plain_ms, final


def time_step_kernels(args, w, si, ri, nt, final):
    """time_loops of kernels 4, 5 and 6 over nt steps from the plain run's
    last state."""
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

    def fwd(m=nt):
        for t in range(m):
            kst.fused_forward_step(grid, c2, prof, f[(t + 1) % 2], f[t % 2], cpml, w, t, si, ri,
                                   seis, rows[t])

    lapw = torch.zeros((NZ, NX), device=dev)
    p = torch.stack([ppen, plast])

    def recon(m=nt):
        for t in reversed(range(nt - m, nt)):
            kst.recon_step(grid, c2, p[(nt - 1 - t) % 2], p[(nt - t) % 2], lapw, w, t, si,
                           tape[t - 2] if t >= 2 else None)

    q = torch.zeros((2, *halo), device=dev)
    adj = torch.zeros((kst.ADJ_PLANES, *halo), device=dev)
    gacc = torch.zeros((NZ, NX), device=dev)
    lam = torch.zeros((nt, si.shape[0]), device=dev)
    chain = torch.empty(2 * ri.shape[0], dtype=torch.int32, device=dev)
    ybar = torch.randn((nt, ri.shape[0]), device=dev)

    def adjoint(m=nt):
        for t in reversed(range(nt - m, nt)):
            kst.fused_adjoint_step(grid, c2, prof, q[(nt - 1 - t) % 2], q[(nt - t) % 2], adj,
                                   lapw, gacc, ybar, t, si, ri, lam, chain,
                                   init_chain=t == nt - 1)

    pattern = r"::((?:fwd|rev|rec|ring)_\w+?)[<(]"
    return time_loops(lambda m: {
        name: (lambda fn=fn: fn(m), m, pattern)
        for name, fn in (("fused_forward_step", fwd), ("recon_step", recon),
                         ("fused_adjoint_step", adjoint))}, nt)


def _halo_planes(grid, n, dev):
    R = grid.radius
    NZ, NX = grid.padded_shape
    return torch.zeros((n, NZ + 2 * R, NX + 2 * R), dtype=torch.float32, device=dev)


def scanres_forward_steps(args, w, si, ri, tape=None, illum=False):
    """scanres_forward's per-step oracle: a loop of fused_forward_step (the
    single-step engine's forward_step launches), the tape rows written by
    it, the illumination summed as acc.addcmul_(P_t, P_t). Returns what
    scanres_forward returns; ``ri`` must hold a receiver (the illumination
    does not depend on them)."""
    ks, kst = kernel_modules()
    grid, c2, prof = args
    dev, R = c2.device, grid.radius
    NZ, NX = grid.padded_shape
    nt = w.shape[0]
    f, cpml = _halo_planes(grid, 2, dev), _halo_planes(grid, 4, dev)
    seis = torch.empty((nt, ri.shape[0]), dtype=torch.float32, device=dev)
    rows = None
    if tape == "snap":
        rows = torch.empty((nt, NZ, NX), dtype=torch.bfloat16, device=dev)
    elif tape == "rings":
        rows = torch.empty((nt, ks.ring_plan(grid, dev)[0].shape[0]), dtype=torch.float32,
                           device=dev)
    acc = torch.zeros((NZ, NX), dtype=torch.float32, device=dev) if illum else None
    for t in range(nt):
        row = {} if rows is None else {"snap_row" if tape == "snap" else "ring_row": rows[t]}
        kst.fused_forward_step(grid, c2, prof, f[(t + 1) % 2], f[t % 2], cpml, w, t, si, ri,
                               seis, **row)
        if illum:
            acc.addcmul_(f[t % 2, R:-R, R:-R], f[t % 2, R:-R, R:-R])
    return seis, rows, f[nt % 2, R:-R, R:-R], f[(nt - 1) % 2, R:-R, R:-R], acc


def scanres_reverse_snap_steps(args, ybar, snap, si, ri):
    """scanres_reverse_snap's per-step oracle: a loop of
    fused_adjoint_step imaging with lapw = snap[t] widened to fp32 (exact).
    Returns (gbar, lam_src)."""
    _, kst = kernel_modules()
    grid, c2, prof = args
    dev = c2.device
    nt = ybar.shape[0]
    q, adj = _halo_planes(grid, 2, dev), _halo_planes(grid, kst.ADJ_PLANES, dev)
    gacc = torch.zeros(grid.padded_shape, dtype=torch.float32, device=dev)
    lam = torch.empty((nt, si.shape[0]), dtype=torch.float32, device=dev)
    chain = torch.empty(2 * ri.shape[0], dtype=torch.int32, device=dev)
    for t in reversed(range(nt)):
        kst.fused_adjoint_step(grid, c2, prof, q[(nt - 1 - t) % 2], q[(nt - t) % 2], adj,
                               snap[t].float(), gacc, ybar, t, si, ri, lam, chain,
                               init_chain=t == nt - 1)
    return gacc, lam


def scanres_reverse_steps(args, w, ybar, tape, ppen, plast, si, ri, return_field=False,
                          merged=True):
    """scanres_reverse's per-step oracle: a loop of fused_reverse_step
    (cuda_step's merged reverse), or with ``merged`` False of recon_step
    and fused_adjoint_step, each fed ring row t-2 (zeros for t < 2).
    Returns what scanres_reverse returns."""
    _, kst = kernel_modules()
    grid, c2, prof = args
    dev, R = c2.device, grid.radius
    nt = ybar.shape[0]
    p = _halo_planes(grid, 2, dev)
    p[0, R:-R, R:-R] = plast
    p[1, R:-R, R:-R] = ppen
    q, adj = _halo_planes(grid, 2, dev), _halo_planes(grid, kst.ADJ_PLANES, dev)
    gacc = torch.zeros(grid.padded_shape, dtype=torch.float32, device=dev)
    lapw = torch.empty_like(gacc)
    lam = torch.empty((nt, si.shape[0]), dtype=torch.float32, device=dev)
    chain = torch.empty(2 * ri.shape[0], dtype=torch.int32, device=dev)
    for t in reversed(range(nt)):
        row = tape[t - 2] if t >= 2 else None
        p_t, p_tp1 = p[(nt - t) % 2], p[(nt - 1 - t) % 2]  # P_{t-1}, P_t
        q_t, q_o = q[(nt - 1 - t) % 2], q[(nt - t) % 2]
        if merged:
            kst.fused_reverse_step(grid, c2, prof, p_t, p_tp1, q_t, q_o, adj, gacc, w, ybar, t,
                                   si, ri, lam, row, chain, init_chain=t == nt - 1)
        else:
            kst.recon_step(grid, c2, p_t, p_tp1, lapw, w, t, si, row)
            kst.fused_adjoint_step(grid, c2, prof, q_t, q_o, adj, lapw, gacc, ybar, t, si, ri,
                                   lam, chain, init_chain=t == nt - 1)
    return (gacc, lam, p[nt % 2, R:-R, R:-R]) if return_field else (gacc, lam)


SCANRES_MODES = {  # scanres_forward's modes: keyword arguments, and no receivers
    "snap": (dict(tape="snap"), False), "rings": (dict(tape="rings"), False),
    "no tape": (dict(tape=None), False), "illumination": (dict(illum=True), True)}
SCANRES_PATTERN = r"::((?:fwd|rev|rec|ring|illum|scan|kstep)_\w+?)[<(]"


def scanres_oracles(args, w, si, ri, ybar, snap_p, rings_p, nt):
    """Rows 1-3's fused steps (with dependent launches and in plain stream
    order) and their per-step oracles (the single-step engine's passes, a
    launch at a time) in the same calls: {kernel: {mode: {run: (ms a step
    by CUDA events, host ms a call)}}}, and whether every fused run equals
    the oracle bitwise on every output (forward: seis, tape, final fields,
    illumination (its seismogram has no receivers); snapshot reverse: gbar,
    lam_src; rings reverse, fed ``rings_p`` = (ring tape, P_{nt-2},
    P_{nt-1}): gbar, lam_src, P_{-1})."""
    ks, _ = kernel_modules()
    calls = {"scanres_forward": {
        mode: (functools.partial(ks.scanres_forward, *args, w, si, ri[:0] if bare else ri, **kw),
               functools.partial(scanres_forward_steps, args, w, si, ri, **kw), bare)
        for mode, (kw, bare) in SCANRES_MODES.items()},
        "scanres_reverse_snap": {"snap": (
            functools.partial(ks.scanres_reverse_snap, *args, ybar, snap_p, si, ri),
            functools.partial(scanres_reverse_snap_steps, args, ybar, snap_p, si, ri), False)},
        "scanres_reverse": {"rings": (
            functools.partial(ks.scanres_reverse, *args, w, ybar, *rings_p, si, ri,
                              return_field=True),
            functools.partial(scanres_reverse_steps, args, w, ybar, *rings_p, si, ri,
                              return_field=True), False)}}
    times, bitwise = {}, True
    for kernel, modes in calls.items():
        times[kernel] = {}
        for mode, (fn, oracle, bare) in modes.items():
            runs = {"fused": functools.partial(fn, dependent_launch=True),
                    "fused in stream order": functools.partial(fn, dependent_launch=False),
                    "per-step oracle": oracle}
            times[kernel][mode], outs = {}, {}
            for label, run in runs.items():
                ev_ms, host_ms = events_ms(run, 3)
                times[kernel][mode][label] = (ev_ms / nt, host_ms)
                outs[label] = run()
            for label in outs:
                bitwise &= all((a is None and b is None) or torch.equal(a, b)
                               for i, (a, b) in enumerate(zip(outs[label],
                                                              outs["per-step oracle"]))
                               if not (bare and i == 0))
    return times, bitwise


def host_us_per_step(run, nts=(32, 288)):
    """Host us a step of ``run(nt)`` (its launches enqueued, not waited
    for): the slope between two nt of the least of three calls each, every
    call right after a synchronize (so the launch queue is empty and the
    per-call constant cancels)."""
    best = {}
    for n in nts:
        run(n)
        torch.cuda.synchronize()
        for _ in range(3):
            t0 = time.perf_counter()
            run(n)
            dt = time.perf_counter() - t0
            torch.cuda.synchronize()
            best[n] = min(best.get(n, dt), dt)
    return 1e6 * (best[nts[1]] - best[nts[0]]) / (nts[1] - nts[0])


def scanres_profile(args, w, si, ri, ybar, snap_p, rings_p, nt):
    """Of one scanres_forward with the snapshot tape, one
    scanres_reverse_snap and one scanres_reverse (the rings, from the last
    two fields, a timing input) over the first nt steps, in plain stream
    order (with dependent launches a kernel's profiler span includes its
    wait), and of their per-step oracles: torch.profiler's rows [(kernel,
    device us a step, launches a step)], and the host enqueue us a step
    (host_us_per_step; the fused kernels' with dependent launches)."""
    ks, _ = kernel_modules()
    tape, ppen, plast = rings_p
    calls = {"scanres_forward": (
                 lambda n, **kw: ks.scanres_forward(*args, w[:n], si, ri, tape="snap", **kw),
                 lambda n: scanres_forward_steps(args, w[:n], si, ri, tape="snap")),
             "scanres_reverse_snap": (
                 lambda n, **kw: ks.scanres_reverse_snap(*args, ybar[:n], snap_p[:n], si, ri,
                                                         **kw),
                 lambda n: scanres_reverse_snap_steps(args, ybar[:n], snap_p[:n], si, ri)),
             "scanres_reverse": (
                 lambda n, **kw: ks.scanres_reverse(*args, w[:n], ybar[:n], tape[:n], ppen,
                                                    plast, si, ri, **kw),
                 lambda n: scanres_reverse_steps(args, w[:n], ybar[:n], tape[:n], ppen, plast,
                                                 si, ri))}
    out = {}
    for kernel, (fn, oracle) in calls.items():
        rows = device_us_per_step(lambda: fn(nt, dependent_launch=False), nt, SCANRES_PATTERN,
                                  calls=True)
        out[(kernel, "fused")] = (rows, host_us_per_step(fn))
        rows = device_us_per_step(lambda: oracle(nt), nt, SCANRES_PATTERN, calls=True)
        out[(kernel, "per-step oracle")] = (rows, host_us_per_step(oracle))
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

    # kernel 1, both tape modes, and its illumination (the plain one with
    # the ring tape's plain run)
    plain_fwd_ms, (seis_p, snap_p, ppen_p, plast_p, _) = timed_ms(
        lambda: ks.scanres_forward_plain(*args, w, si, ri, "snap"), warmup=False)
    fwd_ms, (seis, snap, ppen, plast, _) = timed_ms(
        lambda: ks.scanres_forward(*args, w, si, ri, tape="snap"), reps=3)
    plain_rf_ms, (_, rings_p, rpen_p, rlast_p, il_p) = timed_ms(
        lambda: ks.scanres_forward_plain(*args, w, si, ri, "rings", illum=True), warmup=False)
    rf_ms, (seis_r, rings, rpen, rlast, _) = timed_ms(
        lambda: ks.scanres_forward(*args, w, si, ri, tape="rings"), reps=3)
    no_rcv = ri[:0]
    il_ms, (_, _, _, _, il) = timed_ms(
        lambda: ks.scanres_forward(*args, w, si, no_rcv, illum=True), reps=3)
    errs["fwd"] = {"seis": max(rel_err(seis, seis_p), rel_err(seis_r, seis_p)),
                   "fields": max(rel_err(ppen, ppen_p), rel_err(plast, plast_p),
                                 rel_err(rpen, rpen_p), rel_err(rlast, rlast_p)),
                   "rings": rel_err(rings, rings_p), "illum": rel_err(il, il_p)}
    snap_err = float((snap.float() - snap_p.float()).abs().max())
    snap_ulp = float(snap_p.float().abs().max()) * 2.0**-7  # one bf16 ulp at max
    fwd_abs = float((torch.cat([seis, seis_r]).double()
                     - torch.cat([seis_p, seis_p]).double()).abs().max())
    entries.append(entry("scanres_forward", fwd_abs, fwd_ms / nt, plain_fwd_ms / nt,
                         counts["scanres_forward_snap"], nt))
    rings_bound = bound(counts["scanres_forward_rings"], nt)
    illum_bound = bound(counts["scanres_forward_illum"], nt)

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
        entries.append(entry(name, step_abs[name], step_ms[name][1], step_plain_ms[name],
                             counts[name], nt))

    if quiet:
        return entries
    rings_in = (rings_p, rpen_p, rlast_p)
    var_times, var_bitwise = scanres_oracles(args, w, si, ri, ybar, snap_p, rings_in, nt)
    nt_prof = 64
    prof = scanres_profile(args, w, si, ri, ybar, snap_p, rings_in, nt_prof)
    print(f"[kernels] {smi}: grid {NZ}x{NX} nt {nt}, ms per step, kernel (plain; bound):",
          flush=True)
    for e in entries:
        print(f"[kernels]   {e['name']}: {e['ms']:.5f} ({e['plain_ms']:.4f}; "
              f"{e['bound_ms']:.5f} by {e['bound_by']})", flush=True)
    print(f"[kernels]   scanres_forward with the ring tape: {rf_ms / nt:.5f} "
          f"({plain_rf_ms / nt:.4f} with illumination; {rings_bound[0]:.5f} by "
          f"{rings_bound[1]})", flush=True)
    print(f"[kernels]   scanres_forward with illumination, no receivers: {il_ms / nt:.5f} "
          f"({illum_bound[0]:.5f} by {illum_bound[1]})", flush=True)
    for name, (_, _, host_ms, dev_us, _) in step_ms.items():
        dev_ms = "not measured" if dev_us is None else f"{dev_us / 1e3:.5f} ms"
        print(f"[kernels]   {name}: host time per call {host_ms:.5f} ms, device time per call "
              f"(torch.profiler) {dev_ms}", flush=True)
    plan = ks.scanres_tile_plan(grid)
    for kernel, modes in var_times.items():
        for mode, runs in modes.items():
            print(f"[kernels] {kernel} and its per-step oracle, {mode}, nt {nt} (tile "
                  f"{plan.tz} x {plan.tx}): " + "; ".join(
                      f"{label} {ms:.5f} ms a step by CUDA events, host {host:.3f} ms a call"
                      for label, (ms, host) in runs.items()), flush=True)
    print("[kernels] every fused run == its per-step oracle bitwise (forward: seis, tape, final "
          "fields, illumination; snapshot reverse: gbar, lam_src; rings reverse: gbar, lam_src, "
          f"P_-1): {var_bitwise}", flush=True)
    for (kernel, v), (rows, host) in prof.items():
        shown = ", ".join(f"{k} {us:.2f} (x{n:.4g})" for k, us, n in rows) or "not measured"
        planned = (f" (planned {ks.STEP_LAUNCHES} a step, +1 a call)" if v == "fused" else "")
        print(f"[kernels] torch.profiler device us per step (launches per step), nt {nt_prof}, "
              f"{kernel} {v} in stream order: {shown}; device us a step "
              f"{sum(r[1] for r in rows):.2f}, launches a step {sum(r[2] for r in rows):.4g}"
              f"{planned}; host enqueue {host:.2f} us a step (nt-slope 32 to 288)", flush=True)
    print(f"[kernels] rel err {json.dumps(errs)}; snapshot max err {snap_err:.3e} vs 1 bf16 "
          f"ulp {snap_ulp:.3e}", flush=True)
    for group in errs.values():
        for name, err in group.items():
            if not err <= TOL[name]:
                fail(f"{name} disagrees with the plain version: {err:.3e} > {TOL[name]:.0e}")
    if not snap_err <= snap_ulp:
        fail(f"snapshot tape disagrees with the plain version: {snap_err:.3e} > {snap_ulp:.3e}")
    if not var_bitwise:
        fail("the fused scanres steps are not bitwise equal to their per-step oracles")
    return entries


def kstep_kernels_vs_plain(args, w, si, ri, nt, K=K_CHECK):
    """Rows 20, 21 and 7 against their plain versions over nt steps: the
    K-step forward and reverse in calls of K steps (the last the nt mod K
    that remain), the merged reverse step step by step, and 8 leapfrog
    calls (with Lap(p) on every other one); before each call the kernel's
    state is set to the plain one's, so each kernel is held on its own,
    and the plain state carries on. The reverses start from the plain
    forward's last fields and take its ring tape and seismogram. Returns
    ({kernel: {output: rel err}}, {kernel: max abs err}, {kernel: plain ms
    per call}, (ring tape, P_{nt-2}, P_{nt-1}) of the plain run)."""
    ks, kst = kernel_modules()
    kk = kstep_module()
    grid, c2, prof = args
    dev, R = c2.device, grid.radius
    NZ, NX = grid.padded_shape
    halo = (NZ + 2 * R, NX + 2 * R)
    n_ring = ks.ring_plan(grid, dev)[0].shape[0]
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)  # noqa: E731
    groups = {"kstep_forward": ("fields", "seis", "rings"),
              "kstep_reverse": ("recon", "adjoint", "gbar", "lam_src"),
              "fused_reverse_step": ("recon", "adjoint", "gbar", "lam_src"),
              "leapfrog": ("fields", "lapw")}
    errs = {k: {g: _Err(dev) for g in gs} for k, gs in groups.items()}
    held = _Held(groups)

    # forward: row 20f
    e = errs["kstep_forward"]
    fp, fk, cp, ck = z(2, *halo), z(2, *halo), z(4, *halo), z(4, *halo)
    seis_p, seis_k = z(nt, ri.shape[0]), z(nt, ri.shape[0])
    tape_p, tape_k = z(nt, n_ring), z(nt, n_ring)
    cur, prev = 1, 0
    for t0 in range(0, nt, K):
        k = min(K, nt - t0)
        held.call("kstep_forward",
                  lambda: kk.kstep_forward(grid, c2, prof, fk[cur], fk[prev], ck, w, t0, k, si,
                                           ri, seis_k, tape_k),
                  lambda: kk.kstep_forward_plain(grid, c2, prof, fp[cur], fp[prev], cp, w, t0, k,
                                                 si, ri, seis_p, tape_p),
                  ((fk, fp), (ck, cp)))
        e["fields"].add(fk, fp)
        e["fields"].add(ck, cp)
        if k % 2:
            cur, prev = prev, cur
    e["seis"].add(seis_k, seis_p)
    e["rings"].add(tape_k, tape_p)
    final = (tape_p, fp[prev].clone(), fp[cur].clone())

    # reverses: rows 20r and 21
    ybar = seis_p.contiguous()
    chain = torch.empty(2 * ri.shape[0], dtype=torch.int32, device=dev)
    for name in ("kstep_reverse", "fused_reverse_step"):
        e = errs[name]
        pp, pk = torch.stack([fp[prev], fp[cur]]), z(2, *halo)  # P_{t-1}, P_t
        qp, qk = z(2, *halo), z(2, *halo)
        ap, ak = z(kst.ADJ_PLANES, *halo), z(kst.ADJ_PLANES, *halo)
        gp, gk = z(NZ, NX), z(NZ, NX)
        lsp, lsk = z(nt, si.shape[0]), z(nt, si.shape[0])
        p_t, p_tp1, q, qo = 0, 1, 0, 1
        top = nt
        while top > 0:
            k = min(K, top) if name == "kstep_reverse" else 1
            t0 = top - k
            state = (pk[p_t], pk[p_tp1], qk[q], qk[qo], ak, gk)
            pstate = (pp[p_t], pp[p_tp1], qp[q], qp[qo], ap, gp)
            copies = ((pk, pp), (qk, qp), (ak, ap), (gk, gp))
            if name == "kstep_reverse":
                held.call(name,
                          lambda: kk.kstep_reverse(grid, c2, prof, *state, w, ybar, t0, k, si, ri,
                                                   lsk, tape_p, chain, init_chain=top == nt),
                          lambda: kk.kstep_reverse_plain(grid, c2, prof, *pstate, w, ybar, t0, k,
                                                         si, ri, lsp, tape_p),
                          copies)
            else:
                row = tape_p[t0 - 2] if t0 >= 2 else None
                held.call(name,
                          lambda: kst.fused_reverse_step(grid, c2, prof, *state, w, ybar, t0, si,
                                                         ri, lsk, row, chain,
                                                         init_chain=top == nt),
                          lambda: kst.fused_reverse_step_plain(grid, c2, prof, *pstate, w, ybar,
                                                               t0, si, ri, lsp, row),
                          copies)
            e["recon"].add(pk, pp)
            e["adjoint"].add(qk, qp)
            e["adjoint"].add(ak[[1, 3, 5, 7]], ap[[1, 3, 5, 7]])
            e["gbar"].add(gk, gp)
            if k % 2:
                p_t, p_tp1, q, qo = p_tp1, p_t, qo, q
            top = t0
        e["lam_src"].add(lsk, lsp)

    # row 7: the bare leapfrog from the last two fields
    e = errs["leapfrog"]
    lp, lk = torch.stack([fp[prev], fp[cur]]), z(2, *halo)
    lap_p, lap_k = z(NZ, NX), z(NZ, NX)
    a, b = 1, 0
    for i in range(8):
        with_lap = i % 2 == 0
        held.call("leapfrog",
                  lambda: kst.leapfrog(grid, c2, lk[a], lk[b], lap_k if with_lap else None),
                  lambda: kst.leapfrog_plain(grid, c2, lp[a], lp[b], lap_p if with_lap else None),
                  ((lk, lp),))
        e["fields"].add(lk, lp)
        if with_lap:
            e["lapw"].add(lap_k, lap_p)
        a, b = b, a
    plain_ms = held.plain_ms()
    rel = {k: {g: err.rel() for g, err in gs.items()} for k, gs in errs.items()}
    abs_err = {"kstep_forward": errs["kstep_forward"]["seis"].abs(),
               "kstep_reverse": errs["kstep_reverse"]["gbar"].abs(),
               "fused_reverse_step": errs["fused_reverse_step"]["gbar"].abs(),
               "leapfrog": errs["leapfrog"]["fields"].abs()}
    return rel, abs_err, plain_ms, final


def time_kstep_kernels(args, w, si, ri, nt, final, K=K_CHECK):
    """time_loops of rows 20, 21 and 7 over nt steps from the plain run's
    last state."""
    _, kst = kernel_modules()
    kk = kstep_module()
    grid, c2, prof = args
    dev, R = c2.device, grid.radius
    NZ, NX = grid.padded_shape
    halo = (NZ + 2 * R, NX + 2 * R)
    tape, ppen, plast = final
    f = torch.zeros((2, *halo), device=dev)
    cpml = torch.zeros((4, *halo), device=dev)
    seis = torch.zeros((nt, ri.shape[0]), device=dev)
    rows = torch.zeros_like(tape)
    p = torch.stack([ppen, plast])
    q = torch.zeros((2, *halo), device=dev)
    adj = torch.zeros((kst.ADJ_PLANES, *halo), device=dev)
    gacc = torch.zeros((NZ, NX), device=dev)
    lam = torch.zeros((nt, si.shape[0]), device=dev)
    chain = torch.empty(2 * ri.shape[0], dtype=torch.int32, device=dev)
    ybar = torch.randn((nt, ri.shape[0]), device=dev)
    lapw = torch.zeros((NZ, NX), device=dev)
    kst.fused_reverse_step(grid, c2, prof, p[0], p[1], q[0], q[1], adj, gacc, w, ybar, nt - 1,
                           si, ri, lam, None, chain, init_chain=True)

    def loops(m):
        """Each kernel's loop over m steps (with the state's role swaps)."""

        def fwd():
            for t0 in range(0, m, K):
                k = min(K, m - t0)
                kk.kstep_forward(grid, c2, prof, f[1], f[0], cpml, w, t0, k, si, ri, seis, rows)

        def rev():
            for top in range(m, 0, -K):
                k = min(K, top)
                kk.kstep_reverse(grid, c2, prof, p[0], p[1], q[0], q[1], adj, gacc, w, ybar,
                                 top - k, k, si, ri, lam, tape, chain)

        def merged():
            for t in reversed(range(m)):
                kst.fused_reverse_step(grid, c2, prof, p[t % 2], p[1 - t % 2], q[t % 2],
                                       q[1 - t % 2], adj, gacc, w, ybar, t, si, ri, lam,
                                       tape[t - 2] if t >= 2 else None, chain)

        def leap():
            for t in range(m):
                kst.leapfrog(grid, c2, f[t % 2], f[1 - t % 2], lapw)

        return {"kstep_forward": (fwd, -(-m // K), r"::(kstep_\w+?)[<(]"),
                "kstep_reverse": (rev, -(-m // K), r"::(kstep_\w+?)[<(]"),
                "fused_reverse_step": (merged, m, r"::(kstep_\w+?)[<(]"),
                "leapfrog": (leap, m, r"::(rec_cells)[<(]")}

    return time_loops(loops, nt)


def leapfrog_run(args, final, nt):
    """Row 7 driven on its own, the one route the reference has to it (a
    kernel function of its module): nt bare leapfrog steps from the plain
    forward's last two fields, Lap(p) written at each, with the counter
    set to 0 just before and read just after. Returns the launches."""
    _, kst = kernel_modules()
    grid, c2, _ = args
    _, ppen, plast = final
    f = torch.stack([ppen, plast])  # P_{t-1}, P_t
    lapw = torch.zeros(grid.padded_shape, device=c2.device)
    kst.leapfrog.launches = 0
    for t in range(nt):
        kst.leapfrog(grid, c2, f[(t + 1) % 2], f[t % 2], lapw)
    launches = kst.leapfrog.launches
    print(f"[kstep kernels] leapfrog run: {nt} steps from the last two fields, {launches} "
          "launches", flush=True)
    if not (bool(torch.isfinite(f).all()) and bool(torch.isfinite(lapw).all())):
        fail("the leapfrog run's fields are not finite")
    return launches


def phase_kstep_kernels(dev, smi, nt=NT_CHECK, nt_fs=128, quiet=False):
    """kstep_forward, kstep_reverse (K = 4), fused_reverse_step and
    leapfrog against their plain versions at the main path's grid, one
    shot, nt steps, and with the free surface at nt_fs; then their times."""
    if not quiet:  # first-use costs out of the timings
        phase_kstep_kernels(dev, smi, nt=8, nt_fs=8, quiet=True)
    ks, _ = kernel_modules()
    args, w, si, ri, _ = one_shot(dev, nt=nt)
    rel, abs_err, plain_ms, final = kstep_kernels_vs_plain(args, w, si, ri, nt)
    fs_args, fs_w, fs_si, fs_ri, _ = one_shot(dev, nt=nt_fs, free_surface=True)
    rel_fs, _, _, _ = kstep_kernels_vs_plain(fs_args, fs_w, fs_si, fs_ri, nt_fs)
    times = time_kstep_kernels(args, w, si, ri, nt, final)
    grid = args[0]
    # the same steps as ordinary launches: the single-step engine's passes'
    # device time per step (no launch gaps) against the K-step kernels',
    # which run the same phases
    m = min(64, nt)
    wp = w[:m].contiguous()
    seis_m, tape_m, pen_m, last_m, _ = scanres_forward_steps(args, wp, si, ri, tape="rings")
    scan_us = {
        "forward": device_us_per_step(
            lambda: scanres_forward_steps(args, wp, si, ri, tape="rings"), m,
            r"::((?:fwd|ring)_\w+?)[<(]"),
        "reverse": device_us_per_step(
            lambda: scanres_reverse_steps(args, wp, seis_m.contiguous(), tape_m, pen_m, last_m,
                                          si, ri, merged=False), m, r"::((?:rev|rec)_\w+?)[<(]"),
    }
    counts = step_counts(grid, ri.shape[0], si.shape[0], ks.ring_plan(grid, dev)[0].shape[0])
    steps = {"kstep_forward": K_CHECK, "kstep_reverse": K_CHECK, "fused_reverse_step": 1,
             "leapfrog": 1}  # steps per call
    entries = []
    for name, k in steps.items():
        # ms per step; the bound spreads a call's state over its k steps
        entries.append(entry(name, abs_err[name], times[name][1] / k, plain_ms[name] / k,
                             counts[name], k))
    if quiet:
        return entries
    leapfrog_launches = leapfrog_run(args, final, nt)
    for e in entries:
        if e["name"] == "leapfrog":
            e.update(route=LEAPFROG_ROUTE, launches=leapfrog_launches)
    NZ, NX = grid.padded_shape
    print(f"[kstep kernels] {smi}: grid {NZ}x{NX} nt {nt}, K {K_CHECK}: ms per call, kernel by "
          "CUDA events (per step; host per call; device per call by torch.profiler; plain per "
          "call; bound per step):", flush=True)
    for e in entries:
        calls, ms, host_ms, dev_us, rows = times[e["name"]]
        k = steps[e["name"]]
        dev_ms = "not measured" if dev_us is None else f"{dev_us / 1e3:.5f}"
        print(f"[kstep kernels]   {e['name']}: {ms:.5f} ({e['ms']:.5f}; {host_ms:.5f}; {dev_ms}; "
              f"{plain_ms[e['name']]:.4f}; {e['bound_ms']:.5f} by {e['bound_by']}), {calls} "
              "calls; device us per call: " + ", ".join(f"{n} {us:.2f}" for n, us in rows),
              flush=True)
    per_step = {d: sum(us for _, us in rows) for d, rows in scan_us.items()}
    coop = {"forward": times["kstep_forward"][3], "reverse": times["kstep_reverse"][3]}
    print("[kstep kernels] device us per step, cooperative K-step kernel against the same steps "
          "as ordinary launches (single-step kernels, torch.profiler, no launch gaps): "
          + "; ".join(
              f"{d} {'not measured' if coop[d] is None else f'{coop[d] / K_CHECK:.2f}'} against "
              f"{per_step[d]:.2f} (" + ", ".join(f"{n} {us:.2f}" for n, us in scan_us[d]) + ")"
              for d in ("forward", "reverse")), flush=True)
    print(f"[kstep kernels] rel err {json.dumps(rel)}; free surface nt {nt_fs} "
          f"{json.dumps(rel_fs)}; tolerances {json.dumps(TOL)}", flush=True)
    for group in (rel, rel_fs):
        for name, errs in group.items():
            for out, err in errs.items():
                if not err <= TOL[out]:
                    fail(f"{name} {out} disagrees with the plain version: {err:.3e} > "
                         f"{TOL[out]:.0e}")
    return entries


def phase_shot(dev, smi):
    """Kernel time of one shot's forward (with tape) + adjoint at the main
    path's nt (t_max = 4 s), and of the shot's illumination, what the
    preconditioner runs per shot and stage: the engine's (the forward
    kernel's illum mode) beside its plain version (the step twin's loop,
    what ran on the card before the kernel took it over)."""
    ks, _ = kernel_modules()
    from tpufwi_torch.acquisition import Geometry
    from tpufwi_torch.propagators.acoustic2d import AcousticPropagator

    args, w, si, ri, (vp, dt, f0, c_max) = one_shot(dev, t_max=4.0)
    nt = w.shape[0]

    def fwd_adj(steps=False):
        if steps:  # the per-step oracles
            seis, tape, _, _, _ = scanres_forward_steps(args, w, si, ri, tape="snap")
            return scanres_reverse_snap_steps(args, seis, tape, si, ri)
        seis, tape, _, _, _ = ks.scanres_forward(*args, w, si, ri, tape="snap")
        return ks.scanres_reverse_snap(*args, seis, tape, si, ri)

    def fwd_adj_rings(steps=False):
        seis, tape, ppen, plast, _ = ks.scanres_forward(*args, w, si, ri, tape="rings")
        if steps:
            return scanres_reverse_steps(args, w, seis, tape, ppen, plast, si, ri)
        return ks.scanres_reverse(*args, w, seis, tape, ppen, plast, si, ri)

    ms, (g, _) = timed_ms(fwd_adj, reps=2)
    oracle_ms, (g_s, _) = timed_ms(functools.partial(fwd_adj, True), reps=2)
    ms2, _ = timed_ms(fwd_adj, reps=2)  # fused, oracle, fused: the drift shows
    rings_ms, (gr, _) = timed_ms(fwd_adj_rings, reps=2)
    rings_oracle_ms, (gr_s, _) = timed_ms(functools.partial(fwd_adj_rings, True), reps=2)
    rings_ms2, _ = timed_ms(fwd_adj_rings, reps=2)
    fwd_ms, _ = timed_ms(lambda: ks.scanres_forward(*args, w, si, ri, tape=None))
    prop = AcousticPropagator(args[0], dt, f0, c_max, device=dev)
    launched = ks.scanres_forward.launches
    illum_ms, illum = timed_ms(lambda: prop.illumination(vp, Geometry(si, ri), w), reps=2)
    launched = ks.scanres_forward.launches - launched
    il_oracle_ms, il_s = timed_ms(lambda: scanres_forward_steps(args, w, si, ri, illum=True),
                                 reps=2)
    plain_ms, out_p = timed_ms(
        lambda: ks.scanres_forward_plain(*args, w, si, ri[:0], illum=True), warmup=False)
    err = rel_err(illum, out_p[4][args[0].interior])
    if not all(bool(torch.isfinite(x).all()) for x in (g, gr, illum)):
        fail("one-shot gradient or illumination is not finite")
    il_same = bool(torch.equal(ks.scanres_forward(*args, w, si, ri[:0], illum=True)[4], il_s[4]))
    print(f"[shot] {smi}: nt {nt}: snapshot forward+adjoint, fused steps {ms / 1e3:.4f} / "
          f"{ms2 / 1e3:.4f} s/shot, per-step oracles {oracle_ms / 1e3:.4f} (same gradient "
          f"bitwise: {bool(torch.equal(g, g_s))}); rings forward+adjoint, fused reverse "
          f"{rings_ms / 1e3:.4f} / {rings_ms2 / 1e3:.4f} s/shot, per-step oracle reverse "
          f"{rings_oracle_ms / 1e3:.4f} (same gradient bitwise: {bool(torch.equal(gr, gr_s))}); "
          f"illumination per-step oracle {il_oracle_ms / 1e3:.4f} s/shot (same bitwise: "
          f"{il_same})", flush=True)
    print(f"[shot] {smi}: nt {nt}: forward+adjoint {ms / 1e3:.3f} s/shot (snapshot), "
          f"{rings_ms / 1e3:.3f} s/shot (rings), tape-free forward {fwd_ms / 1e3:.3f} s/shot, "
          f"illumination (kernel) {illum_ms / 1e3:.4f} s/shot ({prop.resolve_impl(nt)}, "
          f"{launched} forward-kernel steps in 3 calls), its plain version {plain_ms / 1e3:.3f} "
          f"s/shot, error {err:.3e} of max (tolerance {TOL['illum']:.0e})", flush=True)
    if not (torch.equal(g, g_s) and torch.equal(gr, gr_s) and il_same):
        fail("the one-shot gradient or illumination differs between the fused scanres steps "
             "and their per-step oracles")
    if launched != 3 * nt:
        fail(f"the illumination launched the forward kernel for {launched} steps, not 3 x {nt}")
    if not err <= TOL["illum"]:
        fail(f"the illumination disagrees with its plain version: {err:.3e}")


def _value_and_grad(prop, vp, geom, w, d):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    v = vp.detach().clone().requires_grad_(True)
    J = 0.5 * ((prop(v, geom, w) - d) ** 2).sum()
    (g,) = torch.autograd.grad(J, v)
    torch.cuda.synchronize()
    return float(J.detach()), g, time.perf_counter() - t0


def phase_gradients(dev, smi):
    """One shot's gradient through the CUDA engines at nt = 4842, against
    each other on the valid region (cuda_kstep and the merged cuda_step
    against the split cuda_step, with bitwise equality reported), and the
    rings reverse's reconstruction error."""
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
             for impl in ("cuda_scansnap", "cuda_scanres", "cuda_step", "cuda_kstep")}
    props["cuda_step merged"] = AcousticPropagator(grid, dt, f0, c_max, impl="cuda_step",
                                                   merged_reverse=True, device=dev)
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
    # against the split single-step engine: (gradient, J, bitwise equal)
    vs_step = {k: (rel_err(g[k], g["cuda_step"]),
                   abs(out[k][0] - out["cuda_step"][0]) / max(out["cuda_step"][0], 1e-30),
                   bool(torch.equal(out[k][1], out["cuda_step"][1]))
                   and out[k][0] == out["cuda_step"][0])
               for k in ("cuda_kstep", "cuda_step merged")}
    seis, tape, ppen, plast, _ = ks.scanres_forward(*args, w, si, ri, tape="rings")
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
    print("[gradients] against cuda_step (split), valid region: " + ", ".join(
        f"{k} gradient {e:.3e}, J {j:.3e} (bound {STEP_GTOL:.0e}), bitwise equal {b}"
        for k, (e, j, b) in vs_step.items()), flush=True)
    print(f"[gradients] reconstruction at t = 0: max |P_-1| on the valid region "
          f"{recon_abs:.3e} (exact 0), {recon_rel:.3e} of max |P_nt-1|", flush=True)
    if not all(bool(torch.isfinite(v[1]).all()) for v in out.values()):
        fail("a gradient is not finite")
    if not err_snap <= SNAP_GTOL:
        fail(f"cuda_scanres vs cuda_scansnap gradient {err_snap:.3e} > {SNAP_GTOL:.0e}")
    if not (err_step <= STEP_GTOL and J_err <= STEP_GTOL):
        fail(f"cuda_step vs cuda_scanres gradient {err_step:.3e} or J {J_err:.3e} "
             f"> {STEP_GTOL:.0e}")
    for k, (e, j, _) in vs_step.items():
        if not (e <= STEP_GTOL and j <= STEP_GTOL):
            fail(f"{k} vs cuda_step gradient {e:.3e} or J {j:.3e} > {STEP_GTOL:.0e}")


def phase_over_budget(dev, smi):
    """The 5 m survey whose snapshot tape the card cannot hold: 'auto'
    takes the rings engine; one value-and-grad, its forward's and reverse's
    device us a step by the kernels' spans' CUDA events."""
    from tpufwi_torch import profiling
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
    profiling.clear()
    with profiling.recording():
        J, g, secs = _value_and_grad(prop, vp, Geometry(si, ri), w, torch.zeros((), device=dev))
    peak = torch.cuda.max_memory_allocated()
    us = {k.name: 1e6 * k.device_s / k.attrs["nt"] for k in profiling.spans()
          if k.name in ("kernels.forward", "kernels.reverse")}
    profiling.clear()
    snap = nt * NZ * NX * 2
    ring = nt * RingSpec.build(grid).tape_bytes_per_step()
    print(f"[over budget] snapshot tape avoided {snap / 2**30:.2f} GiB; ring tape "
          f"{ring / 2**30:.3f} GiB ({ring} bytes); value-and-grad {secs:.3f} s/shot; peak "
          f"memory {peak / 2**30:.2f} GiB; J {J:.6e}; device us a step by CUDA events: "
          f"forward {us['kernels.forward']:.2f}, reverse {us['kernels.reverse']:.2f}; "
          f"gradient finite {bool(torch.isfinite(g).all())}", flush=True)
    if not (np.isfinite(J) and bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0):
        fail("the over-budget gradient is not finite and nonzero")


def drive_merged(cfg, device):
    """invert() on the CLI's synthetic problem with its propagator replaced
    by AcousticPropagator(impl="cuda_step", merged_reverse=True); the
    observed data come first, on the split engine. Returns (vp, the
    inversion's wall seconds)."""
    from tpufwi_torch import invert
    from tpufwi_torch.io import marmousi_like
    from tpufwi_torch.propagators.acoustic2d import AcousticPropagator

    vp_true, dx = marmousi_like(nz=cfg.model.nz, nx=cfg.model.nx, dx=cfg.model.dx)
    problem, vp0 = invert.build_synthetic_problem(cfg, vp_true, dx, device=device)
    prop = problem.prop
    problem.prop = AcousticPropagator(prop.grid, prop.dt, prop.f0, prop.c_max,
                                      impl="cuda_step", merged_reverse=True, device=device)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    vp = invert.invert(problem, vp0, cfg)
    torch.cuda.synchronize()
    return vp, time.perf_counter() - t0


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
    if spec.get("merged_reverse"):
        cfg = FwiConfig().with_overrides([*overrides, f"run_dir={run_dir}"])
        vp, wall = drive_merged(cfg, device)
    else:
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
    # forward evaluations: observed data (unless made before the reset),
    # then per stage the illumination (on the whole-scan forward kernel,
    # where the preconditioner asks for it) and the first value-and-grad,
    # and per iteration the line-search trials + one value-and-grad (a
    # retried line search adds uncounted trials)
    observed = 0 if spec.get("merged_reverse") else 1
    per_stage = 2 if cfg.precond.use_illumination else 1
    fwd_min = n_shots * (observed + per_stage * len(cfg.stages) + sum(r["evals"] for r in its))
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


# ---------------------------------------------------------------- elastic


def elastic_shot(dev, nt, source_type="force_z", record="v", free_surface=False,
                 nz=351, nx=1701, dx=10.0):
    """The elastic main path's kernel inputs for one mid-line shot: the
    land model (marmousi_like without water, vs = vp / 1.9, Gardner rho),
    order 8, pml 20, a source and a receiver line (every 2 cells) at depth 2
    as the CLI lays them: (grid, dt, mats, profiles), wavelet, src_idx,
    rcv_idx on ``dev``, and (vp, vs, rho, f0, vp_max)."""
    from tpufwi_torch.adjoint_scanres import profile_source
    from tpufwi_torch.grid import Grid
    from tpufwi_torch.io import marmousi_like
    from tpufwi_torch.propagators.elastic2d import ElasticPropagator, elastic_cfl_dt
    from tpufwi_torch.wavelets import ricker_np

    vp, dx = marmousi_like(nz=nz, nx=nx, dx=dx, water_depth_m=0.0)
    grid = Grid(shape=vp.shape, h=(dx, dx), pml=20, order=8, free_surface=free_surface)
    vp_max, f0 = float(vp.max()), 12.0
    dt = elastic_cfl_dt(grid.h, vp_max, 8, safety=0.7)

    def on(x, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=dev)

    model = tuple(on(x) for x in (vp, vp / 1.9, 310.0 * vp**0.25))
    prop = ElasticPropagator(grid, dt, f0, vp_max, source_type=source_type, record=record,
                             device=dev)
    mats = tuple(m.contiguous() for m in prop.material_fields(*model))
    rx = np.arange(4, nx - 4, 2)
    src = on(np.array([[2, nx // 2]]) + grid.pad, torch.int64)
    rcv = on(np.stack([np.full(rx.size, 2), rx], 1) + grid.pad, torch.int64)
    prof = profile_source(grid, dt, f0, vp_max)(mats[0])
    return (grid, dt, mats, prof), on(ricker_np(f0, dt, nt)), src, rcv, (*model, f0, vp_max)


def elastic_nt(t_max, nz=351, nx=1701, dx=10.0):
    """Time steps of the elastic land model's survey (order 8, CFL 0.7)."""
    from tpufwi_torch.io import marmousi_like
    from tpufwi_torch.propagators.elastic2d import elastic_cfl_dt

    vp, dx = marmousi_like(nz=nz, nx=nx, dx=dx, water_depth_m=0.0)
    return int(t_max / elastic_cfl_dt((dx, dx), float(vp.max()), 8, safety=0.7))


def _max_rel(got, ref):
    return max(rel_err(a, b) for a, b in zip(got, ref))


def elastic_oracles(fn, oracle, nt):
    """``fn(dependent_launch=)`` with and without dependent launches and its
    per-step oracle ``oracle()`` in the same calls: {run: (outputs, ms a
    step by CUDA events, host ms a call (to the call's return, no sync))},
    and whether every run's outputs equal the oracle's bitwise."""
    out = {}
    runs = {"fused": functools.partial(fn, dependent_launch=True),
            "fused in stream order": functools.partial(fn, dependent_launch=False),
            "per-step oracle": oracle}
    for label, run in runs.items():
        ev_ms, host_ms = events_ms(run, 3)
        out[label] = (run(), ev_ms / nt, host_ms)

    def flat(o):
        return [x for part in o for x in (part if isinstance(part, tuple) else (part,))]

    ref = flat(out["per-step oracle"][0])
    return out, all((a is None and b is None) or torch.equal(a, b)
                    for r in out.values() for a, b in zip(flat(r[0]), ref))


def elastic_kernels_vs_plain(dev, nt, source_type, record, free_surface):
    """Both elastic kernels against their plain versions on one shot, and
    each kernel (also in plain stream order) held bitwise against its
    per-step oracle, the per-step engine's estep_forward / estep_reverse,
    in the same calls: ({output: rel err}, entries' numbers)."""
    from tpufwi_torch.adjoint_elastic_step import estep_reverse

    ke = elastic_module()
    args, w, si, ri, _ = elastic_shot(dev, nt, source_type, record, free_surface)
    kind = (source_type, record)
    plain_ms, (seis_p, tape_p, fin_p) = timed_ms(
        lambda: ke.escan_forward_plain(*args, w, si, ri, *kind, tape=True), warmup=False)
    fwd, fwd_bitwise = elastic_oracles(
        functools.partial(ke.escan_forward, *args, w, si, ri, *kind, tape=True),
        functools.partial(estep_module().estep_forward, *args, w, si, ri, *kind, tape=True), nt)
    (seis, tape, fin), ms = fwd["fused"][0], fwd["fused"][1] * nt
    free_ms, (seis_n, _, _) = timed_ms(
        lambda: ke.escan_forward(*args, w, si, ri, *kind, tape=False), reps=3)
    scale = max(float(f.abs().max()) for f in fin_p)
    errs = {"seis": max(rel_err(seis, seis_p), rel_err(seis_n, seis_p)),
            "finals": _max_rel(fin, fin_p),
            "tape": float((tape - tape_p).abs().max()) / scale}
    ybar = seis_p.contiguous()
    plain_rev_ms, (g_p, sr_p) = timed_ms(
        lambda: ke.escan_reverse_plain(*args, w, ybar, tape_p, fin_p, si, ri, *kind),
        warmup=False)
    rev, rev_bitwise = elastic_oracles(
        functools.partial(ke.escan_reverse, *args, w, ybar, tape_p, fin_p, si, ri, *kind),
        functools.partial(estep_reverse, *args, w, ybar, tape_p, fin_p, si, ri, *kind), nt)
    g, sr = rev["fused"][0]
    errs.update(grads=_max_rel(g, g_p), srcrow=rel_err(sr, sr_p))
    nums = dict(
        fwd=(float((seis.double() - seis_p.double()).abs().max()), ms / nt, plain_ms / nt),
        free_ms=free_ms / nt,
        rev=(max(float((a.double() - b.double()).abs().max()) for a, b in zip(g, g_p)),
             rev["fused"][1], plain_rev_ms / nt),
        runs={v: r[1:] for v, r in rev.items()},
        fwd_runs={v: r[1:] for v, r in fwd.items()},
        bitwise=rev_bitwise, fwd_bitwise=fwd_bitwise,
        counts=elastic_step_counts(args[0], seis.shape[1] * (2 if record == "v" else 1),
                                   si.shape[0], tape.shape[1] // 5),
        grid="x".join(map(str, args[0].padded_shape)),
    )
    return errs, nums


def device_us_per_step(run, nt, pattern, calls=False):
    """Device time per step of each CUDA kernel whose name ``pattern``
    captures, over one ``run()`` after a warm-up one, from torch.profiler,
    sorted by time: [(kernel, us per step)] ([(kernel, us per step, launches
    per step)] with ``calls``), empty when the profiler sees no device
    time."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        m = re.search(pattern, e.key)
        if us > 0 and m:
            rows.append((m.group(1), us / nt) + ((e.count / nt,) if calls else ()))
    return sorted(rows, key=lambda r: -r[1])


def host_enqueue_ms(run):
    """Host ms of one ``run()`` from its call to its return (the launches
    enqueued, not waited for), after a warm-up run."""
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    return ms


def elastic_profile(dev, nt=64):
    """Device us per step (and launches per step) of each CUDA kernel of
    one escan_forward with tape and one escan_reverse, and of their
    per-step oracles, and the calls' host enqueue ms: {(kernel, run):
    (rows, host ms a call)}. The fused kernels are profiled in plain stream
    order (with dependent launches a kernel's span includes its wait for
    the one before it, so the spans overlap); their host ms is with
    dependent launches."""
    from tpufwi_torch.adjoint_elastic_step import estep_reverse

    ke = elastic_module()
    args, w, si, ri, _ = elastic_shot(dev, nt)
    kind = ("force_z", "v")
    pattern = r"::(e[fr]?_\w+?)[<(]"
    seis, tape, fin = ke.escan_forward(*args, w, si, ri, *kind, tape=True)
    calls = {"forward": (
                 functools.partial(ke.escan_forward, *args, w, si, ri, *kind, tape=True),
                 functools.partial(estep_module().estep_forward, *args, w, si, ri, *kind,
                                   tape=True)),
             "reverse": (
                 functools.partial(ke.escan_reverse, *args, w, seis.contiguous(), tape, fin, si,
                                   ri, *kind),
                 functools.partial(estep_reverse, *args, w, seis.contiguous(), tape, fin, si, ri,
                                   *kind))}
    out = {}
    for kernel, (fn, oracle) in calls.items():
        serial = functools.partial(fn, dependent_launch=False)
        out[(kernel, "fused")] = (device_us_per_step(serial, nt, pattern, calls=True),
                                  host_enqueue_ms(fn))
        out[(kernel, "per-step oracle")] = (device_us_per_step(oracle, nt, pattern, calls=True),
                                            host_enqueue_ms(oracle))
    return out


def phase_elastic_kernels(dev, smi, nt=NT_CHECK, nt_fs=128):
    """escan_forward (with and without tape) and escan_reverse against
    their plain versions: the main path's force / v case at nt, and a
    pressure / p free-surface case at nt_fs; each kernel and its per-step
    oracle in the same calls, held bitwise against each other."""
    elastic_kernels_vs_plain(dev, 8, "force_z", "v", False)  # first-use costs
    ke = elastic_module()
    before = (ke.escan_forward.launches, ke.escan_reverse.launches)
    errs, nums = elastic_kernels_vs_plain(dev, nt, "force_z", "v", False)
    errs_fs, nums_fs = elastic_kernels_vs_plain(dev, nt_fs, "pressure", "p", True)
    launched = (ke.escan_forward.launches - before[0], ke.escan_reverse.launches - before[1])
    c = nums["counts"]
    entries = [entry("escan_forward", *nums["fwd"], c["escan_forward_rings"], nt),
               entry("escan_reverse", *nums["rev"], c["escan_reverse"], nt)]
    free_bound = bound(c["escan_forward"], nt)
    print(f"[elastic kernels] {smi}: grid {nums['grid']} order 8, force_z / v, nt {nt}, ms "
          "per step, kernel (plain; bound):", flush=True)
    for e in entries:
        print(f"[elastic kernels]   {e['name']}: {e['ms']:.5f} ({e['plain_ms']:.4f}; "
              f"{e['bound_ms']:.5f} by {e['bound_by']})", flush=True)
    print(f"[elastic kernels]   escan_forward without tape: {nums['free_ms']:.5f} "
          f"({free_bound[0]:.5f} by {free_bound[1]})", flush=True)
    streamed = bound(c["escan_forward_streamed"], nt)
    print(f"[elastic kernels]   escan_forward streamed floor (the five fields in and out, the "
          f"five materials, the strip memories, tape and seis from and to device memory once a "
          f"step): {streamed[0]:.5f} ms a step by {streamed[1]}", flush=True)
    print(f"[elastic kernels]   free surface, pressure / p, nt {nt_fs}: forward "
          f"{nums_fs['fwd'][1]:.5f} ({nums_fs['fwd'][2]:.4f}), reverse {nums_fs['rev'][1]:.5f} "
          f"({nums_fs['rev'][2]:.4f})", flush=True)
    for tag, n, ns in (("force_z / v", nt, nums), ("free surface, pressure / p", nt_fs, nums_fs)):
        for kernel, key, outs, ok in (
                ("escan_forward", "fwd_runs", "seis, tape, five finals", "fwd_bitwise"),
                ("escan_reverse", "runs", "five gradients, srcrow", "bitwise")):
            print(f"[elastic kernels] {kernel} and its per-step oracle, {tag}, nt {n} (tile "
                  f"{ke.TILE_Z} x {ke.TILE_X}): " + "; ".join(
                      f"{v} {ms:.5f} ms a step by CUDA events, host {host:.3f} ms a call"
                      for v, (ms, host) in ns[key].items())
                  + f"; every fused run == its oracle bitwise ({outs}): {ns[ok]}", flush=True)
    print(f"[elastic kernels] rel err force/v {json.dumps(errs)}; pressure/p free surface "
          f"{json.dumps(errs_fs)}; tolerances {json.dumps(ETOL)}; launches in these checks: "
          f"escan_forward {launched[0]}, escan_reverse {launched[1]}", flush=True)
    nt_prof = 64
    prof = elastic_profile(dev, nt_prof)

    def show(rows):
        return ", ".join(f"{k} {us:.2f} (x{n:g})" for k, us, n in rows) or "not measured"

    print("[elastic kernels] torch.profiler device us per step (launches per step), nt "
          f"{nt_prof}:", flush=True)
    for (kernel, v), (rows, host) in prof.items():
        planned = ""
        if v == "fused":
            planned = " (planned {})".format(
                ke.FORWARD_LAUNCHES if kernel == "forward" else ke.reverse_launches(False))
        print(f"[elastic kernels]   {kernel} {v}{' in stream order' if planned else ''}: "
              f"{show(rows)}; device us a step {sum(r[1] for r in rows):.2f}, launches a step "
              f"{sum(r[2] for r in rows):g}{planned}; host enqueue {host:.3f} ms a call, "
              f"{1e3 * host / nt_prof:.2f} us a step", flush=True)
    for group in (errs, errs_fs):
        for name, err in group.items():
            if not err <= ETOL[name]:
                fail(f"elastic {name} disagrees with the plain version: {err:.3e} > "
                     f"{ETOL[name]:.0e}")
    if not (nums["bitwise"] and nums_fs["bitwise"]):
        fail("escan_reverse's fused passes are not bitwise equal to its per-step oracle")
    if not (nums["fwd_bitwise"] and nums_fs["fwd_bitwise"]):
        fail("escan_forward's fused step is not bitwise equal to its per-step oracle")
    return entries


def phase_elastic_shot(dev, smi):
    """One shot at the main path's nt (t_max 4 s) on cuda_escan: the
    tape-free forward and a value-and-grad of 0.5 |seis(m0) - d|^2."""
    from tpufwi_torch.acquisition import Geometry
    from tpufwi_torch.propagators.elastic2d import ElasticPropagator

    nt = elastic_nt(4.0)
    args, w, si, ri, (vp, vs, rho, f0, vp_max) = elastic_shot(dev, nt)
    grid, dt = args[0], args[1]
    prop = ElasticPropagator(grid, dt, f0, vp_max, source_type="force_z", record="v",
                             device=dev)
    impl = prop.fix_impl_for(nt=nt)
    geom = Geometry(si, ri)
    fwd_ms, d = timed_ms(lambda: prop(vp, vs, rho, geom, w))
    smooth = [torch.nn.functional.avg_pool2d(x[None, None], 9, 1, 4,
                                             count_include_pad=False)[0, 0] for x in (vp, vs)]

    def value_and_grad():
        m = [x.detach().clone().requires_grad_(True) for x in (*smooth, rho)]
        J = 0.5 * ((prop(*m, geom, w) - d) ** 2).sum()
        return (J.detach(), *torch.autograd.grad(J, m))

    value_and_grad()  # warm-up
    torch.cuda.reset_peak_memory_stats()
    vg_ms, (J, *g) = timed_ms(value_and_grad, warmup=False)
    peak = torch.cuda.max_memory_allocated()
    finite = all(bool(torch.isfinite(x).all()) for x in g) and bool(torch.isfinite(J))
    print(f"[elastic shot] {smi}: nt {nt}, impl {impl} ({prop.resolve_note}): forward "
          f"{fwd_ms / 1e3:.3f} s, value-and-grad {vg_ms / 1e3:.3f} s, ring tape "
          f"{prop.tape_bytes(nt)} bytes ({prop.tape_bytes(nt) / 2**30:.3f} GiB), peak memory "
          f"{peak / 2**30:.2f} GiB, J {float(J):.6e}, gradient finite {finite}", flush=True)
    if impl != "cuda_escan" or not finite or float(g[0].abs().max()) == 0.0:
        fail("the elastic one-shot gradient is not finite and nonzero on cuda_escan")


# ------------------------------------------------------- elastic per-step


# the ETOL key of each output group of the per-step kernels
ESTEP_TOL = {"fields_v": "finals", "mem_v": "finals", "fields_s": "finals", "mem_s": "finals",
             "seis": "seis", "tape": "tape", "recon_s": "finals", "cot_s": "grads",
             "dual_s": "grads", "grads_s": "grads", "srcrow": "srcrow", "recon_v": "finals",
             "cot_v": "grads", "dual_v": "grads", "grads_v": "grads"}


def estep_kernels_vs_plain(args, w, si, ri, nt, source_type, record):
    """Kernels 10a-11b against their plain versions over nt steps of one
    shot: before each call the kernel's state is set to the plain one's, so
    each kernel is held on its own, and the plain state carries on; the
    reverse starts from the plain forward's last state and takes its tape
    and seismogram. Errors are per plane (each field, memory, cotangent,
    dual and gradient against its own max; a tape row's part against its
    field's max). Returns ({group: rel err}, {kernel: max abs err},
    {kernel: plain ms per call}, (forward state, tape, seismogram) of the
    plain run)."""
    kes = estep_module()
    grid, dt, mats, prof = args
    dev = mats[0].device
    kind = (source_type, record)
    nrec, nsrc = ri.shape[0], si.shape[0]
    n = kernel_modules()[0].ring_plan(grid, dev)[0].shape[0]
    errs = {k: [] for k in ESTEP_TOL}
    held = _Held(ESTEP_NAMES)

    def add(group, got, ref, scales=None):
        """Running errors of each plane (along dim 0) of got."""
        while len(errs[group]) < got.shape[0]:
            errs[group].append(_Err(dev))
        for k in range(got.shape[0]):
            errs[group][k].add(got[k], ref[k], None if scales is None else scales[k])

    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)  # noqa: E731
    sp, sk = (kes.zero_elastic_step_state(grid, device=dev) for _ in range(2))
    shape = (nt, nrec, 2) if record == "v" else (nt, nrec)
    seis_p, seis_k = z(*shape), z(*shape)
    tape_p, tape_k = z(nt, 5 * n), z(nt, 5 * n)
    for t in range(nt):
        held.call("estep_v", lambda: kes.estep_v(grid, dt, mats, prof, sk),
                  lambda: kes.estep_v_plain(grid, dt, mats, prof, sp), zip(sk, sp))
        add("fields_v", sk.fields[:2], sp.fields[:2])
        add("mem_v", sk.mem[:4], sp.mem[:4])
        held.call("estep_s",
                  lambda: kes.estep_s(grid, dt, mats, prof, sk, w, t, si, ri, seis_k, tape_k[t],
                                      *kind),
                  lambda: kes.estep_s_plain(grid, dt, mats, prof, sp, w, t, si, ri, seis_p,
                                            tape_p[t], *kind),
                  zip(sk, sp))
        add("fields_s", sk.fields, sp.fields)
        add("mem_s", sk.mem[4:], sp.mem[4:])
        scales = sp.fields.abs().amax((1, 2))
        add("tape", tape_k[t].view(5, n), tape_p[t].view(5, n), scales)
    add("seis", seis_k[None], seis_p[None])

    ybar = seis_p.contiguous()
    rp, rk = (kes.zero_elastic_reverse_state(grid, device=dev) for _ in range(2))
    rp.fields.copy_(sp.fields)
    srcrow_p, srcrow_k = z(nt, nsrc), z(nt, nsrc)
    chain = torch.empty(2 * nrec, dtype=torch.int32, device=dev)
    for t in reversed(range(nt)):
        row = tape_p[t - 1] if t >= 1 else None
        held.call("estep_rs",
                  lambda: kes.estep_rs(grid, dt, mats, prof, rk, w, ybar, t, si, ri, srcrow_k,
                                       row, *kind, chain, init_chain=t == nt - 1),
                  lambda: kes.estep_rs_plain(grid, dt, mats, prof, rp, w, ybar, t, si, ri,
                                             srcrow_p, row, *kind),
                  zip(rk, rp))
        add("recon_s", rk.fields, rp.fields)
        add("cot_s", rk.cot, rp.cot)
        add("dual_s", rk.dual[:4], rp.dual[:4])
        add("grads_s", rk.grads[:3], rp.grads[:3])
        held.call("estep_rv", lambda: kes.estep_rv(grid, dt, mats, prof, rk, row),
                  lambda: kes.estep_rv_plain(grid, dt, mats, prof, rp, row), zip(rk, rp))
        add("recon_v", rk.fields, rp.fields)
        add("cot_v", rk.cot, rp.cot)
        add("dual_v", rk.dual[4:], rp.dual[4:])
        add("grads_v", rk.grads[3:], rp.grads[3:])
    add("srcrow", srcrow_k[None], srcrow_p[None])
    plain_ms = held.plain_ms()
    rel = {g: max(e.rel() for e in es) for g, es in errs.items()}
    abs_err = {"estep_v": max(e.abs() for e in errs["fields_v"]),
               "estep_s": errs["seis"][0].abs(),
               "estep_rs": max(e.abs() for e in errs["grads_s"]),
               "estep_rv": max(e.abs() for e in errs["grads_v"])}
    return rel, abs_err, plain_ms, (sp, tape_p, ybar)


def time_estep_kernels(args, w, si, ri, nt, final, source_type, record):
    """time_loops of each per-step kernel over nt calls from the plain
    run's states."""
    kes = estep_module()
    grid, dt, mats, prof = args
    dev = mats[0].device
    kind = (source_type, record)
    state, tape, ybar = final
    fwd = kes.zero_elastic_step_state(grid, device=dev)
    kes.copy_into(fwd, state)
    seis = torch.zeros_like(ybar)
    rows = torch.zeros_like(tape)
    rev = kes.zero_elastic_reverse_state(grid, device=dev)
    rev.fields.copy_(state.fields)
    srcrow = torch.zeros((ybar.shape[0], si.shape[0]), device=dev)
    chain = torch.empty(2 * ri.shape[0], dtype=torch.int32, device=dev)
    kes.estep_rs(grid, dt, mats, prof, rev, w, ybar, nt - 1, si, ri, srcrow, None, *kind, chain,
                 init_chain=True)

    def loops(m):
        pattern = r"::(e[fr]?_\w+?)[<(]"
        return {
            "estep_v": (lambda: [kes.estep_v(grid, dt, mats, prof, fwd) for _ in range(m)], m,
                        pattern),
            "estep_s": (lambda: [kes.estep_s(grid, dt, mats, prof, fwd, w, t, si, ri, seis,
                                             rows[t], *kind) for t in range(m)], m, pattern),
            "estep_rs": (lambda: [kes.estep_rs(grid, dt, mats, prof, rev, w, ybar, t, si, ri,
                                               srcrow, tape[t], *kind, chain)
                                  for t in reversed(range(m))], m, pattern),
            "estep_rv": (lambda: [kes.estep_rv(grid, dt, mats, prof, rev, tape[t])
                                  for t in reversed(range(m))], m, pattern),
        }

    return time_loops(loops, nt)


def phase_estep_kernels(dev, smi, nt=NT_CHECK, nt_fs=128):
    """estep_v, estep_s, estep_rs and estep_rv against their plain versions
    step by step: the elastic main path's force / v case at nt, and a
    pressure / p free-surface case at nt_fs; then each kernel's times."""
    warm = elastic_shot(dev, 8)
    estep_kernels_vs_plain(*warm[:4], 8, "force_z", "v")  # first-use costs
    args, w, si, ri, _ = elastic_shot(dev, nt)
    rel, abs_err, plain_ms, final = estep_kernels_vs_plain(args, w, si, ri, nt, "force_z", "v")
    times = time_estep_kernels(args, w, si, ri, nt, final, "force_z", "v")
    fs_args, fs_w, fs_si, fs_ri, _ = elastic_shot(dev, nt_fs, "pressure", "p", free_surface=True)
    rel_fs, _, _, _ = estep_kernels_vs_plain(fs_args, fs_w, fs_si, fs_ri, nt_fs, "pressure", "p")
    counts = elastic_step_counts(args[0], 2 * ri.shape[0], si.shape[0],
                                 final[1].shape[1] // 5)
    entries = [entry(name, abs_err[name], times[name][1], plain_ms[name], counts[name], nt)
               for name in ESTEP_NAMES]
    print(f"[estep kernels] {smi}: grid {'x'.join(map(str, args[0].padded_shape))} order 8, "
          f"force_z / v, nt {nt}, ms per call, kernel by CUDA events (host per call; device "
          "per call by torch.profiler; plain; bound):", flush=True)
    for e in entries:
        _, _, host_ms, dev_us, rows = times[e["name"]]
        dev_ms = "not measured" if dev_us is None else f"{dev_us / 1e3:.5f}"
        print(f"[estep kernels]   {e['name']}: {e['ms']:.5f} ({host_ms:.5f}; {dev_ms}; "
              f"{e['plain_ms']:.4f}; {e['bound_ms']:.5f} by {e['bound_by']}); device us: "
              + ", ".join(f"{k} {us:.2f}" for k, us in rows), flush=True)
    print(f"[estep kernels] rel err force/v {json.dumps(rel)}; pressure/p free surface nt "
          f"{nt_fs} {json.dumps(rel_fs)}; tolerances {json.dumps(ETOL)}", flush=True)
    for group in (rel, rel_fs):
        for name, err in group.items():
            if not err <= ETOL[ESTEP_TOL[name]]:
                fail(f"per-step elastic {name} disagrees with the plain version: {err:.3e} > "
                     f"{ETOL[ESTEP_TOL[name]]:.0e}")
    return entries


def phase_estep_shot(dev, smi):
    """One shot at the main path's nt (t_max 4 s) through cuda_estep and
    cuda_escan: the tape-free seismograms and forward_fused, then a
    value-and-grad of 0.5 |seis(m0) - d|^2 in the five material fields on
    each engine; each against the other within the reference's 1e-5 of
    the maximum (tests/test_elastic_pallas.py)."""
    from tpufwi_torch.acquisition import Geometry
    from tpufwi_torch.adjoint_elastic_scan import make_elastic_simulator_scan
    from tpufwi_torch.adjoint_elastic_step import make_elastic_simulator_fused
    from tpufwi_torch.propagators.elastic2d import ElasticPropagator

    nt = elastic_nt(4.0)
    args, w, si, ri, (vp, vs, rho, f0, vp_max) = elastic_shot(dev, nt)
    grid, dt = args[0], args[1]
    geom = Geometry(si, ri)
    kw = dict(source_type="force_z", record="v", device=dev)
    props = {impl: ElasticPropagator(grid, dt, f0, vp_max, impl=impl, **kw)
             for impl in ("cuda_escan", "cuda_estep")}
    fwd = {}
    with torch.no_grad():
        for impl, prop in props.items():
            fwd[impl] = timed_ms(lambda p=prop: p(vp, vs, rho, geom, w), warmup=False)
    fused_ms, fused = timed_ms(lambda: props["cuda_estep"].forward_fused(vp, vs, rho, geom, w),
                               warmup=False)
    d = fwd["cuda_escan"][1]
    smooth = [torch.nn.functional.avg_pool2d(x[None, None], 9, 1, 4,
                                             count_include_pad=False)[0, 0] for x in (vp, vs)]
    mats0 = tuple(m.detach().contiguous() for m in props["cuda_escan"].material_fields(*smooth,
                                                                                       rho))
    sims = {"cuda_escan": make_elastic_simulator_scan(grid, dt, f0, vp_max, "force_z", "v"),
            "cuda_estep": make_elastic_simulator_fused(grid, dt, f0, vp_max, "force_z", "v")}

    def value_and_grad(sim):
        m = [x.clone().requires_grad_(True) for x in mats0]
        seis = sim(*m, w, si, ri)
        J = 0.5 * ((seis - d) ** 2).sum()
        return (J.detach(), seis.detach(), *torch.autograd.grad(J, m))

    vg = {}
    for impl, sim in sims.items():
        torch.cuda.reset_peak_memory_stats()
        ms, out = timed_ms(lambda s=sim: value_and_grad(s), warmup=False)
        vg[impl] = (ms, out, torch.cuda.max_memory_allocated())
    a, b = vg["cuda_estep"][1], vg["cuda_escan"][1]
    errs = {"seis": rel_err(fwd["cuda_estep"][1], d), "seis_vg": rel_err(a[1], b[1]),
            "J": abs(float(a[0]) - float(b[0])) / abs(float(b[0])),
            "grads": max(rel_err(x, y) for x, y in zip(a[2:], b[2:])),
            "fused_vs_escan": rel_err(fused, d), "fused_vs_estep": rel_err(fused, fwd["cuda_estep"][1])}
    bitwise = all(bool(torch.equal(x, y)) for x, y in zip(a[1:], b[1:]))
    print(f"[estep shot] {smi}: nt {nt}, one shot, force_z / v: tape-free forward cuda_estep "
          f"{fwd['cuda_estep'][0] / 1e3:.3f} s, cuda_escan {fwd['cuda_escan'][0] / 1e3:.3f} s, "
          f"forward_fused {fused_ms / 1e3:.3f} s; value-and-grad cuda_estep "
          f"{vg['cuda_estep'][0] / 1e3:.3f} s (peak {vg['cuda_estep'][2] / 2**30:.2f} GiB), "
          f"cuda_escan {vg['cuda_escan'][0] / 1e3:.3f} s (peak "
          f"{vg['cuda_escan'][2] / 2**30:.2f} GiB); J {float(a[0]):.6e}", flush=True)
    print(f"[estep shot] cuda_estep against cuda_escan, of max: {json.dumps(errs)}; seismogram "
          f"and five gradients bitwise equal: {bitwise}", flush=True)
    if not all(bool(torch.isfinite(x).all()) for x in a[1:]) or float(a[2].abs().max()) == 0.0:
        fail("the cuda_estep gradient is not finite and nonzero")
    for name, err in errs.items():
        if not err <= 1e-5:
            fail(f"cuda_estep {name} off cuda_escan's by {err:.3e} > 1e-5")


# The SASS of the reverse's fused passes without the free surface (er_s /
# er_v<R, 16, 32, false>), as nvcc NVCC_BUILD compiles them: (kernel, R) ->
# (sass_functions' digest, registers). The free-surface flag must leave
# this instantiation's code as it was before the flag existed; a change to
# the land path of er_s / er_v updates this table deliberately.
NVCC_BUILD = "Build cuda_12.9.r12.9/compiler.36037853_0"
LAND_REVERSE_SASS = {
    ("er_s", 1): ("42fd05bbc47af83a", 64), ("er_s", 2): ("e57d86931b1eab5d", 64),
    ("er_s", 4): ("aa8d141b15677d60", 64), ("er_v", 1): ("75accbcd21cac0b2", 64),
    ("er_v", 2): ("cbc9a73c953303df", 64), ("er_v", 4): ("38424404f5f966dc", 64),
}


def sass_functions(so, pattern):
    """{mangled name: digest} of each function of the library ``so`` whose
    name ``pattern`` matches, from cuobjdump -sass: a sha1 of the
    instruction text alone (addresses and encodings dropped, branch labels
    renumbered in order of appearance), so that two builds of the same code
    compare equal whatever the functions around it."""
    from tpufwi_torch.kernels import build

    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True,
                         check=True).stdout
    funcs, name, lines, labels = {}, None, [], {}

    def label(m):
        return "L%d" % labels.setdefault(m.group(0), len(labels))

    for line in out.splitlines() + ["Function : end"]:
        m = re.search(r"Function : (\S+)", line)
        if m:
            if name and re.search(pattern, name):
                funcs[name] = hashlib.sha1("\n".join(lines).encode()).hexdigest()[:16]
            name, lines, labels = m.group(1), [], {}
        elif (m := re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)) or \
                (m := re.match(r"\s*(\.L_x_\d+:)", line)):
            lines.append(re.sub(r"\.L_x_\d+", label, m.group(1)))
    return funcs


def ptxas_resources(log, pattern):
    """{mangled name: (registers, spill store bytes, spill load bytes)} of
    each entry function of an nvcc log (ptxas -v) whose name ``pattern``
    matches."""
    res, name, spill = {}, None, (0, 0)
    for line in log.read_text().splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            name, spill = m.group(1), (0, 0)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spill = (int(m.group(1)), int(m.group(2)))
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            if re.search(pattern, name):
                res[name] = (int(m.group(1)), *spill)
            name = None
    return res


def reverse_pass_key(name):
    """(kernel, R, "fs" or "land") of a mangled er_s / er_v<R, 16, 32[,
    kFS]> name (no flag: the land code)."""
    m = re.search(r"(er_[sv])ILi(\d)ELi16ELi32E(?:Lb([01])E)?E", name)
    return m and (m.group(1), int(m.group(2)), "fs" if m.group(3) == "1" else "land")


def reverse_pass_code(so, log):
    """{(kernel, R, "fs" / "land"): (digest, registers, spill stores, spill
    loads)} of the reverse's fused passes in the elastic library ``so``
    (resources from its nvcc log ``log``)."""
    sass = {reverse_pass_key(n): h for n, h in sass_functions(so, r"er_[sv]ILi").items()}
    res = {reverse_pass_key(n): r for n, r in ptxas_resources(log, r"er_[sv]ILi").items()}
    return {k: (sass[k], *res.get(k, (None, None, None))) for k in sorted(sass)}


def check_reverse_pass_code():
    """The land instantiation of er_s / er_v at every order against
    LAND_REVERSE_SASS (compared only under the nvcc build it was recorded
    with), and no spill in any instantiation."""
    from tpufwi_torch.kernels import build

    ke = elastic_module()
    ke.load_library()
    version = subprocess.run([build.nvcc(), "--version"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[-1]
    code = reverse_pass_code(ke.LIBRARY.path, ke.LIBRARY.log)
    for (kernel, R, kind), (digest, regs, st, ld) in code.items():
        print(f"[reverse passes] {kernel}<R={R}, {kind}>: sass {digest}, {regs} registers, "
              f"spill stores {st} B, loads {ld} B", flush=True)
    if not code or any(st != 0 or ld != 0 for _, _, st, ld in code.values()):
        fail("a reverse pass spills, or none was found in the elastic library")
    if version != NVCC_BUILD:
        print(f"[reverse passes] land SASS not compared: nvcc {version}, the table's "
              f"{NVCC_BUILD}", flush=True)
        return
    land = {(k, R): v[:2] for (k, R, kind), v in code.items() if kind == "land"}
    same = land == LAND_REVERSE_SASS
    print(f"[reverse passes] land er_s / er_v SASS and registers as recorded: {same}", flush=True)
    if not same:
        fail("the land instantiation of er_s / er_v changed its SASS or registers")


MARINE_NT = 4885  # the marine cell's: t_max 4 s at the CFL 0.7 step for 4700 m/s
MARINE_WATER_M = 450.0


def marine_shot(dev, nt, nz=351, nx=1701, dx=10.0):
    """The marine cell's kernel inputs for one mid-line shot: marmousi_like
    with its water layer (vp 1500, vs 0, rho 1000 above the seabed; vs = vp
    / 1.9 and Gardner's rho below it), order 8, pml 20 on the bottom and the
    sides, the free surface, a pressure source at depth 2 and hydrophones
    every 2 cells at depth 2: (grid, dt, mats, profiles), wavelet, src_idx,
    rcv_idx on ``dev``, and (vp, vs, rho, f0, vp_max, water rows)."""
    from tpufwi_torch.adjoint_scanres import profile_source
    from tpufwi_torch.grid import Grid
    from tpufwi_torch.io import marmousi_like
    from tpufwi_torch.propagators.elastic2d import ElasticPropagator, elastic_cfl_dt
    from tpufwi_torch.wavelets import ricker_np

    vp, dx = marmousi_like(nz=nz, nx=nx, dx=dx, water_depth_m=MARINE_WATER_M)
    nw = int(MARINE_WATER_M / dx)
    vs, rho = vp / 1.9, 310.0 * vp**0.25
    vs[:nw], rho[:nw] = 0.0, 1000.0
    grid = Grid(shape=vp.shape, h=(dx, dx), pml=20, order=8, free_surface=True)
    vp_max, f0 = 4700.0, 12.0
    dt = elastic_cfl_dt(grid.h, vp_max, 8, safety=0.7)

    def on(x, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=dev)

    model = tuple(on(x) for x in (vp, vs, rho))
    prop = ElasticPropagator(grid, dt, f0, vp_max, source_type="pressure", record="p",
                             device=dev)
    mats = tuple(m.contiguous() for m in prop.material_fields(*model))
    rx = np.arange(0, nx, 2)
    src = on(np.array([[2, nx // 2]]) + grid.pad, torch.int64)
    rcv = on(np.stack([np.full(rx.size, 2), rx], 1) + grid.pad, torch.int64)
    prof = profile_source(grid, dt, f0, vp_max)(mats[0])
    return (grid, dt, mats, prof), on(ricker_np(f0, dt, nt)), src, rcv, (*model, f0, vp_max, nw)


def phase_marine_shot(dev, smi, nt=MARINE_NT, nt_prof=256):
    """One shot of the marine cell (351 x 1701, the water layer, the free
    surface, a pressure source, hydrophones) at its nt through cuda_escan
    and cuda_estep: a value-and-grad of 0.5 |seis(m0) - d|^2 in the five
    material fields and the wavelet on each, bitwise equal (the same
    per-cell bodies), and escan_image_steps raised by nt by the reverse.
    Then the reverse alone, fed the shot's tape: us a step by CUDA events
    with dependent launches and in plain stream order, and torch.profiler's
    device us and launches a step of each pass in stream order over the
    first ``nt_prof`` steps (2 a step and the call's own, checked; the
    images run in er_s and er_v), with what remains of the image launches.
    Last check_reverse_pass_code: er_s / er_v's land code as recorded, and
    no spill."""
    from tpufwi_torch import profiling
    from tpufwi_torch.adjoint_elastic_scan import make_elastic_simulator_scan
    from tpufwi_torch.adjoint_elastic_step import make_elastic_simulator_fused
    from tpufwi_torch.propagators.elastic2d import ElasticPropagator

    ke = elastic_module()
    args, w, si, ri, (vp, vs, rho, f0, vp_max, nw) = marine_shot(dev, nt)
    grid, dt, mats, prof = args
    kind = ("pressure", "p")
    sims = {"cuda_escan": make_elastic_simulator_scan(grid, dt, f0, vp_max, *kind),
            "cuda_estep": make_elastic_simulator_fused(grid, dt, f0, vp_max, *kind)}
    with torch.no_grad():
        fwd_ms, d = timed_ms(lambda: sims["cuda_escan"](*mats, w, si, ri))
    # the start: vp and vs smoothed below the seabed, the water kept
    m0 = []
    for x in (vp, vs):
        sm = torch.nn.functional.avg_pool2d(x[None, None], 9, 1, 4, count_include_pad=False)[0, 0]
        m0.append(torch.cat([x[:nw], sm[nw:]]))
    mats0 = tuple(m.detach().contiguous() for m in ElasticPropagator(
        grid, dt, f0, vp_max, source_type="pressure", record="p", device=dev).material_fields(
            *m0, rho))

    def value_and_grad(sim):
        m = [x.clone().requires_grad_(True) for x in (*mats0, w)]
        seis = sim(*m, si, ri)
        J = 0.5 * ((seis - d) ** 2).sum()
        return (J.detach(), seis.detach(), *torch.autograd.grad(J, m))

    vg = {}
    for impl, sim in sims.items():
        torch.cuda.reset_peak_memory_stats()
        c0 = profiling.counters()["escan_image_steps"]
        ms, out = timed_ms(lambda s=sim: value_and_grad(s), warmup=False)
        vg[impl] = (ms, out, torch.cuda.max_memory_allocated(),
                    profiling.counters()["escan_image_steps"] - c0)
    a, b = vg["cuda_escan"][1], vg["cuda_estep"][1]
    bitwise = all(bool(torch.equal(x, y)) for x, y in zip(a[1:], b[1:]))
    finite = all(bool(torch.isfinite(x).all()) for x in a)
    print(f"[marine shot] {smi}: grid {'x'.join(map(str, grid.padded_shape))} (water "
          f"{nw} rows, free surface), pressure / p, {ri.shape[0]} hydrophones, nt {nt}: "
          f"tape-free forward {fwd_ms / 1e3:.3f} s; value-and-grad cuda_escan "
          f"{vg['cuda_escan'][0] / 1e3:.3f} s (peak {vg['cuda_escan'][2] / 2**30:.2f} GiB), "
          f"cuda_estep {vg['cuda_estep'][0] / 1e3:.3f} s (peak "
          f"{vg['cuda_estep'][2] / 2**30:.2f} GiB); J {float(a[0]):.6e}; seismogram and six "
          f"gradients bitwise equal: {bitwise}; escan_image_steps raised by "
          f"{vg['cuda_escan'][3]} (cuda_estep {vg['cuda_estep'][3]})", flush=True)
    if not finite or float(a[2].abs().max()) == 0.0:
        fail("the marine gradient is not finite and nonzero on cuda_escan")
    if not bitwise:
        fail("the marine shot's cuda_escan and cuda_estep outputs are not bitwise equal")
    if (vg["cuda_escan"][3], vg["cuda_estep"][3]) != (nt, 0):
        fail("escan_image_steps did not rise by nt in the free-surface reverse")

    def reverse(n, **kw):
        """escan_reverse of the shot's first n steps, fed their tape."""
        seis, tape, fin = ke.escan_forward(*args, w[:n], si, ri, *kind, tape=True)
        return functools.partial(ke.escan_reverse, *args, w[:n], (seis - d[:n]).contiguous(),
                                 tape, fin, si, ri, *kind, **kw)

    ev = {dep: events_ms(reverse(nt, dependent_launch=dep), 3)[0] / nt for dep in (True, False)}
    # a short call in the profiler: a whole call's ~10,000 launches stall it
    rows = device_us_per_step(reverse(nt_prof, dependent_launch=False), nt_prof,
                              r"::(e[fr]?_\w+?)[<(]", calls=True)
    image = sum(us for k, us, _ in rows if k.startswith("er_image"))
    launches = sum(n for _, _, n in rows) * nt_prof
    print(f"[marine shot] escan_reverse alone, nt {nt}: {1e3 * ev[True]:.2f} us a step by CUDA "
          f"events with dependent launches, {1e3 * ev[False]:.2f} in plain stream order; "
          f"torch.profiler in stream order (nt {nt_prof}), device us a step (launches a step): "
          + (", ".join(f"{k} {us:.2f} (x{n:g})" for k, us, n in rows) or "not measured")
          + f"; {launches / nt_prof:.4f} launches a step (the call's "
          f"{ke.reverse_launches(True, nt_prof)} over {nt_prof} steps planned); the image "
          f"launches (er_image*: the call's first stress-image transpose) {image:.4f} us a "
          f"step, {100 * image / (1e3 * ev[False]):.2f}% of the stream-order reverse", flush=True)
    if rows and launches != ke.reverse_launches(True, nt_prof):
        fail("the free-surface reverse did not run its planned launches")
    check_reverse_pass_code()


def phase_main_estep(smi, dev):
    """invert_elastic on an ElasticFwiProblem whose propagator is
    ElasticPropagator(impl="cuda_estep"): the VSP survey of ESTEP_MAIN,
    observed data on the same engine, then every launch counter set to 0
    just before the inversion."""
    from tpufwi_torch import invert
    from tpufwi_torch.config import FwiConfig

    cfg = FwiConfig().with_overrides(list(ESTEP_MAIN))
    shape = (cfg.model.nz, cfg.model.nx)
    bz = np.arange(*ESTEP_BOREHOLE)
    borehole = np.stack([bz, np.full_like(bz, shape[1] // 2)], 1)
    t0 = time.perf_counter()
    problem, m0, bounds, precond = invert.build_synthetic_elastic_problem(
        cfg, device=dev, impl="cuda_estep", extra_rcv=borehole)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    rz = problem.geoms.rcv_idx[0, :, 0]
    span = int(rz.max() - rz.min()) + 1
    recs = []
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    m = invert.invert_elastic(problem, m0, cfg.stages, bounds=bounds, lbfgs_m=cfg.opt.lbfgs_m,
                              scales="auto", precond=precond, log_fn=recs.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    its = [r for r in recs if "event" not in r]
    engines = [r["engine"] for r in recs if r.get("event") == "engine"]
    n_shots = cfg.acq.n_shots
    nt = int(problem.wavelet.shape[0])
    mine = {k: launches[k] for k in ESTEP_NAMES}
    print(f"[main estep] {smi}: {shape[0]}x{shape[1]} at {cfg.model.dx:g} m, order "
          f"{cfg.prop.order}, pml {cfg.prop.pml}, nt {nt}, "
          f"{n_shots} shots, {problem.geoms.rcv_idx.shape[1]} receivers ({len(bz)} in the "
          f"borehole; rows span {span}); observed data {setup:.1f} s; inversion {wall:.1f} s, "
          f"peak memory {peak / 2**30:.2f} GiB, launches {json.dumps(mine)}", flush=True)
    for r in its:
        print(f"[main estep] stage {r['stage']} f<{r['fmax']} Hz it {r['iter']}: "
              f"J={r['J']:.6e} {r['seconds']} s/iter evals {r['evals']}", flush=True)
    if engines != ["cuda_estep"] * len(cfg.stages):
        fail(f"engine records {engines}, expected cuda_estep per stage")
    if len(its) != sum(s.iterations for s in cfg.stages):
        fail(f"{len(its)} iterations logged")
    J = [r["J"] for r in its]
    if not all(np.isfinite(J)) or not all(b < a for a, b in zip(J, J[1:])):
        fail(f"per-step elastic J not finite and falling: {J}")
    others = {k: v for k, v in launches.items() if k not in mine and v}
    if others:
        fail(f"the per-step elastic path launched kernels of another engine: {others}")
    rev = n_shots * (len(cfg.stages) + len(its))
    for name in ("estep_rs", "estep_rv"):
        if mine[name] != nt * rev:
            fail(f"{name} launches {mine[name]} != nt x {rev} reverses")
    fwd_min = n_shots * (len(cfg.stages) + sum(r["evals"] for r in its))
    fwd = mine["estep_v"]
    if mine["estep_s"] != fwd or fwd % nt or fwd // nt < fwd_min:
        fail(f"estep_v / estep_s launches {fwd} / {mine['estep_s']} not nt x (>= {fwd_min}) "
             "forward evaluations")
    print(f"[main estep] evaluations: forward {fwd // nt} (>= {fwd_min}), reverse {rev}",
          flush=True)
    bounds_vs = ((cfg.opt.vmin, cfg.opt.vmax), (cfg.opt.vmin / 1.9, cfg.opt.vmax / 1.9))
    for leaf, (lo, hi) in zip(m, bounds_vs):
        x = leaf.detach().cpu().numpy()
        if x.shape != shape or not np.isfinite(x).all() or not (lo <= x.min() and x.max() <= hi):
            fail("final (vp, vs) not finite, of the model's shape, within the bounds")
    return mine


def phase_main_elastic(smi, device="cuda"):
    from tpufwi_torch import invert
    from tpufwi_torch.config import FwiConfig

    run_dir = os.path.join("smoke_out", "elastic")
    for name in ("log.jsonl", "ckpt_mp.npz"):
        if os.path.exists(os.path.join(run_dir, name)):
            os.remove(os.path.join(run_dir, name))
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    m = invert.main(["--device", device, f"run_dir={run_dir}", *ELASTIC_MAIN])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()

    with open(os.path.join(run_dir, "log.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    its = [r for r in recs if "event" not in r]
    engines = [r["engine"] for r in recs if r.get("event") == "engine"]
    cfg = FwiConfig().with_overrides(list(ELASTIC_MAIN))
    n_shots = cfg.acq.n_shots
    shape = (cfg.model.nz, cfg.model.nx)
    nt = elastic_nt(cfg.acq.t_max, *shape, cfg.model.dx)
    mine = {k: launches[k] for k in ("escan_forward", "escan_reverse")}
    print(f"[main elastic] {smi}: {wall:.1f} s total, peak memory {peak / 2**30:.2f} GiB, "
          f"launches {json.dumps(mine)} (nt {nt})", flush=True)
    for r in its:
        print(f"[main elastic] stage {r['stage']} f<{r['fmax']} Hz it {r['iter']}: "
              f"J={r['J']:.6e} {r['seconds']} s/iter evals {r['evals']}", flush=True)

    if engines != ["cuda_escan"] * len(cfg.stages):
        fail(f"engine records {engines}, expected cuda_escan per stage")
    if len(its) != sum(s.iterations for s in cfg.stages):
        fail(f"{len(its)} iterations logged")
    J = [r["J"] for r in its]
    if not all(np.isfinite(J)) or not all(b < a for a, b in zip(J, J[1:])):
        fail(f"elastic J not finite and falling: {J}")
    if min(mine.values()) <= 0:
        fail(f"an elastic kernel never launched: {mine}")
    others = {k: v for k, v in launches.items() if k not in mine and v}
    if others:
        fail(f"the elastic path launched kernels of another engine: {others}")
    rev = n_shots * (len(cfg.stages) + len(its))
    if mine["escan_reverse"] != nt * rev:
        fail(f"escan_reverse launches {mine['escan_reverse']} != nt x {rev}")
    fwd_min = n_shots * (1 + len(cfg.stages) + sum(r["evals"] for r in its))
    fwd = mine["escan_forward"]
    if fwd % nt or fwd // nt < fwd_min:
        fail(f"escan_forward launches {fwd} not nt x (>= {fwd_min}) evaluations")
    print(f"[main elastic] evaluations: forward {fwd // nt} (>= {fwd_min}), reverse {rev}",
          flush=True)
    bounds = ((cfg.opt.vmin, cfg.opt.vmax), (cfg.opt.vmin / 1.9, cfg.opt.vmax / 1.9))
    for leaf, (lo, hi) in zip(m, bounds):
        x = leaf.detach().cpu().numpy()
        if x.shape != shape or not np.isfinite(x).all() or not (
                lo <= x.min() and x.max() <= hi):
            fail("final (vp, vs) not finite, of the model's shape, within the bounds")
    return mine


# --------------------------------------------------------------------- 3D


@functools.lru_cache(maxsize=None)
def overthrust_model(nz, ny, nx):
    """overthrust_like(nz, ny, nx) at 25 m in the engines' (y, z, x) layout,
    fp32, and its spacing."""
    from tpufwi_torch.io import overthrust_like

    vp, dx = overthrust_like(nz=nz, ny=ny, nx=nx)
    return np.ascontiguousarray(np.transpose(vp, (1, 0, 2)), dtype=np.float32), dx


def overthrust_survey(nz, ny, nx, nt=None, t_max=None, shots=(3, 4), free_surface=False):
    """The 3D survey of scripts/overthrust_ms.py:97-140 on overthrust_like:
    order 8, pml 10, f0 6 Hz, CFL 0.7 at the model's top speed; surface
    shots at depth 2 on a (y, x) grid of ``shots``; a receiver carpet at
    depth 3, every 10 cells in y and 6 in x. Returns (grid, vp, dt, f0,
    c_max, nt, src (nshot, 1, 3), rcv (nrec, 3)), indices physical."""
    from tpufwi_torch.grid import Grid

    vp, dx = overthrust_model(nz, ny, nx)
    grid = Grid(shape=vp.shape, h=(dx,) * 3, pml=10, order=8, free_surface=free_surface)
    c_max, f0 = float(vp.max()), 6.0
    dt = grid.cfl_dt(c_max, safety=0.7)
    nt = nt or int(t_max / dt)
    rcv = np.array([[y, 3, x] for y in range(10, ny - 10, 10) for x in range(10, nx - 10, 6)])
    src = np.array([[[int(y), 2, int(x)]] for y in np.linspace(0.2 * ny, 0.8 * ny, shots[0])
                    for x in np.linspace(0.15 * nx, 0.75 * nx, shots[1])])
    return grid, vp, dt, f0, c_max, nt, src, rcv


def a3d_inputs(dev, grid, vp, dt, f0, c_max, nt, src, rcv):
    """The 3D kernels' inputs for one shot: (grid, c2, profiles), wavelet,
    src_idx, rcv_idx on ``dev`` (physical indices in)."""
    from tpufwi_torch.kernels.acoustic2d_scanres import strip_profiles
    from tpufwi_torch.wavelets import ricker_np

    def on(x, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=dev)

    c2 = on((np.pad(vp, grid.pad, mode="edge") * dt) ** 2)
    prof = tuple(on(p) for p in strip_profiles(grid, dt, c_max, f0))
    return ((grid, c2, prof), on(ricker_np(f0, dt, nt)), on(src + grid.pad, torch.int64),
            on(rcv + grid.pad, torch.int64))


def a3d_step_counts(grid, nrec, nsrc, n_ring):
    """Operations and bytes of one 3D time step: a field (189 MB at the main
    path's grid) outgrows the card's on-chip memory, so every step must move
    the fields it reads and writes. Forward: P_{t-1}, P_{t-2}, C in, P_t out
    (16 B/cell), phi and psi in and out on the strips (16 B/strip cell), the
    seismogram row and the tape row. Reverse: P_{t-1}, P_t, C, lambda_t,
    lambda_{t+1}, gacc in, P_{t-2}, lambda_{t-1}, gacc out (36 B/cell), the
    two dual strip states psibar and phibar in and out (16 B/strip cell; w
    and y are recomputed each step, traffic of the design, not of the
    function), the residual row, lambda at the sources and the tape row
    read. Per shot: C and the final
    fields. Operations: three 9-tap D2 stencils a cell (forward), five
    (reverse: the imaging laplacian and the transposed one of C lambda), the
    strips' D1 stencils and updates. With illumination the forward also
    reads and writes the (NY, NZ, NX) sum (8 B/cell)."""
    NY, NZ, NX = grid.padded_shape
    taps = 2 * grid.radius + 1
    S = grid.pml + grid.radius
    faces = NZ * NX + NY * NX + NY * NZ
    cells, strips, ext = NY * NZ * NX, 2 * S * faces, 2 * (S + grid.radius) * faces
    fwd = cells * (6 * taps + 4) + strips * (2 * taps + 8) + ext * (2 * taps + 1) + 2 * nsrc
    rev = cells * (10 * taps + 12) + strips * (4 * taps + 6) + ext * 4 * taps + 2 * nsrc
    f = 4
    return {
        "a3d_forward": (fwd, 16 * cells + 16 * strips + nrec * f, 3 * cells * f),
        # illum read and written each step, one FMA a cell
        "a3d_forward_illum": (fwd + 2 * cells, 24 * cells + 16 * strips + nrec * f,
                              3 * cells * f),
        "a3d_forward_tape": (fwd, 16 * cells + 16 * strips + (nrec + n_ring) * f, 3 * cells * f),
        "a3d_reverse": (rev, 36 * cells + 16 * strips + (nrec + nsrc + n_ring) * f,
                        3 * cells * f),
    }


def a3d_kernels_vs_plain(args, w, si, ri, reps=2):
    """a3d_forward (no tape, fp32 tape, bf16 tape, illumination) and
    a3d_reverse (fed the plain forward's fp32 tape, last fields and
    seismogram; and the same with that tape rounded to bf16) against their
    plain versions on the card:
    ({output: error}, numbers). Times are ms per step, CUDA events."""
    k3 = a3d_module()
    grid = args[0]
    nt = w.shape[0]
    plain_ms, (seis_p, tape_p, ppen_p, plast_p, il_p) = timed_ms(
        lambda: k3.a3d_forward_plain(*args, w, si, ri, torch.float32, illum=True),
        warmup=False)
    free_ms, (seis_n, _, pen_n, last_n, _) = timed_ms(
        lambda: k3.a3d_forward(*args, w, si, ri), reps=reps)
    ms, (seis, tape, ppen, plast, _) = timed_ms(
        lambda: k3.a3d_forward(*args, w, si, ri, torch.float32), reps=reps)
    bf_ms, (seis_b, tape_b, _, _, _) = timed_ms(
        lambda: k3.a3d_forward(*args, w, si, ri, torch.bfloat16), reps=reps)
    il_ms, (_, _, _, _, il) = timed_ms(
        lambda: k3.a3d_forward(*args, w, si, ri, illum=True), reps=reps)
    scale = float(plast_p.abs().max())
    tape_max = float(tape_p.abs().max())
    errs = {
        "seis": max(rel_err(x, seis_p) for x in (seis, seis_n, seis_b)),
        "fields": max(rel_err(ppen, ppen_p), rel_err(plast, plast_p), rel_err(pen_n, ppen_p),
                      rel_err(last_n, plast_p)),
        "tape": float((tape - tape_p).abs().max()) / max(tape_max, scale),
        "tape_bf16": float((tape_b.float() - tape.to(torch.bfloat16).float()).abs().max())
        / (tape_max * 2.0**-7),
        "illum": rel_err(il, il_p),
    }
    ybar = seis_p.contiguous()
    plain_rev_ms, (g_p, ls_p, p0_p) = timed_ms(
        lambda: k3.a3d_reverse_plain(*args, w, ybar, tape_p, ppen_p, plast_p, si, ri,
                                     return_field=True), warmup=False)
    rev_ms, (g, ls, p0) = timed_ms(
        lambda: k3.a3d_reverse(*args, w, ybar, tape_p, ppen_p, plast_p, si, ri,
                               return_field=True), reps=reps)
    tape16 = tape_p.to(torch.bfloat16)
    g16_p, ls16_p = k3.a3d_reverse_plain(*args, w, ybar, tape16, ppen_p, plast_p, si, ri)
    rev_bf_ms, (g16, ls16) = timed_ms(
        lambda: k3.a3d_reverse(*args, w, ybar, tape16, ppen_p, plast_p, si, ri), reps=reps)
    errs.update(gbar=rel_err(g, g_p), lam_src=rel_err(ls, ls_p),
                gbar_bf16=rel_err(g16, g16_p), lam_src_bf16=rel_err(ls16, ls16_p),
                recon=float((p0 - p0_p).abs().max()) / scale)
    nums = dict(
        fwd=(float((seis.double() - seis_p.double()).abs().max()), ms / nt, plain_ms / nt),
        rev=(float((g.double() - g_p.double()).abs().max()), rev_ms / nt, plain_rev_ms / nt),
        free_ms=free_ms / nt, bf_ms=bf_ms / nt, il_ms=il_ms / nt, rev_bf_ms=rev_bf_ms / nt,
        counts=a3d_step_counts(grid, ri.shape[0], si.shape[0], tape.shape[1]),
        grid="x".join(map(str, grid.padded_shape)), nt=nt,
    )
    return errs, nums


def a3d_variants_bitwise(args, w, si, ri, reps=2):
    """The tiled cell passes (the default) against the gather ones on every
    output: a3d_forward with the fp32 tape, without tape, with the bf16
    tape and with illumination; a3d_reverse fed the tiled forward's fp32
    tape, last fields and seismogram, with that tape and with it rounded
    to bf16, and the reconstructed P_{-1}. On a grid too small for the ring
    tape (a physical extent of at most 4R, so the interior box is empty)
    the forward without tape and with illumination alone. Returns ({output:
    max abs difference}, {variant: (forward ms a step with the fp32 tape, or
    without tape, reverse ms a step)}), CUDA events."""
    from tpufwi_torch.propagators.boundary import RingSpec

    k3 = a3d_module()
    nt = w.shape[0]
    grid = args[0]
    taped = min(grid.shape) > 4 * grid.radius
    if taped:
        RingSpec.build(grid)
    outs, ms = {}, {}
    for v in k3.VARIANTS:
        o = {}
        if taped:
            f_ms, (o["seis"], o["tape"], o["penult"], o["last"], _) = timed_ms(
                lambda: k3.a3d_forward(*args, w, si, ri, torch.float32, variant=v), reps=reps)
            o["seis_bf16"], o["tape_bf16"], _, _, _ = k3.a3d_forward(*args, w, si, ri,
                                                                     torch.bfloat16, variant=v)
        f_ms, (o["seis_notape"], _, o["penult_notape"], o["last_notape"], _) = (
            (f_ms, k3.a3d_forward(*args, w, si, ri, variant=v)) if taped else timed_ms(
                lambda: k3.a3d_forward(*args, w, si, ri, variant=v), reps=reps))
        o["illum"] = k3.a3d_forward(*args, w, si, ri, illum=True, variant=v)[4]
        outs[v] = o
        ms[v] = [f_ms / nt]
    base = outs["tiled"]
    if taped:
        ybar, tape16 = base["seis"].contiguous(), base["tape"].to(torch.bfloat16)
        fields = (base["penult"], base["last"])
        for v in k3.VARIANTS:
            o = outs[v]
            r_ms, (o["gbar"], o["lam_src"], o["recon"]) = timed_ms(
                lambda: k3.a3d_reverse(*args, w, ybar, base["tape"], *fields, si, ri,
                                       return_field=True, variant=v), reps=reps)
            o["gbar_bf16"], o["lam_src_bf16"] = k3.a3d_reverse(*args, w, ybar, tape16, *fields,
                                                               si, ri, variant=v)
            ms[v].append(r_ms / nt)
    diffs = {key: float((outs["tiled"][key].double() - outs["gather"][key].double())
                        .abs().max()) if not torch.equal(outs["tiled"][key], outs["gather"][key])
             else 0.0 for key in base}
    return diffs, ms


def a3d_bf16_gradient(dev, nt):
    """The kernels' gradient image with the bf16 ring tape against the fp32
    tape's, one surface shot (its source in the ring) on the small survey
    grid, long enough for the wave to fill the model: (norm-relative error
    and cosine on the valid region)."""
    from tpufwi_torch.propagators.boundary import RingSpec

    k3 = a3d_module()
    survey = overthrust_survey(48, 64, 80, nt=nt, shots=(1, 1))
    args, w, si, ri = a3d_inputs(dev, *survey[:6], survey[6][0], survey[7])
    seis, tape, ppen, plast, _ = k3.a3d_forward(*args, w, si, ri, torch.float32)
    ybar = seis.contiguous()
    g = k3.a3d_reverse(*args, w, ybar, tape, ppen, plast, si, ri)[0]
    g16 = k3.a3d_reverse(*args, w, ybar, tape.to(torch.bfloat16), ppen, plast, si, ri)[0]
    valid = RingSpec.build(args[0]).valid
    a, b = g[valid].double().ravel(), g16[valid].double().ravel()
    return float((b - a).norm() / a.norm()), float(a @ b / (a.norm() * b.norm()))


def a3d_pass_times(dev, grid, calls=20):
    """The reverse's second half, pass by pass, on random inputs at
    ``grid``: ({pass: us a launch by CUDA events} for the line pass, the
    tiled walk and its gather variant, whether the walk's lambda_{t-1} is
    bitwise the gather's)."""
    from tpufwi_torch.kernels.acoustic2d_scanres import strip_profiles

    k3 = a3d_module()
    dt = grid.cfl_dt(6000.0, safety=0.7)
    prof = tuple(torch.as_tensor(p, device=dev) for p in strip_profiles(grid, dt, 6000.0, 6.0))
    g = torch.Generator(device=dev).manual_seed(5)
    N, ns = grid.padded_shape, k3.strip_cells(grid)
    lam, lam_next = (torch.randn(N, device=dev, generator=g) for _ in range(2))
    c2 = torch.rand(N, device=dev, generator=g) * 0.3
    w, pbar = (torch.randn(ns, device=dev, generator=g) for _ in range(2))
    buf = k3.pass_buffers(grid, lam, c2, prof, other=lam_next, w=w, pbar=pbar)
    k3.a3d_reverse_pass(grid, "lines", buf)
    outs = {}
    for name in ("walk", "gather"):
        b = k3.PassBuffers(buf.lam, buf.other.clone(), buf.c2, buf.prof, buf.strips)
        k3.a3d_reverse_pass(grid, name, b)
        outs[name] = b.other
    same = torch.equal(outs["walk"], outs["gather"])
    us = {name: 1e3 * events_ms(lambda: k3.a3d_reverse_pass(grid, name, buf), calls)[0]
          for name in k3.REVERSE_PASSES}
    return us, same


def phase_a3d_kernels(dev, smi, nt=64, nt_fs=128, nt_bf16=400):
    """a3d_forward and a3d_reverse against their plain versions: one
    surface shot of the 3D main path's survey at nt, and a free-surface
    case on a smaller grid at nt_fs (a source and receivers on the pinned
    surface row, coinciding receivers)."""
    k3 = a3d_module()
    small = overthrust_survey(48, 64, 80, nt=8, shots=(1, 1))
    a3d_kernels_vs_plain(*a3d_inputs(dev, *small[:6], small[6][0], small[7]), reps=1)
    before = (k3.a3d_forward.launches, k3.a3d_reverse.launches)
    survey = overthrust_survey(*MAIN3D["model"], nt=nt, shots=MAIN3D["shots"])
    mid = survey[6][len(survey[6]) // 2]
    errs, nums = a3d_kernels_vs_plain(*a3d_inputs(dev, *survey[:6], mid, survey[7]))
    fs = overthrust_survey(48, 64, 80, nt=nt_fs, shots=(1, 1), free_surface=True)
    src = np.concatenate([fs[6][0], [[30, 0, 40]]])  # a second source, on the surface row
    rcv = np.concatenate([fs[7], [[y, 0, 40] for y in range(10, 54, 6)], fs[7][:3]])
    errs_fs, nums_fs = a3d_kernels_vs_plain(*a3d_inputs(dev, *fs[:6], src, rcv))
    bits, var_ms = a3d_variants_bitwise(*a3d_inputs(dev, *survey[:6], mid, survey[7]))
    bits_fs, var_ms_fs = a3d_variants_bitwise(*a3d_inputs(dev, *fs[:6], src, rcv))
    bf16_rel, bf16_cos = a3d_bf16_gradient(dev, nt_bf16)
    args, w, si, ri = a3d_inputs(dev, *survey[:5], 16, mid, survey[7])

    def fwd_rev(variant):
        def run():
            seis, tape, ppen, plast, _ = k3.a3d_forward(*args, w, si, ri, torch.float32,
                                                        variant=variant)
            k3.a3d_reverse(*args, w, seis.contiguous(), tape, ppen, plast, si, ri,
                           variant=variant)
        return run

    # the default call first: what the engines run
    prof = {v: device_us_per_step(fwd_rev(v), 16, r"::([fr]3_\w+?)[<(]")
            for v in ("tiled", "gather")}
    launched = (k3.a3d_forward.launches - before[0], k3.a3d_reverse.launches - before[1])
    c = nums["counts"]
    entries = [entry("a3d_forward", *nums["fwd"], c["a3d_forward_tape"], nt),
               entry("a3d_reverse", *nums["rev"], c["a3d_reverse"], nt)]
    print(f"[a3d kernels] {smi}: grid {nums['grid']} order 8, one surface shot, nt {nt}, ms "
          "per step, kernel (plain; bound):", flush=True)
    for e in entries:
        print(f"[a3d kernels]   {e['name']}: {e['ms']:.5f} ({e['plain_ms']:.4f}; "
              f"{e['bound_ms']:.5f} by {e['bound_by']})", flush=True)
    for label, ms, key in (("a3d_forward without tape", nums["free_ms"], "a3d_forward"),
                           ("a3d_forward with the bf16 tape", nums["bf_ms"], "a3d_forward_tape"),
                           ("a3d_forward with illumination", nums["il_ms"], "a3d_forward_illum"),
                           ("a3d_reverse with the bf16 tape", nums["rev_bf_ms"], "a3d_reverse")):
        b = bound(c[key], nt)
        print(f"[a3d kernels]   {label}: {ms:.5f} ({b[0]:.5f} by {b[1]})", flush=True)
    print(f"[a3d kernels]   free surface, grid {nums_fs['grid']}, nt {nt_fs}: forward "
          f"{nums_fs['fwd'][1]:.5f} ({nums_fs['fwd'][2]:.4f}), reverse {nums_fs['rev'][1]:.5f} "
          f"({nums_fs['rev'][2]:.4f})", flush=True)
    print(f"[a3d kernels] errors {json.dumps(errs)}; free surface {json.dumps(errs_fs)}; "
          f"tolerances {json.dumps(A3D_TOL)}; bf16-tape gradient against the fp32 tape's, "
          f"surface shot, nt {nt_bf16}: {bf16_rel:.3e} (norm, valid region; bound "
          f"{A3D_BF16_GTOL:.0e}), cosine {bf16_cos:.6f}; launches in these checks: "
          f"a3d_forward {launched[0]}, a3d_reverse {launched[1]}", flush=True)
    for tag, vm, g in (("main grid", var_ms, nums["grid"]),
                       ("free surface", var_ms_fs, nums_fs["grid"])):
        print(f"[a3d kernels] tiled vs gather cell passes, {tag} {g}, ms per step (CUDA "
              "events): forward with the fp32 tape " + ", ".join(
                  f"{v} {m[0]:.5f}" for v, m in vm.items()) + "; reverse " + ", ".join(
                  f"{v} {m[1]:.5f}" for v, m in vm.items()), flush=True)
    print(f"[a3d kernels] tiled against gather, max abs difference per output (0.0: bitwise): "
          f"main grid {json.dumps(bits)}; free surface {json.dumps(bits_fs)}", flush=True)
    for v, rows in prof.items():
        print(f"[a3d kernels] torch.profiler device us per step, variant {v} (forward with the "
              "fp32 tape + reverse, nt 16): " + (", ".join(f"{k} {us:.2f}" for k, us in rows)
                                                 or "not measured"), flush=True)
    grid = survey[0]
    pass_us, walk_same = a3d_pass_times(dev, grid)
    occ = k3.walk_occupancy(grid)
    print(f"[a3d kernels] the reverse's second half alone, grid {nums['grid']}, us a launch "
          "(CUDA events, 20 launches): line pass r3_lines " + f"{pass_us['lines']:.1f}, walk "
          f"r3_cells2_tiled {pass_us['walk']:.1f}, gather r3_cells2 {pass_us['gather']:.1f}; "
          f"walk bitwise the gather's: {walk_same}; walks (registers, shared bytes, blocks an "
          f"SM): {json.dumps(occ)}", flush=True)
    # both variants run the line pass
    gather_names = {"f3_cells", "r3_cells1", "r3_cells2", "r3_lines"}
    tiled_names = {"f3_cells_tiled", "r3_cells1_tiled", "r3_cells2_tiled", "r3_lines"}
    ran = {v: {k for k, _ in rows} for v, rows in prof.items()}
    if ran["tiled"] and (ran["tiled"] & (gather_names - tiled_names)
                         or not tiled_names <= ran["tiled"]):
        fail(f"the default 3D call's cell passes were {sorted(ran['tiled'])}, not the tiled ones")
    if ran["gather"] and (ran["gather"] & (tiled_names - gather_names)
                          or not gather_names <= ran["gather"]):
        fail(f"variant='gather' ran {sorted(ran['gather'])}, not the gather cell passes")
    if not walk_same:
        fail("the reverse's second pass alone: the tiled walk differs from the gather pass")
    if any(regs > 64 or blocks != k3.RESIDENT for regs, _, blocks in occ.values()):
        fail(f"a 3D walk does not hold {k3.RESIDENT} blocks an SM: {occ}")
    for tag, group in (("main grid", bits), ("free surface", bits_fs)):
        unequal = {k: d for k, d in group.items() if d != 0.0}
        if unequal:
            fail(f"3D tiled cell passes differ from the gather ones ({tag}): {unequal}")
    for group in (errs, errs_fs):
        for name, err in group.items():
            if not err <= A3D_TOL[name]:
                fail(f"3D {name} disagrees with the plain version: {err:.3e} > "
                     f"{A3D_TOL[name]:.0e}")
    if not bf16_rel <= A3D_BF16_GTOL:
        fail(f"bf16-tape gradient off the fp32 tape's by {bf16_rel:.3e} > {A3D_BF16_GTOL:.0e}")
    return entries


def phase_a3d_fullscale(dev, smi):
    """One shot on the full SEG/EAGE Overthrust grid at t_max 4 s: 'auto'
    takes the bf16 ring tape (the fp32 one outgrows the card); a tape-free
    forward and a value-and-grad of 0.5 |seis(1.02 vp) - seis(vp)|^2."""
    from tpufwi_torch.acquisition import Geometry
    from tpufwi_torch.io import OVERTHRUST_SHAPE
    from tpufwi_torch.propagators.acoustic2d import AcousticPropagator
    from tpufwi_torch.wavelets import ricker

    t0 = time.perf_counter()
    nz, ny, nx = OVERTHRUST_SHAPE
    grid, vp, dt, f0, c_max, nt, _, rcv = overthrust_survey(nz, ny, nx, t_max=4.0)
    model_s = time.perf_counter() - t0
    prop = AcousticPropagator(grid, dt, f0, c_max, device=dev)
    impl = prop.fix_impl_for(nt=nt)
    print(f"[a3d full] {smi}: overthrust_like {nz} x {ny} x {nx} at 25 m (padded "
          f"{'x'.join(map(str, grid.padded_shape))}), nt {nt}, {rcv.shape[0]} receivers, model "
          f"built in {model_s:.1f} s: impl {impl} ({prop.resolve_note})", flush=True)
    if impl != "cuda3d_bf16":
        fail(f"the full Overthrust shot resolved to {impl}: {prop.resolve_note}")
    geom = Geometry.from_physical(grid, np.array([[ny // 2, 2, nx // 2]]), rcv, device=dev)
    w = ricker(f0, dt, nt, device=dev)
    vp_t = torch.as_tensor(vp, device=dev)
    torch.cuda.reset_peak_memory_stats()
    fwd_ms, d = timed_ms(lambda: prop(vp_t, geom, w), warmup=False)
    J, g, secs = _value_and_grad(prop, vp_t * 1.02, geom, w, d)
    peak = torch.cuda.max_memory_allocated()
    tape = prop.tape3d_bytes(nt, 2)
    print(f"[a3d full] tape-free forward {fwd_ms / 1e3:.3f} s, value-and-grad {secs:.3f} s; "
          f"bf16 ring tape {tape} bytes ({tape / 2**30:.2f} GiB; fp32 "
          f"{prop.tape3d_bytes(nt, 4) / 2**30:.2f} GiB, budget "
          f"{prop.tape3d_budget_bytes() / 2**30:.2f} GiB); peak memory {peak / 2**30:.2f} GiB; "
          f"J {J:.6e}; max |g| {float(g.abs().max()):.3e}", flush=True)
    if not (np.isfinite(J) and bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0):
        fail("the full Overthrust gradient is not finite and nonzero")


def phase_main_3d(smi, dev):
    """invert() on a 3D FwiProblem: the survey of scripts/overthrust_ms.py
    at its large-scale single-chip configuration (overthrust_ms.py:54-55),
    observed data from the true model, a Gaussian-5 smooth start with the
    top rows pinned; every launch counter set to 0 just before invert()."""
    from scipy.ndimage import gaussian_filter

    from tpufwi_torch.acquisition import Geometry
    from tpufwi_torch.config import FwiConfig, OptCfg, PrecondCfg, StageCfg
    from tpufwi_torch.invert import FwiProblem, invert
    from tpufwi_torch.propagators.acoustic2d import AcousticPropagator
    from tpufwi_torch.wavelets import ricker

    cfg3 = MAIN3D
    grid, vp, dt, f0, c_max, nt, src, rcv = overthrust_survey(*cfg3["model"], nt=cfg3["nt"],
                                                              shots=cfg3["shots"])
    n_shots = src.shape[0]
    prop = AcousticPropagator(grid, dt, f0, c_max, device=dev)
    geoms = Geometry.stack([Geometry.from_physical(grid, s, rcv, device=dev) for s in src])
    w = ricker(f0, dt, nt, device=dev)
    with torch.no_grad():
        vp_t = torch.as_tensor(vp, device=dev)
        d_obs = torch.stack([prop(vp_t, geoms.shot(i), w) for i in range(n_shots)])
    top = cfg3["mask_top"]
    vp0 = np.clip(gaussian_filter(vp.astype(np.float64), 5.0), cfg3["vmin"], cfg3["vmax"])
    vp0[:, :top, :] = vp[:, :top, :]  # the near surface pinned to the truth
    problem = FwiProblem(prop=prop, geoms=geoms, d_obs=d_obs, wavelet=w, dt=dt)
    run_dir = os.path.join("smoke_out", "main3d")
    cfg = FwiConfig(stages=(StageCfg(cfg3["fmax"], cfg3["iterations"]),),
                    precond=PrecondCfg(use_illumination=True, mask_top=top),
                    opt=OptCfg(vmin=cfg3["vmin"], vmax=cfg3["vmax"]), run_dir=run_dir)
    if os.path.exists(os.path.join(run_dir, "log.jsonl")):
        os.remove(os.path.join(run_dir, "log.jsonl"))
    vp0_t = torch.as_tensor(vp0, dtype=torch.float32, device=dev)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    vp_out = invert(problem, vp0_t, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()

    with open(os.path.join(run_dir, "log.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    its = [r for r in recs if "event" not in r]
    engines = [r["engine"] for r in recs if r.get("event") == "engine"]
    notes = [r["note"] for r in recs if r.get("event") == "engine"]
    mine = {k: launches[k] for k in ("a3d_forward", "a3d_reverse")}
    print(f"[main 3d] {smi}: padded {'x'.join(map(str, grid.padded_shape))}, {n_shots} shots, "
          f"{rcv.shape[0]} receivers, nt {nt}: {wall:.1f} s total, peak memory "
          f"{peak / 2**30:.2f} GiB, launches {json.dumps(mine)}; engine {engines} {notes}",
          flush=True)
    for r in its:
        print(f"[main 3d] stage {r['stage']} f<{r['fmax']} Hz it {r['iter']}: J={r['J']:.6e} "
              f"{r['seconds']} s/iter {r['shots_per_sec']} shots/s evals {r['evals']}",
              flush=True)
    if engines != ["cuda3d"] * len(cfg.stages):
        fail(f"engine records {engines}, expected cuda3d per stage")
    if len(its) != sum(st.iterations for st in cfg.stages):
        fail(f"{len(its)} iterations logged")
    J = [r["J"] for r in its]
    if not all(np.isfinite(J)) or not all(b < a for a, b in zip(J, J[1:])):
        fail(f"3D J not finite and falling: {J}")
    if min(mine.values()) <= 0:
        fail(f"a 3D kernel never launched: {mine}")
    others = {k: v for k, v in launches.items() if k not in mine and v}
    if others:
        fail(f"the 3D path launched kernels of another engine: {others}")
    rev = n_shots * (len(cfg.stages) + len(its))
    if mine["a3d_reverse"] != nt * rev:
        fail(f"a3d_reverse launches {mine['a3d_reverse']} != nt x {rev}")
    # per stage one illumination and the first value-and-grad, then per
    # iteration the logged evaluations
    fwd_min = n_shots * (2 * len(cfg.stages) + sum(r["evals"] for r in its))
    fwd = mine["a3d_forward"]
    if fwd % nt or fwd // nt < fwd_min:
        fail(f"a3d_forward launches {fwd} not nt x (>= {fwd_min}) evaluations")
    print(f"[main 3d] evaluations: forward {fwd // nt} (>= {fwd_min}), reverse {rev}",
          flush=True)
    out = vp_out.detach().cpu().numpy()
    if out.shape != vp.shape or not np.isfinite(out).all() or not (
            cfg3["vmin"] <= out.min() and out.max() <= cfg3["vmax"]):
        fail("final 3D model is not finite, of the model's shape, within the bounds")
    return mine


# ------------------------------------------------------------ 3D per-step


def a3d_perstep_counts(grid):
    """Operations and bytes of one call of each per-step 3D kernel, each
    input read once and each output written once: leapfrog3d reads p_prev,
    p and C and writes p_next (16 B/cell); strip3d reads p and C and
    reads and writes p_next on the union of the correction bands (S + R
    deep on each face), and reads and writes phi and psi on the strips (16
    B/strip cell). Operations: three (2R+1)-tap D2 stencils and the update
    a cell; D1 p and the phi update a strip cell; D2 p, D1 phi', the psi
    update and the two additions a band cell."""
    NY, NZ, NX = grid.padded_shape
    R, taps = grid.radius, 2 * grid.radius + 1
    S = grid.pml + R
    cells = NY * NZ * NX
    union = cells - int(np.prod([n - 2 * (S + R) for n in grid.padded_shape]))
    bands = sum(2 * (S + R) * (cells // n) for n in grid.padded_shape)
    strips = 2 * S * (NZ * NX + NY * NX + NY * NZ)
    return {"leapfrog3d": (cells * (6 * taps + 4), 16 * cells, 0),
            "strip3d": (strips * (2 * taps + 3) + bands * (4 * taps + 8),
                        16 * union + 16 * strips, 0)}


def a3d_step_state(grid, dev, seed):
    """A random state (p_prev, p, strips) of the per-step kernels: every
    cell and every face's strips active, no two faces alike."""
    _, k3f = a3d_step_modules()
    gen = torch.Generator(device=dev).manual_seed(seed)
    rand = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    return (rand(*grid.padded_shape), rand(*grid.padded_shape),
            0.1 * rand(2 * k3f.strip_cells(grid)))


def a3d_step_kernels_vs_plain(grid, c2, prof, nt, seed=0):
    """leapfrog3d and strip3d against their plain versions over nt fused
    steps from a random state: before each call the kernel's state is set
    to the plain one's, so each kernel is held on its own, and the plain
    state carries on. Returns ({kernel: {output: rel err}}, {kernel: max
    abs err}, {kernel: plain ms per call})."""
    k3s, k3f = a3d_step_modules()
    dev = c2.device
    p_prev, p, sp = a3d_step_state(grid, dev, seed)
    fp = torch.stack([p_prev, p])  # P_{t-2} (becomes P_t), P_{t-1}
    del p_prev, p
    fk, sk = torch.empty_like(fp), torch.empty_like(sp)
    errs = {"leapfrog3d": {"fields": _Err(dev)},
            "strip3d": {"fields": _Err(dev), "strips": _Err(dev)}}
    held = _Held(errs)
    prev, cur = 0, 1
    for _ in range(nt):
        held.call("leapfrog3d", lambda: k3s.leapfrog3d(grid, fk[prev], fk[cur], c2),
                  lambda: k3s.leapfrog3d_plain(grid, fp[prev], fp[cur], c2), ((fk, fp),))
        errs["leapfrog3d"]["fields"].add(fk[prev], fp[prev])
        held.call("strip3d", lambda: k3f.strip3d(grid, fk[cur], fk[prev], sk, prof, c2),
                  lambda: k3f.strip3d_plain(grid, fp[cur], fp[prev], sp, prof, c2),
                  ((fk, fp), (sk, sp)))
        errs["strip3d"]["fields"].add(fk[prev], fp[prev])
        errs["strip3d"]["strips"].add(sk, sp)
        prev, cur = cur, prev
    plain_ms = held.plain_ms()
    if not (bool(torch.isfinite(fp).all()) and bool(torch.isfinite(sp).all())):
        fail("the per-step 3D plain state is not finite")
    rel = {k: {o: e.rel() for o, e in outs.items()} for k, outs in errs.items()}
    abs_err = {k: max(e.abs() for e in outs.values()) for k, outs in errs.items()}
    return rel, abs_err, plain_ms


def time_a3d_step_kernels(grid, c2, prof, nt, seed=1):
    """time_loops of leapfrog3d (nt steps) and strip3d (nt calls on one
    field pair) from a random state."""
    k3s, k3f = a3d_step_modules()
    p_prev, p, strips = a3d_step_state(grid, c2.device, seed)
    f = torch.stack([p_prev, p])
    del p_prev, p
    pattern = r"::(s3_\w+?)[<(]"

    def loops(m):
        def leap():
            for t in range(m):
                k3s.leapfrog3d(grid, f[t % 2], f[1 - t % 2], c2)

        def strip():
            for _ in range(m):
                k3f.strip3d(grid, f[1], f[0], strips, prof, c2)

        return {"leapfrog3d": (leap, m, pattern), "strip3d": (strip, m, pattern)}

    return time_loops(loops, nt)


def leapfrog3d_clocks(grid, c2, m=32, seed=2):
    """leapfrog3d's ms a call by two more clocks than time_loops': the
    median of CUDA events around each of m calls, and the host clock
    around m calls that end in a synchronize."""
    k3s, _ = a3d_step_modules()
    p_prev, p, _ = a3d_step_state(grid, c2.device, seed)
    f = torch.stack([p_prev, p])
    del p_prev, p
    evs = []
    for t in range(m):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        k3s.leapfrog3d(grid, f[t % 2], f[1 - t % 2], c2)
        b.record()
        evs.append((a, b))
    torch.cuda.synchronize()
    each = sorted(a.elapsed_time(b) for a, b in evs)
    t0 = time.perf_counter()
    for t in range(m):
        k3s.leapfrog3d(grid, f[t % 2], f[1 - t % 2], c2)
    torch.cuda.synchronize()
    return each[m // 2], 1e3 * (time.perf_counter() - t0) / m


def a3d_step_case(grid, dt, f0, c_max, c2_np, dev):
    """(c2, prof) of the per-step kernels on ``dev`` from a numpy C."""
    _, k3f = a3d_step_modules()
    c2 = torch.as_tensor(np.ascontiguousarray(c2_np, dtype=np.float32), device=dev)
    return c2, k3f.strip_prof_source(grid, dt, f0, c_max)(c2)


def check_a3d_step(label, rel):
    for kernel, outs in rel.items():
        for out, err in outs.items():
            if not err <= A3D_STEP_TOL[out]:
                fail(f"{label}: {kernel} {out} disagrees with the plain version: {err:.3e} > "
                     f"{A3D_STEP_TOL[out]:.0e}")


def print_a3d_step_times(tag, smi, grid, nt, times, plain_ms):
    counts = a3d_perstep_counts(grid)
    print(f"[{tag}] {smi}: grid {'x'.join(map(str, grid.padded_shape))} order {grid.order} "
          f"pml {grid.pml}, {nt} calls: ms per call, kernel by CUDA events (host per call; "
          "device per call by torch.profiler; plain per call; bound):", flush=True)
    for name, (calls, ms, host_ms, dev_us, rows) in times.items():
        b = bound(counts[name], 1)
        dev_ms = "not measured" if dev_us is None else f"{dev_us / 1e3:.5f}"
        print(f"[{tag}]   {name}: {ms:.5f} ({host_ms:.5f}; {dev_ms}; {plain_ms[name]:.4f}; "
              f"{b[0]:.5f} by {b[1]}), device us per call: "
              + ", ".join(f"{n} {us:.2f}" for n, us in rows), flush=True)


def phase_a3d_step_kernels(dev, smi, nt=64, nt_small=16):
    """leapfrog3d and strip3d against their plain versions at the 3D main
    path's padded grid (its survey's C), nt fused steps from a random
    state, and on a small grid with order 4 and pml 7 (nt_small); then
    their times per call at the main path's grid."""
    from tpufwi_torch.grid import Grid

    small = Grid(shape=(30, 26, 34), h=(10.0, 11.0, 12.0), pml=7, order=4)
    dt_s = small.cfl_dt(2600.0, safety=0.7)
    rng = np.random.default_rng(17)
    c2_s = ((2200 + 150 * rng.standard_normal(small.padded_shape)) * dt_s) ** 2
    args_s = a3d_step_case(small, dt_s, 18.0, 2600.0, c2_s, dev)
    a3d_step_kernels_vs_plain(small, *args_s, 2)  # first-use costs out of the timings
    rel_s, _, _ = a3d_step_kernels_vs_plain(small, *args_s, nt_small, seed=3)
    grid, vp, dt, f0, c_max, _, _, _ = overthrust_survey(*MAIN3D["model"], nt=8,
                                                         shots=MAIN3D["shots"])
    args = a3d_step_case(grid, dt, f0, c_max, (np.pad(vp, grid.pad, mode="edge") * dt) ** 2,
                         dev)
    rel, _, plain_ms = a3d_step_kernels_vs_plain(grid, *args, nt)
    times = time_a3d_step_kernels(grid, *args, nt)
    print_a3d_step_times("a3d step kernels", smi, grid, nt, times, plain_ms)
    print(f"[a3d step kernels] rel err {json.dumps(rel)}; order 4 pml 7 grid "
          f"{'x'.join(map(str, small.padded_shape))} nt {nt_small} {json.dumps(rel_s)}; "
          f"tolerances {json.dumps(A3D_STEP_TOL)}", flush=True)
    check_a3d_step("3D main path's grid", rel)
    check_a3d_step("order 4 pml 7 grid", rel_s)


def phase_bench_3d(dev, smi, check_nt=BENCH_CHECK_NT, nt_held=8, nt_time=32):
    """bench_3d.main() at its default, full SEG/EAGE Overthrust width, with
    every launch counter set to 0 just before it and read just after; then
    the fused step against the torch-op strips and against full_step2 over
    check_nt steps from the impulse, and leapfrog3d and strip3d against
    their plain versions and timed at that grid. Returns the two kernels'
    entries, with their launches in the bench run."""
    from tpufwi_torch.bench import bench_3d

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = bench_3d.main([])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    ran = {k: v for k, v in launches.items() if v}
    grid, dt = bench_3d.bench_grid()
    cells = int(np.prod(grid.padded_shape))
    print(f"[bench 3d] {smi}: padded {'x'.join(map(str, grid.padded_shape))} ({cells} cells), "
          f"{wall:.1f} s with set-up; ms per step and Gcu/s " + "; ".join(
              f"{k} {v['ms_per_step']} ms, {v['gcups']} Gcu/s" for k, v in out.items())
          + f"; launches {json.dumps(ran)}", flush=True)
    if set(ran) != {"leapfrog3d", "strip3d", "a3d_forward"}:
        fail(f"the bench launched {ran}, not leapfrog3d, strip3d and a3d_forward")

    c2 = bench_3d.bench_c2(grid, dt, dev)
    runs = bench_3d.make_runs(grid, dt)
    fused = runs["full_step"](c2, check_nt)
    errs = {name: rel_err(fused, runs[name](c2, check_nt)) for name in ("strip_step", "full_step2")}
    if not bool(torch.isfinite(fused).all()) or float(fused.abs().max()) == 0:
        fail("the fused 3D step's field is not finite and nonzero")
    del fused
    prof = a3d_step_modules()[1].strip_prof_source(grid, dt, bench_3d.F0, bench_3d.C_MAX)(c2)
    rel, abs_err, plain_ms = a3d_step_kernels_vs_plain(grid, c2, prof, nt_held)
    times = time_a3d_step_kernels(grid, c2, prof, nt_time)
    print_a3d_step_times("bench 3d", smi, grid, nt_time, times, plain_ms)
    each_ms, host_ms = leapfrog3d_clocks(grid, c2, nt_time)
    print(f"[bench 3d] leapfrog3d ms a call by two more clocks: {each_ms:.5f} (median of CUDA "
          f"events around each of {nt_time} calls), {host_ms:.5f} (host clock around "
          f"{nt_time} calls and a synchronize)", flush=True)
    print(f"[bench 3d] full_step against the torch-op strips and against full_step2 after "
          f"{check_nt} steps from the impulse, of max: {json.dumps(errs)}; kernels vs plain, "
          f"{nt_held} steps: {json.dumps(rel)}; tolerances {json.dumps(A3D_STEP_TOL)}",
          flush=True)
    for name, err in errs.items():
        if not err <= A3D_STEP_TOL["bench"]:
            fail(f"full_step disagrees with {name}: {err:.3e} > {A3D_STEP_TOL['bench']:.0e}")
    check_a3d_step("bench grid", rel)
    counts = a3d_perstep_counts(grid)
    entries = []
    for name in ("leapfrog3d", "strip3d"):
        e = entry(name, abs_err[name], times[name][1], plain_ms[name], counts[name], 1)
        e["launches"] = launches[name]
        entries.append(e)
    return entries


def probe_counts(grid, shape, nt):
    """Operations and bytes of one call of each probe kernel, as ``bound``
    takes them: each input read once, each output written once. The 2D
    probe per step as ``step_counts`` counts its forward, no sources or
    receivers, its fields in and out once a call (C, P_{-1}, P_0 in, P_nt
    out; a 2D field fits the L2); the 3D probes per call: the taps 2K
    operations and 8 B a cell, the copy 1 and 8 B, step5 3 additions and 2
    H / BZ of a halo one and 16 B a cell, step5x also 4 additions and 12
    values a small-stream cell."""
    kp = probes_module()
    NZ, NX = grid.padded_shape
    taps = 2 * grid.radius + 1
    cells2 = NZ * NX
    fwd = step_counts(grid, 0, 0, 0)["scanres_forward_snap"][0]
    NY3, NZ3, NX3 = shape
    cells, small = NY3 * NZ3 * NX3, NY3 * NZ3 * kp.SS
    step5 = cells * (3 + 2 * kp.H / kp.BZ)
    return {"scan_probe": (fwd, 0, 4 * cells2 * 4),
            "scan_probe_P0": (cells2 * (4 * taps + 4), 0, 4 * cells2 * 4),
            "tap_probe_5": (10 * cells, 8 * cells, 0),
            "tap_probe": (50 * cells, 8 * cells, 0),
            "stream_copy": (cells, 8 * cells, 0),
            "stream_step5": (step5, 16 * cells, 0),
            "stream_step5x": (step5 + 4 * small, 16 * cells + 12 * 4 * small, 0)}


def events_ms(fn, calls):
    """(ms per call by CUDA events, host ms per call) of ``calls`` calls of
    ``fn`` after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    for _ in range(calls):
        fn()
    e1.record()
    host = 1e3 * (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / calls, host


def sm_clock_mhz():
    """(current, max) SM clock in MHz from nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout.splitlines()[0]
    return tuple(float(v) for v in out.split(","))


def phase_probes(dev, smi, nt_2d=PROBE_NT, calls=20):
    """The port's two probe scripts, all modes, at the reference's full
    sizes, with every launch counter set to 0 just before and read just
    after (the probes' launches); then each probe kernel against its plain
    version at full size and its times. Returns the five kernels' entries."""
    from tpufwi_torch.bench import exp_2d_scanres, exp_3d_lap

    kp = probes_module()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res2 = exp_2d_scanres.main([])
    res3 = exp_3d_lap.main([])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(PROBE_NAMES)
    print(f"[probes] {smi}: the probe scripts took {wall:.1f} s with set-up; launches "
          f"{json.dumps(launches)}", flush=True)
    if min(launches.values()) <= 0:
        fail(f"the probe scripts launched {launches}, not every probe kernel")

    # the kernels against their plain versions, and their times
    errs, abs_err, ms, plain = {}, dict.fromkeys(PROBE_NAMES, 0.0), {}, {}

    def hold(name, key, got, ref):
        d = float((got.double() - ref.double()).abs().max())
        errs[key] = d / float(ref.double().abs().max())
        abs_err[name] = max(abs_err[name], d)

    def time_pair(key, kernel, plain_fn, per=1):
        ms[key] = tuple(v / per for v in events_ms(kernel, calls))
        plain[key] = events_ms(plain_fn, 2)[0] / per

    grid, dt = exp_2d_scanres.probe_grid()
    c2, prof, seed = exp_2d_scanres.probe_inputs(grid, dt, dev)
    for tag, strips in (("P0", False), ("P1", True)):
        args = (grid, c2, prof, seed, 0.999 * seed, nt_2d, strips)
        hold("scan_probe", f"scan_probe {tag}", kp.scan_probe(*args), kp.scan_probe_plain(*args))
        time_pair(f"scan_probe {tag}", lambda: kp.scan_probe(*args),
                  lambda: kp.scan_probe_plain(*args), per=nt_2d)
    del c2, prof, seed
    shape = exp_3d_lap.probe_shape()
    x = exp_3d_lap.randn(shape, 0, dev)
    for K in kp.TAP_KS:
        hold("tap_probe", f"tap_probe K={K}", kp.tap_probe(x, K), kp.tap_probe_plain(x, K))
        time_pair(f"tap_probe K={K}", lambda: kp.tap_probe(x, K), lambda: kp.tap_probe_plain(x, K))
    # the copies and their library call on the same terms: into one
    # preallocated output, each held bitwise against p + 1
    copy_out = torch.empty_like(x)
    for v in kp.COPY_VARIANTS:
        ref = kp.stream_copy_plain(x)
        hold("stream_copy", f"stream_copy {v}", kp.stream_copy(x, v, out=copy_out), ref)
        if not torch.equal(copy_out, ref):
            fail(f"stream_copy {v} is not bitwise p + 1")
        del ref
        time_pair(f"stream_copy {v}", lambda: kp.stream_copy(x, v, out=copy_out),
                  lambda: kp.stream_copy_plain(x))
    library_ms = events_ms(lambda: torch.add(x, 1.0, out=copy_out), calls)[0]
    del copy_out
    pp, c2 = 0.5 * x, exp_3d_lap.randn(shape, 1, dev)
    small = [exp_3d_lap.randn(shape[:2] + (kp.SS,), 2 + i, dev) for i in range(8)]
    for staged in (False, True):
        key = f"stream_step5 staged={staged}"
        hold("stream_step5", key, kp.stream_step5(pp, x, c2, staged),
             kp.stream_step5_plain(pp, x, c2, staged))
        time_pair(key, lambda: kp.stream_step5(pp, x, c2, staged),
                  lambda: kp.stream_step5_plain(pp, x, c2, staged))
    got, ref = kp.stream_step5x(pp, x, c2, small), kp.stream_step5x_plain(pp, x, c2, small)
    for i, (g, r) in enumerate(zip((got[0],) + got[1], (ref[0],) + ref[1])):
        hold("stream_step5x", f"stream_step5x out {i}", g, r)
    del got, ref
    time_pair("stream_step5x", lambda: kp.stream_step5x(pp, x, c2, small),
              lambda: kp.stream_step5x_plain(pp, x, c2, small))
    del x, pp, c2, small

    counts = probe_counts(grid, shape, nt_2d)
    count_of = {"scan_probe P0": "scan_probe_P0", "scan_probe P1": "scan_probe",
                "tap_probe K=5": "tap_probe_5", "tap_probe K=25": "tap_probe",
                **{f"stream_copy {v}": "stream_copy" for v in kp.COPY_VARIANTS},
                **{f"stream_step5 staged={s}": "stream_step5" for s in (False, True)},
                "stream_step5x": "stream_step5x"}
    bounds = {key: bound(counts[c], nt_2d if c.startswith("scan") else 1)
              for key, c in count_of.items()}
    clock, clock_max = sm_clock_mhz()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"[probes] {smi}: 2D {'x'.join(map(str, grid.padded_shape))} ms per step at nt "
          f"{nt_2d}, 3D {'x'.join(map(str, shape))} ms per call: kernel by CUDA events (host "
          "per call; plain per call; bound; GB/s of the bound's bytes):", flush=True)
    for key, (k_ms, host_ms) in ms.items():
        b_ms, b_by = bounds[key]
        rate = ("" if key.startswith("scan")
                else f"; {counts[count_of[key]][1] / k_ms / 1e6:.1f} GB/s")
        print(f"[probes]   {key}: {k_ms:.5f} ({host_ms:.5f}; {plain[key]:.4f}; {b_ms:.5f} by "
              f"{b_by}{rate})", flush=True)
    per_tap = (ms["tap_probe K=25"][0] - ms["tap_probe K=5"][0]) / 20
    spec = sms * 128 * clock_max * 1e6
    print(f"[probes] per tap {per_tap:.5f} ms by CUDA events: {4 * np.prod(shape) / per_tap / 1e6:.1f}"
          f" GB/s of shared-memory reads; the card's specification: {sms} SMs x 128 B/clock x "
          f"{clock_max:.0f} MHz (max SM clock; {clock:.0f} MHz now) = {spec / 1e9:.0f} GB/s",
          flush=True)
    print(f"[probes] 2D strip cost (P1 - P0) {ms['scan_probe P1'][0] - ms['scan_probe P0'][0]:.5f}"
          " ms per step by CUDA events; stream_copy's library call torch.add(x, 1, out=o) "
          f"{library_ms:.5f} ms", flush=True)
    flat = [v for v in kp.COPY_VARIANTS if kp.COPY_TILES[v] == (1, 1)]
    print("[probes] copy into a preallocated output, ms a call by CUDA events (x torch.add): "
          + ", ".join(f"{v} {ms[f'stream_copy {v}'][0]:.5f} "
                      f"({ms[f'stream_copy {v}'][0] / library_ms:.3f})" for v in flat)
          + f"; torch.add {library_ms:.5f}; default {kp.COPY_DEFAULT}", flush=True)
    print(f"[probes] scripts: 2D {json.dumps(res2)}; 3D {json.dumps(res3)}", flush=True)
    merged = res3.get("merged", {})
    if 8 in merged and 2 in merged:
        d = merged[8]["full_step2"] - merged[2]["full_step2"]
        print(f"[probes] merged: a3d_forward (full_step2, tiled cell passes) order 8 - order 2 "
              f"{d:.5f} ms a step ({d / 18:.5f} a tap, 25 - 7 taps); the gather cell passes "
              "measured 0.93-0.94 (PERF.md, row 12)", flush=True)
    print(f"[probes] rel err {json.dumps(errs)}; tolerances {json.dumps(PROBE_TOL)}", flush=True)
    for key, err in errs.items():
        tol = PROBE_TOL["scan_probe" if key.startswith("scan_probe") else "3d"]
        if not err <= tol:
            fail(f"{key} disagrees with its plain version: {err:.3e} > {tol:.0e}")
    # each entry's configuration: the 2D probe with its strips (the
    # production forward's step), the taps at K = 25 (an order-8 3D
    # stencil's), the default copy (the stream's ceiling), step5
    # unstaged; max_abs_err over every configuration held
    shown = {"scan_probe": "scan_probe P1", "tap_probe": "tap_probe K=25",
             "stream_copy": f"stream_copy {kp.COPY_DEFAULT}",
             "stream_step5": "stream_step5 staged=False",
             "stream_step5x": "stream_step5x"}
    entries = []
    for name, key in shown.items():
        b_ms, b_by = bounds[key]
        source, replaces = KERNELS[name]
        entries.append(dict(name=name, route=PROBE_ROUTE, source=source, replaces=replaces,
                            launches=launches[name], max_abs_err=abs_err[name], ms=ms[key][0],
                            plain_ms=plain[key], bound_ms=b_ms, bound_by=b_by,
                            library_ms=library_ms if name == "stream_copy" else None))
    return entries


def main() -> int:
    smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    kernels = phase_kernels(dev, smi)
    kernels += phase_kstep_kernels(dev, smi)  # leapfrog's launches with it
    phase_shot(dev, smi)
    phase_gradients(dev, smi)
    phase_over_budget(dev, smi)
    kernels += phase_elastic_kernels(dev, smi)
    phase_elastic_shot(dev, smi)
    kernels += phase_estep_kernels(dev, smi)
    phase_estep_shot(dev, smi)
    phase_marine_shot(dev, smi)
    kernels += phase_a3d_kernels(dev, smi)
    phase_a3d_fullscale(dev, smi)
    phase_a3d_step_kernels(dev, smi)
    kernels += phase_bench_3d(dev, smi)
    kernels += phase_probes(dev, smi)
    launches = dict.fromkeys(KERNELS, 0)
    for path in PATHS:
        for name, n in phase_main(smi, path).items():
            launches[name] += n
    launches.update(phase_main_elastic(smi))
    launches.update(phase_main_estep(smi, dev))
    launches.update(phase_main_3d(smi, dev))
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms")
    for k in kernels:
        k.setdefault("launches", launches[k["name"]])
    if min(k["launches"] for k in kernels) <= 0:
        fail("a kernel was launched on no main path (leapfrog: in no leapfrog run; the "
             "probes: in no probe script)")
    print(json.dumps({"kernels": [{key: k[key] for key in order} for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
