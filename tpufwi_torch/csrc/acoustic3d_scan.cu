// Whole-scan 3D acoustic engine for Hopper (sm_90a): the forward time loop
// (optional fp32 or bf16 boundary-ring tape, optional illumination) and the
// reverse (reconstruction, exact transposed CPML step, imaging).
//
// Replaces the TPU kernels of the fused 3D engine (tpufwi/adjoint3d_pallas.py):
//   a3d_forward <- kernels/acoustic3d_fused2.py make_leapfrog3d_merged (the
//                  leapfrog, x-face CPML, y/z slab apply) and make_corr3d_y /
//                  make_corr3d_z (the y/z face CPML slabs), plus the XLA source
//                  scatter, receiver gather and tape slicing around them
//   a3d_reverse <- kernels/acoustic3d_bwd_pallas.py make_recon3d_kernel (the
//                  reconstruction, ring imposition and imaging) fused with
//                  make_transpose3d_kernel and make_tcorr3d_y / make_tcorr3d_z
//                  (the transposed step with its transposed faces)
// On the TPU the y/z faces were split out of the leapfrog only for VMEM and
// DMA tiling; the CPML is separable, so here every face of every axis rides
// in the same launches. Plain C interface, built by nvcc into its own shared
// library and called through ctypes (tpufwi_torch/kernels/acoustic3d_scan.py).
// The kernels and their semantics are in acoustic3d_kernels.cuh.
//
// What bounds it: memory traffic, in principle. At the 428 x 188 x 588 grid
// of the 3D main path (47.3 M cells, 189 MB a field) a forward step must at
// least read P_{t-1}, P_{t-2}, C and write P_t (16 B/cell, 0.76 GB: 0.23 ms
// at 3.35 TB/s) and a reverse step P_{t-1}, P_t, C, lambda_t, lambda_{t+1}
// and gacc and write P_{t-2}, lambda_{t-1} and gacc (36 B/cell, 0.51 ms);
// the stencils' operations are ~10x below that. A field is far larger than
// the 50 MB L2, so each cell pass is a single sweep. The tiled passes (the
// default) march 2.5D tiles along y (acoustic3d_kernels.cuh, "2.5D marching
// tiles"), each value of the stencil field loaded from device memory about
// once, its 25 taps from registers and shared memory. The cells of the CPML
// shell (within S + R of a face, 30% of the cells at this grid) read strip
// values in their tails: the forward's and the first reverse pass's tiles
// stage them through shared memory in the same cp.async groups as the field,
// before the plane's barrier (tiles whose strip gathers ran after the
// barrier made every tile wait on them and lost to the gather passes,
// PERF.md). The second reverse pass's cells read each axis's transposed
// CPML term, D2 w - D1 y along the axis; a line pass (r3_lines) computes
// them a block per group of whole lines along one axis, y of its strips
// kept in shared memory, so that the pass's tiles copy at most three terms
// at the cell as operands and its ring leaves room for two blocks an SM.
// Every cell pass is one walk over the whole grid in one launch, and every
// launch goes to the caller's stream. The CPML memories are stored on their
// strips only (26% of the cells at this grid a quantity, the terms 34%:
// the forward's strip pass and the line pass are one extra launch per step
// each), u = C lambda is never written, and the reverse fuses the
// reconstruction into the first cell pass, so the reverse reads each full
// field about twice per step.
// variant 1 launches the gather passes over the whole grid instead (one
// thread per cell, every tap and strip value a global load), which compute
// the same values bitwise: checks hold the tiled passes against them. Left
// for later: TMA tile loads and warp specialisation, fewer integer
// operations a tiled cell (several cells a thread, vector copies), a
// persistent kernel or CUDA graph instead of 4-6 launches per step, and the
// one-block source and receiver kernels.
//
// Tapes. Row t holds rings(P_t) after the sources, in RingSpec order
// (tpufwi_torch/propagators/boundary.py), fp32 or bf16 (rounded to nearest
// even); the reverse imposes row t-2 while it reconstructs P_{t-2} (zeros
// for t < 2). At the full Overthrust grid a row is 7.4 M cells and nt = 3028
// rows hold 22.5 G values, so tape offsets are size_t.

#include "acoustic3d_kernels.cuh"

namespace {

// variant 0: tiled cell passes on plan; 1: the gather passes
template <int R>
int check_variant(int variant, const TilePlan& plan, const Dims& D) {
  if (variant == 1 || (variant == 0 && plan_ok<R>(plan, D))) return 0;
  return (int)cudaErrorInvalidValue;
}

template <int R>
int allow_forward_smem(int variant, const Dims& D) {
  if (variant != 0) return 0;
  if (const int err = allow_smem(f3_cells_tiled<R, true>, RingF3S<R>::bytes(D.S))) return err;
  return allow_smem(f3_cells_tiled<R, false>, RingF3S<R>::bytes(D.S));
}

template <int R>
int allow_reverse_smem(int variant, const Dims& D) {
  if (const int err = allow_smem(r3_lines<R>, line_smem<R>(D))) return err;
  if (variant != 0) return 0;
  if (const int err = allow_smem(r3_cells1_tiled<R>, RingR1S<R>::bytes(D.S))) return err;
  return allow_smem(r3_cells2_tiled<R>, RingR2T<R>::BYTES);
}

// the reverse's strip buffers: psibar, w and phibar (strip_total floats
// each), then the terms (strip_total at depth S + R)
struct RevStrips {
  Strips psb, wv, pbar, tv;
  RevStrips(float* strips, const Dims& D, int R) {
    const size_t ns = strip_total(D.n[0], D.n[1], D.n[2], D.S);
    psb = strips_at(strips, D.n[0], D.n[1], D.n[2], D.S);
    wv = strips_at(strips + ns, D.n[0], D.n[1], D.n[2], D.S);
    pbar = strips_at(strips + 2 * ns, D.n[0], D.n[1], D.n[2], D.S);
    tv = strips_at(strips + 3 * ns, D.n[0], D.n[1], D.n[2], D.S + R);
  }
};

// the reverse's second half, one step: the line pass (q = lambda_t), then
// the second cell pass (variant 0: the tiled walk on chunks of cy planes;
// 1: gather) from qc = lambda_t into qo
template <int R>
void r3_lines_launch(const float* q, const float* c2, const float* prof, const RevStrips& sv,
                     const Dims& D, const Taps3& tp, cudaStream_t st) {
  r3_lines<R><<<line_blocks(D), kLineThreads, line_smem<R>(D), st>>>(q, c2, sv.wv, sv.pbar, sv.tv,
                                                                  prof, D, tp);
}

template <int R>
void r3_cells2_launch(const float* qc, float* qo, const float* c2, const RevStrips& sv,
                      const Dims& D, const Taps3& tp, int variant, int cy, cudaStream_t st) {
  if (variant == 0)
    r3_cells2_tiled<R><<<grid_blocks<R>(D, cy), kTileBlock, RingR2T<R>::BYTES, st>>>(
        qc, qo, c2, sv.tv, D, tp, cy);
  else
    r3_cells2<R><<<cell_grid(D), kCellBlock, 0, st>>>(qc, qo, c2, sv.tv, D, tp);
}

template <int R, typename T>
int forward_loop(const float* c2, const float* prof, const float* w, const long long* src,
                 const long long* rcv, float* seis, const int* ring, T* tape, float* illum,
                 float* pa, float* pb, float* strips, const Dims& D, int nt, int nsrc, int nrec,
                 int fs, int n_ring, const Taps3& tp, int variant, const TilePlan& plan,
                 cudaStream_t st) {
  if (const int err = check_variant<R>(variant, plan, D)) return err;
  if (const int err = allow_forward_smem<R>(variant, D)) return err;
  const Strips phi = strips_at(strips, D.n[0], D.n[1], D.n[2], D.S);
  const Strips psi = strips_at(strips + strip_total(D.n[0], D.n[1], D.n[2], D.S), D.n[0],
                               D.n[1], D.n[2], D.S);
  const auto walk = illum != nullptr ? f3_cells_tiled<R, true> : f3_cells_tiled<R, false>;
  float* cur = pb;   // P_{t-1}
  float* prev = pa;  // P_{t-2}, overwritten by P_t
  for (int t = 0; t < nt; ++t) {
    f3_phi<R><<<strip_blocks(D), kStripBlock, 0, st>>>(cur, phi, prof, D, tp);
    if (variant == 0)
      walk<<<grid_blocks<R>(D, plan.cy), kTileBlock, RingF3S<R>::bytes(D.S), st>>>(
          cur, prev, c2, phi, psi, prof, illum, D, fs, tp, plan.cy);
    else
      f3_cells<R><<<cell_grid(D), kCellBlock, 0, st>>>(cur, prev, c2, phi, psi, prof, illum, D,
                                                        fs, tp);
    f3_src_rcv<R><<<1, kSmallBlock, 0, st>>>(prev, c2, w, t, src, rcv, seis, nsrc, nrec, D, fs);
    if (tape != nullptr)
      f3_ring_get<R, T><<<blocks_for(n_ring), kSmallBlock, 0, st>>>(
          prev, ring, tape + (size_t)t * n_ring, n_ring, D);
    if (t == 0) {
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    float* tmp = cur;
    cur = prev;
    prev = tmp;
  }
  if (illum != nullptr) f3_illum_add<R><<<cell_grid(D), kCellBlock, 0, st>>>(cur, illum, D);
  return (int)cudaGetLastError();
}

template <int R, typename T>
int reverse_loop(const float* c2, const float* prof, const float* w, const float* ybar,
                 const T* tape, const int* ring, const long long* src, const long long* rcv,
                 float* gacc, float* lam_src, float* p_tp1, float* p_t, float* qc, float* qo,
                 float* strips, int* chain, const Dims& D, int nt, int nsrc, int nrec, int fs,
                 int n_ring, const RingFrame3& frame, const Taps3& tp, int variant,
                 const TilePlan& plan, cudaStream_t st) {
  if (const int err = check_variant<R>(variant, plan, D)) return err;
  if (const int err = allow_reverse_smem<R>(variant, D)) return err;
  const RevStrips sv(strips, D, R);
  if (nrec > 0) r3_chain<<<blocks_for(nrec), kSmallBlock, 0, st>>>(rcv, nrec, chain);
  for (int t = nt - 1; t >= 0; --t) {
    r3_inject<R><<<1, kSmallBlock, 0, st>>>(qc, ybar, t, rcv, chain, src, lam_src, nsrc, nrec,
                                            D, fs);
    if (variant == 0)
      r3_cells1_tiled<R><<<grid_blocks<R>(D, plan.cy), kTileBlock, RingR1S<R>::bytes(D.S), st>>>(
          qc, c2, p_t, p_tp1, gacc, sv.psb, sv.wv, prof, D, fs, tp, plan.cy);
    else
      r3_cells1<R><<<cell_grid(D), kCellBlock, 0, st>>>(qc, c2, p_t, p_tp1, gacc, sv.psb, sv.wv,
                                                         prof, D, fs, tp);
    r3_src_ring<R, T><<<blocks_for(n_ring), kSmallBlock, 0, st>>>(
        p_tp1, c2, w, t, src, nsrc, ring, t >= 2 ? tape + (size_t)(t - 2) * n_ring : nullptr,
        n_ring, D, fs, frame);
    r3_lines_launch<R>(qc, c2, prof, sv, D, tp, st);
    r3_cells2_launch<R>(qc, qo, c2, sv, D, tp, variant, plan.cy, st);
    if (t == nt - 1) {
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    float* tmp = p_t;
    p_t = p_tp1;
    p_tp1 = tmp;
    tmp = qc;
    qc = qo;
    qo = tmp;
  }
  return (int)cudaGetLastError();
}

// pass 0: the line pass, 1: the tiled second cell pass, 2: its gather
// variant
template <int R>
int reverse_pass(int pass, const float* qcur, float* qoth, const float* c2, const float* prof,
                 float* strips, const Dims& D, const Taps3& tp, const TilePlan& plan,
                 cudaStream_t st) {
  if (pass < 0 || pass > 2) return (int)cudaErrorInvalidValue;
  const int variant = pass == 2 ? 1 : 0;
  if (pass == 1)
    if (const int err = check_variant<R>(variant, plan, D)) return err;
  if (const int err = allow_reverse_smem<R>(variant, D)) return err;
  const RevStrips sv(strips, D, R);
  if (pass == 0)
    r3_lines_launch<R>(qcur, c2, prof, sv, D, tp, st);
  else
    r3_cells2_launch<R>(qcur, qoth, c2, sv, D, tp, variant, plan.cy, st);
  return (int)cudaGetLastError();
}

// a walk's registers a thread, dynamic shared bytes and blocks an SM at
// them (its largest ring)
template <typename K>
int occupancy(K kernel, int bytes, int* out) {
  if (const int err = allow_smem(kernel, bytes)) return err;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, reinterpret_cast<const void*>(kernel));
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = bytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 2, kernel, kTileThreads, bytes);
}

template <int R>
int walk_occupancy(int S, int* out) {
  if (const int err = occupancy(f3_cells_tiled<R, false>, RingF3S<R>::bytes(S), out)) return err;
  if (const int err = occupancy(r3_cells1_tiled<R>, RingR1S<R>::bytes(S), out + 3)) return err;
  return occupancy(r3_cells2_tiled<R>, RingR2T<R>::BYTES, out + 6);
}

}  // namespace

extern "C" {

// c2: the halo-padded C; prof: (3 axes x (a, b) x 2S); pa, pb: zeroed halo
// fields; strips: 2 x strip_total zeroed floats (phi, then psi); tape (with
// ring) and illum may be null; tape_bf16 selects the tape's type. variant
// 0 runs the tiled cell passes on the plan (tz, tx, cy, smem: the largest
// walk's shared bytes), which must be one this library was built for; 1 the
// gather passes (plan unread).
int tpufwi_a3d_forward(const float* c2, const float* prof, const float* w,
                       const long long* src, const long long* rcv, float* seis, const int* ring,
                       void* tape, float* illum, float* pa, float* pb, float* strips, int NY,
                       int NZ, int NX, int S, int R, int nt, int nsrc, int nrec, int fs,
                       int n_ring, int tape_bf16, int variant, int tz, int tx, int cy, int smem,
                       const float* taps, void* stream) {
  const Taps3 tp = load_taps3(taps);
  const Dims D = make_dims(NY, NZ, NX, S, R);
  const TilePlan plan{tz, tx, cy, smem};
  auto st = static_cast<cudaStream_t>(stream);
  if (tape_bf16) {
    auto* tb = static_cast<__nv_bfloat16*>(tape);
    TPUFWI_DISPATCH_R3(R, (forward_loop<kR, __nv_bfloat16>(c2, prof, w, src, rcv, seis, ring, tb,
                                                          illum, pa, pb, strips, D, nt, nsrc,
                                                          nrec, fs, n_ring, tp, variant, plan,
                                                          st)))
  }
  auto* tf = static_cast<float*>(tape);
  TPUFWI_DISPATCH_R3(R, (forward_loop<kR, float>(c2, prof, w, src, rcv, seis, ring, tf, illum,
                                                 pa, pb, strips, D, nt, nsrc, nrec, fs, n_ring,
                                                 tp, variant, plan, st)))
}

// p_tp1 = P_{nt-1}, p_t = P_{nt-2} (halo fields set by the caller); qa, qb:
// zeroed halo fields; strips: 3 x strip_total zeroed floats (psibar, w,
// phibar), then strip_total at depth S + R (the terms); gacc (NY, NZ,
// NX) zeroed; chain: 2 * nrec ints; tape (nt, n_ring) with row t = rings(P_t).
// After the loop P_{-1} is in p_tp1 for even nt, in p_t for odd nt.
// variant and plan as tpufwi_a3d_forward's.
int tpufwi_a3d_reverse(const float* c2, const float* prof, const float* w, const float* ybar,
                       const void* tape, const int* ring, const long long* src,
                       const long long* rcv, float* gacc, float* lam_src, float* p_tp1,
                       float* p_t, float* qa, float* qb, float* strips, int* chain, int NY,
                       int NZ, int NX, int S, int R, int nt, int nsrc, int nrec, int fs,
                       int n_ring, int tape_bf16, int y0, int y1, int z0, int z1, int x0, int x1,
                       int rw, int variant, int tz, int tx, int cy, int smem, const float* taps,
                       void* stream) {
  const Taps3 tp = load_taps3(taps);
  const Dims D = make_dims(NY, NZ, NX, S, R);
  const RingFrame3 frame{{y0, z0, x0}, {y1, z1, x1}, rw};
  const TilePlan plan{tz, tx, cy, smem};
  auto st = static_cast<cudaStream_t>(stream);
  if (tape_bf16) {
    auto* tb = static_cast<const __nv_bfloat16*>(tape);
    TPUFWI_DISPATCH_R3(R, (reverse_loop<kR, __nv_bfloat16>(
                              c2, prof, w, ybar, tb, ring, src, rcv, gacc, lam_src, p_tp1, p_t,
                              qa, qb, strips, chain, D, nt, nsrc, nrec, fs, n_ring, frame, tp,
                              variant, plan, st)))
  }
  auto* tf = static_cast<const float*>(tape);
  TPUFWI_DISPATCH_R3(R, (reverse_loop<kR, float>(c2, prof, w, ybar, tf, ring, src, rcv, gacc,
                                                 lam_src, p_tp1, p_t, qa, qb, strips, chain, D,
                                                 nt, nsrc, nrec, fs, n_ring, frame, tp, variant,
                                                 plan, st)))
}

// One pass of the reverse's second half alone on the stream, for the checks
// and their timing (the reverse runs the two each step, in this order):
// pass 0 the line pass (qcur = lambda_t, c2, w and
// phibar in strips -> phibar' and the terms in strips), 1 the tiled second
// cell pass on the plan, 2 its gather variant (qcur = lambda_t, qoth =
// lambda_{t+1}, the terms -> qoth = lambda_{t-1}). qcur, qoth and c2 are
// halo fields, strips as tpufwi_a3d_reverse's; the plan as its (unread by
// passes 0 and 2).
int tpufwi_a3d_reverse_pass(const float* qcur, float* qoth, const float* c2, const float* prof,
                            float* strips, int pass, int NY, int NZ, int NX, int S, int R,
                            int tz, int tx, int cy, int smem, const float* taps,
                            void* stream) {
  const Taps3 tp = load_taps3(taps);
  const Dims D = make_dims(NY, NZ, NX, S, R);
  const TilePlan plan{tz, tx, cy, smem};
  auto st = static_cast<cudaStream_t>(stream);
  TPUFWI_DISPATCH_R3(R, (reverse_pass<kR>(pass, qcur, qoth, c2, prof, strips, D, tp, plan, st)))
}

// The tiled walks at radius R and strip depth S: f3_cells_tiled (without
// illumination), r3_cells1_tiled and r3_cells2_tiled in turn, each its
// registers a thread, its dynamic shared bytes and the blocks an SM holds
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor): 9 ints into out.
int tpufwi_a3d_walk_occupancy(int R, int S, int* out) {
  TPUFWI_DISPATCH_R3(R, (walk_occupancy<kR>(S, out)))
}

const char* tpufwi_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
