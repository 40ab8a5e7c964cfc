// Whole-scan 2D elastic P-SV engine for Hopper (sm_90a): the forward time
// loop with an optional fp32 five-field boundary-ring tape, and the reverse
// (reconstruction, exact transposed stages, imaging).
//
// Replaces two TPU kernels of tpufwi/kernels/elastic2d_pallas_scan.py:
//   escan_forward  <- make_elastic_scan_forward (with_tape or not)
//   escan_reverse  <- make_elastic_scan_reverse
// Plain C interface, built by nvcc into its own shared library and called
// through ctypes (tpufwi_torch/kernels/elastic2d_scan.py). The kernels and
// their semantics are in elastic2d_kernels.cuh.
//
// Design. On the TPU each sweep is one pallas_call with the five fields,
// the cotangents, the gradient accumulators and the CPML strips in VMEM.
// Here they live in device memory (one 399x1749 fp32 plane is 2.8 MB; a
// forward step touches ~13 planes, a reverse step ~27, more than the 50 MB
// L2) and a host loop in this file launches each time step as a few
// ordered kernels on the caller's stream. The receivers are gathered and
// injected by index, not by the TPU kernel's one-hot matmul, so there is no
// receiver-slab contract.
//
// The forward runs 2 launches a step, each a programmatic dependent of the
// one before: stage V (ef_v, which also adds the step before's force
// sources), then ef_s_fused, stage S on shared-memory tiles with the glue
// folded into the thread that owns each cell (the sources, both
// free-surface images, the receivers, the ring tape), and one tail launch a
// call for the last step's force sources. A single pass a step (stage V
// over each tile's R cross, then stage S) was bitwise too and lost on the
// card: the cross costs 1.75x stage V's work at a 16 x 32 tile, where the
// two one-thread-a-cell passes already run near their streamed bytes
// (PERF.md).
//
// The reverse's cell passes, er_s and er_v, a shared-memory tile each,
// compute the dbar values over their tile and its R reach and apply the
// transposed stencils from shared memory, as the TPU kernel keeps them in
// VMEM scratch; no dbar plane in device memory, the dual planes ping-ponged
// between two sets. The step's glue runs in the thread that owns each
// cell, as in ef_s_fused: the receiver cotangents, the source-point
// cotangent, the source undone and both ring imposes (a force source's undo
// and a pressure receiver's cotangent, which er_s reads over its reach, in
// er_v of the step before, or for the call's first step in er_setup). 2
// launches per reverse step (estage_rfused), with the free surface too:
// the tile rows are then shifted as the forward's, so that one tile row
// holds every ghost row and its mirrors, and that row's tiles run the
// images after their cells (er_s the stress image and the velocity-image
// transpose; er_v the velocity image, the stress-image transpose and a
// force source's undo on the image's rows), in an epilogue that the land
// instantiation (a template flag chosen here from fs) does not compile;
// once a call er_setup (the maps) and, with the free surface, the first
// step's stress-image transpose. Each
// launch of a step is a programmatic dependent of the one before it: its
// launch and block scheduling overlap that kernel's drain, and it waits for
// that kernel's memory before it touches any (dependent launch off: plain
// stream order).
//
// The oracle of both on the card is the per-step engine (elastic2d_step.cu:
// estage_v + estage_s, 4 launches a step, 6 with the free surface; estage_rs
// + estage_rv, 8 and 12, the dbar planes in device memory), which runs the
// header's per-cell bodies too, so the two engines agree bitwise.
//
// Tape. Row t holds rings(state after step t) of vx, vz, sxx, szz, sxz,
// fp32, taken after the sources and the stress image (a surface source sits
// in the ring); the reverse step t imposes row t-1 (zeros for t = 0), so
// the tape is written unshifted where the TPU kernel delays it one step in
// VMEM. 5 x 16,352 cells = 327 KB per step at 399x1749, order 8.
//
// What bounds it: the stencils' operations in principle (~4 D+/D- of 2R
// taps per stage and cell), but at this size the device memory traffic of
// the cell passes (the reverse step streams ~45 planes, the forward's two
// passes ~22) and the launches. Left for later: strip-only CPML storage, a
// persistent kernel or a CUDA graph per step.

#include "elastic2d_kernels.cuh"

namespace {

// ws: the 5 halo fields and the 8 memories; stage V and the fused stage S
// on TZ x TX tiles (the plan must say so), iws the zeroed maps and a flag
// word per stage-V block.
template <int R, int TZ, int TX>
int forward_loop(const EPlan& plan, int dep, EMats mt, EProf pr, const float* w,
                 const long long* src, const long long* rcv, float* seis, const int* ring,
                 float* ring_tape, float* ws, int* iws, int NZ, int NX, int S, int nt, int nsrc,
                 int nrec, int fs, int n_ring, int force, int rec_v, const ETaps& tp,
                 cudaStream_t st) {
  const size_t hp = (size_t)(NZ + 2 * R) * (NX + 2 * R);
  const size_t pl = (size_t)NZ * NX;
  EFields f{ws, ws + hp, ws + 2 * hp, ws + 3 * hp, ws + 4 * hp};
  float* mem = ws + 5 * hp;
  if (const int err = fused_check_plan<R, TZ, TX>(plan)) return err;
  const int shift = ef_shift<R, TZ>(fs);
  const dim3 grid((NX + TX - 1) / TX, (NZ + shift + TZ - 1) / TZ), block(TX, kFRows);
  const dim3 vgrid = e_cell_grid(NZ, NX);
  const SMaps m = carve_maps(iws, NZ, NX, grid.x * grid.y, nsrc);
  int* vflags = m.rnext + nrec;
  const int nr = ring_tape ? n_ring : 0;
  ef_setup<<<e_blocks(nsrc + nrec + nr), kESmallBlock, 0, st>>>(
      src, nsrc, rcv, nrec, ring, nr, NX, TZ, TX, grid.x, shift, m, vflags, vgrid.x);
  const EFwdArgs a{mt, pr, w, seis, mem + 4 * pl, m, NZ, NX, S, fs, shift, nrec, n_ring,
                   force, rec_v, tp};
  for (int t = 0; t < nt; ++t) {
    // stage V adds the step before's force sources
    const EVSrc vs{force && t >= 1 ? vflags : nullptr, m.smap, m.snext, w, t - 1};
    launch_dep(dep, ef_v<R>, vgrid, kECellBlock, 0, st, f, mem, mt, pr, NZ, NX, S, tp, vs);
    launch_dep(dep, ef_s_fused<R, TZ, TX>, grid, block, (size_t)ef_smem<R, TZ, TX>(), st, a,
               t, f, ring_tape ? ring_tape + (size_t)t * 5 * n_ring : nullptr);
    if (t == 0) {
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  // the last step's force sources
  if (force) e_src<<<1, 1, 0, st>>>(f, mt.bz, w, nt - 1, src, nsrc, NX, R, tp.dt, force);
  return (int)cudaGetLastError();
}

// the fused passes on TZ x TX tiles (the plan must say so), iws the zeroed
// maps
template <int R, int TZ, int TX>
int reverse_loop(const EPlan& plan, int dep, EMats mt, EProf pr, const float* w,
                 const float* ybar, const float* ring_tape, const int* ring,
                 const long long* src, const long long* rcv, float* g, float* srcrow, float* ws,
                 int* iws, int NZ, int NX, int S, int nt, int nsrc, int nrec, int fs,
                 int n_ring, int force, int rec_v, const ETaps& tp, cudaStream_t st) {
  const size_t hp = (size_t)(NZ + 2 * R) * (NX + 2 * R);
  const size_t pl = (size_t)NZ * NX;
  EFields f{ws, ws + hp, ws + 2 * hp, ws + 3 * hp, ws + 4 * hp};
  if (const int err = fused_check_plan<R, TZ, TX>(plan)) return err;
  float* cbb = ws + 5 * hp;
  EFields cb{cbb, cbb + pl, cbb + 2 * pl, cbb + 3 * pl, cbb + 4 * pl};
  float* dual = cbb + 5 * pl;
  // with the free surface the tile rows are shifted as the forward's
  const int shift = ef_shift<R, TZ>(fs);
  const int ntx = (NX + TX - 1) / TX, ntz = (NZ + shift + TZ - 1) / TZ;
  const SMaps m = carve_maps(iws, NZ, NX, ntx * ntz, nsrc);
  er_setup<<<e_blocks(nsrc + nrec + n_ring), kESmallBlock, 0, st>>>(
      src, nsrc, rcv, nrec, ring, n_ring, NX, R, TZ, TX, ntx, shift, m, f, cb, mt.bz, w, ybar,
      nt - 1, tp.dt, force, rec_v);
  if (fs >= 0) er_image_s_t<R><<<e_blocks(R * NX), kESmallBlock, 0, st>>>(cb, NX, fs);
  for (int t = nt - 1; t >= 0; --t) {
    const float* row = t >= 1 ? ring_tape + (size_t)(t - 1) * 5 * n_ring : nullptr;
    // two sets of 8 dual planes, swapped each step
    const int k = (nt - 1 - t) & 1;
    const ERevGlue gl{m, w, ybar, row, srcrow, t, nsrc, nrec, n_ring, fs, force, rec_v};
    const float* din = dual + k * 8 * pl;
    float* dout = dual + (1 - k) * 8 * pl;
    if (fs >= 0)
      estage_rfused<R, TZ, TX, true>(f, cb, din, dout, g, mt, pr, gl, NZ, NX, S, tp, dep, st);
    else
      estage_rfused<R, TZ, TX, false>(f, cb, din, dout, g, mt, pr, gl, NZ, NX, S, tp, dep, st);
    if (t == nt - 1) {
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// ws: 5 zeroed halo planes (vx, vz, sxx, szz, sxz: the final fields on
// return) then 8 zeroed compact CPML memory planes; iws: the zeroed int
// maps of 3 NZ NX + tiles + nsrc + nrec ints, then a word per block of
// stage V (32 x 8 cells); ring and ring_tape may be null together (no
// tape). plan and dep as the reverse's. taps: z[4], x[4], dt.
int tpufwi_escan_forward(const float* lam, const float* l2m, const float* muxz,
                         const float* bxm, const float* bzm, const float* az, const float* bz,
                         const float* ax, const float* bx, const float* w,
                         const long long* src, const long long* rcv, float* seis,
                         const int* ring, float* ring_tape, float* ws, int* iws, int NZ, int NX,
                         int S, int R, int nt, int nsrc, int nrec, int fs, int n_ring, int force,
                         int rec_v, int tz, int tx, int smem, int dep, const float* taps,
                         void* stream) {
  const ETaps tp = load_etaps(taps);
  const EMats mt{lam, l2m, muxz, bxm, bzm};
  const EProf pr{az, bz, ax, bx};
  const EPlan plan{tz, tx, smem};
  auto st = static_cast<cudaStream_t>(stream);
  TPUFWI_EDISPATCH_R(R, (forward_loop<kR, kFTZ, kFTX>(plan, dep, mt, pr, w, src, rcv, seis, ring,
                                                        ring_tape, ws, iws, NZ, NX, S, nt, nsrc,
                                                        nrec, fs, n_ring, force, rec_v, tp, st)))
}

// ws: 5 halo planes holding the final fields (set by the caller), then 5
// zeroed compact cotangent planes and 16 zeroed compact dual planes (two
// sets); g: 5 zeroed compact gradient planes (lam, l2m, muxz, bx, bz);
// srcrow (nt, nsrc); iws: the zeroed int maps of 3 NZ NX + tiles + nsrc +
// nrec ints; ring_tape (nt, 5 n_ring). The passes run on the plan (tz, tx,
// smem: the tile and the larger pass's shared bytes), which must be the one
// the library was built for, each launch a programmatic dependent of the
// one before it when dep is 1.
int tpufwi_escan_reverse(const float* lam, const float* l2m, const float* muxz,
                         const float* bxm, const float* bzm, const float* az, const float* bz,
                         const float* ax, const float* bx, const float* w, const float* ybar,
                         const float* ring_tape, const int* ring, const long long* src,
                         const long long* rcv, float* g, float* srcrow, float* ws, int* iws,
                         int NZ, int NX, int S, int R, int nt, int nsrc, int nrec, int fs,
                         int n_ring, int force, int rec_v, int tz, int tx, int smem, int dep,
                         const float* taps, void* stream) {
  const ETaps tp = load_etaps(taps);
  const EMats mt{lam, l2m, muxz, bxm, bzm};
  const EProf pr{az, bz, ax, bx};
  const EPlan plan{tz, tx, smem};
  auto st = static_cast<cudaStream_t>(stream);
  // (parenthesised: the template's commas are not the macro's)
  TPUFWI_EDISPATCH_R(R, (reverse_loop<kR, kFTZ, kFTX>(plan, dep, mt, pr, w, ybar, ring_tape,
                                                        ring, src, rcv, g, srcrow, ws, iws, NZ,
                                                        NX, S, nt, nsrc, nrec, fs, n_ring, force,
                                                        rec_v, tp, st)))
}

const char* tpufwi_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
