// Whole-scan 2D acoustic engine for Hopper (sm_90a): the forward time loop
// with a bf16 snapshot tape or an fp32 boundary-ring tape, the snapshot
// reverse and the rings reverse.
//
// Replaces three TPU kernels of tpufwi/kernels/acoustic2d_pallas_scanres.py:
//   scanres_forward       <- make_scanres_forward (snap_tape=True, with_tape
//                            (rings) or no tape)
//   scanres_reverse_snap  <- make_scanres_reverse_snap
//   scanres_reverse       <- make_scanres_reverse (reconstruction + exact
//                            transposed CPML step + imaging)
// Plain C interface, built by nvcc into a shared library together with
// acoustic2d_step.cu and called through ctypes
// (tpufwi_torch/kernels/acoustic2d_scanres.py). The kernels and their
// semantics are in acoustic2d_kernels.cuh.
//
// Design. On the TPU the whole loop is one pallas_call with the state in
// VMEM. Here the state lives in device memory (a 399x1749 fp32 field is
// 2.8 MB; the working set of one step fits the 50 MB L2) and a host loop in
// this file launches each time step as a few ordered kernels on the caller's
// stream, so the Python side makes one call per propagation.
//
// Tapes. Snapshot row t is bf16(D2 laplacian of P_{t-1}), the field step t
// starts from (2 bytes per cell per step, 6.8 GB at 399x1749x4842). Ring
// row t is rings(P_t) after the sources, fp32 (16,352 cells = 64 KB per
// step at that grid, 0.32 GB for the shot); the rings reverse re-imposes
// row t-2 while it reconstructs P_{t-2} (zeros for t < 2), so the tape is
// written unshifted, where the TPU kernel shifts it in VMEM.
//
// What bounds it: memory traffic and launches. Per cell and step the
// forward moves ~18 bytes (P_{t-1} read once if the stencil hits cache,
// P_{t-2} read + P_t write, C read, the snapshot row), the snapshot reverse
// ~30, the rings reverse ~38 (its reconstruction reads P_{t-1} and rewrites
// P_t, and reads no snapshot row). Only the tape must reach HBM. Left for
// later: strip-only storage of the CPML variables, a persistent kernel (or
// CUDA graph) instead of 3-5 launches per step, shared-memory tiling of the
// stencils, and the one-block source and receiver kernels.

#include "acoustic2d_kernels.cuh"

namespace {

template <int R>
int forward_loop(const float* c2, const float* az, const float* bz, const float* ax,
                 const float* bx, const float* w, const long long* src,
                 const long long* rcv, float* seis, __nv_bfloat16* snap, const int* ring,
                 float* ring_tape, int n_ring, float* ws, int NZ, int NX, int S, int nt,
                 int nsrc, int nrec, int fs, const Taps& tp, cudaStream_t st) {
  const size_t plane = (size_t)(NZ + 2 * R) * (NX + 2 * R);
  float* pa = ws;          // P_t for even t
  float* pb = ws + plane;  // P_t for odd t
  float* cur = pb;         // P_{t-1}
  float* prev = pa;        // P_{t-2}, overwritten by P_t
  for (int t = 0; t < nt; ++t) {
    forward_step<R>(c2, az, bz, ax, bx, w, t, src, rcv, seis,
                    snap ? snap + (size_t)t * NZ * NX : nullptr, ring,
                    ring_tape ? ring_tape + (size_t)t * n_ring : nullptr, n_ring, cur, prev,
                    ws + 2 * plane, ws + 3 * plane, ws + 4 * plane, ws + 5 * plane, NZ, NX, S,
                    nsrc, nrec, fs, tp, st);
    if (t == 0) {
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    float* tmp = cur;
    cur = prev;
    prev = tmp;
  }
  return (int)cudaGetLastError();
}

template <int R>
int reverse_snap_loop(const float* c2, const float* az, const float* bz, const float* ax,
                      const float* bx, const float* ybar, const __nv_bfloat16* snap,
                      const long long* src, const long long* rcv, float* gacc, float* lam_src,
                      float* ws, int* chain, int NZ, int NX, int S, int nt, int nsrc, int nrec,
                      int fs, const Taps& tp, cudaStream_t st) {
  const size_t plane = (size_t)(NZ + 2 * R) * (NX + 2 * R);
  rev_chain<<<blocks_for(nrec), kSmallBlock, 0, st>>>(rcv, nrec, chain);
  float* qc = ws;          // lambda_t
  float* qo = ws + plane;  // lambda_{t+1}, overwritten by lambda_{t-1}
  for (int t = nt - 1; t >= 0; --t) {
    reverse_step<R, __nv_bfloat16>(c2, az, bz, ax, bx, ybar, t, snap + (size_t)t * NZ * NX,
                                   nullptr, nullptr, src, rcv, chain, gacc, lam_src, qc, qo,
                                   ws + 2 * plane, plane, NZ, NX, S, nsrc, nrec, fs, tp, st);
    if (t == nt - 1) {
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    float* tmp = qc;
    qc = qo;
    qo = tmp;
  }
  return (int)cudaGetLastError();
}

template <int R>
int reverse_rings_loop(const float* c2, const float* az, const float* bz, const float* ax,
                       const float* bx, const float* w, const float* ybar,
                       const float* ring_tape, const int* ring, int n_ring,
                       const long long* src, const long long* rcv, float* gacc, float* lam_src,
                       float* ws, int* chain, int NZ, int NX, int S, int nt, int nsrc, int nrec,
                       int fs, RingFrame frame, const Taps& tp, cudaStream_t st) {
  const size_t plane = (size_t)(NZ + 2 * R) * (NX + 2 * R);
  rev_chain<<<blocks_for(nrec), kSmallBlock, 0, st>>>(rcv, nrec, chain);
  float* p_tp1 = ws;          // P_t, overwritten by P_{t-2}
  float* p_t = ws + plane;    // P_{t-1}
  float* qc = ws + 2 * plane;
  float* qo = ws + 3 * plane;
  for (int t = nt - 1; t >= 0; --t) {
    reverse_step<R, float>(c2, az, bz, ax, bx, ybar, t, nullptr, p_t, p_tp1, src, rcv, chain,
                           gacc, lam_src, qc, qo, ws + 4 * plane, plane, NZ, NX, S, nsrc, nrec,
                           fs, tp, st);
    rec_src_ring<<<blocks_for(n_ring), kSmallBlock, 0, st>>>(
        p_tp1, c2, w, t, src, nsrc, ring, t >= 2 ? ring_tape + (size_t)(t - 2) * n_ring : nullptr,
        n_ring, NX, R, fs, frame);
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

}  // namespace

extern "C" {

// ws: 6 zeroed halo planes (pa, pb, phiz, psiz, phix, psix); snap, ring and
// ring_tape may be null (ring and ring_tape together).
int tpufwi_scanres_forward(const float* c2, const float* az, const float* bz,
                           const float* ax, const float* bx, const float* w,
                           const long long* src, const long long* rcv, float* seis,
                           void* snap, const int* ring, float* ring_tape, float* ws, int NZ,
                           int NX, int S, int R, int nt, int nsrc, int nrec, int fs, int n_ring,
                           const float* taps, void* stream) {
  const Taps tp = load_taps(taps);
  auto* sb = static_cast<__nv_bfloat16*>(snap);
  auto st = static_cast<cudaStream_t>(stream);
  TPUFWI_DISPATCH_R(R, forward_loop<kR>(c2, az, bz, ax, bx, w, src, rcv, seis, sb, ring,
                                        ring_tape, n_ring, ws, NZ, NX, S, nt, nsrc, nrec, fs,
                                        tp, st))
}

// ws: 11 zeroed halo planes; gacc (NZ, NX) zeroed; chain: 2 * nrec ints.
int tpufwi_scanres_reverse_snap(const float* c2, const float* az, const float* bz,
                                const float* ax, const float* bx, const float* ybar,
                                const void* snap, const long long* src, const long long* rcv,
                                float* gacc, float* lam_src, float* ws, int* chain, int NZ,
                                int NX, int S, int R, int nt, int nsrc, int nrec, int fs,
                                const float* taps, void* stream) {
  const Taps tp = load_taps(taps);
  auto* sb = static_cast<const __nv_bfloat16*>(snap);
  auto st = static_cast<cudaStream_t>(stream);
  TPUFWI_DISPATCH_R(R, reverse_snap_loop<kR>(c2, az, bz, ax, bx, ybar, sb, src, rcv, gacc,
                                             lam_src, ws, chain, NZ, NX, S, nt, nsrc, nrec, fs,
                                             tp, st))
}

// ws: 13 halo planes: P_{nt-1}, P_{nt-2} (set by the caller), then 11
// zeroed (lambda ping-pong and the 9 adjoint planes); gacc (NZ, NX) zeroed;
// chain: 2 * nrec ints; ring_tape (nt, n_ring) with row t = rings(P_t).
int tpufwi_scanres_reverse_rings(const float* c2, const float* az, const float* bz,
                                 const float* ax, const float* bx, const float* w,
                                 const float* ybar, const float* ring_tape, const int* ring,
                                 const long long* src, const long long* rcv, float* gacc,
                                 float* lam_src, float* ws, int* chain, int NZ, int NX, int S,
                                 int R, int nt, int nsrc, int nrec, int fs, int n_ring, int z0,
                                 int z1, int x0, int x1, int rw, const float* taps,
                                 void* stream) {
  const Taps tp = load_taps(taps);
  const RingFrame frame{z0, z1, x0, x1, rw};
  auto st = static_cast<cudaStream_t>(stream);
  TPUFWI_DISPATCH_R(R, reverse_rings_loop<kR>(c2, az, bz, ax, bx, w, ybar, ring_tape, ring,
                                              n_ring, src, rcv, gacc, lam_src, ws, chain, NZ,
                                              NX, S, nt, nsrc, nrec, fs, frame, tp, st))
}

const char* tpufwi_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
