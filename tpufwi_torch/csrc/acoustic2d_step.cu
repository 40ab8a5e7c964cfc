// Single-step 2D acoustic kernels for Hopper (sm_90a): one C call per time
// step, driven from a Python loop (tpufwi_torch/adjoint_step.py).
//
// Replaces the three TPU kernels of the single-step engine
// (tpufwi/adjoint_pallas.py):
//   fused_forward_step  <- tpufwi/kernels/acoustic2d_pallas.py::
//                          make_fused_forward_step (leapfrog, CPML strips,
//                          sources, optional ring slabs of the post-source
//                          field); the receivers are gathered here too
//   recon_step          <- tpufwi/kernels/acoustic2d_pallas_bwd.py::
//                          make_recon_kernel (reverse leapfrog, sources
//                          before the ring imposition, Lap(p_t))
//   fused_adjoint_step  <- acoustic2d_pallas_bwd.py::make_fused_adjoint_step
//                          (receiver injection, transposed CPML step,
//                          imaging gbar += lambda * lapw)
// Built into one library with acoustic2d_scanres.cu, whose kernels these
// entry points launch (acoustic2d_kernels.cuh): a step here is the same few
// ordered launches as a step of the whole-scan loops, so the two engines do
// the same arithmetic. The state is the caller's halo-laid tensors; nothing
// is allocated here.
//
// What bounds it: the host. Each kernel call is one ctypes call from
// Python; at 399x1749 a call took 0.05-0.07 ms of host time, as long as the
// card took for it (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py), so the
// single-step engine is slower than the whole-scan one by its per-step host
// calls.

#include "acoustic2d_kernels.cuh"

namespace {

template <int R>
int step_forward(const float* c2, const float* az, const float* bz, const float* ax,
                 const float* bx, const float* w, int t, const long long* src,
                 const long long* rcv, float* seis, const int* ring, float* ring_row, int n_ring,
                 const float* cur, float* prev, float* cpml, int NZ, int NX, int S, int nsrc,
                 int nrec, int fs, const Taps& tp, cudaStream_t st) {
  const size_t plane = (size_t)(NZ + 2 * R) * (NX + 2 * R);
  forward_step<R>(c2, az, bz, ax, bx, w, t, src, rcv, seis, nullptr, ring, ring_row, n_ring,
                  cur, prev, cpml, cpml + plane, cpml + 2 * plane, cpml + 3 * plane, NZ, NX, S,
                  nsrc, nrec, fs, tp, st);
  return (int)cudaGetLastError();
}

template <int R>
int step_recon(const float* c2, const float* w, int t, const long long* src, const int* ring,
               const float* ring_row, int n_ring, const float* p_t, float* p_tp1, float* lapw,
               int NZ, int NX, int nsrc, int fs, RingFrame frame, const Taps& tp,
               cudaStream_t st) {
  rec_cells<R><<<cell_grid(NZ, NX), kCellBlock, 0, st>>>(p_t, p_tp1, c2, lapw, NZ, NX, fs, tp);
  rec_src_ring<<<blocks_for(n_ring), kSmallBlock, 0, st>>>(p_tp1, c2, w, t, src, nsrc, ring,
                                                           ring_row, n_ring, NX, R, fs, frame);
  return (int)cudaGetLastError();
}

template <int R>
int step_adjoint(const float* c2, const float* az, const float* bz, const float* ax,
                 const float* bx, const float* ybar, int t, const float* lapw,
                 const long long* src, const long long* rcv, int* chain, int init_chain,
                 float* gacc, float* lam_src, float* q, float* qo, float* adj, int NZ, int NX,
                 int S, int nsrc, int nrec, int fs, const Taps& tp, cudaStream_t st) {
  const size_t plane = (size_t)(NZ + 2 * R) * (NX + 2 * R);
  if (init_chain) rev_chain<<<blocks_for(nrec), kSmallBlock, 0, st>>>(rcv, nrec, chain);
  reverse_step<R, float>(c2, az, bz, ax, bx, ybar, t, lapw, nullptr, nullptr, src, rcv, chain,
                         gacc, lam_src, q, qo, adj, plane, NZ, NX, S, nsrc, nrec, fs, tp, st);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// cur = P_{t-1}; prev = P_{t-2}, overwritten by P_t; cpml: 4 halo planes
// (phiz, psiz, phix, psix) updated in place; seis[t] <- P_t[rcv];
// ring_row (may be null) <- rings(P_t).
int tpufwi_step_forward(const float* c2, const float* az, const float* bz, const float* ax,
                        const float* bx, const float* w, const long long* src,
                        const long long* rcv, float* seis, const int* ring, float* ring_row,
                        const float* cur, float* prev, float* cpml, int t, int n_ring, int NZ,
                        int NX, int S, int R, int nsrc, int nrec, int fs, const float* taps,
                        void* stream) {
  const Taps tp = load_taps(taps);
  auto st = static_cast<cudaStream_t>(stream);
  TPUFWI_DISPATCH_R(R, step_forward<kR>(c2, az, bz, ax, bx, w, t, src, rcv, seis, ring,
                                        ring_row, n_ring, cur, prev, cpml, NZ, NX, S, nsrc, nrec,
                                        fs, tp, st))
}

// p_t = P_{t-1}; p_tp1 = P_t, overwritten by P_{t-2} with the ring imposed
// from ring_row (zeros when null); lapw (NZ, NX) <- D2 laplacian of p_t.
int tpufwi_step_recon(const float* c2, const float* w, const long long* src, const int* ring,
                      const float* ring_row, const float* p_t, float* p_tp1, float* lapw, int t,
                      int n_ring, int NZ, int NX, int R, int nsrc, int fs, int z0, int z1,
                      int x0, int x1, int rw, const float* taps, void* stream) {
  const Taps tp = load_taps(taps);
  const RingFrame frame{z0, z1, x0, x1, rw};
  auto st = static_cast<cudaStream_t>(stream);
  TPUFWI_DISPATCH_R(R, step_recon<kR>(c2, w, t, src, ring, ring_row, n_ring, p_t, p_tp1, lapw,
                                      NZ, NX, nsrc, fs, frame, tp, st))
}

// q = lambda_t before its receiver injection; qo = lambda_{t+1},
// overwritten by lambda_{t-1}; adj: 9 halo planes; gacc += lambda_t * lapw;
// lam_src[t] <- lambda_t at the sources; init_chain builds the receiver
// chain (2 * nrec ints) first, on the first reverse step.
int tpufwi_step_adjoint(const float* c2, const float* az, const float* bz, const float* ax,
                        const float* bx, const float* ybar, const float* lapw,
                        const long long* src, const long long* rcv, int* chain, float* gacc,
                        float* lam_src, float* q, float* qo, float* adj, int t, int init_chain,
                        int NZ, int NX, int S, int R, int nsrc, int nrec, int fs,
                        const float* taps, void* stream) {
  const Taps tp = load_taps(taps);
  auto st = static_cast<cudaStream_t>(stream);
  TPUFWI_DISPATCH_R(R, step_adjoint<kR>(c2, az, bz, ax, bx, ybar, t, lapw, src, rcv, chain,
                                        init_chain, gacc, lam_src, q, qo, adj, NZ, NX, S, nsrc,
                                        nrec, fs, tp, st))
}

}  // extern "C"
