// K-step 2D acoustic kernels for Hopper (sm_90a): k time steps per launch,
// one cooperative kernel running every phase of every step, with a grid
// barrier between the phases.
//
// Replaces three TPU kernels:
//   kstep_forward       <- tpufwi/kernels/acoustic2d_pallas_kstep.py::
//                          make_kstep_forward (K forward steps, ring slabs,
//                          receiver rows)
//   kstep_reverse       <- acoustic2d_pallas_kstep.py::make_kstep_reverse (K
//                          steps of reconstruction + transposed CPML step +
//                          imaging, Lap(p_t) kept on chip)
//   fused_reverse_step  <- tpufwi/kernels/acoustic2d_pallas_bwd.py::
//                          make_fused_reverse_step: the reverse kernel with
//                          k = 1 (tpufwi_step_reverse)
// Built into one library with acoustic2d_scanres.cu and acoustic2d_step.cu.
// A sub-step runs the header's per-cell functions (acoustic2d_kernels.cuh)
// in the order the ordinary kernels of a step launch them, so the K-step,
// single-step and whole-scan engines do the same arithmetic:
//   forward:  strips | cells | sources, then receivers (one block) | ring row
//   reverse:  receiver injection and lambda at the sources (one block) |
//             cells with the reconstruction fused | strips | cells, and the
//             reconstruction's sources and ring imposition
// where | is a grid barrier (cooperative_groups grid.sync). The in-place
// updates (P_t over P_{t-2}, P_{t-2} over P_t, lambda_{t-1} over
// lambda_{t+1}) read their own buffer only at the cell they write; every
// stencil read of a buffer written in the same step sits behind a barrier.
// Receivers are gathered and injected by index anywhere on the grid.
//
// The grid is as many blocks as are co-resident on the card (occupancy x
// SM count, no more than the work needs), each thread striding over the
// cells. A launch larger than the card can hold fails with
// cudaErrorCooperativeLaunchTooLarge, which the caller raises.

#include <cooperative_groups.h>

#include "acoustic2d_kernels.cuh"

namespace cg = cooperative_groups;

namespace {

// 256 threads a block, at least 4 blocks an SM (64 registers a thread)
constexpr int kCoopBlock = 256;
constexpr int kCoopMinBlocks = 4;

struct ForwardArgs {
  const float *c2, *az, *bz, *ax, *bx, *w;
  const long long *src, *rcv;
  float* seis;
  const int* ring;
  float* tape;  // (nt, n_ring) or null
  float *cur, *prev, *phiz, *psiz, *phix, *psix;
  int t0, k, n_ring, NZ, NX, S, nsrc, nrec, fs;
  Taps tp;
};

struct ReverseArgs {
  const float *c2, *az, *bz, *ax, *bx, *w, *ybar;
  const long long *src, *rcv;
  const int *chain, *ring;
  // step t imposes ring_rows[t - 2 - ring_lo] (zeros for t < 2 or null)
  const float* ring_rows;
  int ring_lo;
  float *p_t, *p_tp1, *q, *qo, *adj, *gacc, *lam_src;
  size_t plane;
  int t0, k, n_ring, NZ, NX, S, nsrc, nrec, fs;
  RingFrame frame;
  Taps tp;
};

// forward steps t0 .. t0 + k - 1: cur = P_{t0-1}, prev = P_{t0-2}; the two
// swap roles every step, as a caller of the single-step kernel swaps them
template <int R>
__global__ void __launch_bounds__(kCoopBlock, kCoopMinBlocks) kstep_forward(ForwardArgs a) {
  cg::grid_group grid = cg::this_grid();
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nth = gridDim.x * blockDim.x;
  const int n_strip = 2 * a.S * a.NX + 2 * a.NZ * a.S;
  const int n_cells = a.NZ * a.NX;
  float* cur = a.cur;
  float* prev = a.prev;
  for (int j = 0; j < a.k; ++j) {
    const int t = a.t0 + j;
    for (int idx = tid; idx < n_strip; idx += nth)
      fwd_strip_cell<R>(cur, a.phiz, a.phix, a.az, a.bz, a.ax, a.bx, idx, a.NZ, a.NX, a.S, a.tp);
    grid.sync();
    for (int c = tid; c < n_cells; c += nth) {
      const int z = c / a.NX;
      fwd_cell<R>(cur, prev, a.phiz, a.psiz, a.phix, a.psix, a.c2, a.az, a.bz, a.ax, a.bx,
                  nullptr, z, c - z * a.NX, a.NZ, a.NX, a.S, a.fs, a.tp);
    }
    grid.sync();
    if (blockIdx.x == 0) {
      if (threadIdx.x == 0) fwd_sources(prev, a.c2, a.w, t, a.src, a.nsrc, a.NX, R, a.fs);
      __syncthreads();
      for (int r = threadIdx.x; r < a.nrec; r += blockDim.x)
        fwd_receiver(prev, t, a.rcv, a.seis, r, a.nrec, a.NX, R);
    }
    // the next step's strips read P_t after its sources; the ring row reads
    // it too and writes only the tape
    grid.sync();
    if (a.tape != nullptr)
      for (int q = tid; q < a.n_ring; q += nth)
        ring_cell(prev, a.ring, a.tape + (size_t)t * a.n_ring, q, a.NX, R);
    float* tmp = cur;
    cur = prev;
    prev = tmp;
  }
}

// reverse steps t0 + k - 1 down to t0: p_t = P_{t-1}, p_tp1 = P_t (becomes
// P_{t-2}), q = lambda_t before its injection, qo = lambda_{t+1} (becomes
// lambda_{t-1}); the pairs swap roles every step
template <int R>
__global__ void __launch_bounds__(kCoopBlock, kCoopMinBlocks) kstep_reverse(ReverseArgs a) {
  cg::grid_group grid = cg::this_grid();
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nth = gridDim.x * blockDim.x;
  const int n_strip = 2 * a.S * a.NX + 2 * a.NZ * a.S;
  const int n_cells = a.NZ * a.NX;
  float* u = a.adj;
  float* psbz = a.adj + a.plane;
  float* wz = a.adj + 2 * a.plane;
  float* pbz = a.adj + 3 * a.plane;
  float* yz = a.adj + 4 * a.plane;
  float* psbx = a.adj + 5 * a.plane;
  float* wx = a.adj + 6 * a.plane;
  float* pbx = a.adj + 7 * a.plane;
  float* yx = a.adj + 8 * a.plane;
  float* p_t = a.p_t;
  float* p_tp1 = a.p_tp1;
  float* q = a.q;
  float* qo = a.qo;
  for (int j = a.k - 1; j >= 0; --j) {
    const int t = a.t0 + j;
    if (blockIdx.x == 0) {
      const float* yb = a.ybar + (size_t)t * a.nrec;
      for (int r = threadIdx.x; r < a.nrec; r += blockDim.x)
        inject_receiver(q, yb, a.rcv, a.chain, r, a.nrec, a.NX, R);
      __syncthreads();
      for (int s = threadIdx.x; s < a.nsrc; s += blockDim.x)
        lambda_at_source(q, t, a.src, a.lam_src, s, a.nsrc, a.NX, R, a.fs);
    }
    grid.sync();
    for (int c = tid; c < n_cells; c += nth) {
      const int z = c / a.NX;
      rev_cell1_rings<R>(q, u, a.c2, p_t, p_tp1, a.gacc, psbz, wz, psbx, wx, a.az, a.bz, a.ax,
                         a.bx, z, c - z * a.NX, a.NZ, a.NX, a.S, a.fs, a.tp);
    }
    grid.sync();
    for (int idx = tid; idx < n_strip; idx += nth)
      rev_strip_cell<R>(u, wz, wx, pbz, yz, pbx, yx, a.az, a.bz, a.ax, a.bx, idx, a.NZ, a.NX,
                        a.S, a.tp);
    grid.sync();
    for (int c = tid; c < n_cells; c += nth) {
      const int z = c / a.NX;
      rev_cell2<R>(q, qo, u, wz, yz, wx, yx, z, c - z * a.NX, a.NZ, a.NX, a.S, a.tp);
    }
    // P_{t-2}: no phase of this step reads p_tp1 after the cells above
    const float* row = (t >= 2 && a.ring_rows != nullptr)
                           ? a.ring_rows + (size_t)(t - 2 - a.ring_lo) * a.n_ring
                           : nullptr;
    if (tid == 0) rec_sources(p_tp1, a.c2, a.w, t, a.src, a.nsrc, a.NX, R, a.fs, a.frame);
    for (int r = tid; r < a.n_ring; r += nth) ring_impose(p_tp1, a.ring, row, r, a.NX, R);
    float* tmp = p_t;
    p_t = p_tp1;
    p_tp1 = tmp;
    tmp = q;
    q = qo;
    qo = tmp;
    if (j > 0) grid.sync();
  }
}

// Co-resident blocks of a cooperative kernel on the current device (once
// per kernel and device), no more than the work needs
template <typename Kernel>
int coop_blocks(Kernel kernel, int work, int* cache) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 16) return 0;
  if (cache[dev] == 0) {
    int per_sm = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kCoopBlock, 0);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cache[dev] = per_sm * sms;
  }
  const int needed = (work + kCoopBlock - 1) / kCoopBlock;
  return needed < cache[dev] ? needed : cache[dev];
}

// the launch's own error, else one left by an earlier launch of the call;
// either way the error is cleared for the next call
int launched(cudaError_t err) {
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

template <int R>
int launch_forward(const ForwardArgs& a, cudaStream_t st) {
  static int cache[16] = {0};
  const int work = a.NZ * a.NX + 2 * a.S * (a.NX + a.NZ);
  const int blocks = coop_blocks(kstep_forward<R>, work, cache);
  void* args[] = {const_cast<ForwardArgs*>(&a)};
  return launched(cudaLaunchCooperativeKernel((const void*)kstep_forward<R>, blocks, kCoopBlock,
                                              args, 0, st));
}

template <int R>
int launch_reverse(const ReverseArgs& a, int init_chain, cudaStream_t st) {
  static int cache[16] = {0};
  if (init_chain) rev_chain<<<blocks_for(a.nrec), kSmallBlock, 0, st>>>(a.rcv, a.nrec,
                                                                        const_cast<int*>(a.chain));
  const int work = a.NZ * a.NX + 2 * a.S * (a.NX + a.NZ);
  const int blocks = coop_blocks(kstep_reverse<R>, work, cache);
  void* args[] = {const_cast<ReverseArgs*>(&a)};
  return launched(cudaLaunchCooperativeKernel((const void*)kstep_reverse<R>, blocks, kCoopBlock,
                                              args, 0, st));
}

ReverseArgs reverse_args(const float* c2, const float* az, const float* bz, const float* ax,
                         const float* bx, const float* w, const float* ybar, const long long* src,
                         const long long* rcv, const int* chain, const int* ring,
                         const float* ring_rows, int ring_lo, float* p_t, float* p_tp1, float* q,
                         float* qo, float* adj, float* gacc, float* lam_src, int t0, int k,
                         int n_ring, int NZ, int NX, int S, int R, int nsrc, int nrec, int fs,
                         RingFrame frame, const float* taps) {
  return ReverseArgs{c2, az, bz, ax, bx, w, ybar, src, rcv, chain, ring, ring_rows, ring_lo,
                     p_t, p_tp1, q, qo, adj, gacc, lam_src,
                     (size_t)(NZ + 2 * R) * (NX + 2 * R), t0, k, n_ring, NZ, NX, S, nsrc, nrec,
                     fs, frame, load_taps(taps)};
}

}  // namespace

extern "C" {

// k forward steps from t0 in place: as k calls of tpufwi_step_forward, each
// followed by the caller's swap of cur and prev; cpml: 4 halo planes; seis
// (nt, nrec) rows t0 .. t0 + k - 1; tape (nt, n_ring) the same rows, or null.
int tpufwi_kstep_forward(const float* c2, const float* az, const float* bz, const float* ax,
                         const float* bx, const float* w, const long long* src,
                         const long long* rcv, float* seis, const int* ring, float* tape,
                         float* cur, float* prev, float* cpml, int t0, int k, int n_ring, int NZ,
                         int NX, int S, int R, int nsrc, int nrec, int fs, const float* taps,
                         void* stream) {
  const size_t plane = (size_t)(NZ + 2 * R) * (NX + 2 * R);
  const ForwardArgs a{c2, az, bz, ax, bx, w, src, rcv, seis, ring, tape, cur, prev, cpml,
                      cpml + plane, cpml + 2 * plane, cpml + 3 * plane, t0, k, n_ring, NZ, NX, S,
                      nsrc, nrec, fs, load_taps(taps)};
  auto st = static_cast<cudaStream_t>(stream);
  TPUFWI_DISPATCH_R(R, launch_forward<kR>(a, st))
}

// k reverse steps t0 + k - 1 down to t0 in place: as k steps of the rings
// reverse, each followed by the caller's swaps of (p_t, p_tp1) and (q, qo);
// adj: 9 halo planes; gacc += lambda_t Lap(P_{t-1}); lam_src (nt, nsrc) rows
// t0 .. t0 + k - 1; tape (nt, n_ring), row t - 2 imposed at step t (zeros
// when t < 2 or tape is null); init_chain builds the receiver chain first.
int tpufwi_kstep_reverse(const float* c2, const float* az, const float* bz, const float* ax,
                         const float* bx, const float* w, const float* ybar,
                         const long long* src, const long long* rcv, int* chain,
                         const int* ring, const float* tape, float* p_t, float* p_tp1, float* q,
                         float* qo, float* adj, float* gacc, float* lam_src, int t0, int k,
                         int init_chain, int n_ring, int NZ, int NX, int S, int R, int nsrc,
                         int nrec, int fs, int z0, int z1, int x0, int x1, int rw,
                         const float* taps, void* stream) {
  const ReverseArgs a = reverse_args(c2, az, bz, ax, bx, w, ybar, src, rcv, chain, ring, tape, 0,
                                     p_t, p_tp1, q, qo, adj, gacc, lam_src, t0, k, n_ring, NZ, NX,
                                     S, R, nsrc, nrec, fs, RingFrame{z0, z1, x0, x1, rw}, taps);
  auto st = static_cast<cudaStream_t>(stream);
  TPUFWI_DISPATCH_R(R, launch_reverse<kR>(a, init_chain, st))
}

// One reverse step t (the reverse kernel with k = 1): tpufwi_step_recon and
// tpufwi_step_adjoint in one call, Lap(P_{t-1}) never leaving the kernel;
// ring_row is tape row t - 2 (null: zeros).
int tpufwi_step_reverse(const float* c2, const float* az, const float* bz, const float* ax,
                        const float* bx, const float* w, const float* ybar, const long long* src,
                        const long long* rcv, int* chain, const int* ring, const float* ring_row,
                        float* p_t, float* p_tp1, float* q, float* qo, float* adj, float* gacc,
                        float* lam_src, int t, int init_chain, int n_ring, int NZ, int NX, int S,
                        int R, int nsrc, int nrec, int fs, int z0, int z1, int x0, int x1,
                        int rw, const float* taps, void* stream) {
  const ReverseArgs a = reverse_args(c2, az, bz, ax, bx, w, ybar, src, rcv, chain, ring, ring_row,
                                     t - 2, p_t, p_tp1, q, qo, adj, gacc, lam_src, t, 1, n_ring,
                                     NZ, NX, S, R, nsrc, nrec, fs,
                                     RingFrame{z0, z1, x0, x1, rw}, taps);
  auto st = static_cast<cudaStream_t>(stream);
  TPUFWI_DISPATCH_R(R, launch_reverse<kR>(a, init_chain, st))
}

}  // extern "C"
