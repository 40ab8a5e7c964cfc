// Whole-scan 2D acoustic engine for Hopper (sm_90a): the forward time loop
// with a bf16 snapshot tape or an fp32 boundary-ring tape, the snapshot
// reverse and the rings reverse.
//
// Replaces three TPU kernels of tpufwi/kernels/acoustic2d_pallas_scanres.py:
//   scanres_forward       <- make_scanres_forward (snap_tape=True, with_tape
//                            (rings) or no tape); its optional illumination
//                            (sum_t P_t^2) is what the reference's
//                            AcousticPropagator.illumination computes in XLA
//   scanres_reverse_snap  <- make_scanres_reverse_snap
//   scanres_reverse       <- make_scanres_reverse (reconstruction + exact
//                            transposed CPML step + imaging)
// Plain C interface, built by nvcc into a shared library together with
// acoustic2d_step.cu and acoustic2d_kstep.cu and called through ctypes
// (tpufwi_torch/kernels/acoustic2d_scanres.py). The per-cell arithmetic is
// in acoustic2d_kernels.cuh.
//
// Design. On the TPU the whole loop is one pallas_call with the state in
// VMEM. Here the state lives in device memory (a 399x1749 fp32 field is
// 2.8 MB; the working set of one step fits the 50 MB L2) and a host loop in
// this file launches each time step on the caller's stream, so the Python
// side makes one call per propagation. At that size a step is paced by
// launches and latency, not by bytes, so the forward and both reverses run
// one shared-memory tiled kernel a step (fwd_fused, rev_fused below), each
// a programmatic dependent of the one before it (dependent launch off:
// plain stream order), after one small launch a call (scan_setup: the cell
// maps of the sources, receivers and ring cells; in the reverse also
// lambda_{nt-1}). Their oracle on the card is the single-step engine
// (acoustic2d_step.cu), which runs the header's passes a launch at a time
// (forward_step, reverse_step; the rings reverse's is the merged step of
// acoustic2d_kstep.cu): the same per-cell arithmetic, so bitwise equal.
//
// The fused forward step. A block of TX x ROWS threads owns a TZ x TX tile
// of cells, TZ / ROWS rows a thread (TPUFWI_SCAN_TILE: 16 x 32 cells, 256
// threads, at least 6 blocks an SM). It copies P_{t-1} over the tile and
// its cross into shared memory (R along each axis, 2R along an axis whose
// CPML band the tile touches: phi' is needed R cells past its own cell and
// is computed from D1 P R cells further), phi over the reach, and the own
// cells' P_{t-2}, C, psi and illumination; computes phi' over the reach
// (the owner writes its own); then every cell of the tile: the D2
// laplacian (the snapshot row), D1 phi', psi', the leapfrog over P_{t-2}
// in place, the surface pin, its sources in index order, its receivers,
// its ring-tape entry and illum += P_t^2. A reach reads phi at cells whose
// own tile rewrites them in the same launch, so phi_z and phi_x ping-pong
// between two sets of planes (the workspace grows from 6 to 8 planes);
// psi is read only at its own cell and updated in place.
//
// The fused snapshot-reverse step. The receiver-cotangent injection and
// the surface pin of lambda_t move to the thread that writes lambda_t, in
// the step before (and to scan_setup for lambda_{nt-1}); it also writes
// lambda at the sources. So a tile reads an injected, pinned lambda_t over
// its cross, computes u = C lambda and the w planes over the tile and 2R,
// the y planes over the tile and R (the strips only), and writes
// lambda_{t-1}, gacc, psibar and phibar for its own cells; psibar and
// phibar ping-pong. No u, w or y plane reaches device memory.
//
// Loads. Every copy of a step is a 4-byte cp.async (zero-filled off the
// grid and off the strips) issued before the tile's first barrier, so a
// thread stages nothing in registers but the reverse's C of its cross
// cells; a thread computes u and w over its own copies right after its
// cp.async wait, before the barrier. Only a tile that holds a source,
// receiver or ring cell (a flag word a tile) reads the cell maps, after
// the barrier. The block rows of the CPML band's tiles, which reach 2R and
// take a second barrier, are dispatched first (tile_row). The per-cell
// arithmetic is the header's tails, in the single-step passes' tap order.
//
// The fused rings-reverse step is rev_fused in its rings form: the image
// is the fp32 D2 laplacian of P_{t-1}, copied over the tile's R cross (no
// tile writes P_{t-1} in the step), and the owner rewrites its P_t in place
// with P_{t-2} = 2 P_{t-1} - P_t + C lap, pins the surface, undoes its
// sources outside the ring and off the surface in index order, and imposes
// ring row t-2 (zeros for t < 2), as rev_cell1_rings and rec_sources do.
//
// Tapes. Snapshot row t is bf16(D2 laplacian of P_{t-1}), the field step t
// starts from (2 bytes per cell per step, 6.8 GB at 399x1749x4842). Ring
// row t is rings(P_t) after the sources, fp32 (16,352 cells = 64 KB per
// step at that grid, 0.32 GB for the shot); the rings reverse re-imposes
// row t-2 while it reconstructs P_{t-2} (zeros for t < 2), so the tape is
// written unshifted, where the TPU kernel shifts it in VMEM.
//
// What bounds it: latency and launches at the main grid (the field sits in
// L2); only the tape must reach HBM (2 bytes a cell a step). On an NVIDIA
// H100 80GB HBM3 at 700 W, 399 x 1749, order 8 (chip_smoke.py): a forward
// step took 9.1 us of device time against 11.7 for the same passes in 3
// launches, a reverse step 12.4 against 20.9 in 4 (the rings form 14.7
// against 23.3 in 5), and the host enqueues a step in 2-4 us, under the
// device time. The passes' tile and shared bytes are the plan that
// kernels/acoustic2d_scanres.py::scanres_tile_plan states.

#include <cuda_bf16.h>

#include "acoustic2d_kernels.cuh"
#include "cell_maps.cuh"  // SMaps, carve_maps, cell_map_entry

namespace {

// ------------------------------------------------------------------ passes

// the tile the loops run: TZ x TX cells, a block of TX x ROWS threads, at
// least MINB blocks an SM (the register cap)
#ifndef TPUFWI_SCAN_TILE
#define TPUFWI_SCAN_TILE 16, 32, 8, 6
#endif

template <int R, int TZ, int TX, int ROWS, int MINB>
struct STile {
  static constexpr int P = TZ / ROWS;  // own rows a thread: ty + j ROWS
  static constexpr int NT = TX * ROWS;
  static constexpr int H = 2 * R;                      // the widest reach
  static constexpr int W = TX + 2 * H;                 // rect and x-row stride
  static constexpr int RECT = (TZ + 2 * H) * W;        // the tile and its 2R cross
  static constexpr int ZCOL = (TZ + 2 * H) * TX;       // its columns, 2R above and below
  static constexpr int XROW = TZ * W;                  // its rows, 2R left and right
  static constexpr int ZCOL1 = (TZ + 2 * R) * TX;      // its columns, R above and below
  static constexpr int W1 = TX + 2 * R;
  static constexpr int XROW1 = TZ * W1;                // its rows, R left and right
  static constexpr int OWN = TZ * TX;                  // the tile
  static constexpr int MA = (2 * H + ROWS - 1) / ROWS;        // z-arm rows a thread
  static constexpr int MX = (TZ * 2 * H + NT - 1) / NT;       // x-arm cells a thread
  static constexpr int MZ = (TZ + 2 * R + ROWS - 1) / ROWS;   // ZCOL1 rows a thread
  static constexpr int M1 = (XROW1 + NT - 1) / NT;            // XROW1 cells a thread
  // shared bytes: fwd_fused P_{t-1}, phi_z', phi_x' and the own cells'
  // P_{t-2}, C, psi_z, psi_x, illum; rev_fused u, w_z, w_x, y_z, y_x and
  // the own cells' lambda_{t+1}, gacc; its rings form also P_{t-1} over the
  // tile and its R cross (in a RECT plane) and the own cells' P_t
  static constexpr int FWD = 4 * (RECT + ZCOL1 + XROW1 + 5 * OWN);
  static constexpr int REV = 4 * (RECT + ZCOL + XROW + ZCOL1 + XROW1 + 2 * OWN);
  static constexpr int REV_RINGS = REV + 4 * (RECT + OWN);
  static constexpr int MAX = FWD > REV_RINGS ? FWD : REV_RINGS;
  static_assert(TZ % ROWS == 0 && NT <= 1024 && TX >= 2 * R, "tile");
};

// the fused passes' launch plan, as the caller states it (the wrapper's
// scanres_tile_plan): the tile and the larger pass's shared bytes
struct SPlan {
  int tz, tx, smem;
};

// The maps (cell_maps.cuh), one thread per source, receiver and ring cell
// (in that order). With yb (ybar row nt-1, the reverses) it also writes
// lambda_{nt-1} into q: each cell's receiver cotangents summed in index
// order and added to zero, 0 on the pinned surface row; and lambda at the
// sources into lam_row, as rev_inject does.
__global__ void scan_setup(const long long* __restrict__ src, int nsrc,
                           const long long* __restrict__ rcv, int nrec,
                           const int* __restrict__ ring, int n_ring, int NX, int R, int tz, int tx,
                           int ntx, SMaps m, const float* __restrict__ yb, float* __restrict__ q,
                           float* __restrict__ lam_row, int fs) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  cell_map_entry(k, src, nsrc, rcv, nrec, ring, n_ring, NX, tz, tx, ntx, 0, m);
  if (yb == nullptr) return;
  if (k < nsrc) {
    const int z = (int)src[2 * k], x = (int)src[2 * k + 1];
    float v = 0.f;
    if (z != fs) {
      int first = -1;
      float s = 0.f;
      for (int r = 0; r < nrec; ++r)
        if (rcv[2 * r] == z && rcv[2 * r + 1] == x) {
          s = first < 0 ? yb[r] : s + yb[r];
          if (first < 0) first = r;
        }
      if (first >= 0) v = 0.f + s;
    }
    lam_row[k] = v;
  } else if (k < nsrc + nrec) {
    const int r = k - nsrc;
    int next;
    if (!chain_at(rcv, nrec, r, next)) return;
    const int z = (int)rcv[2 * r], x = (int)rcv[2 * r + 1];
    float s = yb[r];
    for (int j = next; j >= 0;) {
      s += yb[j];
      int n2 = -1;
      for (int l = j + 1; l < nrec && n2 < 0; ++l)
        if (same_cell(rcv, l, r)) n2 = l;
      j = n2;
    }
    q[(z + R) * (NX + 2 * R) + x + R] = (z == fs) ? 0.f : 0.f + s;
  }
}

// The tile row of block row by of n: the top two and bottom two rows
// first (0, n-1, 1, n-2), then the rest in order. Those rows hold the
// z band's heavier tiles, which so start first and leave the light ones
// for the tail.
__device__ __forceinline__ int tile_row(int by, int n) {
  if (n < 4) return by;
  if (by < 4) return (by & 1) ? n - 1 - (by >> 1) : (by >> 1);
  return by - 2;
}

// A tile's geometry: its origin (block row by tile_row), its extent
// clipped to the grid, whether it holds a cell of the CPML band along z
// and along x (within S + R of an edge, where D1 phi' or the y planes
// enter; there the cross reaches 2R, elsewhere R), and this thread's place
// in it.
template <int R, int TZ, int TX>
struct STileAt {
  int z0, x0, z1, x1, hz, hx, tx, ty, x, tile;
  bool bandz, bandx;
  __device__ STileAt(int NZ, int NX, int S) {
    const int row = tile_row(blockIdx.y, gridDim.y);
    tile = row * gridDim.x + blockIdx.x;
    z0 = row * TZ;
    x0 = blockIdx.x * TX;
    z1 = min(z0 + TZ, NZ);
    x1 = min(x0 + TX, NX);
    const int SE = S + R;
    bandz = z0 < SE || z1 > NZ - SE;
    bandx = x0 < SE || x1 > NX - SE;
    hz = bandz ? 2 * R : R;
    hx = bandx ? 2 * R : R;
    tx = threadIdx.x;
    ty = threadIdx.y;
    x = x0 + tx;
  }
  // z-arm row k of [0, 2 hz): hz rows above the tile, then hz below
  __device__ int arm_z(int k) const { return k < hz ? z0 - hz + k : z0 + TZ + k - hz; }
  // x-arm cell k of [0, TZ 2 hx): its row and column
  __device__ void arm_x(int k, int& z, int& xr) const {
    const int oz = bandx ? k / (4 * R) : k / (2 * R);
    const int e = k - oz * 2 * hx;
    z = z0 + oz;
    xr = e < hx ? x0 - hx + e : x0 + TX + e - hx;
  }
};

struct FwdArgs {
  const float *c2, *az, *bz, *ax, *bx, *w;
  float *seis, *psiz, *psix, *illum;
  SMaps m;
  int NZ, NX, S, fs, nrec;
  Taps tp;
};

// One forward step t: cur = P_{t-1}; prev = P_{t-2}, overwritten by P_t;
// phi read from (phiz_in, phix_in), the owner's phi' written to (phiz_out,
// phix_out); the optional snapshot row t and ring row t.
template <int R, int TZ, int TX, int ROWS, int MINB>
__global__ void __launch_bounds__(TX * ROWS, MINB)
    fwd_fused(FwdArgs a, int t, const float* __restrict__ cur, float* __restrict__ prev,
              const float* __restrict__ phiz_in, const float* __restrict__ phix_in,
              float* __restrict__ phiz_out, float* __restrict__ phix_out,
              __nv_bfloat16* __restrict__ snap_row, float* __restrict__ ring_row) {
  dep_wait();
  dep_trigger();
  using T = STile<R, TZ, TX, ROWS, MINB>;
  constexpr int P = T::P, H = T::H, W = T::W, W1 = T::W1;
  extern __shared__ float sm[];
  float* sp = sm;                   // P_{t-1}, RECT
  float* sphz = sp + T::RECT;       // phi_z, then phi_z', ZCOL1
  float* sphx = sphz + T::ZCOL1;    // phi_x, then phi_x', XROW1
  float* own = sphx + T::XROW1;     // P_{t-2}, C, psi_z, psi_x, illum: OWN each
  const int NZ = a.NZ, NX = a.NX, S = a.S, SE = S + R, ld = NX + 2 * R;
  const STileAt<R, TZ, TX> g(NZ, NX, S);
  const int tid = g.ty * TX + g.tx, x = g.x;
  const bool xin = x < NX;

  // every copy of the step, before the one barrier: P_{t-1} over the tile
  // and its cross, phi over the reach (0 off the strips), the own cells'
  // operands
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int oz = g.ty + j * ROWS, z = g.z0 + oz;
    const bool in = z < NZ && xin;
    const int i = (z + R) * ld + x + R, c = z * NX + x, o = oz * TX + g.tx;
    cp_async4(sp + (oz + H) * W + g.tx + H, cur + i, in);
    cp_async4(own + o, prev + i, in);
    cp_async4(own + T::OWN + o, a.c2 + c, in);
    if (g.bandz) cp_async4(own + 2 * T::OWN + o, a.psiz + i, in && strip_index(z, NZ, S) >= 0);
    if (g.bandx) cp_async4(own + 3 * T::OWN + o, a.psix + i, in && strip_index(x, NX, S) >= 0);
    if (a.illum != nullptr) cp_async4(own + 4 * T::OWN + o, a.illum + c, in);
  }
#pragma unroll
  for (int m = 0; m < T::MA; ++m) {
    const int k = g.ty + m * ROWS;
    if (k < 2 * g.hz) {
      const int z = g.arm_z(k);
      cp_async4(sp + (z - g.z0 + H) * W + g.tx + H, cur + (z + R) * ld + x + R,
                z >= 0 && z < NZ && xin);
    }
  }
#pragma unroll
  for (int m = 0; m < T::MX; ++m) {
    const int k = tid + m * T::NT;
    if (k < TZ * 2 * g.hx) {
      int z, xr;
      g.arm_x(k, z, xr);
      cp_async4(sp + (z - g.z0 + H) * W + xr - g.x0 + H, cur + (z + R) * ld + xr + R,
                z < NZ && xr >= 0 && xr < NX);
    }
  }
  if (g.bandz) {
#pragma unroll
    for (int m = 0; m < T::MZ; ++m) {
      const int r1 = g.ty + m * ROWS, z = g.z0 - R + r1;
      if (r1 < TZ + 2 * R)
        cp_async4(sphz + r1 * TX + g.tx, phiz_in + (z + R) * ld + x + R,
                  z >= 0 && z < NZ && xin && strip_index(z, NZ, S) >= 0);
    }
  }
  if (g.bandx) {
#pragma unroll
    for (int m = 0; m < T::M1; ++m) {
      const int k = tid + m * T::NT;
      if (k < T::XROW1) {
        const int oz = k / W1, z = g.z0 + oz, xr = g.x0 - R + k - oz * W1;
        cp_async4(sphx + k, phix_in + (z + R) * ld + xr + R,
                  z < NZ && xr >= 0 && xr < NX && strip_index(xr, NX, S) >= 0);
      }
    }
  }
  const float wt = a.w[t];
  cp_async_wait_all();
  __syncthreads();

  // phi' over the reach (F1), in place; the owner's cells to device memory
  if (g.bandz) {
#pragma unroll
    for (int m = 0; m < T::MZ; ++m) {
      const int r1 = g.ty + m * ROWS, z = g.z0 - R + r1;
      if (r1 >= TZ + 2 * R) continue;
      const int s = (z >= 0 && z < NZ && xin) ? strip_index(z, NZ, S) : -1;
      if (s < 0) continue;  // 0 off the strips, as copied
      const float v = phi_update(a.bz[s], sphz[r1 * TX + g.tx], a.az[s],
                                 tap_sum<R>(sp, (z - g.z0 + H) * W + g.tx + H, W, a.tp.d1z));
      sphz[r1 * TX + g.tx] = v;
      if (z >= g.z0 && z < g.z1) phiz_out[(z + R) * ld + x + R] = v;
    }
  }
  if (g.bandx) {
#pragma unroll
    for (int m = 0; m < T::M1; ++m) {
      const int k = tid + m * T::NT;
      if (k >= T::XROW1) continue;
      const int oz = k / W1, z = g.z0 + oz, rx = k - oz * W1, xr = g.x0 - R + rx;
      const int s = (z < NZ && xr >= 0 && xr < NX) ? strip_index(xr, NX, S) : -1;
      if (s < 0) continue;
      const float v = phi_update(a.bx[s], sphx[k], a.ax[s],
                                 tap_sum<R>(sp, (oz + H) * W + rx + R, 1, a.tp.d1x));
      sphx[k] = v;
      if (xr >= g.x0 && xr < g.x1) phix_out[(z + R) * ld + xr + R] = v;
    }
  }
  if (g.bandz || g.bandx) __syncthreads();

  // the own cells (F2-F5); the maps only in a tile that holds a source,
  // receiver or ring cell
  const int fl = a.m.flags[g.tile];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int oz = g.ty + j * ROWS, z = g.z0 + oz;
    if (z >= NZ || !xin) continue;
    const int i = (z + R) * ld + x + R, c = z * NX + x, rs = (oz + H) * W + g.tx + H;
    const int o = oz * TX + g.tx;
    const float d2z = tap_sum<R>(sp, rs, W, a.tp.d2z), d2x = tap_sum<R>(sp, rs, 1, a.tp.d2x);
    const float lap = d2z + d2x;
    if (snap_row != nullptr) snap_row[c] = __float2bfloat16(lap);
    float acc = lap;
    if (z < SE || z >= NZ - SE) {
      const float corr = tap_sum<R>(sphz, (oz + R) * TX + g.tx, TX, a.tp.d1z);
      acc += corr;
      const int s = strip_index(z, NZ, S);
      if (s >= 0) {
        const float ps = psi_update(a.bz[s], own[2 * T::OWN + o], a.az[s], d2z, corr);
        a.psiz[i] = ps;
        acc += ps;
      }
    }
    if (x < SE || x >= NX - SE) {
      const float corr = tap_sum<R>(sphx, oz * W1 + g.tx + R, 1, a.tp.d1x);
      acc += corr;
      const int s = strip_index(x, NX, S);
      if (s >= 0) {
        const float ps = psi_update(a.bx[s], own[3 * T::OWN + o], a.ax[s], d2x, corr);
        a.psix[i] = ps;
        acc += ps;
      }
    }
    const float c2v = own[T::OWN + o];
    float pn = leapfrog_update(sp[rs], own[o], c2v, acc);
    if (z == a.fs) {
      pn = 0.f;  // a source on the pinned row is overwritten by the pin
    } else if (fl & 1) {
      for (int k = a.m.smap[c] - 1; k >= 0; k = a.m.snext[k]) pn = add_source(pn, c2v, wt);
    }
    prev[i] = pn;
    if (fl & 2)
      for (int r = a.m.rmap[c] - 1; r >= 0; r = a.m.rnext[r])
        a.seis[(size_t)t * a.nrec + r] = pn;
    if (ring_row != nullptr && (fl & 4)) {
      const int k = a.m.gmap[c];
      if (k > 0) ring_row[k - 1] = pn;
    }
    if (a.illum != nullptr) a.illum[c] = fmaf(pn, pn, own[4 * T::OWN + o]);
  }
}

struct RevArgs {
  const float *c2, *az, *bz, *ax, *bx, *ybar;
  float *gacc, *lam_src;
  SMaps m;
  int NZ, NX, S, fs, nsrc, nrec;
  Taps tp;
  const float* w;  // the rings form: the wavelet and the frame its ring tiles
  RingFrame frame;
};

// one cell of rev_fused's cross, by the thread that copied it: u = C
// lambda in place over lambda (slot su), and where the cell's strip along
// z (wz) or x (wx) is taken, w in place over the copied psibar (psibar'
// to pz_out / px_out when not null: the owner's)
__device__ __forceinline__ void rev_cross_cell(float* su, float c2v, float* wz, int sz,
                                               float* wx, int sx, const float* az,
                                               const float* bz, const float* ax,
                                               const float* bx, float* pz_out, float* px_out) {
  const float uu = __fmul_rn(c2v, *su);
  *su = uu;
  if (sz >= 0) {
    float nb, w;
    adj_w(*wz, uu, az[sz], bz[sz], nb, w);
    *wz = w;
    if (pz_out != nullptr) *pz_out = nb;
  }
  if (sx >= 0) {
    float nb, w;
    adj_w(*wx, uu, ax[sx], bx[sx], nb, w);
    *wx = w;
    if (px_out != nullptr) *px_out = nb;
  }
}

// One reverse step t: qc = lambda_t (injected and pinned); qo =
// lambda_{t+1}, overwritten by lambda_{t-1} (injected with ybar row t-1 and
// pinned, for t >= 1); psibar and phibar read from the in set and the
// owner's written to the out set. The snapshot form (kRings false) images
// with img_row, the snapshot row t. The rings form images with the fp32 D2
// laplacian of pc = P_{t-1} (read over the tile's R cross) and rewrites pn
// = P_t in place with P_{t-2} = 2 P_{t-1} - P_t + C lap, the surface
// pinned, its sources undone outside the ring and off the surface, then
// ring_row (tape row t-2; zeros when null) imposed.
template <int R, int TZ, int TX, int ROWS, int MINB, bool kRings>
__global__ void __launch_bounds__(TX * ROWS, MINB)
    rev_fused(RevArgs a, int t, const float* __restrict__ qc, float* __restrict__ qo,
              const float* __restrict__ psbz_in, const float* __restrict__ pbz_in,
              const float* __restrict__ psbx_in, const float* __restrict__ pbx_in,
              float* __restrict__ psbz_out, float* __restrict__ pbz_out,
              float* __restrict__ psbx_out, float* __restrict__ pbx_out,
              const __nv_bfloat16* __restrict__ img_row, const float* __restrict__ pc,
              float* __restrict__ pn, const float* __restrict__ ring_row) {
  dep_wait();
  dep_trigger();
  using T = STile<R, TZ, TX, ROWS, MINB>;
  constexpr int P = T::P, H = T::H, W = T::W, W1 = T::W1;
  extern __shared__ float sm[];
  float* su = sm;                  // lambda_t, then u = C lambda_t: RECT
  float* swz = su + T::RECT;       // psibar_z, then w_z: ZCOL
  float* swx = swz + T::ZCOL;      // psibar_x, then w_x: XROW
  float* syz = swx + T::XROW;      // phibar_z, then y_z: ZCOL1
  float* syx = syz + T::ZCOL1;     // phibar_x, then y_x: XROW1
  float* own = syx + T::XROW1;     // lambda_{t+1}, gacc (and P_t): OWN each
  float* spc = own + 3 * T::OWN;   // the rings form's P_{t-1}: RECT, R cross filled
  const int NZ = a.NZ, NX = a.NX, S = a.S, SE = S + R, ld = NX + 2 * R;
  const STileAt<R, TZ, TX> g(NZ, NX, S);
  const int tid = g.ty * TX + g.tx, x = g.x;
  const bool xin = x < NX;
  // the tile column's x strip
  const int sxo = (g.bandx && xin) ? strip_index(x, NX, S) : -1;

  // every copy of the step, before the one barrier: lambda_t over the tile
  // and its cross, psibar where w is taken (the column's z strip cells, the
  // rows' x strip cells), phibar over the y entries (0 off the strips), the
  // own cells' operands; C of this thread's cross cells into registers
  float c2o[P], c2z[T::MA], c2x[T::MX], im[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int oz = g.ty + j * ROWS, z = g.z0 + oz;
    const bool in = z < NZ && xin;
    const int i = (z + R) * ld + x + R, c = z * NX + x, o = oz * TX + g.tx;
    const bool zs = in && g.bandz && strip_index(z, NZ, S) >= 0;
    cp_async4(su + (oz + H) * W + g.tx + H, qc + i, in);
    cp_async4(swz + (oz + H) * TX + g.tx, psbz_in + i, zs);
    cp_async4(swx + oz * W + g.tx + H, psbx_in + i, in && sxo >= 0);
    cp_async4(own + o, qo + i, in);
    cp_async4(own + T::OWN + o, a.gacc + c, in);
    c2o[j] = in ? a.c2[c] : 0.f;
    if (kRings) {
      cp_async4(spc + (oz + H) * W + g.tx + H, pc + i, in);
      cp_async4(own + 2 * T::OWN + o, pn + i, in);
    } else {
      im[j] = in ? __bfloat162float(img_row[c]) : 0.f;
    }
  }
#pragma unroll
  for (int m = 0; m < T::MA; ++m) {
    const int k = g.ty + m * ROWS;
    c2z[m] = 0.f;
    if (k < 2 * g.hz) {
      const int z = g.arm_z(k), rz = z - g.z0 + H;
      const bool in = z >= 0 && z < NZ && xin;
      cp_async4(su + rz * W + g.tx + H, qc + (z + R) * ld + x + R, in);
      cp_async4(swz + rz * TX + g.tx, psbz_in + (z + R) * ld + x + R,
                in && g.bandz && strip_index(z, NZ, S) >= 0);
      if (kRings && z >= g.z0 - R && z < g.z0 + TZ + R)
        cp_async4(spc + rz * W + g.tx + H, pc + (z + R) * ld + x + R, in);
      if (in) c2z[m] = a.c2[z * NX + x];
    }
  }
#pragma unroll
  for (int m = 0; m < T::MX; ++m) {
    const int k = tid + m * T::NT;
    c2x[m] = 0.f;
    if (k < TZ * 2 * g.hx) {
      int z, xr;
      g.arm_x(k, z, xr);
      const bool in = z < NZ && xr >= 0 && xr < NX;
      const int oz = z - g.z0, rx = xr - g.x0 + H;
      cp_async4(su + (oz + H) * W + rx, qc + (z + R) * ld + xr + R, in);
      cp_async4(swx + oz * W + rx, psbx_in + (z + R) * ld + xr + R,
                in && g.bandx && strip_index(xr, NX, S) >= 0);
      if (kRings && xr >= g.x0 - R && xr < g.x0 + TX + R)
        cp_async4(spc + (oz + H) * W + rx, pc + (z + R) * ld + xr + R, in);
      if (in) c2x[m] = a.c2[z * NX + xr];
    }
  }
  if (g.bandz) {
#pragma unroll
    for (int m = 0; m < T::MZ; ++m) {
      const int r1 = g.ty + m * ROWS, z = g.z0 - R + r1;
      if (r1 < TZ + 2 * R)
        cp_async4(syz + r1 * TX + g.tx, pbz_in + (z + R) * ld + x + R,
                  z >= 0 && z < NZ && xin && strip_index(z, NZ, S) >= 0);
    }
  }
  if (g.bandx) {
#pragma unroll
    for (int m = 0; m < T::M1; ++m) {
      const int k = tid + m * T::NT;
      if (k < T::XROW1) {
        const int oz = k / W1, z = g.z0 + oz, xr = g.x0 - R + k - oz * W1;
        cp_async4(syx + k, pbx_in + (z + R) * ld + xr + R,
                  z < NZ && xr >= 0 && xr < NX && strip_index(xr, NX, S) >= 0);
      }
    }
  }
  const float wt = kRings ? a.w[t] : 0.f;
  cp_async_wait_all();

  // u and the w planes (R1) over this thread's own copies, no barrier
  // needed; the owner keeps lambda_t and writes psibar'
  float lam[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int oz = g.ty + j * ROWS, z = g.z0 + oz;
    const int rs = (oz + H) * W + g.tx + H;
    lam[j] = su[rs];
    if (z >= NZ || !xin) continue;
    const int i = (z + R) * ld + x + R;
    rev_cross_cell(su + rs, c2o[j], swz + (oz + H) * TX + g.tx,
                   g.bandz ? strip_index(z, NZ, S) : -1,
                   swx + oz * W + g.tx + H, sxo, a.az, a.bz, a.ax, a.bx, psbz_out + i,
                   psbx_out + i);
  }
#pragma unroll
  for (int m = 0; m < T::MA; ++m) {
    const int k = g.ty + m * ROWS;
    if (k >= 2 * g.hz) continue;
    const int z = g.arm_z(k), rz = z - g.z0 + H;
    if (z < 0 || z >= NZ || !xin) continue;
    rev_cross_cell(su + rz * W + g.tx + H, c2z[m], swz + rz * TX + g.tx,
                   g.bandz ? strip_index(z, NZ, S) : -1, nullptr, -1, a.az, a.bz, a.ax, a.bx,
                   nullptr, nullptr);
  }
#pragma unroll
  for (int m = 0; m < T::MX; ++m) {
    const int k = tid + m * T::NT;
    if (k >= TZ * 2 * g.hx) continue;
    int z, xr;
    g.arm_x(k, z, xr);
    if (z >= NZ || xr < 0 || xr >= NX) continue;
    const int oz = z - g.z0, rx = xr - g.x0 + H;
    rev_cross_cell(su + (oz + H) * W + rx, c2x[m], nullptr, -1, swx + oz * W + rx,
                   g.bandx ? strip_index(xr, NX, S) : -1, a.az, a.bz, a.ax, a.bx, nullptr,
                   nullptr);
  }
  __syncthreads();

  // y over the tile and R (R2), in place over the copied phibar; the
  // owner's phibar' to the out set
  if (g.bandz) {
#pragma unroll
    for (int m = 0; m < T::MZ; ++m) {
      const int r1 = g.ty + m * ROWS, z = g.z0 - R + r1;
      if (r1 >= TZ + 2 * R) continue;
      const int s = (z >= 0 && z < NZ && xin) ? strip_index(z, NZ, S) : -1;
      if (s < 0) continue;
      const int rz = z - g.z0 + H;
      float nb, yv;
      adj_y(syz[r1 * TX + g.tx],
            tap_sum_uw<R>(su, rz * W + g.tx + H, W, swz, rz * TX + g.tx, TX, a.tp.d1z),
            a.az[s], a.bz[s], nb, yv);
      syz[r1 * TX + g.tx] = yv;
      if (z >= g.z0 && z < g.z1) pbz_out[(z + R) * ld + x + R] = nb;
    }
  }
  if (g.bandx) {
#pragma unroll
    for (int m = 0; m < T::M1; ++m) {
      const int k = tid + m * T::NT;
      if (k >= T::XROW1) continue;
      const int oz = k / W1, z = g.z0 + oz, rx1 = k - oz * W1, xr = g.x0 - R + rx1;
      const int s = (z < NZ && xr >= 0 && xr < NX) ? strip_index(xr, NX, S) : -1;
      if (s < 0) continue;
      const int rx = rx1 - R + H;
      float nb, yv;
      adj_y(syx[k], tap_sum_uw<R>(su, (oz + H) * W + rx, 1, swx, oz * W + rx, 1, a.tp.d1x),
            a.ax[s], a.bx[s], nb, yv);
      syx[k] = yv;
      if (xr >= g.x0 && xr < g.x1) pbx_out[(z + R) * ld + xr + R] = nb;
    }
  }
  if (g.bandz || g.bandx) __syncthreads();

  // the own cells (the rings form's reconstruction, then R3, imaging, then
  // R0 of step t-1 and its pin); the maps only in a tile that holds a
  // source, receiver or ring cell
  const int fl = (kRings || t >= 1) ? a.m.flags[g.tile] : 0;
  const float* yb = a.ybar + (size_t)(t >= 1 ? t - 1 : 0) * a.nrec;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int oz = g.ty + j * ROWS, z = g.z0 + oz;
    if (z >= NZ || !xin) continue;
    const int i = (z + R) * ld + x + R, c = z * NX + x, o = oz * TX + g.tx;
    if (kRings) {
      const int rs = (oz + H) * W + g.tx + H;
      im[j] = tap_sum<R>(spc, rs, W, a.tp.d2z) + tap_sum<R>(spc, rs, 1, a.tp.d2x);
      float p = (z == a.fs) ? 0.f : leapfrog_update(spc[rs], own[2 * T::OWN + o], c2o[j], im[j]);
      if ((fl & 1) && z != a.fs && !in_ring(z, x, a.frame))
        for (int k = a.m.smap[c] - 1; k >= 0; k = a.m.snext[k]) p = add_source(p, c2o[j], wt);
      if (fl & 4) {
        const int k = a.m.gmap[c];
        if (k > 0) p = ring_row != nullptr ? ring_row[k - 1] : 0.f;
      }
      pn[i] = p;
    }
    const float lap = rev_lap<R>(su, (oz + H) * W + g.tx + H, W, swz, (oz + H) * TX + g.tx, TX,
                                 syz, (oz + R) * TX + g.tx, TX, swx, oz * W + g.tx + H, syx,
                                 oz * W1 + g.tx + R, z < SE || z >= NZ - SE,
                                 x < SE || x >= NX - SE, a.tp);
    float q = rev_leapfrog(lam[j], own[o], lap);
    a.gacc[c] = fmaf(lam[j], im[j], own[T::OWN + o]);
    if (t >= 1) {
      if (fl & 2) {
        const int r = a.m.rmap[c] - 1;
        if (r >= 0) {
          float s = yb[r];
          for (int n = a.m.rnext[r]; n >= 0; n = a.m.rnext[n]) s += yb[n];
          q += s;
        }
      }
      if (fl & 1)
        for (int k = a.m.smap[c] - 1; k >= 0; k = a.m.snext[k])
          a.lam_src[(size_t)(t - 1) * a.nsrc + k] = (z == a.fs) ? 0.f : q;
      if (z == a.fs) q = 0.f;
    }
    qo[i] = q;
  }
}

// let the fused passes take their shared bytes (above the default 48 KB
// only by this attribute); a refusal is an error
template <int R, int TZ, int TX, int ROWS, int MINB>
inline int scan_allow_smem() {
  using T = STile<R, TZ, TX, ROWS, MINB>;
  cudaError_t e = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(fwd_fused<R, TZ, TX, ROWS, MINB>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::FWD);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(rev_fused<R, TZ, TX, ROWS, MINB, false>),
        cudaFuncAttributeMaxDynamicSharedMemorySize, T::REV);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(rev_fused<R, TZ, TX, ROWS, MINB, true>),
        cudaFuncAttributeMaxDynamicSharedMemorySize, T::REV_RINGS);
  return (int)e;
}

// the plan the caller states against the tile this library runs
template <int R, int TZ, int TX, int ROWS, int MINB>
inline int scan_check_plan(const SPlan& plan) {
  using T = STile<R, TZ, TX, ROWS, MINB>;
  if (plan.tz != TZ || plan.tx != TX || plan.smem != T::MAX)
    return (int)cudaErrorInvalidValue;
  return scan_allow_smem<R, TZ, TX, ROWS, MINB>();
}

inline int tiles_x(int NX, int tx) { return (NX + tx - 1) / tx; }

// ------------------------------------------------------------ host loops

// ws: pa, pb, phi_z, psi_z, phi_x, psi_x, then the second phi_z, phi_x;
// iws: the maps (SMaps), zeroed
template <int R, int TZ, int TX, int ROWS, int MINB>
int forward_loop(const SPlan& plan, int dep, const float* c2, const float* az,
                 const float* bz, const float* ax, const float* bx, const float* w,
                 const long long* src, const long long* rcv, float* seis, __nv_bfloat16* snap,
                 const int* ring, float* ring_tape, int n_ring, float* illum, float* ws, int* iws,
                 int NZ, int NX, int S, int nt, int nsrc, int nrec, int fs, const Taps& tp,
                 cudaStream_t st) {
  const size_t plane = (size_t)(NZ + 2 * R) * (NX + 2 * R);
  float* pa = ws;          // P_t for even t
  float* pb = ws + plane;  // P_t for odd t
  float* cur = pb;         // P_{t-1}
  float* prev = pa;        // P_{t-2}, overwritten by P_t
  if (const int err = scan_check_plan<R, TZ, TX, ROWS, MINB>(plan)) return err;
  const dim3 grid(tiles_x(NX, TX), (NZ + TZ - 1) / TZ), block(TX, ROWS);
  const SMaps m = carve_maps(iws, NZ, NX, grid.x * grid.y, nsrc);
  scan_setup<<<blocks_for(nsrc + nrec + n_ring), kSmallBlock, 0, st>>>(
      src, nsrc, rcv, nrec, ring, ring_tape ? n_ring : 0, NX, R, TZ, TX, grid.x, m, nullptr,
      nullptr, nullptr, fs);
  const FwdArgs a{c2, az, bz, ax, bx, w, seis, ws + 3 * plane, ws + 5 * plane, illum, m,
                  NZ, NX, S, fs, nrec, tp};
  float* phiz[2] = {ws + 2 * plane, ws + 6 * plane};
  float* phix[2] = {ws + 4 * plane, ws + 7 * plane};
  for (int t = 0; t < nt; ++t) {
    const int k = t & 1;
    launch_dep(dep, fwd_fused<R, TZ, TX, ROWS, MINB>, grid, block,
               (size_t)STile<R, TZ, TX, ROWS, MINB>::FWD, st, a, t, (const float*)cur, prev,
               (const float*)phiz[k], (const float*)phix[k], phiz[1 - k], phix[1 - k],
               snap ? snap + (size_t)t * NZ * NX : nullptr,
               ring_tape ? ring_tape + (size_t)t * n_ring : nullptr);
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

// ws: lambda ping-pong q0, q1, then psibar_z, phibar_z, psibar_x, phibar_x
// in two sets. iws: the maps (SMaps), zeroed
template <int R, int TZ, int TX, int ROWS, int MINB>
int reverse_snap_loop(const SPlan& plan, int dep, const float* c2, const float* az,
                      const float* bz, const float* ax, const float* bx, const float* ybar,
                      const __nv_bfloat16* snap, const long long* src, const long long* rcv,
                      float* gacc, float* lam_src, float* ws, int* iws, int NZ, int NX, int S,
                      int nt, int nsrc, int nrec, int fs, const Taps& tp, cudaStream_t st) {
  const size_t plane = (size_t)(NZ + 2 * R) * (NX + 2 * R);
  float* qc = ws;          // lambda_t
  float* qo = ws + plane;  // lambda_{t+1}, overwritten by lambda_{t-1}
  if (const int err = scan_check_plan<R, TZ, TX, ROWS, MINB>(plan)) return err;
  const dim3 grid(tiles_x(NX, TX), (NZ + TZ - 1) / TZ), block(TX, ROWS);
  const SMaps m = carve_maps(iws, NZ, NX, grid.x * grid.y, nsrc);
  scan_setup<<<blocks_for(nsrc + nrec), kSmallBlock, 0, st>>>(
      src, nsrc, rcv, nrec, nullptr, 0, NX, R, TZ, TX, grid.x, m,
      ybar + (size_t)(nt - 1) * nrec, qc, lam_src + (size_t)(nt - 1) * nsrc, fs);
  const RevArgs a{c2, az, bz, ax, bx, ybar, gacc, lam_src, m, NZ, NX, S, fs, nsrc, nrec, tp,
                  nullptr, RingFrame{}};
  float* set[2] = {ws + 2 * plane, ws + 6 * plane};  // psibar_z, phibar_z, psibar_x, phibar_x
  for (int t = nt - 1; t >= 0; --t) {
    const int k = (nt - 1 - t) & 1;
    const float* in = set[k];
    float* out = set[1 - k];
    launch_dep(dep, rev_fused<R, TZ, TX, ROWS, MINB, false>, grid, block,
               (size_t)STile<R, TZ, TX, ROWS, MINB>::REV, st, a, t, (const float*)qc, qo, in,
               in + plane, in + 2 * plane, in + 3 * plane, out, out + plane, out + 2 * plane,
               out + 3 * plane, snap + (size_t)t * NZ * NX, (const float*)nullptr,
               (float*)nullptr, (const float*)nullptr);
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

// ws: P_t, P_{t-1} (set by the caller), the lambda ping-pong q0, q1, then
// psibar_z, phibar_z, psibar_x, phibar_x in two sets. iws: the maps (SMaps),
// zeroed. The two field planes swap every step, so P_{-1} ends in plane
// nt % 2.
template <int R, int TZ, int TX, int ROWS, int MINB>
int reverse_rings_loop(const SPlan& plan, int dep, const float* c2,
                       const float* az, const float* bz, const float* ax, const float* bx,
                       const float* w, const float* ybar, const float* ring_tape,
                       const int* ring, int n_ring, const long long* src, const long long* rcv,
                       float* gacc, float* lam_src, float* ws, int* iws, int NZ, int NX, int S,
                       int nt, int nsrc, int nrec, int fs, RingFrame frame, const Taps& tp,
                       cudaStream_t st) {
  const size_t plane = (size_t)(NZ + 2 * R) * (NX + 2 * R);
  float* p_tp1 = ws;          // P_t, overwritten by P_{t-2}
  float* p_t = ws + plane;    // P_{t-1}
  float* qc = ws + 2 * plane;
  float* qo = ws + 3 * plane;
  if (const int err = scan_check_plan<R, TZ, TX, ROWS, MINB>(plan)) return err;
  const dim3 grid(tiles_x(NX, TX), (NZ + TZ - 1) / TZ), block(TX, ROWS);
  const SMaps m = carve_maps(iws, NZ, NX, grid.x * grid.y, nsrc);
  scan_setup<<<blocks_for(nsrc + nrec + n_ring), kSmallBlock, 0, st>>>(
      src, nsrc, rcv, nrec, ring, n_ring, NX, R, TZ, TX, grid.x, m,
      ybar + (size_t)(nt - 1) * nrec, qc, lam_src + (size_t)(nt - 1) * nsrc, fs);
  const RevArgs a{c2, az, bz, ax, bx, ybar, gacc, lam_src, m, NZ, NX, S, fs, nsrc, nrec, tp,
                  w, frame};
  float* set[2] = {ws + 4 * plane, ws + 8 * plane};
  for (int t = nt - 1; t >= 0; --t) {
    const int k = (nt - 1 - t) & 1;
    const float* in = set[k];
    float* out = set[1 - k];
    launch_dep(dep, rev_fused<R, TZ, TX, ROWS, MINB, true>, grid, block,
               (size_t)STile<R, TZ, TX, ROWS, MINB>::REV_RINGS, st, a, t, (const float*)qc, qo,
               in, in + plane, in + 2 * plane, in + 3 * plane, out, out + plane,
               out + 2 * plane, out + 3 * plane, (const __nv_bfloat16*)nullptr,
               (const float*)p_t, p_tp1,
               t >= 2 ? ring_tape + (size_t)(t - 2) * n_ring : (const float*)nullptr);
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

// ws: 8 zeroed halo planes (pa, pb, phiz, psiz, phix, psix, and a second
// phiz, phix); iws: the zeroed int maps of 3 NZ NX + tiles + nsrc + nrec
// ints; snap, ring and ring_tape may be null (ring and ring_tape together);
// illum, when given, is a (NZ, NX) accumulator that gains P_t^2 for every
// step t. The pass runs on the plan (tz, tx, smem: the tile and the larger
// pass's shared bytes, rejected unless it is the tile the library was built
// for), each step a programmatic dependent of the one before when dep is 1.
int tpufwi_scanres_forward(const float* c2, const float* az, const float* bz,
                           const float* ax, const float* bx, const float* w,
                           const long long* src, const long long* rcv, float* seis,
                           void* snap, const int* ring, float* ring_tape, float* illum,
                           float* ws, int* iws, int NZ, int NX, int S, int R, int nt, int nsrc,
                           int nrec, int fs, int n_ring, int tz, int tx, int smem, int dep,
                           const float* taps, void* stream) {
  const Taps tp = load_taps(taps);
  const SPlan plan{tz, tx, smem};
  auto* sb = static_cast<__nv_bfloat16*>(snap);
  auto st = static_cast<cudaStream_t>(stream);
  TPUFWI_DISPATCH_R(R, (forward_loop<kR, TPUFWI_SCAN_TILE>(
                           plan, dep, c2, az, bz, ax, bx, w, src, rcv, seis, sb, ring,
                           ring_tape, n_ring, illum, ws, iws, NZ, NX, S, nt, nsrc, nrec, fs, tp,
                           st)))
}

// ws: 10 zeroed halo planes; gacc (NZ, NX) zeroed; iws: the zeroed int maps
// (as the forward's); plan and dep as the forward's.
int tpufwi_scanres_reverse_snap(const float* c2, const float* az, const float* bz,
                                const float* ax, const float* bx, const float* ybar,
                                const void* snap, const long long* src, const long long* rcv,
                                float* gacc, float* lam_src, float* ws, int* iws, int NZ,
                                int NX, int S, int R, int nt, int nsrc, int nrec, int fs, int tz,
                                int tx, int smem, int dep, const float* taps, void* stream) {
  const Taps tp = load_taps(taps);
  const SPlan plan{tz, tx, smem};
  auto* sb = static_cast<const __nv_bfloat16*>(snap);
  auto st = static_cast<cudaStream_t>(stream);
  TPUFWI_DISPATCH_R(R, (reverse_snap_loop<kR, TPUFWI_SCAN_TILE>(
                           plan, dep, c2, az, bz, ax, bx, ybar, sb, src, rcv, gacc,
                           lam_src, ws, iws, NZ, NX, S, nt, nsrc, nrec, fs, tp, st)))
}

// ws: 12 halo planes: P_{nt-1}, P_{nt-2} (set by the caller), then zeroed
// (the lambda ping-pong and the adjoint planes); gacc (NZ, NX) zeroed; iws:
// the zeroed int maps (as the forward's); ring_tape (nt, n_ring) with row
// t = rings(P_t); plan and dep as the forward's.
int tpufwi_scanres_reverse_rings(const float* c2, const float* az, const float* bz,
                                 const float* ax, const float* bx, const float* w,
                                 const float* ybar, const float* ring_tape, const int* ring,
                                 const long long* src, const long long* rcv, float* gacc,
                                 float* lam_src, float* ws, int* iws, int NZ, int NX, int S,
                                 int R, int nt, int nsrc, int nrec, int fs, int n_ring, int z0,
                                 int z1, int x0, int x1, int rw, int tz, int tx, int smem,
                                 int dep, const float* taps, void* stream) {
  const Taps tp = load_taps(taps);
  const RingFrame frame{z0, z1, x0, x1, rw};
  const SPlan plan{tz, tx, smem};
  auto st = static_cast<cudaStream_t>(stream);
  TPUFWI_DISPATCH_R(R, (reverse_rings_loop<kR, TPUFWI_SCAN_TILE>(
                           plan, dep, c2, az, bz, ax, bx, w, ybar, ring_tape, ring,
                           n_ring, src, rcv, gacc, lam_src, ws, iws, NZ, NX, S, nt, nsrc, nrec,
                           fs, frame, tp, st)))
}

const char* tpufwi_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
