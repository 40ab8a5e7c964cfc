// Device code of the 2D acoustic engines for Hopper (sm_90a), shared by the
// whole-scan host loops (acoustic2d_scanres.cu) and the single-step entry
// points (acoustic2d_step.cu). Both translation units include it; every
// kernel has internal linkage.
//
// Semantics (the step twin, tpufwi_torch/kernels/acoustic2d_eager.py):
//   per axis d:  phi_d' = b phi_d + a D1_d p ;  v_d = D2_d p + D1_d phi_d'
//                psi_d' = b psi_d + a v_d    ;  lap = sum_d v_d + psi_d'
//   P_t = 2 P_{t-1} - P_{t-2} + C lap(P_{t-1}) ; P_t[src] += C[src] w[t]
//   P_t[fs row] = 0 ; seis[t] = P_t[rcv]
// Reconstruction runs the interior leapfrog backwards:
//   P_{t-2} = impose(pin(2 P_{t-1} - P_t + C lapw + C[src] w[t]), ring)
//   lapw = D2z P_{t-1} + D2x P_{t-1}     (the imaging laplacian)
// and the reverse runs the exact transpose of the step on lambda (the
// cotangent of P_t), imaging gbar += lambda_t * lapw.
//
// Kernels, in the order a step launches them:
//   forward:  F1 fwd_strips   phi' on the CPML strips (D1 of p)
//             F2 fwd_cells    one thread per cell: 17-tap D2 laplacian,
//                             optional bf16 tape row, D1 phi' and psi' inside
//                             the strips, leapfrog in place over P_{t-2},
//                             free-surface pin
//             F3 fwd_src_rcv  one block: sources (serially, so coinciding
//                             sources sum in a fixed order), then receivers
//             F4 ring_get     optional: one thread per ring cell, the ring
//                             of the post-source field into a tape row
//   reverse:  R0 rev_inject   one block: receiver-cotangent injection (each
//                             cell owned by its first receiver, which sums
//                             the others in index order), lambda at sources
//             R1 rev_cells1   one thread per cell: surface mask, u = C lambda,
//                             imaging, psi-bar ring -> w
//                (rev_cells1_rings: the same, with the reconstruction of
//                             P_{t-2} and its lapw fused in)
//             R2 rev_strips   phi-bar ring -> y (needs D1 u and D1 w)
//             R3 rev_cells2   one thread per cell: lambda_{t-1} =
//                             2 lambda_t - lambda_{t+1} + D2 u + D2 w - D1 y
//   reconstruction: C1 rec_cells (lapw and the leapfrog, in place, pin)
//                   C2 rec_src_ring (sources outside the ring, then the
//                      ring imposed from the tape row, or zeros)
// Every transposed stencil is a gather with flipped taps (D1^T = -D1,
// D2^T = D2), never an atomic scatter, so the gradient is deterministic.
// All arithmetic is fp32 (FMA); no tensor cores.
//
// Layout: every field is stored with a zero halo of R cells on each side
// ((NZ+2R) x (NX+2R), row stride NX+2R), so stencil gathers need no bounds
// tests; kernels write only the interior. The CPML memory variables are
// full-size fields that stay zero outside the strips. Ring cells are given
// as int32 indices into the flattened (NZ, NX) padded grid.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

namespace {

struct Taps {
  float d1z[9];
  float d2z[9];
  float d1x[9];
  float d2x[9];
};

// the interior-and-valid frame that the ring tiles: cells of the physical
// interior [z0, z1) x [x0, x1) within w of its edge
struct RingFrame {
  int z0, z1, x0, x1, w;
};

__device__ __forceinline__ bool in_ring(int z, int x, const RingFrame& f) {
  if (z < f.z0 || z >= f.z1 || x < f.x0 || x >= f.x1) return false;
  return z < f.z0 + f.w || z >= f.z1 - f.w || x < f.x0 + f.w || x >= f.x1 - f.w;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// index of row z (or column x) into a (2, S) strip profile, -1 outside
__device__ __forceinline__ int strip_index(int z, int n, int S) {
  if (z < S) return z;
  if (z >= n - S) return S + z - (n - S);
  return -1;
}

__device__ __forceinline__ int halo_index(int flat, int NX, int R) {
  const int z = flat / NX;
  return (z + R) * (NX + 2 * R) + flat - z * NX + R;
}

// D2z p + D2x p at halo index i
template <int R>
__device__ __forceinline__ float d2_lap(const float* __restrict__ p, int i, int ld,
                                        const Taps& tp) {
  float d2z = 0.f, d2x = 0.f;
#pragma unroll
  for (int k = 0; k <= 2 * R; ++k) {
    d2z = fmaf(tp.d2z[k], p[i + (k - R) * ld], d2z);
    d2x = fmaf(tp.d2x[k], p[i + k - R], d2x);
  }
  return d2z + d2x;
}

// --------------------------------------------------------------- forward

template <int R>
__global__ void fwd_strips(const float* __restrict__ p, float* __restrict__ phiz,
                           float* __restrict__ phix, const float* __restrict__ az,
                           const float* __restrict__ bz, const float* __restrict__ ax,
                           const float* __restrict__ bx, int NZ, int NX, int S, Taps tp) {
  const int ld = NX + 2 * R;
  const int nz_cells = 2 * S * NX;
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < nz_cells) {
    const int side = idx / (S * NX);
    const int rem = idx - side * S * NX;
    const int j = rem / NX;
    const int x = rem - j * NX;
    const int z = side ? NZ - S + j : j;
    const int i = (z + R) * ld + x + R;
    float d1 = 0.f;
#pragma unroll
    for (int k = 0; k <= 2 * R; ++k) d1 = fmaf(tp.d1z[k], p[i + (k - R) * ld], d1);
    const int s = side * S + j;
    phiz[i] = bz[s] * phiz[i] + az[s] * d1;
    return;
  }
  idx -= nz_cells;
  if (idx >= 2 * NZ * S) return;
  const int side = idx / (NZ * S);
  const int rem = idx - side * NZ * S;
  const int z = rem / S;
  const int j = rem - z * S;
  const int x = side ? NX - S + j : j;
  const int i = (z + R) * ld + x + R;
  float d1 = 0.f;
#pragma unroll
  for (int k = 0; k <= 2 * R; ++k) d1 = fmaf(tp.d1x[k], p[i + k - R], d1);
  const int s = side * S + j;
  phix[i] = bx[s] * phix[i] + ax[s] * d1;
}

template <int R>
__global__ void fwd_cells(const float* __restrict__ p, float* __restrict__ pnext,
                          const float* __restrict__ phiz, float* __restrict__ psiz,
                          const float* __restrict__ phix, float* __restrict__ psix,
                          const float* __restrict__ c2, const float* __restrict__ az,
                          const float* __restrict__ bz, const float* __restrict__ ax,
                          const float* __restrict__ bx, __nv_bfloat16* __restrict__ tape_row,
                          int NZ, int NX, int S, int fs, Taps tp) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= NX || z >= NZ) return;
  const int ld = NX + 2 * R;
  const int i = (z + R) * ld + x + R;
  float d2z = 0.f, d2x = 0.f;
#pragma unroll
  for (int k = 0; k <= 2 * R; ++k) {
    d2z = fmaf(tp.d2z[k], p[i + (k - R) * ld], d2z);
    d2x = fmaf(tp.d2x[k], p[i + k - R], d2x);
  }
  const float lap = d2z + d2x;
  if (tape_row != nullptr) tape_row[z * NX + x] = __float2bfloat16(lap);
  float acc = lap;
  const int SE = S + R;  // D1 phi' reaches R cells past the strip
  if (z < SE || z >= NZ - SE) {
    float corr = 0.f;
#pragma unroll
    for (int k = 0; k <= 2 * R; ++k) corr = fmaf(tp.d1z[k], phiz[i + (k - R) * ld], corr);
    acc += corr;
    const int s = strip_index(z, NZ, S);
    if (s >= 0) {
      const float ps = bz[s] * psiz[i] + az[s] * (d2z + corr);
      psiz[i] = ps;
      acc += ps;
    }
  }
  if (x < SE || x >= NX - SE) {
    float corr = 0.f;
#pragma unroll
    for (int k = 0; k <= 2 * R; ++k) corr = fmaf(tp.d1x[k], phix[i + k - R], corr);
    acc += corr;
    const int s = strip_index(x, NX, S);
    if (s >= 0) {
      const float ps = bx[s] * psix[i] + ax[s] * (d2x + corr);
      psix[i] = ps;
      acc += ps;
    }
  }
  // pnext holds P_{t-2} on entry; each cell reads it only here
  float pn = 2.f * p[i] - pnext[i] + c2[z * NX + x] * acc;
  if (z == fs) pn = 0.f;
  pnext[i] = pn;
}

__global__ void fwd_src_rcv(float* __restrict__ p, const float* __restrict__ c2,
                            const float* __restrict__ w, int t,
                            const long long* __restrict__ src,
                            const long long* __restrict__ rcv, float* __restrict__ seis,
                            int nsrc, int nrec, int NX, int R, int fs) {
  const int ld = NX + 2 * R;
  if (threadIdx.x == 0) {
    for (int k = 0; k < nsrc; ++k) {
      const int z = (int)src[2 * k], x = (int)src[2 * k + 1];
      // a source on the pinned surface row is overwritten by the pin
      if (z != fs) p[(z + R) * ld + x + R] += c2[z * NX + x] * w[t];
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < nrec; r += blockDim.x) {
    const int z = (int)rcv[2 * r], x = (int)rcv[2 * r + 1];
    seis[(size_t)t * nrec + r] = p[(z + R) * ld + x + R];
  }
}

// row[k] = p[ring cell k]: after the sources, so in-ring sources are taped
__global__ void ring_get(const float* __restrict__ p, const int* __restrict__ ring,
                         float* __restrict__ row, int n_ring, int NX, int R) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < n_ring) row[k] = p[halo_index(ring[k], NX, R)];
}

// ---------------------------------------------------------- reconstruction

// p_tp1 holds P_t on entry and 2 P_{t-1} - P_t + C lapw (surface pinned) on
// exit; lapw = D2 laplacian of p_t = P_{t-1}. Each cell reads p_tp1 only
// at itself, so the update is in place.
template <int R>
__global__ void rec_cells(const float* __restrict__ p_t, float* __restrict__ p_tp1,
                          const float* __restrict__ c2, float* __restrict__ lapw,
                          int NZ, int NX, int fs, Taps tp) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= NX || z >= NZ) return;
  const int ld = NX + 2 * R;
  const int i = (z + R) * ld + x + R;
  const int c = z * NX + x;
  const float lap = d2_lap<R>(p_t, i, ld, tp);
  lapw[c] = lap;
  p_tp1[i] = (z == fs) ? 0.f : 2.f * p_t[i] - p_tp1[i] + c2[c] * lap;
}

// The reconstruction's sources (skipped on the surface row and in the ring,
// where the pin and the tape win) and the ring imposition, from the tape
// row or zeros when row is null. The two touch disjoint cells.
__global__ void rec_src_ring(float* __restrict__ p, const float* __restrict__ c2,
                             const float* __restrict__ w, int t,
                             const long long* __restrict__ src, int nsrc,
                             const int* __restrict__ ring, const float* __restrict__ row,
                             int n_ring, int NX, int R, int fs, RingFrame frame) {
  const int ld = NX + 2 * R;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k == 0) {
    for (int s = 0; s < nsrc; ++s) {
      const int z = (int)src[2 * s], x = (int)src[2 * s + 1];
      if (z != fs && !in_ring(z, x, frame)) p[(z + R) * ld + x + R] += c2[z * NX + x] * w[t];
    }
  }
  if (k < n_ring) p[halo_index(ring[k], NX, R)] = row ? row[k] : 0.f;
}

// --------------------------------------------------------------- reverse

// chain[r] = next receiver with the same cell (-1: none);
// chain[nrec + r] = 1 if r is the first receiver of its cell
__global__ void rev_chain(const long long* __restrict__ rcv, int nrec, int* __restrict__ chain) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= nrec) return;
  const long long z = rcv[2 * r], x = rcv[2 * r + 1];
  int head = 1;
  for (int q = 0; q < r; ++q)
    if (rcv[2 * q] == z && rcv[2 * q + 1] == x) { head = 0; break; }
  int next = -1;
  for (int q = r + 1; q < nrec; ++q)
    if (rcv[2 * q] == z && rcv[2 * q + 1] == x) { next = q; break; }
  chain[r] = next;
  chain[nrec + r] = head;
}

__global__ void rev_inject(float* __restrict__ q, const float* __restrict__ ybar, int t,
                           const long long* __restrict__ rcv, const int* __restrict__ chain,
                           const long long* __restrict__ src, float* __restrict__ lam_src,
                           int nsrc, int nrec, int NX, int R, int fs) {
  const int ld = NX + 2 * R;
  const float* yb = ybar + (size_t)t * nrec;
  for (int r = threadIdx.x; r < nrec; r += blockDim.x) {
    if (!chain[nrec + r]) continue;
    float s = yb[r];
    for (int n = chain[r]; n >= 0; n = chain[n]) s += yb[n];
    const int z = (int)rcv[2 * r], x = (int)rcv[2 * r + 1];
    q[(z + R) * ld + x + R] += s;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < nsrc; k += blockDim.x) {
    const int z = (int)src[2 * k], x = (int)src[2 * k + 1];
    lam_src[(size_t)t * nsrc + k] = (z == fs) ? 0.f : q[(z + R) * ld + x + R];
  }
}

// R1 for one cell, imaging with img = the laplacian of the field step t
// started from
__device__ __forceinline__ void transposed_cell(
    float* __restrict__ q, float* __restrict__ u, const float* __restrict__ c2,
    float* __restrict__ gacc, float* __restrict__ psbz, float* __restrict__ wz,
    float* __restrict__ psbx, float* __restrict__ wx, const float* __restrict__ az,
    const float* __restrict__ bz, const float* __restrict__ ax, const float* __restrict__ bx,
    int z, int x, int i, int c, int NZ, int NX, int S, int fs, float img) {
  float lam = q[i];
  if (z == fs) {  // transpose of the surface pin
    lam = 0.f;
    q[i] = 0.f;
  }
  const float uu = c2[c] * lam;
  u[i] = uu;
  gacc[c] = fmaf(lam, img, gacc[c]);
  const int sz = strip_index(z, NZ, S);
  if (sz >= 0) {
    const float pt = psbz[i] + uu;
    psbz[i] = bz[sz] * pt;
    wz[i] = az[sz] * pt;
  }
  const int sx = strip_index(x, NX, S);
  if (sx >= 0) {
    const float pt = psbx[i] + uu;
    psbx[i] = bx[sx] * pt;
    wx[i] = ax[sx] * pt;
  }
}

// img_row: the bf16 snapshot tape row (snapshot reverse) or the fp32 lapw of
// the reconstruction (single-step adjoint)
template <int R, typename T>
__global__ void rev_cells1(float* __restrict__ q, float* __restrict__ u,
                           const float* __restrict__ c2, const T* __restrict__ img_row,
                           float* __restrict__ gacc, float* __restrict__ psbz,
                           float* __restrict__ wz, float* __restrict__ psbx,
                           float* __restrict__ wx, const float* __restrict__ az,
                           const float* __restrict__ bz, const float* __restrict__ ax,
                           const float* __restrict__ bx, int NZ, int NX, int S, int fs) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= NX || z >= NZ) return;
  const int i = (z + R) * (NX + 2 * R) + x + R;
  const int c = z * NX + x;
  transposed_cell(q, u, c2, gacc, psbz, wz, psbx, wx, az, bz, ax, bx, z, x, i, c, NZ, NX, S,
                  fs, to_float(img_row[c]));
}

// rev_cells1 with the reconstruction fused in: lapw of p_t = P_{t-1} images
// lambda_t, and P_{t-2} is written in place over p_tp1 = P_t
template <int R>
__global__ void rev_cells1_rings(float* __restrict__ q, float* __restrict__ u,
                                 const float* __restrict__ c2, const float* __restrict__ p_t,
                                 float* __restrict__ p_tp1, float* __restrict__ gacc,
                                 float* __restrict__ psbz, float* __restrict__ wz,
                                 float* __restrict__ psbx, float* __restrict__ wx,
                                 const float* __restrict__ az, const float* __restrict__ bz,
                                 const float* __restrict__ ax, const float* __restrict__ bx,
                                 int NZ, int NX, int S, int fs, Taps tp) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= NX || z >= NZ) return;
  const int ld = NX + 2 * R;
  const int i = (z + R) * ld + x + R;
  const int c = z * NX + x;
  const float lap = d2_lap<R>(p_t, i, ld, tp);
  p_tp1[i] = (z == fs) ? 0.f : 2.f * p_t[i] - p_tp1[i] + c2[c] * lap;
  transposed_cell(q, u, c2, gacc, psbz, wz, psbx, wx, az, bz, ax, bx, z, x, i, c, NZ, NX, S,
                  fs, lap);
}

template <int R>
__global__ void rev_strips(const float* __restrict__ u, const float* __restrict__ wz,
                           const float* __restrict__ wx, float* __restrict__ pbz,
                           float* __restrict__ yz, float* __restrict__ pbx,
                           float* __restrict__ yx, const float* __restrict__ az,
                           const float* __restrict__ bz, const float* __restrict__ ax,
                           const float* __restrict__ bx, int NZ, int NX, int S, Taps tp) {
  const int ld = NX + 2 * R;
  const int nz_cells = 2 * S * NX;
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < nz_cells) {
    const int side = idx / (S * NX);
    const int rem = idx - side * S * NX;
    const int j = rem / NX;
    const int x = rem - j * NX;
    const int z = side ? NZ - S + j : j;
    const int i = (z + R) * ld + x + R;
    float d1 = 0.f;  // D1 (u + w); its transpose enters with a minus sign
#pragma unroll
    for (int k = 0; k <= 2 * R; ++k) {
      const int o = i + (k - R) * ld;
      d1 = fmaf(tp.d1z[k], u[o] + wz[o], d1);
    }
    const int s = side * S + j;
    const float pt = pbz[i] - d1;
    pbz[i] = bz[s] * pt;
    yz[i] = az[s] * pt;
    return;
  }
  idx -= nz_cells;
  if (idx >= 2 * NZ * S) return;
  const int side = idx / (NZ * S);
  const int rem = idx - side * NZ * S;
  const int z = rem / S;
  const int j = rem - z * S;
  const int x = side ? NX - S + j : j;
  const int i = (z + R) * ld + x + R;
  float d1 = 0.f;
#pragma unroll
  for (int k = 0; k <= 2 * R; ++k) d1 = fmaf(tp.d1x[k], u[i + k - R] + wx[i + k - R], d1);
  const int s = side * S + j;
  const float pt = pbx[i] - d1;
  pbx[i] = bx[s] * pt;
  yx[i] = ax[s] * pt;
}

template <int R>
__global__ void rev_cells2(const float* __restrict__ qcur, float* __restrict__ qoth,
                           const float* __restrict__ u, const float* __restrict__ wz,
                           const float* __restrict__ yz, const float* __restrict__ wx,
                           const float* __restrict__ yx, int NZ, int NX, int S, Taps tp) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= NX || z >= NZ) return;
  const int ld = NX + 2 * R;
  const int i = (z + R) * ld + x + R;
  float lap = 0.f;
#pragma unroll
  for (int k = 0; k <= 2 * R; ++k) {
    lap = fmaf(tp.d2z[k], u[i + (k - R) * ld], lap);
    lap = fmaf(tp.d2x[k], u[i + k - R], lap);
  }
  const int SE = S + R;
  if (z < SE || z >= NZ - SE) {
#pragma unroll
    for (int k = 0; k <= 2 * R; ++k) {
      const int o = i + (k - R) * ld;
      lap = fmaf(tp.d2z[k], wz[o], lap);
      lap = fmaf(-tp.d1z[k], yz[o], lap);
    }
  }
  if (x < SE || x >= NX - SE) {
#pragma unroll
    for (int k = 0; k <= 2 * R; ++k) {
      lap = fmaf(tp.d2x[k], wx[i + k - R], lap);
      lap = fmaf(-tp.d1x[k], yx[i + k - R], lap);
    }
  }
  // qoth holds lambda_{t+1} on entry and lambda_{t-1} (before its
  // receiver injection) on exit; each cell reads it only here
  qoth[i] = 2.f * qcur[i] - qoth[i] + lap;
}

// ------------------------------------------------------------ launch shapes

const dim3 kCellBlock(32, 8);
const int kStripBlock = 256;
const int kSmallBlock = 256;

inline dim3 cell_grid(int NZ, int NX) {
  return dim3((NX + kCellBlock.x - 1) / kCellBlock.x, (NZ + kCellBlock.y - 1) / kCellBlock.y);
}

inline int strip_blocks(int NZ, int NX, int S) {
  return (2 * S * NX + 2 * NZ * S + kStripBlock - 1) / kStripBlock;
}

inline int blocks_for(int n) { return (n + kSmallBlock - 1) / kSmallBlock; }

inline Taps load_taps(const float* host) {
  Taps tp;
  std::memcpy(&tp, host, sizeof(Taps));
  return tp;
}

// One forward step on the caller's stream: P_{t-1} in cur, P_{t-2} in prev
// (overwritten by P_t); optional bf16 snapshot row and fp32 ring row.
template <int R>
void forward_step(const float* c2, const float* az, const float* bz, const float* ax,
                  const float* bx, const float* w, int t, const long long* src,
                  const long long* rcv, float* seis, __nv_bfloat16* snap_row, const int* ring,
                  float* ring_row, int n_ring, const float* cur, float* prev, float* phiz,
                  float* psiz, float* phix, float* psix, int NZ, int NX, int S, int nsrc,
                  int nrec, int fs, const Taps& tp, cudaStream_t st) {
  fwd_strips<R><<<strip_blocks(NZ, NX, S), kStripBlock, 0, st>>>(cur, phiz, phix, az, bz, ax,
                                                                  bx, NZ, NX, S, tp);
  fwd_cells<R><<<cell_grid(NZ, NX), kCellBlock, 0, st>>>(cur, prev, phiz, psiz, phix, psix, c2,
                                                         az, bz, ax, bx, snap_row, NZ, NX, S,
                                                         fs, tp);
  fwd_src_rcv<<<1, kSmallBlock, 0, st>>>(prev, c2, w, t, src, rcv, seis, nsrc, nrec, NX, R, fs);
  if (ring_row != nullptr)
    ring_get<<<blocks_for(n_ring), kSmallBlock, 0, st>>>(prev, ring, ring_row, n_ring, NX, R);
}

// R0, then R1 (img_row is null for the fused reconstruction of the rings
// reverse, which then reads p_t and rewrites p_tp1), R2, R3. adj holds the
// 9 planes u, psibar_z, w_z, phibar_z, y_z, psibar_x, w_x, phibar_x, y_x.
template <int R, typename T>
void reverse_step(const float* c2, const float* az, const float* bz, const float* ax,
                  const float* bx, const float* ybar, int t, const T* img_row,
                  const float* p_t, float* p_tp1, const long long* src, const long long* rcv,
                  const int* chain, float* gacc, float* lam_src, float* qc, float* qo,
                  float* adj, size_t plane, int NZ, int NX, int S, int nsrc, int nrec, int fs,
                  const Taps& tp, cudaStream_t st) {
  float* u = adj;
  float* psbz = adj + plane;
  float* wz = adj + 2 * plane;
  float* pbz = adj + 3 * plane;
  float* yz = adj + 4 * plane;
  float* psbx = adj + 5 * plane;
  float* wx = adj + 6 * plane;
  float* pbx = adj + 7 * plane;
  float* yx = adj + 8 * plane;
  rev_inject<<<1, kSmallBlock, 0, st>>>(qc, ybar, t, rcv, chain, src, lam_src, nsrc, nrec, NX,
                                        R, fs);
  if (img_row != nullptr)
    rev_cells1<R, T><<<cell_grid(NZ, NX), kCellBlock, 0, st>>>(
        qc, u, c2, img_row, gacc, psbz, wz, psbx, wx, az, bz, ax, bx, NZ, NX, S, fs);
  else
    rev_cells1_rings<R><<<cell_grid(NZ, NX), kCellBlock, 0, st>>>(
        qc, u, c2, p_t, p_tp1, gacc, psbz, wz, psbx, wx, az, bz, ax, bx, NZ, NX, S, fs, tp);
  rev_strips<R><<<strip_blocks(NZ, NX, S), kStripBlock, 0, st>>>(u, wz, wx, pbz, yz, pbx, yx, az,
                                                                  bz, ax, bx, NZ, NX, S, tp);
  rev_cells2<R><<<cell_grid(NZ, NX), kCellBlock, 0, st>>>(qc, qo, u, wz, yz, wx, yx, NZ, NX, S,
                                                          tp);
}

}  // namespace

// R is a template parameter of every stencil kernel; dispatch the orders
// the port supports (2, 4 and 8)
#define TPUFWI_DISPATCH_R(R, CALL)                  \
  switch (R) {                                      \
    case 1: { constexpr int kR = 1; return CALL; }  \
    case 2: { constexpr int kR = 2; return CALL; }  \
    case 4: { constexpr int kR = 4; return CALL; }  \
    default: return (int)cudaErrorInvalidValue;     \
  }
