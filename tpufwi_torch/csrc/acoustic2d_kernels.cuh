// Device code of the 2D acoustic engines for Hopper (sm_90a), shared by the
// whole-scan host loops (acoustic2d_scanres.cu), the single-step entry
// points (acoustic2d_step.cu) and the cooperative K-step kernels
// (acoustic2d_kstep.cu). Each translation unit includes it; every kernel
// has internal linkage.
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
//                (rev_cell1_rings: the same, with the reconstruction of
//                             P_{t-2} and its lapw fused in; the K-step
//                             reverse's cell body)
//             R2 rev_strips   phi-bar ring -> y (needs D1 u and D1 w)
//             R3 rev_cells2   one thread per cell: lambda_{t-1} =
//                             2 lambda_t - lambda_{t+1} + D2 u + D2 w - D1 y
//   reconstruction: C1 rec_cells (lapw and the leapfrog, in place, pin;
//                      with the pin off, the bare leapfrog)
//                   C2 rec_src_ring (sources outside the ring, then the
//                      ring imposed from the tape row, or zeros)
// The whole-scan engine fuses a step into one shared-memory tiled kernel
// (acoustic2d_scanres.cu): F1-F4 and the illumination in fwd_fused, R0-R3
// in rev_fused. Every engine runs the per-cell tails below (tap_sum,
// phi_update, psi_update, leapfrog_update, add_source, adj_w, adj_y,
// rev_lap, rev_leapfrog): a
// product that could contract into an FMA is fused explicitly (fmaf), so a
// value recomputed in a fused pass's reach has the owner's bits, and the
// engines agree bitwise.
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

#include "pdl.cuh"  // dep_wait, dep_trigger, launch_dep

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

// The per-cell bodies are __device__ functions, so the ordinary kernels
// below, the fused passes (acoustic2d_scanres.cu) and the cooperative
// K-step kernels (acoustic2d_kstep.cu) run one arithmetic per cell: the
// engines agree bitwise.

// sum_k taps[k] f[i + (k - R) s], one FMA a tap in tap order
template <int R>
__device__ __forceinline__ float tap_sum(const float* __restrict__ f, int i, int s,
                                         const float* taps) {
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k <= 2 * R; ++k) acc = fmaf(taps[k], f[i + (k - R) * s], acc);
  return acc;
}

// phi' = b phi + a D1 p
__device__ __forceinline__ float phi_update(float b, float phi, float a, float d1) {
  return fmaf(b, phi, a * d1);
}

// psi' = b psi + a (D2 p + D1 phi')
__device__ __forceinline__ float psi_update(float b, float psi, float a, float d2, float corr) {
  return fmaf(b, psi, a * (d2 + corr));
}

// P_t = 2 P_{t-1} - P_{t-2} + C acc
__device__ __forceinline__ float leapfrog_update(float p, float p_prev, float c2, float acc) {
  return fmaf(c2, acc, 2.f * p - p_prev);
}

// lambda_{t-1} (before its receiver injection) = 2 lambda_t - lambda_{t+1} + lap
__device__ __forceinline__ float rev_leapfrog(float q, float q_next, float lap) {
  return 2.f * q - q_next + lap;
}

// one source: p += C w
__device__ __forceinline__ float add_source(float p, float c2, float w) { return fmaf(c2, w, p); }

// the transposed psi update at a strip cell: pt = psibar + u, psibar' = b
// pt, w = a pt (u = C lambda must come rounded, __fmul_rn: a product
// contracted into this sum in one kernel and not in another would break
// the engines' bitwise agreement)
__device__ __forceinline__ void adj_w(float psb, float uu, float a, float b, float& psb_new,
                                      float& w) {
  const float pt = psb + uu;
  psb_new = b * pt;
  w = a * pt;
}

// the transposed phi update at a strip cell, d1 = D1 (u + w): pt = phibar -
// d1, phibar' = b pt, y = a pt
__device__ __forceinline__ void adj_y(float pb, float d1, float a, float b, float& pb_new,
                                      float& y) {
  const float pt = pb - d1;
  pb_new = b * pt;
  y = a * pt;
}

// D1 (u + w) along one axis: u at iu, w at iw, strides su, sw
template <int R>
__device__ __forceinline__ float tap_sum_uw(const float* __restrict__ u, int iu, int su,
                                            const float* __restrict__ w, int iw, int sw,
                                            const float* taps) {
  float d1 = 0.f;
#pragma unroll
  for (int k = 0; k <= 2 * R; ++k) d1 = fmaf(taps[k], u[iu + (k - R) * su] + w[iw + (k - R) * sw], d1);
  return d1;
}

// R3's sum for lambda_{t-1}: D2 u, then in the z band D2z wz - D1z yz, then
// in the x band D2x wx - D1x yx, one accumulator in that order. Each array
// at its own index and z stride (x stride 1): the single-step pass reads
// halo planes, the fused one shared-memory planes.
template <int R>
__device__ __forceinline__ float rev_lap(const float* __restrict__ u, int iu, int su,
                                         const float* __restrict__ wz, int iwz, int swz,
                                         const float* __restrict__ yz, int iyz, int syz,
                                         const float* __restrict__ wx, int iwx,
                                         const float* __restrict__ yx, int iyx, bool zband,
                                         bool xband, const Taps& tp) {
  float lap = 0.f;
#pragma unroll
  for (int k = 0; k <= 2 * R; ++k) {
    lap = fmaf(tp.d2z[k], u[iu + (k - R) * su], lap);
    lap = fmaf(tp.d2x[k], u[iu + k - R], lap);
  }
  if (zband) {
#pragma unroll
    for (int k = 0; k <= 2 * R; ++k) {
      lap = fmaf(tp.d2z[k], wz[iwz + (k - R) * swz], lap);
      lap = fmaf(-tp.d1z[k], yz[iyz + (k - R) * syz], lap);
    }
  }
  if (xband) {
#pragma unroll
    for (int k = 0; k <= 2 * R; ++k) {
      lap = fmaf(tp.d2x[k], wx[iwx + k - R], lap);
      lap = fmaf(-tp.d1x[k], yx[iyx + k - R], lap);
    }
  }
  return lap;
}

// --------------------------------------------------------------- forward

// F1 for strip cell idx of [0, 2 S NX + 2 NZ S): z strips, then x strips
template <int R>
__device__ __forceinline__ void fwd_strip_cell(const float* __restrict__ p,
                                               float* __restrict__ phiz,
                                               float* __restrict__ phix,
                                               const float* __restrict__ az,
                                               const float* __restrict__ bz,
                                               const float* __restrict__ ax,
                                               const float* __restrict__ bx, int idx, int NZ,
                                               int NX, int S, const Taps& tp) {
  const int ld = NX + 2 * R;
  const int nz_cells = 2 * S * NX;
  if (idx < nz_cells) {
    const int side = idx / (S * NX);
    const int rem = idx - side * S * NX;
    const int j = rem / NX;
    const int x = rem - j * NX;
    const int z = side ? NZ - S + j : j;
    const int i = (z + R) * ld + x + R;
    const int s = side * S + j;
    phiz[i] = phi_update(bz[s], phiz[i], az[s], tap_sum<R>(p, i, ld, tp.d1z));
    return;
  }
  idx -= nz_cells;
  const int side = idx / (NZ * S);
  const int rem = idx - side * NZ * S;
  const int z = rem / S;
  const int j = rem - z * S;
  const int x = side ? NX - S + j : j;
  const int i = (z + R) * ld + x + R;
  const int s = side * S + j;
  phix[i] = phi_update(bx[s], phix[i], ax[s], tap_sum<R>(p, i, 1, tp.d1x));
}

// F2 for cell (z, x)
template <int R>
__device__ __forceinline__ void fwd_cell(const float* __restrict__ p, float* __restrict__ pnext,
                                         const float* __restrict__ phiz, float* __restrict__ psiz,
                                         const float* __restrict__ phix, float* __restrict__ psix,
                                         const float* __restrict__ c2, const float* __restrict__ az,
                                         const float* __restrict__ bz, const float* __restrict__ ax,
                                         const float* __restrict__ bx,
                                         __nv_bfloat16* __restrict__ tape_row, int z, int x,
                                         int NZ, int NX, int S, int fs, const Taps& tp) {
  const int ld = NX + 2 * R;
  const int i = (z + R) * ld + x + R;
  const float d2z = tap_sum<R>(p, i, ld, tp.d2z), d2x = tap_sum<R>(p, i, 1, tp.d2x);
  const float lap = d2z + d2x;
  if (tape_row != nullptr) tape_row[z * NX + x] = __float2bfloat16(lap);
  float acc = lap;
  const int SE = S + R;  // D1 phi' reaches R cells past the strip
  if (z < SE || z >= NZ - SE) {
    const float corr = tap_sum<R>(phiz, i, ld, tp.d1z);
    acc += corr;
    const int s = strip_index(z, NZ, S);
    if (s >= 0) {
      const float ps = psi_update(bz[s], psiz[i], az[s], d2z, corr);
      psiz[i] = ps;
      acc += ps;
    }
  }
  if (x < SE || x >= NX - SE) {
    const float corr = tap_sum<R>(phix, i, 1, tp.d1x);
    acc += corr;
    const int s = strip_index(x, NX, S);
    if (s >= 0) {
      const float ps = psi_update(bx[s], psix[i], ax[s], d2x, corr);
      psix[i] = ps;
      acc += ps;
    }
  }
  // pnext holds P_{t-2} on entry; each cell reads it only here
  float pn = leapfrog_update(p[i], pnext[i], c2[z * NX + x], acc);
  if (z == fs) pn = 0.f;
  pnext[i] = pn;
}

// F3's sources, by one thread (coinciding sources sum in index order)
__device__ __forceinline__ void fwd_sources(float* __restrict__ p, const float* __restrict__ c2,
                                            const float* __restrict__ w, int t,
                                            const long long* __restrict__ src, int nsrc, int NX,
                                            int R, int fs) {
  const int ld = NX + 2 * R;
  for (int k = 0; k < nsrc; ++k) {
    const int z = (int)src[2 * k], x = (int)src[2 * k + 1];
    // a source on the pinned surface row is overwritten by the pin
    if (z != fs) {
      float* q = p + (z + R) * ld + x + R;
      *q = add_source(*q, c2[z * NX + x], w[t]);
    }
  }
}

// F3's receiver r, after the sources
__device__ __forceinline__ void fwd_receiver(const float* __restrict__ p, int t,
                                             const long long* __restrict__ rcv,
                                             float* __restrict__ seis, int r, int nrec, int NX,
                                             int R) {
  const int z = (int)rcv[2 * r], x = (int)rcv[2 * r + 1];
  seis[(size_t)t * nrec + r] = p[(z + R) * (NX + 2 * R) + x + R];
}

template <int R>
__global__ void fwd_strips(const float* __restrict__ p, float* __restrict__ phiz,
                           float* __restrict__ phix, const float* __restrict__ az,
                           const float* __restrict__ bz, const float* __restrict__ ax,
                           const float* __restrict__ bx, int NZ, int NX, int S, Taps tp) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < 2 * S * NX + 2 * NZ * S) fwd_strip_cell<R>(p, phiz, phix, az, bz, ax, bx, idx, NZ, NX,
                                                       S, tp);
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
  fwd_cell<R>(p, pnext, phiz, psiz, phix, psix, c2, az, bz, ax, bx, tape_row, z, x, NZ, NX, S, fs,
              tp);
}

__global__ void fwd_src_rcv(float* __restrict__ p, const float* __restrict__ c2,
                            const float* __restrict__ w, int t,
                            const long long* __restrict__ src,
                            const long long* __restrict__ rcv, float* __restrict__ seis,
                            int nsrc, int nrec, int NX, int R, int fs) {
  if (threadIdx.x == 0) fwd_sources(p, c2, w, t, src, nsrc, NX, R, fs);
  __syncthreads();
  for (int r = threadIdx.x; r < nrec; r += blockDim.x) fwd_receiver(p, t, rcv, seis, r, nrec, NX, R);
}

// row[k] = p[ring cell k]: after the sources, so in-ring sources are taped
__device__ __forceinline__ void ring_cell(const float* __restrict__ p, const int* __restrict__ ring,
                                          float* __restrict__ row, int k, int NX, int R) {
  row[k] = p[halo_index(ring[k], NX, R)];
}

__global__ void ring_get(const float* __restrict__ p, const int* __restrict__ ring,
                         float* __restrict__ row, int n_ring, int NX, int R) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < n_ring) ring_cell(p, ring, row, k, NX, R);
}

// ---------------------------------------------------------- reconstruction

// p_tp1 holds P_t on entry and 2 P_{t-1} - P_t + C lapw (surface pinned) on
// exit; lapw = D2 laplacian of p_t = P_{t-1}, written unless null. Each
// cell reads p_tp1 only at itself, so the update is in place. With fs = -1
// this is the bare leapfrog p_other <- 2 p - p_other + C Lap(p).
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
  if (lapw != nullptr) lapw[c] = lap;
  p_tp1[i] = (z == fs) ? 0.f : leapfrog_update(p_t[i], p_tp1[i], c2[c], lap);
}

// The reconstruction's sources, by one thread (skipped on the surface row
// and in the ring, where the pin and the tape win)
__device__ __forceinline__ void rec_sources(float* __restrict__ p, const float* __restrict__ c2,
                                            const float* __restrict__ w, int t,
                                            const long long* __restrict__ src, int nsrc, int NX,
                                            int R, int fs, const RingFrame& frame) {
  const int ld = NX + 2 * R;
  for (int s = 0; s < nsrc; ++s) {
    const int z = (int)src[2 * s], x = (int)src[2 * s + 1];
    if (z != fs && !in_ring(z, x, frame)) {
      float* q = p + (z + R) * ld + x + R;
      *q = add_source(*q, c2[z * NX + x], w[t]);
    }
  }
}

// ring cell k imposed from the tape row, or zero when row is null
__device__ __forceinline__ void ring_impose(float* __restrict__ p, const int* __restrict__ ring,
                                            const float* __restrict__ row, int k, int NX, int R) {
  p[halo_index(ring[k], NX, R)] = row ? row[k] : 0.f;
}

// The sources and the ring imposition, from the tape row or zeros when row
// is null. The two touch disjoint cells.
__global__ void rec_src_ring(float* __restrict__ p, const float* __restrict__ c2,
                             const float* __restrict__ w, int t,
                             const long long* __restrict__ src, int nsrc,
                             const int* __restrict__ ring, const float* __restrict__ row,
                             int n_ring, int NX, int R, int fs, RingFrame frame) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k == 0) rec_sources(p, c2, w, t, src, nsrc, NX, R, fs, frame);
  if (k < n_ring) ring_impose(p, ring, row, k, NX, R);
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

// R0 for receiver r: the first receiver of a cell adds the cotangents of
// all its cell's receivers, in index order
__device__ __forceinline__ void inject_receiver(float* __restrict__ q,
                                                const float* __restrict__ yb,
                                                const long long* __restrict__ rcv,
                                                const int* __restrict__ chain, int r, int nrec,
                                                int NX, int R) {
  if (!chain[nrec + r]) return;
  float s = yb[r];
  for (int n = chain[r]; n >= 0; n = chain[n]) s += yb[n];
  const int z = (int)rcv[2 * r], x = (int)rcv[2 * r + 1];
  q[(z + R) * (NX + 2 * R) + x + R] += s;
}

// R0's lambda_t at source k, after the injection
__device__ __forceinline__ void lambda_at_source(const float* __restrict__ q, int t,
                                                 const long long* __restrict__ src,
                                                 float* __restrict__ lam_src, int k, int nsrc,
                                                 int NX, int R, int fs) {
  const int z = (int)src[2 * k], x = (int)src[2 * k + 1];
  lam_src[(size_t)t * nsrc + k] = (z == fs) ? 0.f : q[(z + R) * (NX + 2 * R) + x + R];
}

__global__ void rev_inject(float* __restrict__ q, const float* __restrict__ ybar, int t,
                           const long long* __restrict__ rcv, const int* __restrict__ chain,
                           const long long* __restrict__ src, float* __restrict__ lam_src,
                           int nsrc, int nrec, int NX, int R, int fs) {
  const float* yb = ybar + (size_t)t * nrec;
  for (int r = threadIdx.x; r < nrec; r += blockDim.x)
    inject_receiver(q, yb, rcv, chain, r, nrec, NX, R);
  __syncthreads();
  for (int k = threadIdx.x; k < nsrc; k += blockDim.x)
    lambda_at_source(q, t, src, lam_src, k, nsrc, NX, R, fs);
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
  const float uu = __fmul_rn(c2[c], lam);  // rounded: never contracted into adj_w's sum
  u[i] = uu;
  gacc[c] = fmaf(lam, img, gacc[c]);
  const int sz = strip_index(z, NZ, S);
  if (sz >= 0) adj_w(psbz[i], uu, az[sz], bz[sz], psbz[i], wz[i]);
  const int sx = strip_index(x, NX, S);
  if (sx >= 0) adj_w(psbx[i], uu, ax[sx], bx[sx], psbx[i], wx[i]);
}

// img_row: the fp32 lapw of the reconstruction (or a snapshot row widened)
template <int R>
__global__ void rev_cells1(float* __restrict__ q, float* __restrict__ u,
                           const float* __restrict__ c2, const float* __restrict__ img_row,
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
                  fs, img_row[c]);
}

// R1 with the reconstruction fused in, for cell (z, x): lapw of p_t =
// P_{t-1} images lambda_t, and P_{t-2} is written in place over p_tp1 = P_t
template <int R>
__device__ __forceinline__ void rev_cell1_rings(
    float* __restrict__ q, float* __restrict__ u, const float* __restrict__ c2,
    const float* __restrict__ p_t, float* __restrict__ p_tp1, float* __restrict__ gacc,
    float* __restrict__ psbz, float* __restrict__ wz, float* __restrict__ psbx,
    float* __restrict__ wx, const float* __restrict__ az, const float* __restrict__ bz,
    const float* __restrict__ ax, const float* __restrict__ bx, int z, int x, int NZ, int NX,
    int S, int fs, const Taps& tp) {
  const int ld = NX + 2 * R;
  const int i = (z + R) * ld + x + R;
  const int c = z * NX + x;
  const float lap = d2_lap<R>(p_t, i, ld, tp);
  p_tp1[i] = (z == fs) ? 0.f : leapfrog_update(p_t[i], p_tp1[i], c2[c], lap);
  transposed_cell(q, u, c2, gacc, psbz, wz, psbx, wx, az, bz, ax, bx, z, x, i, c, NZ, NX, S,
                  fs, lap);
}

// R2 for strip cell idx of [0, 2 S NX + 2 NZ S): z strips, then x strips
template <int R>
__device__ __forceinline__ void rev_strip_cell(
    const float* __restrict__ u, const float* __restrict__ wz, const float* __restrict__ wx,
    float* __restrict__ pbz, float* __restrict__ yz, float* __restrict__ pbx,
    float* __restrict__ yx, const float* __restrict__ az, const float* __restrict__ bz,
    const float* __restrict__ ax, const float* __restrict__ bx, int idx, int NZ, int NX, int S,
    const Taps& tp) {
  const int ld = NX + 2 * R;
  const int nz_cells = 2 * S * NX;
  if (idx < nz_cells) {
    const int side = idx / (S * NX);
    const int rem = idx - side * S * NX;
    const int j = rem / NX;
    const int x = rem - j * NX;
    const int z = side ? NZ - S + j : j;
    const int i = (z + R) * ld + x + R;
    const int s = side * S + j;
    // D1 (u + w); its transpose enters with a minus sign
    adj_y(pbz[i], tap_sum_uw<R>(u, i, ld, wz, i, ld, tp.d1z), az[s], bz[s], pbz[i], yz[i]);
    return;
  }
  idx -= nz_cells;
  const int side = idx / (NZ * S);
  const int rem = idx - side * NZ * S;
  const int z = rem / S;
  const int j = rem - z * S;
  const int x = side ? NX - S + j : j;
  const int i = (z + R) * ld + x + R;
  const int s = side * S + j;
  adj_y(pbx[i], tap_sum_uw<R>(u, i, 1, wx, i, 1, tp.d1x), ax[s], bx[s], pbx[i], yx[i]);
}

template <int R>
__global__ void rev_strips(const float* __restrict__ u, const float* __restrict__ wz,
                           const float* __restrict__ wx, float* __restrict__ pbz,
                           float* __restrict__ yz, float* __restrict__ pbx,
                           float* __restrict__ yx, const float* __restrict__ az,
                           const float* __restrict__ bz, const float* __restrict__ ax,
                           const float* __restrict__ bx, int NZ, int NX, int S, Taps tp) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < 2 * S * NX + 2 * NZ * S)
    rev_strip_cell<R>(u, wz, wx, pbz, yz, pbx, yx, az, bz, ax, bx, idx, NZ, NX, S, tp);
}

// R3 for cell (z, x)
template <int R>
__device__ __forceinline__ void rev_cell2(const float* __restrict__ qcur,
                                          float* __restrict__ qoth, const float* __restrict__ u,
                                          const float* __restrict__ wz,
                                          const float* __restrict__ yz,
                                          const float* __restrict__ wx,
                                          const float* __restrict__ yx, int z, int x, int NZ,
                                          int NX, int S, const Taps& tp) {
  const int ld = NX + 2 * R;
  const int i = (z + R) * ld + x + R;
  const int SE = S + R;
  const float lap = rev_lap<R>(u, i, ld, wz, i, ld, yz, i, ld, wx, i, yx, i,
                               z < SE || z >= NZ - SE, x < SE || x >= NX - SE, tp);
  // qoth holds lambda_{t+1} on entry and lambda_{t-1} (before its
  // receiver injection) on exit; each cell reads it only here
  qoth[i] = rev_leapfrog(qcur[i], qoth[i], lap);
}

template <int R>
__global__ void rev_cells2(const float* __restrict__ qcur, float* __restrict__ qoth,
                           const float* __restrict__ u, const float* __restrict__ wz,
                           const float* __restrict__ yz, const float* __restrict__ wx,
                           const float* __restrict__ yx, int NZ, int NX, int S, Taps tp) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= NX || z >= NZ) return;
  rev_cell2<R>(qcur, qoth, u, wz, yz, wx, yx, z, x, NZ, NX, S, tp);
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

// R0, then R1 imaging with img_row, R2, R3. adj holds the 9 planes u,
// psibar_z, w_z, phibar_z, y_z, psibar_x, w_x, phibar_x, y_x.
template <int R>
void reverse_step(const float* c2, const float* az, const float* bz, const float* ax,
                  const float* bx, const float* ybar, int t, const float* img_row,
                  const long long* src, const long long* rcv, const int* chain, float* gacc,
                  float* lam_src, float* qc, float* qo, float* adj, size_t plane, int NZ,
                  int NX, int S, int nsrc, int nrec, int fs, const Taps& tp, cudaStream_t st) {
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
  rev_cells1<R><<<cell_grid(NZ, NX), kCellBlock, 0, st>>>(
      qc, u, c2, img_row, gacc, psbz, wz, psbx, wx, az, bz, ax, bx, NZ, NX, S, fs);
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
