// Device code of the 3D acoustic engines for Hopper (sm_90a), included by
// acoustic3d_scan.cu (the whole-scan engine) and acoustic3d_step.cu (the
// per-step leapfrog and strip kernels); every kernel has internal linkage.
//
// Semantics (the step twin, tpufwi_torch/kernels/acoustic2d_eager.py, on a
// (y, z, x) grid, z the depth axis):
//   per axis d:  phi_d' = b phi_d + a D1_d p ;  v_d = D2_d p + D1_d phi_d'
//                psi_d' = b psi_d + a v_d    ;  lap = sum_d v_d + psi_d'
//   P_t = 2 P_{t-1} - P_{t-2} + C lap(P_{t-1}) ; P_t[src] += C[src] w[t]
//   P_t[fs z-row] = 0 ; seis[t] = P_t[rcv]
// The CPML is separable: each axis carries the 2D engine's per-axis algebra
// (acoustic2d_kernels.cuh) on its own pair of faces, and all six faces are
// handled by the same launches.
// Reconstruction runs the interior leapfrog backwards:
//   P_{t-2} = impose(pin(2 P_{t-1} - P_t + C lapw + C[src] w[t]), ring)
//   lapw = sum_d D2_d P_{t-1}     (the imaging laplacian)
// and the reverse runs the exact transpose of the step on lambda (the
// cotangent of P_t), imaging gacc += lambda_t * lapw:
//   u = C lambda ;  per strip cell: ps = psibar + u, psibar' = b ps, w = a ps
//                   per strip cell: pt = phibar - D1 (u + w), phibar' = b pt,
//                                   y = a pt
//   lambda_{t-1} = 2 lambda_t - lambda_{t+1} + sum_d D2_d (u + w_d) - D1_d y_d
// (D1^T = -D1, D2^T = D2: every transposed stencil is a gather, never an
// atomic scatter, so the gradient is deterministic.) fp32 FMA only.
//
// Kernels, in the order a step launches them:
//   forward:  F1 f3_phi     one thread per strip cell of the three axes:
//                           phi_d' (D1_d of p)
//             F2 f3_cells   one thread per cell: the three 9-tap D2 stencils,
//                           D1_d phi_d' and psi_d' in the CPML reach of each
//                           axis, the leapfrog in place over P_{t-2}, the
//                           surface pin; optionally illum += P_{t-1}^2
//             F3 f3_src_rcv one block: sources (serially: coinciding sources
//                           sum in a fixed order), then receivers
//             F4 f3_ring_get optional: the ring of the post-source field into
//                           a tape row (fp32 or bf16)
//   reverse:  R0 r3_inject  one block: receiver-cotangent injection (each
//                           cell owned by its first receiver, which sums the
//                           others in index order), lambda at the sources
//             R1 r3_cells1  one thread per cell: reconstruction of P_{t-2}
//                           over P_t, lapw, imaging, surface mask, psibar -> w
//             R1b r3_src_ring the reconstruction's sources, the ring imposed
//             R2 r3_strips  one thread per strip cell: phibar -> y
//             R3 r3_cells2  one thread per cell: lambda_{t-1}
//
// Layout. The wavefields (p, lambda) and C are stored with a zero halo of R
// cells on every side ((NY+2R) x (NZ+2R) x (NX+2R), x contiguous), so the
// stencil gathers need no bounds tests; kernels write only the interior.
// (The per-step kernels of acoustic3d_step.cu keep their fields on the
// padded grid with no halo, read through GridField.)
// u = C lambda is formed on the fly from the two halo fields. The CPML
// memories live on their strips only (width S = pml + R on each face): the
// axis-d strip array has the padded grid's extent on the other two axes and
// 2S (low strip, then high) on axis d; values outside a strip are zero and
// are never stored. Ring cells are int32 indices into the flattened
// (NY, NZ, NX) padded grid. Every count fits int32 at the full SEG/EAGE
// Overthrust grid (837 x 223 x 837 halo cells); tape offsets are size_t.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

namespace {

struct Taps3 {
  float d1[3][9];  // y, z, x; zero past 2R+1 taps
  float d2[3][9];
};

struct Dims {
  int n[3];  // padded NY, NZ, NX
  int S;     // strip depth
  int lx;    // halo row stride, NX + 2R
  int ly;    // halo plane stride, (NZ + 2R)(NX + 2R)
};

struct RingFrame3 {  // the physical interior [lo, hi) per axis; ring width w
  int lo[3], hi[3], w;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <int R>
__device__ __forceinline__ int halo_at(int y, int z, int x, const Dims& D) {
  return (y + R) * D.ly + (z + R) * D.lx + x + R;
}

// halo stride of axis AX
template <int AX>
__device__ __forceinline__ int axis_stride(const Dims& D) {
  return AX == 0 ? D.ly : (AX == 1 ? D.lx : 1);
}

template <int AX>
__device__ __forceinline__ int coord(int y, int z, int x) {
  return AX == 0 ? y : (AX == 1 ? z : x);
}

// strip coordinate (0 .. 2S) of padded coordinate c on an axis of n cells,
// -1 outside both strips or outside the grid
__device__ __forceinline__ int strip_coord(int c, int n, int S) {
  if (c < 0 || c >= n) return -1;
  if (c < S) return c;
  if (c >= n - S) return c - n + 2 * S;
  return -1;
}

// offset of (y, z, x), with its axis-AX coordinate replaced by strip
// coordinate j, in the axis-AX strip array
template <int AX>
__device__ __forceinline__ int strip_off(int y, int z, int x, int j, const Dims& D) {
  const int S2 = 2 * D.S;
  if (AX == 0) return (j * D.n[1] + z) * D.n[2] + x;
  if (AX == 1) return (y * S2 + j) * D.n[2] + x;
  return (y * D.n[1] + z) * S2 + j;
}

// value of the axis-AX strip array k cells along AX from (y, z, x); zero
// outside the strips
template <int AX>
__device__ __forceinline__ float strip_at(const float* __restrict__ a, int y, int z, int x,
                                          int k, const Dims& D) {
  const int j = strip_coord(coord<AX>(y, z, x) + k, D.n[AX], D.S);
  return j < 0 ? 0.f : a[strip_off<AX>(y, z, x, j, D)];
}

template <int AX>
__device__ __forceinline__ int strip_cells(const Dims& D) {
  return 2 * D.S * (AX == 0 ? D.n[1] * D.n[2] : (AX == 1 ? D.n[0] * D.n[2] : D.n[0] * D.n[1]));
}

// (y, z, x, j) of element e of the axis-AX strip array
template <int AX>
__device__ __forceinline__ void strip_cell(int e, const Dims& D, int& y, int& z, int& x,
                                           int& j) {
  const int S2 = 2 * D.S;
  if (AX == 0) {
    j = e / (D.n[1] * D.n[2]);
    const int r = e - j * D.n[1] * D.n[2];
    z = r / D.n[2];
    x = r - z * D.n[2];
    y = j < D.S ? j : D.n[0] - S2 + j;
  } else if (AX == 1) {
    y = e / (S2 * D.n[2]);
    const int r = e - y * S2 * D.n[2];
    j = r / D.n[2];
    x = r - j * D.n[2];
    z = j < D.S ? j : D.n[1] - S2 + j;
  } else {
    const int yz = e / S2;
    j = e - yz * S2;
    y = yz / D.n[1];
    z = yz - y * D.n[1];
    x = j < D.S ? j : D.n[2] - S2 + j;
  }
}

// the profiles are packed per axis as (a: 2S, b: 2S)
__device__ __forceinline__ const float* prof_a(const float* prof, int ax, int S) {
  return prof + 4 * S * ax;
}
__device__ __forceinline__ const float* prof_b(const float* prof, int ax, int S) {
  return prof + 4 * S * ax + 2 * S;
}

// the strip arrays of one quantity are packed y, z, x
struct Strips {
  float* s[3];
};

inline Strips strips_at(float* base, int NY, int NZ, int NX, int S) {
  Strips st;
  st.s[0] = base;
  st.s[1] = st.s[0] + (size_t)2 * S * NZ * NX;
  st.s[2] = st.s[1] + (size_t)NY * 2 * S * NX;
  return st;
}

inline size_t strip_total(int NY, int NZ, int NX, int S) {
  return (size_t)2 * S * ((size_t)NZ * NX + (size_t)NY * NX + (size_t)NY * NZ);
}

// Field readers: the value k cells along axis AX from (y, z, x), zero past
// the padded grid. HaloField reads the whole-scan engine's halo layout,
// whose zero halo makes the test needless; GridField reads a field on the
// padded grid as it is (the per-step engine, acoustic3d_step.cu). Either
// gives the same value, so a per-cell function templated on the reader runs
// one arithmetic in both engines.
template <int R>
struct HaloField {
  const float* p;
  template <int AX>
  __device__ __forceinline__ float along(int y, int z, int x, int k, const Dims& D) const {
    return p[halo_at<R>(y, z, x, D) + k * axis_stride<AX>(D)];
  }
};

// the (NY, NZ, NX) strides of axis AX
template <int AX>
__device__ __forceinline__ int grid_stride(const Dims& D) {
  return AX == 0 ? D.n[1] * D.n[2] : (AX == 1 ? D.n[2] : 1);
}

__device__ __forceinline__ int grid_at(int y, int z, int x, const Dims& D) {
  return (y * D.n[1] + z) * D.n[2] + x;
}

struct GridField {
  const float* p;
  template <int AX>
  __device__ __forceinline__ float along(int y, int z, int x, int k, const Dims& D) const {
    const int c = coord<AX>(y, z, x) + k;
    return (c < 0 || c >= D.n[AX]) ? 0.f : p[grid_at(y, z, x, D) + k * grid_stride<AX>(D)];
  }
};

// --------------------------------------------------------------- forward

template <int R, int AX, typename F>
__device__ __forceinline__ void phi_cell(F p, float* __restrict__ phi,
                                         const float* __restrict__ prof, int e, const Dims& D,
                                         const Taps3& tp) {
  int y, z, x, j;
  strip_cell<AX>(e, D, y, z, x, j);
  float d1 = 0.f;
#pragma unroll
  for (int k = 0; k <= 2 * R; ++k)
    d1 = fmaf(tp.d1[AX][k], p.template along<AX>(y, z, x, k - R, D), d1);
  phi[e] = prof_b(prof, AX, D.S)[j] * phi[e] + prof_a(prof, AX, D.S)[j] * d1;
}

// phi' of every strip cell of the three axes, from p read through F
template <int R, typename F>
__device__ __forceinline__ void phi_cells(F p, const Strips& phi,
                                          const float* __restrict__ prof, int e, const Dims& D,
                                          const Taps3& tp) {
  const int ny = strip_cells<0>(D), nz = strip_cells<1>(D), nx = strip_cells<2>(D);
  if (e < ny) return phi_cell<R, 0>(p, phi.s[0], prof, e, D, tp);
  e -= ny;
  if (e < nz) return phi_cell<R, 1>(p, phi.s[1], prof, e, D, tp);
  e -= nz;
  if (e < nx) phi_cell<R, 2>(p, phi.s[2], prof, e, D, tp);
}

template <int R>
__global__ void f3_phi(const float* __restrict__ p, Strips phi, const float* __restrict__ prof,
                       Dims D, Taps3 tp) {
  phi_cells<R>(HaloField<R>{p}, phi, prof, blockIdx.x * blockDim.x + threadIdx.x, D, tp);
}

// axis AX's CPML parts at (y, z, x), given d2 = D2_AX p at the cell:
// corr = D1 phi' within R of the strips and, inside them, psi' (updated in
// place) as ps. Returns 0 outside that reach, 1 in it outside the strips,
// 2 inside a strip.
template <int R, int AX>
__device__ __forceinline__ int cpml_parts(const float* __restrict__ phi,
                                          float* __restrict__ psi,
                                          const float* __restrict__ prof, int y, int z, int x,
                                          float d2, const Dims& D, const Taps3& tp, float& corr,
                                          float& ps) {
  const int c = coord<AX>(y, z, x);
  const int SE = D.S + R;
  if (c >= SE && c < D.n[AX] - SE) return 0;
  corr = 0.f;
#pragma unroll
  for (int k = 0; k <= 2 * R; ++k)
    if (k != R) corr = fmaf(tp.d1[AX][k], strip_at<AX>(phi, y, z, x, k - R, D), corr);
  const int j = strip_coord(c, D.n[AX], D.S);
  if (j < 0) return 1;
  const int o = strip_off<AX>(y, z, x, j, D);
  ps = prof_b(prof, AX, D.S)[j] * psi[o] + prof_a(prof, AX, D.S)[j] * (d2 + corr);
  psi[o] = ps;
  return 2;
}

// axis AX's CPML terms at (y, z, x): D1 phi' within R of the strips, and
// psi' (updated in place) inside them; d2 is D2_AX p at the cell
template <int R, int AX>
__device__ __forceinline__ float cpml_terms(const float* __restrict__ phi,
                                            float* __restrict__ psi,
                                            const float* __restrict__ prof, int y, int z, int x,
                                            float d2, const Dims& D, const Taps3& tp) {
  float corr, ps;
  const int where = cpml_parts<R, AX>(phi, psi, prof, y, z, x, d2, D, tp, corr, ps);
  return where == 0 ? 0.f : (where == 1 ? corr : corr + ps);
}

// pnext holds P_{t-2} on entry and P_t (before the sources) on exit; each
// cell reads it only at itself. illum, when given, accumulates P_{t-1}^2
// on the (NY, NZ, NX) grid.
template <int R>
__global__ void f3_cells(const float* __restrict__ p, float* __restrict__ pnext,
                         const float* __restrict__ c2, Strips phi, Strips psi,
                         const float* __restrict__ prof, float* __restrict__ illum, Dims D,
                         int fs, Taps3 tp) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.y * blockDim.y + threadIdx.y;
  const int y = blockIdx.z;
  if (x >= D.n[2] || z >= D.n[1]) return;
  const int i = halo_at<R>(y, z, x, D);
  float d2y = 0.f, d2z = 0.f, d2x = 0.f;
#pragma unroll
  for (int k = 0; k <= 2 * R; ++k) {
    d2y = fmaf(tp.d2[0][k], p[i + (k - R) * D.ly], d2y);
    d2z = fmaf(tp.d2[1][k], p[i + (k - R) * D.lx], d2z);
    d2x = fmaf(tp.d2[2][k], p[i + k - R], d2x);
  }
  float acc = d2y + d2z + d2x;
  acc += cpml_terms<R, 0>(phi.s[0], psi.s[0], prof, y, z, x, d2y, D, tp);
  acc += cpml_terms<R, 1>(phi.s[1], psi.s[1], prof, y, z, x, d2z, D, tp);
  acc += cpml_terms<R, 2>(phi.s[2], psi.s[2], prof, y, z, x, d2x, D, tp);
  const float pc = p[i];
  if (illum != nullptr) {
    const int c = (y * D.n[1] + z) * D.n[2] + x;
    illum[c] = fmaf(pc, pc, illum[c]);
  }
  float pn = 2.f * pc - pnext[i] + c2[i] * acc;
  if (z == fs) pn = 0.f;
  pnext[i] = pn;
}

template <int R>
__device__ __forceinline__ int halo_of_triple(const long long* __restrict__ idx, int k,
                                              const Dims& D) {
  return halo_at<R>((int)idx[3 * k], (int)idx[3 * k + 1], (int)idx[3 * k + 2], D);
}

template <int R>
__global__ void f3_src_rcv(float* __restrict__ p, const float* __restrict__ c2,
                           const float* __restrict__ w, int t,
                           const long long* __restrict__ src,
                           const long long* __restrict__ rcv, float* __restrict__ seis,
                           int nsrc, int nrec, Dims D, int fs) {
  if (threadIdx.x == 0) {
    for (int k = 0; k < nsrc; ++k) {
      // a source on the pinned surface row is overwritten by the pin
      if ((int)src[3 * k + 1] == fs) continue;
      const int i = halo_of_triple<R>(src, k, D);
      p[i] += c2[i] * w[t];
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < nrec; r += blockDim.x)
    seis[(size_t)t * nrec + r] = p[halo_of_triple<R>(rcv, r, D)];
}

template <int R>
__device__ __forceinline__ int halo_of_flat(int f, const Dims& D) {
  const int y = f / (D.n[1] * D.n[2]);
  const int r = f - y * D.n[1] * D.n[2];
  const int z = r / D.n[2];
  return halo_at<R>(y, z, r - z * D.n[2], D);
}

// row[k] = p[ring cell k], after the sources, so in-ring sources are taped
template <int R, typename T>
__global__ void f3_ring_get(const float* __restrict__ p, const int* __restrict__ ring,
                            T* __restrict__ row, int n_ring, Dims D) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < n_ring) store(row + k, p[halo_of_flat<R>(ring[k], D)]);
}

// illum += p^2 on the (NY, NZ, NX) grid: the last field of the forward
template <int R>
__global__ void f3_illum_add(const float* __restrict__ p, float* __restrict__ illum, Dims D) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.y * blockDim.y + threadIdx.y;
  const int y = blockIdx.z;
  if (x >= D.n[2] || z >= D.n[1]) return;
  const float v = p[halo_at<R>(y, z, x, D)];
  const int c = (y * D.n[1] + z) * D.n[2] + x;
  illum[c] = fmaf(v, v, illum[c]);
}

// --------------------------------------------------------------- reverse

// chain[r] = next receiver with the same cell (-1: none);
// chain[nrec + r] = 1 if r is the first receiver of its cell
__global__ void r3_chain(const long long* __restrict__ rcv, int nrec, int* __restrict__ chain) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= nrec) return;
  auto same = [&](int q) {
    return rcv[3 * q] == rcv[3 * r] && rcv[3 * q + 1] == rcv[3 * r + 1] &&
           rcv[3 * q + 2] == rcv[3 * r + 2];
  };
  int head = 1;
  for (int q = 0; q < r; ++q)
    if (same(q)) { head = 0; break; }
  int next = -1;
  for (int q = r + 1; q < nrec; ++q)
    if (same(q)) { next = q; break; }
  chain[r] = next;
  chain[nrec + r] = head;
}

template <int R>
__global__ void r3_inject(float* __restrict__ q, const float* __restrict__ ybar, int t,
                          const long long* __restrict__ rcv, const int* __restrict__ chain,
                          const long long* __restrict__ src, float* __restrict__ lam_src,
                          int nsrc, int nrec, Dims D, int fs) {
  const float* yb = ybar + (size_t)t * nrec;
  for (int r = threadIdx.x; r < nrec; r += blockDim.x) {
    if (!chain[nrec + r]) continue;
    float s = yb[r];
    for (int n = chain[r]; n >= 0; n = chain[n]) s += yb[n];
    q[halo_of_triple<R>(rcv, r, D)] += s;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < nsrc; k += blockDim.x)
    lam_src[(size_t)t * nsrc + k] =
        ((int)src[3 * k + 1] == fs) ? 0.f : q[halo_of_triple<R>(src, k, D)];
}

template <int AX>
__device__ __forceinline__ void psibar_cell(const Strips& psb, const Strips& w, const float* __restrict__ prof,
                                            int y, int z, int x, float u, const Dims& D) {
  const int j = strip_coord(coord<AX>(y, z, x), D.n[AX], D.S);
  if (j < 0) return;
  const int o = strip_off<AX>(y, z, x, j, D);
  const float ps = psb.s[AX][o] + u;
  psb.s[AX][o] = prof_b(prof, AX, D.S)[j] * ps;
  w.s[AX][o] = prof_a(prof, AX, D.S)[j] * ps;
}

// p_tp1 holds P_t on entry and P_{t-2} (before its sources and ring) on
// exit; lapw = D2 laplacian of p_t = P_{t-1} images lambda_t. q = lambda_t
// (after injection) is masked on the surface row in place.
template <int R>
__global__ void r3_cells1(float* __restrict__ q, const float* __restrict__ c2,
                          const float* __restrict__ p_t, float* __restrict__ p_tp1,
                          float* __restrict__ gacc, Strips psb, Strips w,
                          const float* __restrict__ prof, Dims D, int fs, Taps3 tp) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.y * blockDim.y + threadIdx.y;
  const int y = blockIdx.z;
  if (x >= D.n[2] || z >= D.n[1]) return;
  const int i = halo_at<R>(y, z, x, D);
  float lap = 0.f;
#pragma unroll
  for (int k = 0; k <= 2 * R; ++k) {
    lap = fmaf(tp.d2[0][k], p_t[i + (k - R) * D.ly], lap);
    lap = fmaf(tp.d2[1][k], p_t[i + (k - R) * D.lx], lap);
    lap = fmaf(tp.d2[2][k], p_t[i + k - R], lap);
  }
  const float cc = c2[i];
  p_tp1[i] = (z == fs) ? 0.f : 2.f * p_t[i] - p_tp1[i] + cc * lap;
  float lam = q[i];
  if (z == fs) {  // transpose of the surface pin
    lam = 0.f;
    q[i] = 0.f;
  }
  const int c = (y * D.n[1] + z) * D.n[2] + x;
  gacc[c] = fmaf(lam, lap, gacc[c]);
  const float u = cc * lam;
  psibar_cell<0>(psb, w, prof, y, z, x, u, D);
  psibar_cell<1>(psb, w, prof, y, z, x, u, D);
  psibar_cell<2>(psb, w, prof, y, z, x, u, D);
}

__device__ __forceinline__ bool in_ring(int y, int z, int x, const RingFrame3& f) {
  const int c[3] = {y, z, x};
  bool edge = false;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    if (c[d] < f.lo[d] || c[d] >= f.hi[d]) return false;
    edge = edge || c[d] < f.lo[d] + f.w || c[d] >= f.hi[d] - f.w;
  }
  return edge;
}

// The reconstruction's sources (skipped on the surface row and in the
// ring, where the pin and the tape win) and the ring imposition from the
// tape row, or zeros when row is null. The two touch disjoint cells.
template <int R, typename T>
__global__ void r3_src_ring(float* __restrict__ p, const float* __restrict__ c2,
                            const float* __restrict__ w, int t,
                            const long long* __restrict__ src, int nsrc,
                            const int* __restrict__ ring, const T* __restrict__ row,
                            int n_ring, Dims D, int fs, RingFrame3 frame) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k == 0) {
    for (int s = 0; s < nsrc; ++s) {
      const int y = (int)src[3 * s], z = (int)src[3 * s + 1], x = (int)src[3 * s + 2];
      if (z == fs || in_ring(y, z, x, frame)) continue;
      const int i = halo_at<R>(y, z, x, D);
      p[i] += c2[i] * w[t];
    }
  }
  if (k < n_ring) p[halo_of_flat<R>(ring[k], D)] = row ? to_float(row[k]) : 0.f;
}

template <int R, int AX>
__device__ __forceinline__ void phibar_cell(const float* __restrict__ q,
                                            const float* __restrict__ c2, const Strips& w,
                                            const Strips& pb, const Strips& yv,
                                            const float* __restrict__ prof, int e,
                                            const Dims& D, const Taps3& tp) {
  int y, z, x, j;
  strip_cell<AX>(e, D, y, z, x, j);
  const int i = halo_at<R>(y, z, x, D);
  const int st = axis_stride<AX>(D);
  float d1 = 0.f;  // D1 (u + w); its transpose enters with a minus sign
#pragma unroll
  for (int k = 0; k <= 2 * R; ++k) {
    if (k == R) continue;
    const int o = i + (k - R) * st;
    d1 = fmaf(tp.d1[AX][k], c2[o] * q[o] + strip_at<AX>(w.s[AX], y, z, x, k - R, D), d1);
  }
  const float pt = pb.s[AX][e] - d1;
  pb.s[AX][e] = prof_b(prof, AX, D.S)[j] * pt;
  yv.s[AX][e] = prof_a(prof, AX, D.S)[j] * pt;
}

template <int R>
__global__ void r3_strips(const float* __restrict__ q, const float* __restrict__ c2, Strips w,
                          Strips pb, Strips yv, const float* __restrict__ prof, Dims D,
                          Taps3 tp) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int ny = strip_cells<0>(D), nz = strip_cells<1>(D), nx = strip_cells<2>(D);
  if (e < ny) return phibar_cell<R, 0>(q, c2, w, pb, yv, prof, e, D, tp);
  e -= ny;
  if (e < nz) return phibar_cell<R, 1>(q, c2, w, pb, yv, prof, e, D, tp);
  e -= nz;
  if (e < nx) phibar_cell<R, 2>(q, c2, w, pb, yv, prof, e, D, tp);
}

// axis AX's transposed CPML terms at (y, z, x): D2 w - D1 y within R of
// the strips
template <int R, int AX>
__device__ __forceinline__ float tcpml_terms(const Strips& w, const Strips& yv, int y, int z,
                                             int x, const Dims& D, const Taps3& tp) {
  const int c = coord<AX>(y, z, x);
  const int SE = D.S + R;
  if (c >= SE && c < D.n[AX] - SE) return 0.f;
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k <= 2 * R; ++k) {
    acc = fmaf(tp.d2[AX][k], strip_at<AX>(w.s[AX], y, z, x, k - R, D), acc);
    if (k != R) acc = fmaf(-tp.d1[AX][k], strip_at<AX>(yv.s[AX], y, z, x, k - R, D), acc);
  }
  return acc;
}

// qoth holds lambda_{t+1} on entry and lambda_{t-1} (before its receiver
// injection) on exit; each cell reads it only at itself
template <int R>
__global__ void r3_cells2(const float* __restrict__ qcur, float* __restrict__ qoth,
                          const float* __restrict__ c2, Strips w, Strips yv, Dims D,
                          Taps3 tp) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.y * blockDim.y + threadIdx.y;
  const int y = blockIdx.z;
  if (x >= D.n[2] || z >= D.n[1]) return;
  const int i = halo_at<R>(y, z, x, D);
  float lap = 0.f;
#pragma unroll
  for (int k = 0; k <= 2 * R; ++k) {
    const int oy = i + (k - R) * D.ly, oz = i + (k - R) * D.lx, ox = i + k - R;
    lap = fmaf(tp.d2[0][k], c2[oy] * qcur[oy], lap);
    lap = fmaf(tp.d2[1][k], c2[oz] * qcur[oz], lap);
    lap = fmaf(tp.d2[2][k], c2[ox] * qcur[ox], lap);
  }
  lap += tcpml_terms<R, 0>(w, yv, y, z, x, D, tp);
  lap += tcpml_terms<R, 1>(w, yv, y, z, x, D, tp);
  lap += tcpml_terms<R, 2>(w, yv, y, z, x, D, tp);
  qoth[i] = 2.f * qcur[i] - qoth[i] + lap;
}

// ------------------------------------------------------------ launch shapes

const dim3 kCellBlock(32, 8, 1);
const int kStripBlock = 256;
const int kSmallBlock = 256;

inline dim3 cell_grid(const Dims& D) {
  return dim3((D.n[2] + kCellBlock.x - 1) / kCellBlock.x,
              (D.n[1] + kCellBlock.y - 1) / kCellBlock.y, D.n[0]);
}

inline int strip_blocks(const Dims& D) {
  const size_t n = strip_total(D.n[0], D.n[1], D.n[2], D.S);
  return (int)((n + kStripBlock - 1) / kStripBlock);
}

inline int blocks_for(int n) { return (n + kSmallBlock - 1) / kSmallBlock; }

inline Dims make_dims(int NY, int NZ, int NX, int S, int R) {
  Dims D;
  D.n[0] = NY;
  D.n[1] = NZ;
  D.n[2] = NX;
  D.S = S;
  D.lx = NX + 2 * R;
  D.ly = (NZ + 2 * R) * D.lx;
  return D;
}

inline Taps3 load_taps3(const float* host) {
  Taps3 tp;
  std::memcpy(&tp, host, sizeof(Taps3));
  return tp;
}

}  // namespace

// R is a template parameter of every stencil kernel; dispatch the orders
// the port supports (2, 4 and 8)
#define TPUFWI_DISPATCH_R3(R, CALL)                 \
  switch (R) {                                      \
    case 1: { constexpr int kR = 1; return CALL; }  \
    case 2: { constexpr int kR = 2; return CALL; }  \
    case 4: { constexpr int kR = 4; return CALL; }  \
    default: return (int)cudaErrorInvalidValue;     \
  }
