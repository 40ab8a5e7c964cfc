// Device code of the 2D elastic P-SV engines for Hopper (sm_90a): the
// per-step kernels and the host functions that launch one stage of a
// forward or reverse time step on a stream (estage_v, estage_s, estage_rs,
// estage_rv). The whole-scan loops (elastic2d_scan.cu) and the per-step
// entry points (elastic2d_step.cu) include it and launch the same
// functions. Every kernel has internal linkage.
//
// Semantics (the step twin, tpufwi_torch/kernels/elastic2d_eager.py), with
// D+ f[i] = sum_k c_k (f[i+1+k] - f[i-k]) and D- f[i] = sum_k c_k (f[i+k] -
// f[i-1-k]) (c_k = staggered taps / h, zero outside the grid):
//   stage V: m = b m + a d for the 4 stress derivatives (CPML strips),
//            vx += dt bx (D+x sxx + m + D-z sxz + m),
//            vz += dt bz (D-x sxz + m + D+z szz + m); velocity image
//   stage S: m = b m + a d for the 4 velocity derivatives,
//            sxx += dt (l2m exx + lam ezz), szz += dt (l2m ezz + lam exx),
//            sxz += dt muxz (D+z vx + m + D+x vz + m)
//   source:  pressure dt w on sxx and szz, or force dt bz[src] w on vz;
//            stress image; receivers (vz, vx) or -(sxx + szz) / 2; the
//            five fields' boundary rings into the tape row.
// The reverse runs, per step t descending (the reference's order,
// tpufwi/propagators/elastic2d.py and elastic2d_pallas_scan.py):
//   receiver-cotangent injection; stress-image transpose; the source-point
//   cotangent into srcrow and the source undone on the primal;
//   R-S: strains of v, sigma_t reconstructed, imaging of lam, l2m, muxz,
//        the transposed stress update -> vxb, vzb; the stress rings of row
//        t-1 imposed (zeros for t = 0) and the primal re-imaged;
//   velocity-image transpose;
//   R-V: stress derivatives of sigma_t, v_{t-1/2} reconstructed, imaging
//        of bx, bz, the transposed velocity update -> sxxb, szzb, sxzb;
//        the velocity rings imposed and the primal re-imaged.
// The transposed update is taken at zero CPML memory (the update is affine,
// its memory part carried by the dual memories): with q the cotangent of a
// total derivative d + m', tot = q + dual, dual' = b tot, dbar = q + a tot.
// The transposes of the stencils are gathers ((D+)^T = -D-, (D-)^T = -D+)
// over zero-halo dbar planes, never atomics, so the result is deterministic.
// All arithmetic is fp32 (FMA); no tensor cores.
//
// Layout: the five primal fields and the four dbar planes are stored with a
// zero halo of R cells on each side ((NZ+2R) x (NX+2R), row stride NX+2R);
// kernels write only the interior. Materials, CPML memories, their duals,
// cotangents and gradients are compact (NZ, NX); the memories stay zero
// outside the strips. Ring cells are int32 indices into the flattened
// padded grid, and a tape row holds the five fields' rings in the order
// vx, vz, sxx, szz, sxz.

#pragma once

#include <cuda_runtime.h>

#include <cstring>

namespace {

// staggered taps over h per axis (zero past R) and dt
struct ETaps {
  float z[4];
  float x[4];
  float dt;
};

struct EMats {
  const float *lam, *l2m, *muxz, *bx, *bz;
};

// strip profiles: az, bz (2, S) along z; ax, bx (2, S) along x
struct EProf {
  const float *az, *bz, *ax, *bx;
};

struct EFields {
  float *vx, *vz, *sxx, *szz, *sxz;
};

__device__ __forceinline__ int e_strip(int z, int n, int S) {
  if (z < S) return z;
  if (z >= n - S) return S + z - (n - S);
  return -1;
}

__device__ __forceinline__ int e_halo(int flat, int NX, int R) {
  const int z = flat / NX;
  return (z + R) * (NX + 2 * R) + flat - z * NX + R;
}

template <int R>
__device__ __forceinline__ float dplus(const float* __restrict__ f, int i, int s,
                                       const float* c) {
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < R; ++k) acc = fmaf(c[k], f[i + (1 + k) * s] - f[i - k * s], acc);
  return acc;
}

template <int R>
__device__ __forceinline__ float dminus(const float* __restrict__ f, int i, int s,
                                        const float* c) {
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < R; ++k) acc = fmaf(c[k], f[i + k * s] - f[i - (1 + k) * s], acc);
  return acc;
}

// one CPML memory: m' = b m + a d; returns d + m'
__device__ __forceinline__ float e_mem(float* __restrict__ m, int c, float a, float b, float d) {
  const float mn = fmaf(b, m[c], a * d);
  m[c] = mn;
  return d + mn;
}

// the dual of one memory: tot = q + dual, dual' = b tot; returns q + a tot
__device__ __forceinline__ float e_dual(float* __restrict__ m, int c, float a, float b, float q) {
  const float tot = q + m[c];
  m[c] = b * tot;
  return fmaf(a, tot, q);
}

// --------------------------------------------------------------- forward

// stage V; mem holds m_sxx_x, m_sxz_z, m_sxz_x, m_szz_z (compact planes)
template <int R>
__global__ void ef_v(EFields f, float* __restrict__ mem, EMats mt, EProf pr, int NZ, int NX,
                     int S, ETaps tp) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= NX || z >= NZ) return;
  const int ld = NX + 2 * R;
  const int i = (z + R) * ld + x + R;
  const int c = z * NX + x;
  const size_t pl = (size_t)NZ * NX;
  float vx_x = dplus<R>(f.sxx, i, 1, tp.x);
  float vx_z = dminus<R>(f.sxz, i, ld, tp.z);
  float vz_x = dminus<R>(f.sxz, i, 1, tp.x);
  float vz_z = dplus<R>(f.szz, i, ld, tp.z);
  const int sx = e_strip(x, NX, S), sz = e_strip(z, NZ, S);
  if (sx >= 0) {
    vx_x = e_mem(mem, c, pr.ax[sx], pr.bx[sx], vx_x);
    vz_x = e_mem(mem + 2 * pl, c, pr.ax[sx], pr.bx[sx], vz_x);
  }
  if (sz >= 0) {
    vx_z = e_mem(mem + pl, c, pr.az[sz], pr.bz[sz], vx_z);
    vz_z = e_mem(mem + 3 * pl, c, pr.az[sz], pr.bz[sz], vz_z);
  }
  f.vx[i] = fmaf(tp.dt * mt.bx[c], vx_x + vx_z, f.vx[i]);
  f.vz[i] = fmaf(tp.dt * mt.bz[c], vz_x + vz_z, f.vz[i]);
}

// stage S; mem holds m_vx_x, m_vz_z, m_vx_z, m_vz_x
template <int R>
__global__ void ef_s(EFields f, float* __restrict__ mem, EMats mt, EProf pr, int NZ, int NX,
                     int S, ETaps tp) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= NX || z >= NZ) return;
  const int ld = NX + 2 * R;
  const int i = (z + R) * ld + x + R;
  const int c = z * NX + x;
  const size_t pl = (size_t)NZ * NX;
  float exx = dminus<R>(f.vx, i, 1, tp.x);
  float ezz = dminus<R>(f.vz, i, ld, tp.z);
  float hz = dplus<R>(f.vx, i, ld, tp.z);
  float hx = dplus<R>(f.vz, i, 1, tp.x);
  const int sx = e_strip(x, NX, S), sz = e_strip(z, NZ, S);
  if (sx >= 0) {
    exx = e_mem(mem, c, pr.ax[sx], pr.bx[sx], exx);
    hx = e_mem(mem + 3 * pl, c, pr.ax[sx], pr.bx[sx], hx);
  }
  if (sz >= 0) {
    ezz = e_mem(mem + pl, c, pr.az[sz], pr.bz[sz], ezz);
    hz = e_mem(mem + 2 * pl, c, pr.az[sz], pr.bz[sz], hz);
  }
  const float l2m = mt.l2m[c], lam = mt.lam[c];
  f.sxx[i] = fmaf(tp.dt, fmaf(l2m, exx, lam * ezz), f.sxx[i]);
  f.szz[i] = fmaf(tp.dt, fmaf(l2m, ezz, lam * exx), f.szz[i]);
  f.sxz[i] = fmaf(tp.dt * mt.muxz[c], hz + hx, f.sxz[i]);
}

// sources, serially in index order (coinciding sources sum in a fixed
// order); sign -1 undoes them
__device__ __forceinline__ void e_src_apply(EFields f, const float* __restrict__ bzm,
                                            const float* __restrict__ w, int t,
                                            const long long* __restrict__ src, int nsrc,
                                            int NX, int R, float dt, int force, float sign) {
  const int ld = NX + 2 * R;
  for (int k = 0; k < nsrc; ++k) {
    const int z = (int)src[2 * k], x = (int)src[2 * k + 1];
    const int i = (z + R) * ld + x + R;
    if (force) {
      f.vz[i] += (sign * dt * bzm[z * NX + x]) * w[t];
    } else {
      const float a = (sign * dt) * w[t];
      f.sxx[i] += a;
      f.szz[i] += a;
    }
  }
}

__global__ void e_src(EFields f, const float* __restrict__ bzm, const float* __restrict__ w,
                      int t, const long long* __restrict__ src, int nsrc, int NX, int R,
                      float dt, int force) {
  if (threadIdx.x == 0 && blockIdx.x == 0) e_src_apply(f, bzm, w, t, src, nsrc, NX, R, dt, force, 1.f);
}

// free-surface images on the halo primals (row fs = grid.pad); the rows
// read and the rows written are disjoint
template <int R>
__global__ void e_image_s(EFields f, int NX, int fs) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (R + 1) * NX) return;
  const int k = idx / NX, x = idx - k * NX;
  const int ld = NX + 2 * R;
  const int col = x + R;
  if (k == R) {
    f.szz[(fs + R) * ld + col] = 0.f;
    return;
  }
  f.szz[(fs - 1 - k + R) * ld + col] = -f.szz[(fs + 1 + k + R) * ld + col];
  f.sxz[(fs - 1 - k + R) * ld + col] = -f.sxz[(fs + k + R) * ld + col];
}

template <int R>
__global__ void e_image_v(EFields f, int NX, int fs) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= R * NX) return;
  const int k = idx / NX, x = idx - k * NX;
  const int ld = NX + 2 * R;
  const int col = x + R;
  f.vx[(fs - 1 - k + R) * ld + col] = f.vx[(fs + 1 + k + R) * ld + col];
  f.vz[(fs - 1 - k + R) * ld + col] = f.vz[(fs + k + R) * ld + col];
}

// receivers into seis row t, then the five fields' rings into ring_row
// (when not null): one thread per receiver or ring cell
__global__ void ef_rec_ring(EFields f, const long long* __restrict__ rcv,
                            float* __restrict__ seis, int t, int nrec, int rec_v,
                            const int* __restrict__ ring, float* __restrict__ ring_row,
                            int n_ring, int NX, int R) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < nrec) {
    const int z = (int)rcv[2 * k], x = (int)rcv[2 * k + 1];
    const int i = (z + R) * (NX + 2 * R) + x + R;
    if (rec_v) {
      const size_t o = 2 * ((size_t)t * nrec + k);
      seis[o] = f.vz[i];
      seis[o + 1] = f.vx[i];
    } else {
      seis[(size_t)t * nrec + k] = -(f.sxx[i] + f.szz[i]) / 2.f;
    }
    return;
  }
  k -= nrec;
  if (ring_row == nullptr || k >= 5 * n_ring) return;
  const int fi = k / n_ring;
  const float* src = fi == 0 ? f.vx : fi == 1 ? f.vz : fi == 2 ? f.sxx : fi == 3 ? f.szz : f.sxz;
  ring_row[k] = src[e_halo(ring[k - fi * n_ring], NX, R)];
}

// --------------------------------------------------------------- reverse

// chain[r] = next receiver with the same cell (-1: none);
// chain[nrec + r] = 1 if r is the first receiver of its cell
__global__ void er_chain(const long long* __restrict__ rcv, int nrec, int* __restrict__ chain) {
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

// receiver-cotangent injection: each cell owned by its first receiver,
// which sums the others in index order; cb = compact vxb, vzb, sxxb, szzb
__global__ void er_inject(EFields cb, const float* __restrict__ ybar, int t,
                          const long long* __restrict__ rcv, const int* __restrict__ chain,
                          int nrec, int NX, int rec_v) {
  for (int r = threadIdx.x; r < nrec; r += blockDim.x) {
    if (!chain[nrec + r]) continue;
    const int c = (int)rcv[2 * r] * NX + (int)rcv[2 * r + 1];
    if (rec_v) {
      const float* yb = ybar + 2 * (size_t)t * nrec;
      float s0 = yb[2 * r], s1 = yb[2 * r + 1];
      for (int n = chain[r]; n >= 0; n = chain[n]) {
        s0 += yb[2 * n];
        s1 += yb[2 * n + 1];
      }
      cb.vz[c] += s0;
      cb.vx[c] += s1;
    } else {
      const float* yb = ybar + (size_t)t * nrec;
      float s = yb[r];
      for (int n = chain[r]; n >= 0; n = chain[n]) s += yb[n];
      cb.sxx[c] += -0.5f * s;
      cb.szz[c] += -0.5f * s;
    }
  }
}

// transposes of the images on the compact cotangents; each thread owns a
// ghost row cell and its mirror
template <int R>
__global__ void er_image_s_t(EFields cb, int NX, int fs) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= R * NX) return;
  const int k = idx / NX, x = idx - k * NX;
  const int g = (fs - 1 - k) * NX + x;
  cb.szz[(fs + 1 + k) * NX + x] -= cb.szz[g];
  cb.szz[g] = 0.f;
  cb.sxz[(fs + k) * NX + x] -= cb.sxz[g];
  cb.sxz[g] = 0.f;
  if (k == 0) cb.szz[fs * NX + x] = 0.f;
}

template <int R>
__global__ void er_image_v_t(EFields cb, int NX, int fs) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= R * NX) return;
  const int k = idx / NX, x = idx - k * NX;
  const int g = (fs - 1 - k) * NX + x;
  cb.vx[(fs + 1 + k) * NX + x] += cb.vx[g];
  cb.vx[g] = 0.f;
  cb.vz[(fs + k) * NX + x] += cb.vz[g];
  cb.vz[g] = 0.f;
}

// the source-point cotangent into srcrow row t ((sxxb + szzb)[src] for a
// pressure source, vzb[src] for a force), then the step's source undone on
// the primal
__global__ void er_src(EFields f, EFields cb, const float* __restrict__ bzm,
                       const float* __restrict__ w, int t, const long long* __restrict__ src,
                       int nsrc, float* __restrict__ srcrow, int NX, int R, float dt,
                       int force) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  for (int k = 0; k < nsrc; ++k) {
    const int c = (int)src[2 * k] * NX + (int)src[2 * k + 1];
    srcrow[(size_t)t * nsrc + k] = force ? cb.vz[c] : cb.sxx[c] + cb.szz[c];
  }
  e_src_apply(f, bzm, w, t, src, nsrc, NX, R, dt, force, -1.f);
}

// R-S, one thread per cell: strains of the carried v, sigma_t
// reconstructed in place, imaging, and the dbar planes of the transposed
// stress update (q: exx, ezz, D+z vx, D+x vz); dual: the duals of
// m_vx_x, m_vz_z, m_vx_z, m_vz_x; g: glam, gl2m, gmuxz planes
template <int R>
__global__ void er_s1(EFields f, EFields cb, float* __restrict__ dual, EFields q,
                      float* __restrict__ g, EMats mt, EProf pr, int NZ, int NX, int S,
                      ETaps tp) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= NX || z >= NZ) return;
  const int ld = NX + 2 * R;
  const int i = (z + R) * ld + x + R;
  const int c = z * NX + x;
  const size_t pl = (size_t)NZ * NX;
  const float dt = tp.dt;
  const float exx = dminus<R>(f.vx, i, 1, tp.x);
  const float ezz = dminus<R>(f.vz, i, ld, tp.z);
  const float hz = dplus<R>(f.vx, i, ld, tp.z);
  const float hx = dplus<R>(f.vz, i, 1, tp.x);
  const float l2m = mt.l2m[c], lam = mt.lam[c], mu = mt.muxz[c];
  f.sxx[i] -= dt * fmaf(l2m, exx, lam * ezz);
  f.szz[i] -= dt * fmaf(l2m, ezz, lam * exx);
  f.sxz[i] -= dt * mu * (hz + hx);

  const float sb = cb.sxx[c], zb = cb.szz[c], xb = cb.sxz[c];
  const int sx = e_strip(x, NX, S), sz = e_strip(z, NZ, S);
  // the strains at zero memory: (1 + a) d on the strips
  float exe = exx, eze = ezz, hze = hz, hxe = hx;
  if (sx >= 0) {
    exe = fmaf(pr.ax[sx], exx, exx);
    hxe = fmaf(pr.ax[sx], hx, hx);
  }
  if (sz >= 0) {
    eze = fmaf(pr.az[sz], ezz, ezz);
    hze = fmaf(pr.az[sz], hz, hz);
  }
  g[c] = fmaf(dt, fmaf(eze, sb, exe * zb), g[c]);            // lam
  g[pl + c] = fmaf(dt, fmaf(exe, sb, eze * zb), g[pl + c]);  // l2m
  g[2 * pl + c] = fmaf(dt * (hze + hxe), xb, g[2 * pl + c]); // muxz

  float qexx = dt * fmaf(l2m, sb, lam * zb);
  float qezz = dt * fmaf(l2m, zb, lam * sb);
  float qhz = dt * mu * xb, qhx = qhz;
  if (sx >= 0) {
    qexx = e_dual(dual, c, pr.ax[sx], pr.bx[sx], qexx);
    qhx = e_dual(dual + 3 * pl, c, pr.ax[sx], pr.bx[sx], qhx);
  }
  if (sz >= 0) {
    qezz = e_dual(dual + pl, c, pr.az[sz], pr.bz[sz], qezz);
    qhz = e_dual(dual + 2 * pl, c, pr.az[sz], pr.bz[sz], qhz);
  }
  q.vx[i] = qexx;
  q.vz[i] = qezz;
  q.sxx[i] = qhz;
  q.szz[i] = qhx;
}

// the transposed stress update's stencils: vxb += -D+x q_exx - D-z q_hz,
// vzb += -D+z q_ezz - D-x q_hx
template <int R>
__global__ void er_s2(EFields cb, EFields q, int NZ, int NX, ETaps tp) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= NX || z >= NZ) return;
  const int ld = NX + 2 * R;
  const int i = (z + R) * ld + x + R;
  const int c = z * NX + x;
  cb.vx[c] -= dplus<R>(q.vx, i, 1, tp.x) + dminus<R>(q.sxx, i, ld, tp.z);
  cb.vz[c] -= dplus<R>(q.vz, i, ld, tp.z) + dminus<R>(q.szz, i, 1, tp.x);
}

// R-V, one thread per cell: stress derivatives of sigma_t, v_{t-1/2}
// reconstructed in place, imaging of bx, bz (g planes 3 and 4), and the
// dbar planes of the transposed velocity update (q: D+x sxx, D-z sxz,
// D-x sxz, D+z szz); dual: the duals of m_sxx_x, m_sxz_z, m_sxz_x, m_szz_z
template <int R>
__global__ void er_v1(EFields f, EFields cb, float* __restrict__ dual, EFields q,
                      float* __restrict__ g, EMats mt, EProf pr, int NZ, int NX, int S,
                      ETaps tp) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= NX || z >= NZ) return;
  const int ld = NX + 2 * R;
  const int i = (z + R) * ld + x + R;
  const int c = z * NX + x;
  const size_t pl = (size_t)NZ * NX;
  const float dt = tp.dt;
  const float a1 = dplus<R>(f.sxx, i, 1, tp.x);    // -> vx
  const float a2 = dminus<R>(f.sxz, i, ld, tp.z);  // -> vx
  const float b1 = dminus<R>(f.sxz, i, 1, tp.x);   // -> vz
  const float b2 = dplus<R>(f.szz, i, ld, tp.z);   // -> vz
  const float bxm = mt.bx[c], bzm = mt.bz[c];
  f.vx[i] -= dt * bxm * (a1 + a2);
  f.vz[i] -= dt * bzm * (b1 + b2);

  const float vb = cb.vx[c], wb = cb.vz[c];
  const int sx = e_strip(x, NX, S), sz = e_strip(z, NZ, S);
  float a1e = a1, a2e = a2, b1e = b1, b2e = b2;
  if (sx >= 0) {
    a1e = fmaf(pr.ax[sx], a1, a1);
    b1e = fmaf(pr.ax[sx], b1, b1);
  }
  if (sz >= 0) {
    a2e = fmaf(pr.az[sz], a2, a2);
    b2e = fmaf(pr.az[sz], b2, b2);
  }
  g[3 * pl + c] = fmaf(dt * (a1e + a2e), vb, g[3 * pl + c]);
  g[4 * pl + c] = fmaf(dt * (b1e + b2e), wb, g[4 * pl + c]);

  const float ux = dt * bxm * vb, uz = dt * bzm * wb;
  float q1 = ux, q2 = ux, q3 = uz, q4 = uz;
  if (sx >= 0) {
    q1 = e_dual(dual, c, pr.ax[sx], pr.bx[sx], q1);
    q3 = e_dual(dual + 2 * pl, c, pr.ax[sx], pr.bx[sx], q3);
  }
  if (sz >= 0) {
    q2 = e_dual(dual + pl, c, pr.az[sz], pr.bz[sz], q2);
    q4 = e_dual(dual + 3 * pl, c, pr.az[sz], pr.bz[sz], q4);
  }
  q.vx[i] = q1;
  q.vz[i] = q2;
  q.sxx[i] = q3;
  q.szz[i] = q4;
}

// sxxb += -D-x q1; szzb += -D-z q4; sxzb += -D+z q2 - D+x q3
template <int R>
__global__ void er_v2(EFields cb, EFields q, int NZ, int NX, ETaps tp) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= NX || z >= NZ) return;
  const int ld = NX + 2 * R;
  const int i = (z + R) * ld + x + R;
  const int c = z * NX + x;
  cb.sxx[c] -= dminus<R>(q.vx, i, 1, tp.x);
  cb.szz[c] -= dminus<R>(q.szz, i, ld, tp.z);
  cb.sxz[c] -= dplus<R>(q.vz, i, ld, tp.z) + dplus<R>(q.sxx, i, 1, tp.x);
}

// nf consecutive ring rows (n_ring cells each) imposed on fields a, b, c
// (the first nf of them), from row or zeros when row is null
__global__ void e_impose(float* a, float* b, float* c, int nf, const int* __restrict__ ring,
                         const float* __restrict__ row, int n_ring, int NX, int R) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= nf * n_ring) return;
  const int fi = k / n_ring;
  float* dst = fi == 0 ? a : fi == 1 ? b : c;
  dst[e_halo(ring[k - fi * n_ring], NX, R)] = row ? row[k] : 0.f;
}

// ------------------------------------------------------------ launch shapes

const dim3 kECellBlock(32, 8);
const int kESmallBlock = 256;

inline dim3 e_cell_grid(int NZ, int NX) {
  return dim3((NX + kECellBlock.x - 1) / kECellBlock.x, (NZ + kECellBlock.y - 1) / kECellBlock.y);
}

inline int e_blocks(int n) { return (n + kESmallBlock - 1) / kESmallBlock; }

inline ETaps load_etaps(const float* host) {
  ETaps tp;
  std::memcpy(&tp, host, sizeof(ETaps));
  return tp;
}

// ------------------------------------------------------------ stage launches
//
// One host function per TPU call of the per-step engine, each with the glue
// the reference runs around that call as XLA ops. A forward step is
// estage_v then estage_s, a reverse step estage_rs then estage_rv, in the
// whole-scan loops (elastic2d_scan.cu) and behind the per-step entry points
// (elastic2d_step.cu) alike, so the two engines launch the same kernels in
// the same order. mem: 8 compact CPML memory planes, stage V's four then
// stage S's four; dual: 8 compact dual planes, R-S's four then R-V's four.

// Stage V (TPU kernel 10a), then the mid-step velocity image. mem: the 8
// memory planes; stage V updates planes 0-3.
template <int R>
void estage_v(EFields f, float* mem, EMats mt, EProf pr, int NZ, int NX, int S, int fs,
              const ETaps& tp, cudaStream_t st) {
  ef_v<R><<<e_cell_grid(NZ, NX), kECellBlock, 0, st>>>(f, mem, mt, pr, NZ, NX, S, tp);
  if (fs >= 0) e_image_v<R><<<e_blocks(R * NX), kESmallBlock, 0, st>>>(f, NX, fs);
}

// Stage S (10b) on planes 4-7 of mem, then the step's sources, the stress
// image, the receivers into seis row t and (when ring_row is not null) the
// five fields' rings into ring_row.
template <int R>
void estage_s(EFields f, float* mem, EMats mt, EProf pr, const float* w, int t,
              const long long* src, int nsrc, const long long* rcv, int nrec, float* seis,
              const int* ring, float* ring_row, int n_ring, int NZ, int NX, int S, int fs,
              int force, int rec_v, const ETaps& tp, cudaStream_t st) {
  const size_t pl = (size_t)NZ * NX;
  ef_s<R><<<e_cell_grid(NZ, NX), kECellBlock, 0, st>>>(f, mem + 4 * pl, mt, pr, NZ, NX, S, tp);
  e_src<<<1, 1, 0, st>>>(f, mt.bz, w, t, src, nsrc, NX, R, tp.dt, force);
  if (fs >= 0) e_image_s<R><<<e_blocks((R + 1) * NX), kESmallBlock, 0, st>>>(f, NX, fs);
  const int n_out = nrec + (ring_row ? 5 * n_ring : 0);
  ef_rec_ring<<<e_blocks(n_out), kESmallBlock, 0, st>>>(f, rcv, seis, t, nrec, rec_v, ring,
                                                        ring_row, n_ring, NX, R);
}

// Reverse step t, first half (the order in the header comment): the
// receiver-cotangent injection, the stress-image transpose, the
// source-point cotangent and the source undone on the primal (once: the
// reference undoes a force on local copies of vz in both of its reverse
// kernels), R-S (11a) with the stress rings of ring_row (tape row t-1;
// zeros when null) imposed and re-imaged, and the velocity-image
// transpose. cb: compact cotangents; dual: the 8 dual planes, R-S updates
// planes 0-3; q: four zero-halo dbar planes in the vx..szz slots; g: 5
// compact gradient planes (lam, l2m, muxz, bx, bz).
template <int R>
void estage_rs(EFields f, EFields cb, float* dual, EFields q, float* g, EMats mt, EProf pr,
               const float* w, const float* ybar, int t, const long long* src, int nsrc,
               const long long* rcv, int nrec, const int* chain, float* srcrow,
               const int* ring, const float* ring_row, int n_ring, int NZ, int NX, int S,
               int fs, int force, int rec_v, const ETaps& tp, cudaStream_t st) {
  er_inject<<<1, kESmallBlock, 0, st>>>(cb, ybar, t, rcv, chain, nrec, NX, rec_v);
  if (fs >= 0) er_image_s_t<R><<<e_blocks(R * NX), kESmallBlock, 0, st>>>(cb, NX, fs);
  er_src<<<1, 1, 0, st>>>(f, cb, mt.bz, w, t, src, nsrc, srcrow, NX, R, tp.dt, force);
  er_s1<R><<<e_cell_grid(NZ, NX), kECellBlock, 0, st>>>(f, cb, dual, q, g, mt, pr, NZ, NX, S,
                                                        tp);
  e_impose<<<e_blocks(3 * n_ring), kESmallBlock, 0, st>>>(
      f.sxx, f.szz, f.sxz, 3, ring, ring_row ? ring_row + 2 * n_ring : nullptr, n_ring, NX, R);
  if (fs >= 0) e_image_s<R><<<e_blocks((R + 1) * NX), kESmallBlock, 0, st>>>(f, NX, fs);
  er_s2<R><<<e_cell_grid(NZ, NX), kECellBlock, 0, st>>>(cb, q, NZ, NX, tp);
  if (fs >= 0) er_image_v_t<R><<<e_blocks(R * NX), kESmallBlock, 0, st>>>(cb, NX, fs);
}

// Reverse step t, second half: R-V (11b) on dual planes 4-7, with the
// velocity rings of ring_row imposed and re-imaged.
template <int R>
void estage_rv(EFields f, EFields cb, float* dual, EFields q, float* g, EMats mt, EProf pr,
               const int* ring, const float* ring_row, int n_ring, int NZ, int NX, int S,
               int fs, const ETaps& tp, cudaStream_t st) {
  const size_t pl = (size_t)NZ * NX;
  er_v1<R><<<e_cell_grid(NZ, NX), kECellBlock, 0, st>>>(f, cb, dual + 4 * pl, q, g, mt, pr, NZ,
                                                        NX, S, tp);
  e_impose<<<e_blocks(2 * n_ring), kESmallBlock, 0, st>>>(f.vx, f.vz, nullptr, 2, ring,
                                                          ring_row, n_ring, NX, R);
  if (fs >= 0) e_image_v<R><<<e_blocks(R * NX), kESmallBlock, 0, st>>>(f, NX, fs);
  er_v2<R><<<e_cell_grid(NZ, NX), kECellBlock, 0, st>>>(cb, q, NZ, NX, tp);
}

}  // namespace

// R is a template parameter of every stencil kernel; dispatch the orders
// the port supports (2, 4 and 8)
#define TPUFWI_EDISPATCH_R(R, CALL)                 \
  switch (R) {                                      \
    case 1: { constexpr int kR = 1; return CALL; }  \
    case 2: { constexpr int kR = 2; return CALL; }  \
    case 4: { constexpr int kR = 4; return CALL; }  \
    default: return (int)cudaErrorInvalidValue;     \
  }
