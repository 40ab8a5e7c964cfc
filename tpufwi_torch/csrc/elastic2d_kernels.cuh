// Device code of the 2D elastic P-SV engines for Hopper (sm_90a): the
// per-step kernels and the host functions that launch one stage of a
// forward or reverse time step on a stream (estage_v, estage_s, estage_rs,
// estage_rv; estage_rfused, a whole reverse step on the fused passes). The
// whole-scan loops (elastic2d_scan.cu) and the per-step entry points
// (elastic2d_step.cu) include it. Every kernel has internal linkage.
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
// over dbar values that are zero outside the grid, never atomics, so the
// result is deterministic. The per-step engine's passes keep the dbar
// values in four zero-halo planes in device memory; the whole-scan engine's
// fused passes keep them in a shared-memory tile. Those run step t as two
// launches, er_s (the glue before R-S, R-S with its stress rings, the
// stress image and the velocity-image transpose) and er_v (R-V with its
// velocity rings, the velocity image, and step t-1's glue up to R-S:
// a force source undone, the p receivers' cotangents, the stress-image
// transpose); with the free surface their tile rows are shifted so that
// one tile row holds every ghost row and its mirrors, and runs the images.
// All arithmetic is fp32 (FMA); no tensor cores.
//
// Layout: the five primal fields and the per-step passes' four dbar planes
// are stored with a zero halo of R cells on each side ((NZ+2R) x (NX+2R),
// row stride NX+2R); kernels write only the interior. Materials, CPML
// memories, their duals, cotangents and gradients are compact (NZ, NX); the
// memories stay zero outside the strips. Ring cells are int32 indices into
// the flattened padded grid, and a tape row holds the five fields' rings in
// the order vx, vz, sxx, szz, sxz.

#pragma once

#include <cuda_runtime.h>

#include <cstring>

#include "cell_maps.cuh"  // SMaps, carve_maps, cell_map_entry
#include "pdl.cuh"        // dep_wait, dep_trigger, launch_dep

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

// one CPML memory: m' = b m + a d (in place); returns d + m'
__device__ __forceinline__ float e_mem(float& m, float a, float b, float d) {
  m = fmaf(b, m, a * d);
  return d + m;
}

// the dual of one memory: tot = q + din, dual' = b tot into dout (kWrite;
// dout may be din); returns q + a tot
template <bool kWrite>
__device__ __forceinline__ float e_dual(const float* din, float* dout, int c, float a, float b,
                                        float q) {
  const float tot = q + din[c];
  if (kWrite) dout[c] = b * tot;
  return fmaf(a, tot, q);
}

// --------------------------------------------------------------- forward

// The forward cell bodies, one arithmetic for the per-step passes (ef_v, ef_s,
// e_src) and the fused one (ef_s_fused): every product that could contract
// into an FMA is fused or rounded explicitly, so the two agree bitwise.

// stage V at one cell from its stress derivatives (vx_x = D+x sxx, vx_z =
// D-z sxz, vz_x = D-x sxz, vz_z = D+z szz): on the strips the memories m
// (m_sxx_x, m_sxz_z, m_sxz_x, m_szz_z) in place, then v in place
__device__ __forceinline__ void ev_cell(float vx_x, float vx_z, float vz_x, float vz_z,
                                        float m[4], int sx, int sz, const EProf& pr, float dtbx,
                                        float dtbz, float& vx, float& vz) {
  if (sx >= 0) {
    vx_x = e_mem(m[0], pr.ax[sx], pr.bx[sx], vx_x);
    vz_x = e_mem(m[2], pr.ax[sx], pr.bx[sx], vz_x);
  }
  if (sz >= 0) {
    vx_z = e_mem(m[1], pr.az[sz], pr.bz[sz], vx_z);
    vz_z = e_mem(m[3], pr.az[sz], pr.bz[sz], vz_z);
  }
  vx = fmaf(dtbx, vx_x + vx_z, vx);
  vz = fmaf(dtbz, vz_x + vz_z, vz);
}

// stage S at one cell from its velocity derivatives (exx = D-x vx, ezz =
// D-z vz, hz = D+z vx, hx = D+x vz): on the strips the memories m (m_vx_x,
// m_vz_z, m_vx_z, m_vz_x) in place, then the stresses in place
__device__ __forceinline__ void es_cell(float exx, float ezz, float hz, float hx, float m[4],
                                        int sx, int sz, const EProf& pr, float dt, float lam,
                                        float l2m, float mu, float& sxx, float& szz,
                                        float& sxz) {
  if (sx >= 0) {
    exx = e_mem(m[0], pr.ax[sx], pr.bx[sx], exx);
    hx = e_mem(m[3], pr.ax[sx], pr.bx[sx], hx);
  }
  if (sz >= 0) {
    ezz = e_mem(m[1], pr.az[sz], pr.bz[sz], ezz);
    hz = e_mem(m[2], pr.az[sz], pr.bz[sz], hz);
  }
  sxx = fmaf(dt, fmaf(l2m, exx, lam * ezz), sxx);
  szz = fmaf(dt, fmaf(l2m, ezz, lam * exx), szz);
  sxz = fmaf(dt * mu, hz + hx, sxz);
}

// one source at its cell: a pressure source dt w on sxx and szz, a force
// dt bz w on vz; sign -1 undoes it
__device__ __forceinline__ void e_src_cell(float& vz, float& sxx, float& szz, float bzc, float wt,
                                           float dt, int force, float sign) {
  if (force) {
    vz = fmaf(sign * dt * bzc, wt, vz);
  } else {
    const float a = __fmul_rn(sign * dt, wt);
    sxx += a;
    szz += a;
  }
}

// the four memories of a compact cell c (planes pl apart), read on the
// strips (zero elsewhere) and written back there
__device__ __forceinline__ void e_mem_load(const float* __restrict__ mem, int c, size_t pl,
                                           int sx, int sz, float m[4], int x0, int x2, int z1,
                                           int z3) {
  // (x0, x2): the slots of the x strips' memories, (z1, z3): the z strips'
  m[0] = m[1] = m[2] = m[3] = 0.f;
  if (sx >= 0) {
    m[x0] = mem[x0 * pl + c];
    m[x2] = mem[x2 * pl + c];
  }
  if (sz >= 0) {
    m[z1] = mem[z1 * pl + c];
    m[z3] = mem[z3 * pl + c];
  }
}

__device__ __forceinline__ void e_mem_store(float* __restrict__ mem, int c, size_t pl, int sx,
                                            int sz, const float m[4], int x0, int x2, int z1,
                                            int z3) {
  if (sx >= 0) {
    mem[x0 * pl + c] = m[x0];
    mem[x2 * pl + c] = m[x2];
  }
  if (sz >= 0) {
    mem[z1 * pl + c] = m[z1];
    mem[z3 * pl + c] = m[z3];
  }
}

// the force sources that the fused forward's stage V adds, at its own
// cells, to vz before its update: those of the step before (the per-step
// adds them after its stage S, where the fused one cannot, since other
// tiles read vz in that launch); flags (null: none) is a word per block
// of ef_v (kEVX x kEVY cells), 1 where one of its cells holds a source;
// w[t] the sources' wavelet value
struct EVSrc {
  const int *flags, *smap, *snext;
  const float* w;
  int t;
};

constexpr int kEVX = 32, kEVY = 8;  // ef_v's block: kECellBlock

// stage V in place; mem holds m_sxx_x, m_sxz_z, m_sxz_x, m_szz_z (compact
// planes): the x strips' in slots 0 and 2, the z strips' in 1 and 3
template <int R>
__global__ void ef_v(EFields f, float* __restrict__ mem, EMats mt, EProf pr, int NZ, int NX,
                     int S, ETaps tp, EVSrc src) {
  dep_wait();
  dep_trigger();
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= NX || z >= NZ) return;
  const int ld = NX + 2 * R;
  const int i = (z + R) * ld + x + R;
  const int c = z * NX + x;
  const size_t pl = (size_t)NZ * NX;
  const int sx = e_strip(x, NX, S), sz = e_strip(z, NZ, S);
  float m[4];
  e_mem_load(mem, c, pl, sx, sz, m, 0, 2, 1, 3);
  float vx = f.vx[i], vz = f.vz[i];
  if (src.flags != nullptr && (src.flags[blockIdx.y * gridDim.x + blockIdx.x] & 1)) {
    float unused = 0.f;
    for (int k = src.smap[c] - 1; k >= 0; k = src.snext[k])
      e_src_cell(vz, unused, unused, mt.bz[c], src.w[src.t], tp.dt, 1, 1.f);
  }
  ev_cell(dplus<R>(f.sxx, i, 1, tp.x), dminus<R>(f.sxz, i, ld, tp.z),
          dminus<R>(f.sxz, i, 1, tp.x), dplus<R>(f.szz, i, ld, tp.z), m, sx, sz, pr,
          tp.dt * mt.bx[c], tp.dt * mt.bz[c], vx, vz);
  f.vx[i] = vx;
  f.vz[i] = vz;
  e_mem_store(mem, c, pl, sx, sz, m, 0, 2, 1, 3);
}

// stage S; mem holds m_vx_x, m_vz_z, m_vx_z, m_vz_x: the x strips' in
// slots 0 and 3, the z strips' in 1 and 2
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
  const int sx = e_strip(x, NX, S), sz = e_strip(z, NZ, S);
  float m[4];
  e_mem_load(mem, c, pl, sx, sz, m, 0, 3, 1, 2);
  es_cell(dminus<R>(f.vx, i, 1, tp.x), dminus<R>(f.vz, i, ld, tp.z), dplus<R>(f.vx, i, ld, tp.z),
          dplus<R>(f.vz, i, 1, tp.x), m, sx, sz, pr, tp.dt, mt.lam[c], mt.l2m[c], mt.muxz[c],
          f.sxx[i], f.szz[i], f.sxz[i]);
  e_mem_store(mem, c, pl, sx, sz, m, 0, 3, 1, 2);
}

// receiver k of seis row t: (vz, vx) for a v record, else -(sxx + szz) / 2
__device__ __forceinline__ void e_record(float* __restrict__ seis, int t, int nrec, int k,
                                         int rec_v, float vx, float vz, float sxx, float szz) {
  if (rec_v) {
    const size_t o = 2 * ((size_t)t * nrec + k);
    seis[o] = vz;
    seis[o + 1] = vx;
  } else {
    seis[(size_t)t * nrec + k] = -(sxx + szz) / 2.f;
  }
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
    e_src_cell(f.vz[i], f.sxx[i], f.szz[i], bzm[z * NX + x], w[t], dt, force, sign);
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
__device__ __forceinline__ void e_image_s_cell(EFields f, int NX, int fs, int idx) {
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
__global__ void e_image_s(EFields f, int NX, int fs) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < (R + 1) * NX) e_image_s_cell<R>(f, NX, fs, idx);
}

template <int R>
__device__ __forceinline__ void e_image_v_cell(EFields f, int NX, int fs, int idx) {
  const int k = idx / NX, x = idx - k * NX;
  const int ld = NX + 2 * R;
  const int col = x + R;
  f.vx[(fs - 1 - k + R) * ld + col] = f.vx[(fs + 1 + k + R) * ld + col];
  f.vz[(fs - 1 - k + R) * ld + col] = f.vz[(fs + k + R) * ld + col];
}

template <int R>
__global__ void e_image_v(EFields f, int NX, int fs) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < R * NX) e_image_v_cell<R>(f, NX, fs, idx);
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
    e_record(seis, t, nrec, k, rec_v, f.vx[i], f.vz[i], f.sxx[i], f.szz[i]);
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

// receiver-cotangent injection by the threads [tid, nthreads) of one block:
// each cell owned by its first receiver, which sums the others in index
// order; cb = compact vxb, vzb, sxxb, szzb
__device__ __forceinline__ void er_inject_rows(EFields cb, const float* __restrict__ ybar, int t,
                                               const long long* __restrict__ rcv,
                                               const int* __restrict__ chain, int nrec, int NX,
                                               int rec_v, int tid, int nthreads) {
  for (int r = tid; r < nrec; r += nthreads) {
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

__global__ void er_inject(EFields cb, const float* __restrict__ ybar, int t,
                          const long long* __restrict__ rcv, const int* __restrict__ chain,
                          int nrec, int NX, int rec_v) {
  er_inject_rows(cb, ybar, t, rcv, chain, nrec, NX, rec_v, threadIdx.x, blockDim.x);
}

// transposes of the images on the compact cotangents; each cell idx < R NX
// owns a ghost row cell and its mirror
template <int R>
__device__ __forceinline__ void er_image_s_t_cell(EFields cb, int NX, int fs, int idx) {
  const int k = idx / NX, x = idx - k * NX;
  const int g = (fs - 1 - k) * NX + x;
  cb.szz[(fs + 1 + k) * NX + x] -= cb.szz[g];
  cb.szz[g] = 0.f;
  cb.sxz[(fs + k) * NX + x] -= cb.sxz[g];
  cb.sxz[g] = 0.f;
  if (k == 0) cb.szz[fs * NX + x] = 0.f;
}

template <int R>
__global__ void er_image_s_t(EFields cb, int NX, int fs) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < R * NX) er_image_s_t_cell<R>(cb, NX, fs, idx);
}

template <int R>
__device__ __forceinline__ void er_image_v_t_cell(EFields cb, int NX, int fs, int idx) {
  const int k = idx / NX, x = idx - k * NX;
  const int g = (fs - 1 - k) * NX + x;
  cb.vx[(fs + 1 + k) * NX + x] += cb.vx[g];
  cb.vx[g] = 0.f;
  cb.vz[(fs + k) * NX + x] += cb.vz[g];
  cb.vz[g] = 0.f;
}

template <int R>
__global__ void er_image_v_t(EFields cb, int NX, int fs) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < R * NX) er_image_v_t_cell<R>(cb, NX, fs, idx);
}

// the source-point cotangent into srcrow row t ((sxxb + szzb)[src] for a
// pressure source, vzb[src] for a force), then the step's source undone on
// the primal; one thread
__device__ __forceinline__ void er_src_cells(EFields f, EFields cb, const float* __restrict__ bzm,
                                             const float* __restrict__ w, int t,
                                             const long long* __restrict__ src, int nsrc,
                                             float* __restrict__ srcrow, int NX, int R, float dt,
                                             int force) {
  for (int k = 0; k < nsrc; ++k) {
    const int c = (int)src[2 * k] * NX + (int)src[2 * k + 1];
    srcrow[(size_t)t * nsrc + k] = force ? cb.vz[c] : cb.sxx[c] + cb.szz[c];
  }
  e_src_apply(f, bzm, w, t, src, nsrc, NX, R, dt, force, -1.f);
}

__global__ void er_src(EFields f, EFields cb, const float* __restrict__ bzm,
                       const float* __restrict__ w, int t, const long long* __restrict__ src,
                       int nsrc, float* __restrict__ srcrow, int NX, int R, float dt,
                       int force) {
  if (threadIdx.x == 0 && blockIdx.x == 0)
    er_src_cells(f, cb, bzm, w, t, src, nsrc, srcrow, NX, R, dt, force);
}

// The reverse cell bodies, one arithmetic for the per-step passes (er_s1 +
// er_s2, er_v1 + er_v2) and the fused ones (er_s, er_v): products that
// could contract into an FMA are fused or rounded explicitly (fmaf,
// __fmul_rn), so the two agree bitwise however each is compiled.

// R-S at one cell: the dbar values of the transposed stress update, q =
// (exx, ezz, D+z vx, D+x vz), from the stress cotangents sb, zb, xb
// through the duals of m_vx_x, m_vz_z, m_vx_z, m_vz_x (read from din,
// written to dout when kWrite)
template <bool kWrite>
__device__ __forceinline__ void rs_dbar(float sb, float zb, float xb, float lam, float l2m,
                                        float mu, const float* din, float* dout, int c,
                                        size_t pl, int sx, int sz, const EProf& pr, float dt,
                                        float q[4]) {
  q[0] = dt * fmaf(l2m, sb, lam * zb);
  q[1] = dt * fmaf(l2m, zb, lam * sb);
  q[2] = __fmul_rn(dt, mu) * xb;
  q[3] = q[2];
  if (sx >= 0) {
    q[0] = e_dual<kWrite>(din, dout, c, pr.ax[sx], pr.bx[sx], q[0]);
    q[3] = e_dual<kWrite>(din + 3 * pl, dout + 3 * pl, c, pr.ax[sx], pr.bx[sx], q[3]);
  }
  if (sz >= 0) {
    q[1] = e_dual<kWrite>(din + pl, dout + pl, c, pr.az[sz], pr.bz[sz], q[1]);
    q[2] = e_dual<kWrite>(din + 2 * pl, dout + 2 * pl, c, pr.az[sz], pr.bz[sz], q[2]);
  }
}

// R-S at one cell from the strains of the carried v: sigma_t
// reconstructed (sxx, szz, sxz in place) and the imaging of lam, l2m, muxz
// (g0, g1, g2 in place)
__device__ __forceinline__ void rs_cell(float exx, float ezz, float hz, float hx, float sb,
                                        float zb, float xb, float lam, float l2m, float mu,
                                        int sx, int sz, const EProf& pr, float dt, float& sxx,
                                        float& szz, float& sxz, float& g0, float& g1,
                                        float& g2) {
  sxx = fmaf(-dt, fmaf(l2m, exx, lam * ezz), sxx);
  szz = fmaf(-dt, fmaf(l2m, ezz, lam * exx), szz);
  sxz = fmaf(-__fmul_rn(dt, mu), hz + hx, sxz);
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
  g0 = fmaf(dt, fmaf(eze, sb, exe * zb), g0);      // lam
  g1 = fmaf(dt, fmaf(exe, sb, eze * zb), g1);      // l2m
  g2 = fmaf(__fmul_rn(dt, hze + hxe), xb, g2);     // muxz
}

// the transposed stress update's stencils over dbar planes q (row stride
// ld, index s): vxb += -D+x q_exx - D-z q_hz, vzb += -D+z q_ezz - D-x q_hx
template <int R>
__device__ __forceinline__ void rs_trans(const float* qexx, const float* qezz, const float* qhz,
                                         const float* qhx, int s, int ld, const ETaps& tp,
                                         float& vxb, float& vzb) {
  vxb -= dplus<R>(qexx, s, 1, tp.x) + dminus<R>(qhz, s, ld, tp.z);
  vzb -= dplus<R>(qezz, s, ld, tp.z) + dminus<R>(qhx, s, 1, tp.x);
}

// R-V at one cell: the dbar values of the transposed velocity update, q =
// (D+x sxx, D-z sxz, D-x sxz, D+z szz), from vb, wb through the duals of
// m_sxx_x, m_sxz_z, m_sxz_x, m_szz_z
template <bool kWrite>
__device__ __forceinline__ void rv_dbar(float vb, float wb, float bxm, float bzm, const float* din,
                                        float* dout, int c, size_t pl, int sx, int sz,
                                        const EProf& pr, float dt, float q[4]) {
  const float ux = __fmul_rn(dt, bxm) * vb, uz = __fmul_rn(dt, bzm) * wb;
  q[0] = q[1] = ux;
  q[2] = q[3] = uz;
  if (sx >= 0) {
    q[0] = e_dual<kWrite>(din, dout, c, pr.ax[sx], pr.bx[sx], q[0]);
    q[2] = e_dual<kWrite>(din + 2 * pl, dout + 2 * pl, c, pr.ax[sx], pr.bx[sx], q[2]);
  }
  if (sz >= 0) {
    q[1] = e_dual<kWrite>(din + pl, dout + pl, c, pr.az[sz], pr.bz[sz], q[1]);
    q[3] = e_dual<kWrite>(din + 3 * pl, dout + 3 * pl, c, pr.az[sz], pr.bz[sz], q[3]);
  }
}

// R-V at one cell from the stress derivatives of sigma_t (a1 = D+x sxx,
// a2 = D-z sxz -> vx; b1 = D-x sxz, b2 = D+z szz -> vz): v_{t-1/2}
// reconstructed (vx, vz in place) and the imaging of bx, bz (g3, g4)
__device__ __forceinline__ void rv_cell(float a1, float a2, float b1, float b2, float vb,
                                        float wb, float bxm, float bzm, int sx, int sz,
                                        const EProf& pr, float dt, float& vx, float& vz,
                                        float& g3, float& g4) {
  vx = fmaf(-__fmul_rn(dt, bxm), a1 + a2, vx);
  vz = fmaf(-__fmul_rn(dt, bzm), b1 + b2, vz);
  float a1e = a1, a2e = a2, b1e = b1, b2e = b2;
  if (sx >= 0) {
    a1e = fmaf(pr.ax[sx], a1, a1);
    b1e = fmaf(pr.ax[sx], b1, b1);
  }
  if (sz >= 0) {
    a2e = fmaf(pr.az[sz], a2, a2);
    b2e = fmaf(pr.az[sz], b2, b2);
  }
  g3 = fmaf(__fmul_rn(dt, a1e + a2e), vb, g3);
  g4 = fmaf(__fmul_rn(dt, b1e + b2e), wb, g4);
}

// sxxb += -D-x q1; szzb += -D-z q4; sxzb += -D+z q2 - D+x q3
template <int R>
__device__ __forceinline__ void rv_trans(const float* q1, const float* q2, const float* q3,
                                         const float* q4, int s, int ld, const ETaps& tp,
                                         float& sxxb, float& szzb, float& sxzb) {
  sxxb -= dminus<R>(q1, s, 1, tp.x);
  szzb -= dminus<R>(q4, s, ld, tp.z);
  sxzb -= dplus<R>(q2, s, ld, tp.z) + dplus<R>(q3, s, 1, tp.x);
}

// ---- the per-step engine's passes: one thread a cell, the dbar planes
// through device memory

// R-S, first pass: strains of the carried v, sigma_t reconstructed in
// place, imaging, and the four zero-halo dbar planes q (exx, ezz, D+z vx,
// D+x vz in the vx..szz slots); dual: the 4 duals, updated in place; g:
// glam, gl2m, gmuxz planes
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
  const float exx = dminus<R>(f.vx, i, 1, tp.x);
  const float ezz = dminus<R>(f.vz, i, ld, tp.z);
  const float hz = dplus<R>(f.vx, i, ld, tp.z);
  const float hx = dplus<R>(f.vz, i, 1, tp.x);
  const float sb = cb.sxx[c], zb = cb.szz[c], xb = cb.sxz[c];
  const float lam = mt.lam[c], l2m = mt.l2m[c], mu = mt.muxz[c];
  const int sx = e_strip(x, NX, S), sz = e_strip(z, NZ, S);
  rs_cell(exx, ezz, hz, hx, sb, zb, xb, lam, l2m, mu, sx, sz, pr, tp.dt, f.sxx[i], f.szz[i],
          f.sxz[i], g[c], g[pl + c], g[2 * pl + c]);
  float qv[4];
  rs_dbar<true>(sb, zb, xb, lam, l2m, mu, dual, dual, c, pl, sx, sz, pr, tp.dt, qv);
  q.vx[i] = qv[0];
  q.vz[i] = qv[1];
  q.sxx[i] = qv[2];
  q.szz[i] = qv[3];
}

template <int R>
__global__ void er_s2(EFields cb, EFields q, int NZ, int NX, ETaps tp) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= NX || z >= NZ) return;
  const int ld = NX + 2 * R;
  const int c = z * NX + x;
  rs_trans<R>(q.vx, q.vz, q.sxx, q.szz, (z + R) * ld + x + R, ld, tp, cb.vx[c], cb.vz[c]);
}

// R-V, first pass: stress derivatives of sigma_t, v_{t-1/2} reconstructed
// in place, imaging of bx, bz, and the dbar planes (q1..q4 in the vx..szz
// slots); dual: the 4 duals of stage V's memories
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
  const float a1 = dplus<R>(f.sxx, i, 1, tp.x);
  const float a2 = dminus<R>(f.sxz, i, ld, tp.z);
  const float b1 = dminus<R>(f.sxz, i, 1, tp.x);
  const float b2 = dplus<R>(f.szz, i, ld, tp.z);
  const float vb = cb.vx[c], wb = cb.vz[c];
  const float bxm = mt.bx[c], bzm = mt.bz[c];
  const int sx = e_strip(x, NX, S), sz = e_strip(z, NZ, S);
  rv_cell(a1, a2, b1, b2, vb, wb, bxm, bzm, sx, sz, pr, tp.dt, f.vx[i], f.vz[i], g[3 * pl + c],
          g[4 * pl + c]);
  float qv[4];
  rv_dbar<true>(vb, wb, bxm, bzm, dual, dual, c, pl, sx, sz, pr, tp.dt, qv);
  q.vx[i] = qv[0];
  q.vz[i] = qv[1];
  q.sxx[i] = qv[2];
  q.szz[i] = qv[3];
}

template <int R>
__global__ void er_v2(EFields cb, EFields q, int NZ, int NX, ETaps tp) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= NX || z >= NZ) return;
  const int ld = NX + 2 * R;
  const int c = z * NX + x;
  rv_trans<R>(q.vx, q.vz, q.sxx, q.szz, (z + R) * ld + x + R, ld, tp, cb.sxx[c], cb.szz[c],
              cb.sxz[c]);
}

// ---- the fused passes (escan_reverse's): a block of
// TX x kFRows threads owns a TZ x TX tile of cells, TZ / kFRows rows a
// thread. Shared memory holds planes of (TZ + 2R) x (TX + 2R) cells, the
// tile and its R reach: the stencil inputs (v for er_s, the stresses for
// er_v) and the four dbar planes, which the block computes over the reach
// too (the neighbouring tile computes the same values there, with the same
// arithmetic) and reads back through the transposed stencils. Only the
// cross of the tile and its reach along z and along x is filled: no
// stencil reads the corners. q outside the grid is 0, as the per-step passes'
// zero halo; the duals are read from din and written to dout (ping-pong),
// since a tile's reach reads the old duals of cells that their own tile
// updates in the same launch. Every global load of a thread, its own
// cells' read-modify-write operands included, is issued before the block's
// one barrier; after it the pass reads only shared memory and registers,
// except in a tile whose flag word says it holds a source, receiver or
// ring cell: that tile's owner threads run the step's glue (ERevGlue)
// through the maps, each at its own cell and in the per-step engine's order.

constexpr int kFRows = 8;          // threads along z
constexpr int kFTZ = 16, kFTX = 32;  // the tile escan_reverse runs

template <int R, int TZ, int TX>
struct FTile {
  static constexpr int kPer = TZ / kFRows;  // own rows a thread
  static constexpr int kThreads = TX * kFRows;
  static constexpr int W = TX + 2 * R;  // shared row stride
  static constexpr int N = (TZ + 2 * R) * W;
  static constexpr int kReachZ = 2 * R * TX;           // reach rows above and below
  static constexpr int kReach = kReachZ + TZ * 2 * R;  // and columns left and right
  static_assert(TZ % kFRows == 0 && kThreads <= 1024, "tile");
  // reach cell k -> its (row, column) in the shared plane
  __device__ static void reach(int k, int& rz, int& rx) {
    if (k < kReachZ) {
      const int r = k / TX;
      rz = r < R ? r : TZ + r;
      rx = R + k - r * TX;
    } else {
      k -= kReachZ;
      const int r = k / (2 * R), e = k - r * (2 * R);
      rz = R + r;
      rx = e < R ? e : TX + e;
    }
  }
};

// shared bytes of a fused pass: er_s 2 + 4 planes, er_v 3 + 4
template <int R, int TZ, int TX>
constexpr int fused_smem(int planes) {
  return planes * FTile<R, TZ, TX>::N * (int)sizeof(float);
}

// the shift of the fused passes' tile rows (the forward's and, with the
// free surface, the reverse's): block row by starts at row by TZ - shift,
// so that with the free surface one starts at fs - 2R
template <int R, int TZ>
__host__ __device__ inline int ef_shift(int fs) {
  return fs >= 0 ? (TZ - ((fs - 2 * R) % TZ + TZ) % TZ) % TZ : 0;
}

// The glue of fused reverse step t that er_s and er_v run in the owner
// thread of each cell, through the maps of the reverse's tiles (m, built
// by er_setup): er_s the v receivers' cotangents of ybar row t, the
// source-point cotangent into srcrow row t, a pressure source undone, and
// the stress rings of row (tape row t-1; zeros when null) imposed; er_v the
// velocity rings imposed and, for step t-1, a force source undone and the
// p receivers' cotangents of ybar row t-1. With the free surface the
// surface tile row's epilogues run the images after the cells (er_s_images,
// er_v_images), and a force source on the velocity image's rows is undone
// there, after the image.
struct ERevGlue {
  SMaps m;
  const float *w, *ybar, *row;
  float* srcrow;
  int t, nsrc, nrec, n_ring, fs, force, rec_v;
};

// the cotangents of ybar row t of the receivers at compact cell c, summed
// along their chain in index order (er_inject_rows' sums): (vz, vx) into
// s0, s1 for a v record, else into s0; false where no receiver sits
__device__ __forceinline__ bool er_rec_sum(const ERevGlue& gl, int c, int t, float& s0,
                                           float& s1) {
  const int r = gl.m.rmap[c] - 1;
  if (r < 0) return false;
  if (gl.rec_v) {
    const float* yb = gl.ybar + 2 * (size_t)t * gl.nrec;
    s0 = yb[2 * r], s1 = yb[2 * r + 1];
    for (int n = gl.m.rnext[r]; n >= 0; n = gl.m.rnext[n]) {
      s0 += yb[2 * n];
      s1 += yb[2 * n + 1];
    }
  } else {
    const float* yb = gl.ybar + (size_t)t * gl.nrec;
    s0 = yb[r];
    for (int n = gl.m.rnext[r]; n >= 0; n = gl.m.rnext[n]) s0 += yb[n];
  }
  return true;
}

// the force sources of step t at compact cell c undone on its vz (bzc: bz
// there), serially in index order as e_src_apply
__device__ __forceinline__ void er_undo_force(const ERevGlue& gl, int c, int t, float bzc,
                                              float dt, float& vz) {
  float unused = 0.f;
  for (int k = gl.m.smap[c] - 1; k >= 0; k = gl.m.snext[k])
    e_src_cell(vz, unused, unused, bzc, gl.w[t], dt, 1, -1.f);
}

// The free surface's epilogues of the fused passes, in the surface tile row
// (z0 = fs - 2R: its tiles hold the ghost rows fs-R .. fs-1 and every
// mirror row fs .. fs+R, and no other tile row writes them). After a
// barrier, which makes the block's own cells' writes visible to all its
// threads, thread row k of column x owns ghost row fs-1-k and its mirrors,
// as the per-step engine's image launches own them: the same cell
// functions in the same order, so the same roundings.

// er_s's: the stress image of the primal (k = R: the surface pin) and the
// velocity-image transpose of the cotangents
template <int R>
__device__ __forceinline__ void er_s_images(EFields f, EFields cb, int NX, int fs, int x) {
  __syncthreads();
  if (x >= NX) return;
  for (int k = threadIdx.y; k <= R; k += kFRows) {
    e_image_s_cell<R>(f, NX, fs, k * NX + x);
    if (k < R) er_image_v_t_cell<R>(cb, NX, fs, k * NX + x);
  }
}

// er_v's: the velocity image of the primal, then for step t-1 the
// stress-image transpose of the cotangents and a force source undone on
// the image's vz rows fs-R .. fs+R-1, which er_v's cells leave to it (the
// per-step engine undoes it after the image)
template <int R>
__device__ __forceinline__ void er_v_images(EFields f, EFields cb, const ERevGlue& gl,
                                            const float* __restrict__ bzm, int NX, float dt,
                                            int x) {
  __syncthreads();
  if (x >= NX) return;
  const int fs = gl.fs;
  for (int k = threadIdx.y; k < R; k += kFRows) {
    e_image_v_cell<R>(f, NX, fs, k * NX + x);
    if (gl.t < 1) continue;
    er_image_s_t_cell<R>(cb, NX, fs, k * NX + x);
    if (!gl.force) continue;
    for (int e = 0; e < 2; ++e) {
      const int z = e ? fs + k : fs - 1 - k;
      er_undo_force(gl, z * NX + x, gl.t - 1, bzm[z * NX + x], dt,
                    f.vz[(z + R) * (NX + 2 * R) + x + R]);
    }
  }
}

// kFS: the free surface (fs >= 0), chosen by the host; without it the
// tile rows are unshifted and no epilogue is compiled
template <int R, int TZ, int TX, bool kFS>
__global__ void __launch_bounds__(TX * kFRows, 1024 / (TX * kFRows))
    er_s(EFields f, EFields cb, const float* din, float* dout, float* __restrict__ g, EMats mt,
         EProf pr, int NZ, int NX, int S, ETaps tp, ERevGlue gl) {
  static_assert(!kFS || TZ >= 3 * R + 1, "the surface tile row holds rows fs-2R .. fs+R");
  dep_wait();
  dep_trigger();
  using T = FTile<R, TZ, TX>;
  constexpr int P = T::kPer;
  extern __shared__ float sm[];
  float* svx = sm;
  float* svz = sm + T::N;
  float* qexx = sm + 2 * T::N;
  float* qezz = sm + 3 * T::N;
  float* qhz = sm + 4 * T::N;
  float* qhx = sm + 5 * T::N;
  const int z0 = blockIdx.y * TZ - (kFS ? ef_shift<R, TZ>(gl.fs) : 0), x0 = blockIdx.x * TX;
  const int ld = NX + 2 * R;
  const size_t pl = (size_t)NZ * NX;
  const float dt = tp.dt;
  const int x = x0 + threadIdx.x;
  // own cells: the dbar inputs and the read-modify-write operands
  float sb[P], zb[P], xb[P], lam[P], l2m[P], mu[P];
  float sxx[P], szz[P], sxz[P], g0[P], g1[P], g2[P], vxb[P], vzb[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int rz = R + threadIdx.y + j * kFRows, z = z0 + rz - R;
    const int s = rz * T::W + threadIdx.x + R, i = (z + R) * ld + x + R;
    const bool halo = (!kFS || z >= -R) && z < NZ + R && x < NX + R;
    svx[s] = halo ? f.vx[i] : 0.f;
    svz[s] = halo ? f.vz[i] : 0.f;
    float qv[4] = {0.f, 0.f, 0.f, 0.f};
    if ((!kFS || z >= 0) && z < NZ && x < NX) {
      const int c = z * NX + x;
      sb[j] = cb.sxx[c], zb[j] = cb.szz[c], xb[j] = cb.sxz[c];
      lam[j] = mt.lam[c], l2m[j] = mt.l2m[c], mu[j] = mt.muxz[c];
      sxx[j] = f.sxx[i], szz[j] = f.szz[i], sxz[j] = f.sxz[i];
      g0[j] = g[c], g1[j] = g[pl + c], g2[j] = g[2 * pl + c];
      vxb[j] = cb.vx[c], vzb[j] = cb.vz[c];
      rs_dbar<true>(sb[j], zb[j], xb[j], lam[j], l2m[j], mu[j], din, dout, c, pl,
                    e_strip(x, NX, S), e_strip(z, NZ, S), pr, dt, qv);
    }
    qexx[s] = qv[0], qezz[s] = qv[1], qhz[s] = qv[2], qhx[s] = qv[3];
  }
  for (int k = threadIdx.y * TX + threadIdx.x; k < T::kReach; k += T::kThreads) {
    int rz, rx;
    T::reach(k, rz, rx);
    const int z = z0 + rz - R, xr = x0 + rx - R, s = rz * T::W + rx;
    const bool halo = z >= -R && z < NZ + R && xr >= -R && xr < NX + R;
    svx[s] = halo ? f.vx[(z + R) * ld + xr + R] : 0.f;
    svz[s] = halo ? f.vz[(z + R) * ld + xr + R] : 0.f;
    float qv[4] = {0.f, 0.f, 0.f, 0.f};
    if (z >= 0 && z < NZ && xr >= 0 && xr < NX) {
      const int c = z * NX + xr;
      rs_dbar<false>(cb.sxx[c], cb.szz[c], cb.sxz[c], mt.lam[c], mt.l2m[c], mt.muxz[c], din,
                     dout, c, pl, e_strip(xr, NX, S), e_strip(z, NZ, S), pr, dt, qv);
    }
    qexx[s] = qv[0], qezz[s] = qv[1], qhz[s] = qv[2], qhx[s] = qv[3];
  }
  const int fl = gl.m.flags[blockIdx.y * gridDim.x + blockIdx.x];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int rz = R + threadIdx.y + j * kFRows, z = z0 + rz - R;
    if ((kFS && z < 0) || z >= NZ || x >= NX) continue;
    const int s = rz * T::W + threadIdx.x + R, c = z * NX + x, i = (z + R) * ld + x + R;
    if ((fl & 2) && gl.rec_v) {  // the receivers' cotangents
      float s0, s1 = 0.f;
      if (er_rec_sum(gl, c, gl.t, s0, s1)) vzb[j] += s0, vxb[j] += s1;
    }
    if (fl & 1)  // the source-point cotangent; a pressure source undone
      for (int k = gl.m.smap[c] - 1; k >= 0; k = gl.m.snext[k]) {
        gl.srcrow[(size_t)gl.t * gl.nsrc + k] = gl.force ? vzb[j] : sb[j] + zb[j];
        float unused = 0.f;
        if (!gl.force) e_src_cell(unused, sxx[j], szz[j], 0.f, gl.w[gl.t], dt, 0, -1.f);
      }
    const float exx = dminus<R>(svx, s, 1, tp.x);
    const float ezz = dminus<R>(svz, s, T::W, tp.z);
    const float hz = dplus<R>(svx, s, T::W, tp.z);
    const float hx = dplus<R>(svz, s, 1, tp.x);
    rs_cell(exx, ezz, hz, hx, sb[j], zb[j], xb[j], lam[j], l2m[j], mu[j], e_strip(x, NX, S),
            e_strip(z, NZ, S), pr, dt, sxx[j], szz[j], sxz[j], g0[j], g1[j], g2[j]);
    if (fl & 4) {  // the stress rings
      const int q = gl.m.gmap[c] - 1, n = gl.n_ring;
      if (q >= 0) {
        sxx[j] = gl.row ? gl.row[2 * n + q] : 0.f;
        szz[j] = gl.row ? gl.row[3 * n + q] : 0.f;
        sxz[j] = gl.row ? gl.row[4 * n + q] : 0.f;
      }
    }
    rs_trans<R>(qexx, qezz, qhz, qhx, s, T::W, tp, vxb[j], vzb[j]);
    f.sxx[i] = sxx[j], f.szz[i] = szz[j], f.sxz[i] = sxz[j];
    g[c] = g0[j], g[pl + c] = g1[j], g[2 * pl + c] = g2[j];
    cb.vx[c] = vxb[j], cb.vz[c] = vzb[j];
  }
  if constexpr (kFS)
    if (z0 == gl.fs - 2 * R) er_s_images<R>(f, cb, NX, gl.fs, x);  // block-uniform
}

template <int R, int TZ, int TX, bool kFS>
__global__ void __launch_bounds__(TX * kFRows, 1024 / (TX * kFRows))
    er_v(EFields f, EFields cb, const float* din, float* dout, float* __restrict__ g, EMats mt,
         EProf pr, int NZ, int NX, int S, ETaps tp, ERevGlue gl) {
  static_assert(!kFS || TZ >= 3 * R + 1, "the surface tile row holds rows fs-2R .. fs+R");
  dep_wait();
  dep_trigger();
  using T = FTile<R, TZ, TX>;
  constexpr int P = T::kPer;
  extern __shared__ float sm[];
  float* ssxx = sm;
  float* sszz = sm + T::N;
  float* ssxz = sm + 2 * T::N;
  float* q1 = sm + 3 * T::N;
  float* q2 = sm + 4 * T::N;
  float* q3 = sm + 5 * T::N;
  float* q4 = sm + 6 * T::N;
  const int z0 = blockIdx.y * TZ - (kFS ? ef_shift<R, TZ>(gl.fs) : 0), x0 = blockIdx.x * TX;
  const int ld = NX + 2 * R;
  const size_t pl = (size_t)NZ * NX;
  const float dt = tp.dt;
  const int x = x0 + threadIdx.x;
  float vb[P], wb[P], bxm[P], bzm[P];
  float vx[P], vz[P], g3[P], g4[P], sxxb[P], szzb[P], sxzb[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int rz = R + threadIdx.y + j * kFRows, z = z0 + rz - R;
    const int s = rz * T::W + threadIdx.x + R, i = (z + R) * ld + x + R;
    const bool halo = (!kFS || z >= -R) && z < NZ + R && x < NX + R;
    ssxx[s] = halo ? f.sxx[i] : 0.f;
    sszz[s] = halo ? f.szz[i] : 0.f;
    ssxz[s] = halo ? f.sxz[i] : 0.f;
    float qv[4] = {0.f, 0.f, 0.f, 0.f};
    if ((!kFS || z >= 0) && z < NZ && x < NX) {
      const int c = z * NX + x;
      vb[j] = cb.vx[c], wb[j] = cb.vz[c], bxm[j] = mt.bx[c], bzm[j] = mt.bz[c];
      vx[j] = f.vx[i], vz[j] = f.vz[i], g3[j] = g[3 * pl + c], g4[j] = g[4 * pl + c];
      sxxb[j] = cb.sxx[c], szzb[j] = cb.szz[c], sxzb[j] = cb.sxz[c];
      rv_dbar<true>(vb[j], wb[j], bxm[j], bzm[j], din, dout, c, pl, e_strip(x, NX, S),
                    e_strip(z, NZ, S), pr, dt, qv);
    }
    q1[s] = qv[0], q2[s] = qv[1], q3[s] = qv[2], q4[s] = qv[3];
  }
  for (int k = threadIdx.y * TX + threadIdx.x; k < T::kReach; k += T::kThreads) {
    int rz, rx;
    T::reach(k, rz, rx);
    const int z = z0 + rz - R, xr = x0 + rx - R, s = rz * T::W + rx;
    const bool halo = z >= -R && z < NZ + R && xr >= -R && xr < NX + R;
    const int i = (z + R) * ld + xr + R;
    ssxx[s] = halo ? f.sxx[i] : 0.f;
    sszz[s] = halo ? f.szz[i] : 0.f;
    ssxz[s] = halo ? f.sxz[i] : 0.f;
    float qv[4] = {0.f, 0.f, 0.f, 0.f};
    if (z >= 0 && z < NZ && xr >= 0 && xr < NX) {
      const int c = z * NX + xr;
      rv_dbar<false>(cb.vx[c], cb.vz[c], mt.bx[c], mt.bz[c], din, dout, c, pl,
                     e_strip(xr, NX, S), e_strip(z, NZ, S), pr, dt, qv);
    }
    q1[s] = qv[0], q2[s] = qv[1], q3[s] = qv[2], q4[s] = qv[3];
  }
  const int fl = gl.m.flags[blockIdx.y * gridDim.x + blockIdx.x];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int rz = R + threadIdx.y + j * kFRows, z = z0 + rz - R;
    if ((kFS && z < 0) || z >= NZ || x >= NX) continue;
    const int s = rz * T::W + threadIdx.x + R, c = z * NX + x, i = (z + R) * ld + x + R;
    const float a1 = dplus<R>(ssxx, s, 1, tp.x);
    const float a2 = dminus<R>(ssxz, s, T::W, tp.z);
    const float b1 = dminus<R>(ssxz, s, 1, tp.x);
    const float b2 = dplus<R>(sszz, s, T::W, tp.z);
    rv_cell(a1, a2, b1, b2, vb[j], wb[j], bxm[j], bzm[j], e_strip(x, NX, S), e_strip(z, NZ, S),
            pr, dt, vx[j], vz[j], g3[j], g4[j]);
    if (fl & 4) {  // the velocity rings
      const int q = gl.m.gmap[c] - 1;
      if (q >= 0) {
        vx[j] = gl.row ? gl.row[q] : 0.f;
        vz[j] = gl.row ? gl.row[gl.n_ring + q] : 0.f;
      }
    }
    // step t-1's force source (on the image's rows, er_v_images')
    if ((fl & 1) && gl.force && gl.t >= 1 && (gl.fs < 0 || z < gl.fs - R || z >= gl.fs + R))
      er_undo_force(gl, c, gl.t - 1, bzm[j], dt, vz[j]);
    rv_trans<R>(q1, q2, q3, q4, s, T::W, tp, sxxb[j], szzb[j], sxzb[j]);
    if ((fl & 2) && !gl.rec_v && gl.t >= 1) {  // step t-1's receivers' cotangents
      float s0, s1 = 0.f;
      if (er_rec_sum(gl, c, gl.t - 1, s0, s1)) sxxb[j] += -0.5f * s0, szzb[j] += -0.5f * s0;
    }
    f.vx[i] = vx[j], f.vz[i] = vz[j];
    g[3 * pl + c] = g3[j], g[4 * pl + c] = g4[j];
    cb.sxx[c] = sxxb[j], cb.szz[c] = szzb[j], cb.sxz[c] = sxzb[j];
  }
  if constexpr (kFS)
    if (z0 == gl.fs - 2 * R) er_v_images<R>(f, cb, gl, mt.bz, NX, dt, x);  // block-uniform
}

// ---- the fused forward (escan_forward's): two launches a step, each a
// programmatic dependent of the one before. Stage V is the per-step
// engine's ef_v, which also adds the step before's force sources;
// ef_s_fused then runs, on TZ x TX tiles (FTile's thread layout), stage S
// from v copied over the tile and its R cross (a ghost row of the free
// surface copied from its mirror row: the velocity image) and folds in the
// glue the per-step engine launches after it: the sources (a force source's vz
// only in registers, for the receivers and the tape: vz is read by other
// tiles in this launch, so stage V adds it in the next step, and the call's
// last step's in a tail launch), the stress image and the surface pin, the
// receivers, the ring-tape entries, and the imaged v of its own ghost
// cells. The stresses and stage S's memories are read at their own cell
// only, and no tile reads a ghost row's v, so nothing ping-pongs. With the
// free surface the tile rows are shifted so that one starts at fs - 2R:
// its tiles hold the ghost rows fs-R .. fs-1 and their mirrors fs .. fs+R,
// so the stress image runs in shared memory after a barrier (only in that
// tile row). Every copy is a 4-byte cp.async issued before the first
// barrier, the materials' (which no step writes) before the wait on the
// step before; the maps (and bz at a force source) only in a tile that
// holds a source, receiver or ring cell, after it.

constexpr int kEFMinBlocks = 4;  // ef_s_fused's register cap: 4 blocks an SM

// ef_s_fused's shared floats: v over the tile and its R cross (N each);
// sxx, szz, sxz, lam, l2m, mu_xz and stage S's four memories over the tile
template <int R, int TZ, int TX>
constexpr int ef_smem() {
  return 4 * (2 * FTile<R, TZ, TX>::N + 10 * TZ * TX);
}

struct EFwdArgs {
  EMats mt;
  EProf pr;
  const float* w;
  float *seis, *mem_s;  // stage S's memories, in place
  SMaps m;
  int NZ, NX, S, fs, shift, nrec, n_ring, force, rec_v;
  ETaps tp;
};

// v of cell (z, x) into shared slot s, a ghost row's from its mirror row
// (2 fs - z for vx, 2 fs - 1 - z for vz: the velocity image), zero off the
// grid
template <int R>
__device__ __forceinline__ void ef_copy_v(float* svx, float* svz, int s,
                                          const float* __restrict__ vxi,
                                          const float* __restrict__ vzi, int z, int x, int NZ,
                                          int NX, int fs) {
  const bool on = z >= 0 && z < NZ && x >= 0 && x < NX;
  const bool ghost = fs >= 0 && z >= fs - R && z < fs;
  const int ld = NX + 2 * R, col = on ? x + R : 0;
  const int zx = !on ? -R : ghost ? 2 * fs - z : z, zz = !on ? -R : ghost ? 2 * fs - 1 - z : z;
  cp_async4(svx + s, vxi + (zx + R) * ld + col, on);
  cp_async4(svz + s, vzi + (zz + R) * ld + col, on);
}

// Stage S and the glue of forward step t on the fields f: the stresses in
// place, v at the own ghost cells; ring_row (tape row t) may be null.
template <int R, int TZ, int TX>
__global__ void __launch_bounds__(TX * kFRows, kEFMinBlocks)
    ef_s_fused(EFwdArgs a, int t, EFields f, float* __restrict__ ring_row) {
  using T = FTile<R, TZ, TX>;
  constexpr int P = T::kPer, W = T::W, OWN = TZ * TX;
  extern __shared__ float sm[];
  float* svx = sm;         // v over the cross; then (surface row) the new szz
  float* svz = sm + T::N;  // and sxz
  float* own = sm + 2 * T::N;  // sxx, szz, sxz, lam, l2m, mu, stage S's memories: OWN each
  const int NZ = a.NZ, NX = a.NX, S = a.S, fs = a.fs, ld = NX + 2 * R;
  const size_t pl = (size_t)NZ * NX;
  const float dt = a.tp.dt;
  const int z0 = blockIdx.y * TZ - a.shift, x0 = blockIdx.x * TX;
  const int tx = threadIdx.x, ty = threadIdx.y, x = x0 + tx;
  const bool surf = fs >= 0 && z0 == fs - 2 * R;  // the tile row of the stress image
  const bool band = x0 < S || x0 + TX > NX - S || z0 < S || z0 + TZ > NZ - S;

#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int oz = ty + j * kFRows, z = z0 + oz, o = oz * TX + tx;
    const bool on = z >= 0 && z < NZ && x < NX;
    const int c = on ? z * NX + x : 0;
    cp_async4(own + 3 * OWN + o, a.mt.lam + c, on);
    cp_async4(own + 4 * OWN + o, a.mt.l2m + c, on);
    cp_async4(own + 5 * OWN + o, a.mt.muxz + c, on);
  }
  dep_wait();
  dep_trigger();
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int oz = ty + j * kFRows, z = z0 + oz, o = oz * TX + tx;
    const bool on = z >= 0 && z < NZ && x < NX;
    const int c = on ? z * NX + x : 0, hi = on ? (z + R) * ld + x + R : 0;
    ef_copy_v<R>(svx, svz, (oz + R) * W + tx + R, f.vx, f.vz, z, x, NZ, NX, fs);
    cp_async4(own + o, f.sxx + hi, on);
    cp_async4(own + OWN + o, f.szz + hi, on);
    cp_async4(own + 2 * OWN + o, f.sxz + hi, on);
    if (band) {
      const bool sx = on && e_strip(x, NX, S) >= 0, sz = on && e_strip(z, NZ, S) >= 0;
      cp_async4(own + 6 * OWN + o, a.mem_s + c, sx);  // x strips: slots 0 and 3
      cp_async4(own + 9 * OWN + o, a.mem_s + 3 * pl + c, sx);
      cp_async4(own + 7 * OWN + o, a.mem_s + pl + c, sz);  // z strips: 1 and 2
      cp_async4(own + 8 * OWN + o, a.mem_s + 2 * pl + c, sz);
    }
  }
  for (int k = threadIdx.y * TX + tx; k < T::kReach; k += T::kThreads) {
    int rz, rx;
    T::reach(k, rz, rx);
    ef_copy_v<R>(svx, svz, rz * W + rx, f.vx, f.vz, z0 + rz - R, x0 + rx - R, NZ, NX, fs);
  }
  const float wt = a.w[t];
  const int fl = a.m.flags[blockIdx.y * gridDim.x + blockIdx.x];
  cp_async_wait_all();
  __syncthreads();

  // stage S, the sources and the surface pin of the own cells
  float nvx[P], nvz[P], svz_own[P], nsxx[P], nszz[P], nsxz[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int oz = ty + j * kFRows, z = z0 + oz, o = oz * TX + tx;
    if (z < 0 || z >= NZ || x >= NX) continue;
    const int c = z * NX + x, s = (oz + R) * W + tx + R;
    const int sx = e_strip(x, NX, S), sz = e_strip(z, NZ, S);
    float m[4] = {0.f, 0.f, 0.f, 0.f};
    if (sx >= 0) m[0] = own[6 * OWN + o], m[3] = own[9 * OWN + o];
    if (sz >= 0) m[1] = own[7 * OWN + o], m[2] = own[8 * OWN + o];
    nsxx[j] = own[o], nszz[j] = own[OWN + o], nsxz[j] = own[2 * OWN + o];
    es_cell(dminus<R>(svx, s, 1, a.tp.x), dminus<R>(svz, s, W, a.tp.z),
            dplus<R>(svx, s, W, a.tp.z), dplus<R>(svz, s, 1, a.tp.x), m, sx, sz, a.pr, dt,
            own[3 * OWN + o], own[4 * OWN + o], own[5 * OWN + o], nsxx[j], nszz[j], nsxz[j]);
    e_mem_store(a.mem_s, c, pl, sx, sz, m, 0, 3, 1, 2);
    nvx[j] = svx[s], nvz[j] = svz_own[j] = svz[s];
    if (fl & 1)
      for (int k = a.m.smap[c] - 1; k >= 0; k = a.m.snext[k])
        e_src_cell(nvz[j], nsxx[j], nszz[j], a.mt.bz[c], wt, dt, a.force, 1.f);
    if (z == fs) nszz[j] = 0.f;
  }
  if (surf) {  // the stress image: ghost row g from rows 2 fs - g (szz), 2 fs - 1 - g (sxz)
    __syncthreads();
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int oz = ty + j * kFRows, z = z0 + oz;
      if (z < 0 || z >= NZ || x >= NX) continue;
      svx[(oz + R) * W + tx + R] = nszz[j];
      svz[(oz + R) * W + tx + R] = nsxz[j];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int oz = ty + j * kFRows, z = z0 + oz;
      if (z < fs - R || z >= fs || x >= NX) continue;
      const int s = (oz + R) * W + tx + R;
      nszz[j] = -svx[s + 2 * (fs - z) * W];
      nsxz[j] = -svz[s + (2 * (fs - z) - 1) * W];
    }
  }

  // the own cells' fields, receivers and ring entries; v only at a ghost
  // cell (its image, without the force source)
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int oz = ty + j * kFRows, z = z0 + oz;
    if (z < 0 || z >= NZ || x >= NX) continue;
    const int c = z * NX + x, hi = (z + R) * ld + x + R;
    if (surf && z >= fs - R && z < fs) {
      f.vx[hi] = nvx[j];
      f.vz[hi] = svz_own[j];
    }
    f.sxx[hi] = nsxx[j], f.szz[hi] = nszz[j], f.sxz[hi] = nsxz[j];
    if (fl & 2)
      for (int r = a.m.rmap[c] - 1; r >= 0; r = a.m.rnext[r])
        e_record(a.seis, t, a.nrec, r, a.rec_v, nvx[j], nvz[j], nsxx[j], nszz[j]);
    if (ring_row != nullptr && (fl & 4)) {
      const int g = a.m.gmap[c] - 1;
      if (g >= 0) {
        const int n = a.n_ring;
        ring_row[g] = nvx[j];
        ring_row[n + g] = nvz[j];
        ring_row[2 * n + g] = nsxx[j];
        ring_row[3 * n + g] = nszz[j];
        ring_row[4 * n + g] = nsxz[j];
      }
    }
  }
}

// the forward's maps (cell_maps.cuh), one thread per source, receiver and
// ring cell, and the flag words of ef_v's blocks (vnx a row) that hold a
// source
__global__ void ef_setup(const long long* __restrict__ src, int nsrc,
                         const long long* __restrict__ rcv, int nrec,
                         const int* __restrict__ ring, int n_ring, int NX, int tz, int tx,
                         int ntx, int shift, SMaps m, int* __restrict__ vflags, int vnx) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  cell_map_entry(k, src, nsrc, rcv, nrec, ring, n_ring, NX, tz, tx, ntx, shift, m);
  if (k < nsrc) atomicOr(&vflags[((int)src[2 * k] / kEVY) * vnx + (int)src[2 * k + 1] / kEVX], 1);
}

// the entry after j of a (n entries) at j's cell (-1: none)
__device__ __forceinline__ int next_at(const long long* __restrict__ a, int n, int j) {
  for (int q = j + 1; q < n; ++q)
    if (same_cell(a, q, j)) return q;
  return -1;
}

// The fused reverse's set-up, once a call: the maps of its tiles (TZ x TX,
// ntx a row, the rows shifted by ef_shift; cell_map_entry, one thread per
// source, receiver and ring cell), and the glue of step t = nt-1 that er_v
// of a step after it would run: a force source undone and the p
// receivers' cotangents of ybar row t, by the first entry of each cell
// along its chain in index order.
__global__ void er_setup(const long long* __restrict__ src, int nsrc,
                         const long long* __restrict__ rcv, int nrec,
                         const int* __restrict__ ring, int n_ring, int NX, int R, int tz, int tx,
                         int ntx, int shift, SMaps m, EFields f, EFields cb,
                         const float* __restrict__ bzm, const float* __restrict__ w,
                         const float* __restrict__ ybar, int t, float dt, int force, int rec_v) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  cell_map_entry(k, src, nsrc, rcv, nrec, ring, n_ring, NX, tz, tx, ntx, shift, m);
  int next;
  if (k < nsrc) {
    if (!force || !chain_at(src, nsrc, k, next)) return;
    const int z = (int)src[2 * k], x = (int)src[2 * k + 1];
    float* vz = f.vz + (z + R) * (NX + 2 * R) + x + R;
    float unused = 0.f;
    for (int j = k; j >= 0; j = next_at(src, nsrc, j))
      e_src_cell(*vz, unused, unused, bzm[z * NX + x], w[t], dt, 1, -1.f);
  } else if (k < nsrc + nrec && !rec_v) {
    const int r = k - nsrc;
    if (!chain_at(rcv, nrec, r, next)) return;
    const float* yb = ybar + (size_t)t * nrec;
    float s = yb[r];
    for (int n = next; n >= 0; n = next_at(rcv, nrec, n)) s += yb[n];
    const int c = (int)rcv[2 * r] * NX + (int)rcv[2 * r + 1];
    cb.sxx[c] += -0.5f * s;
    cb.szz[c] += -0.5f * s;
  }
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

const dim3 kECellBlock(kEVX, kEVY);
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
// estage_v then estage_s, a reverse step estage_rs then estage_rv, behind
// the per-step entry points (elastic2d_step.cu); the whole-scan engine's
// fused passes (elastic2d_scan.cu) run the same cell bodies and glue, so
// the per-step engine is their oracle. mem: 8 compact CPML memory planes,
// stage V's four then stage S's four; dual: 8 compact dual planes, R-S's
// four then R-V's four.

// Stage V (TPU kernel 10a), then the mid-step velocity image. mem: the 8
// memory planes; stage V updates planes 0-3.
template <int R>
void estage_v(EFields f, float* mem, EMats mt, EProf pr, int NZ, int NX, int S, int fs,
              const ETaps& tp, cudaStream_t st) {
  ef_v<R><<<e_cell_grid(NZ, NX), kECellBlock, 0, st>>>(f, mem, mt, pr, NZ, NX, S, tp, EVSrc{});
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

// the fused passes' launch plan, as the caller states it (the wrapper's
// escan_tile_plan): the tile and the larger pass's shared bytes
struct EPlan {
  int tz, tx, smem;
};

// the largest fused pass's shared bytes, which the plan states
template <int R, int TZ, int TX>
constexpr int fused_plan_smem() {
  constexpr int rev = fused_smem<R, TZ, TX>(7), fwd = ef_smem<R, TZ, TX>();
  return rev > fwd ? rev : fwd;
}

// let both instantiations of the reverse's fused passes take their shared
// bytes
template <int R, int TZ, int TX, bool kFS>
inline cudaError_t fused_reverse_smem() {
  cudaError_t e = cudaFuncSetAttribute(reinterpret_cast<const void*>(er_s<R, TZ, TX, kFS>),
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       fused_smem<R, TZ, TX>(6));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(reinterpret_cast<const void*>(er_v<R, TZ, TX, kFS>),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             fused_smem<R, TZ, TX>(7));
  return e;
}

// check the caller's plan against the tile this library runs, and let the
// fused passes take their shared bytes (above the default 48 KB only by
// this attribute); a refusal is an error
template <int R, int TZ, int TX>
inline int fused_check_plan(const EPlan& plan) {
  if (plan.tz != TZ || plan.tx != TX || plan.smem != fused_plan_smem<R, TZ, TX>())
    return (int)cudaErrorInvalidValue;
  cudaError_t e = fused_reverse_smem<R, TZ, TX, false>();
  if (e == cudaSuccess) e = fused_reverse_smem<R, TZ, TX, true>();
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(reinterpret_cast<const void*>(ef_s_fused<R, TZ, TX>),
                             cudaFuncAttributeMaxDynamicSharedMemorySize, ef_smem<R, TZ, TX>());
  return (int)e;
}

// Reverse step t on the fused passes, the glue in their owner threads
// (ERevGlue, whose t is this step): er_s then er_v, 2 launches, with the
// free surface too (kFS, which must say gl.fs >= 0): their tile rows are
// then shifted by ef_shift, as the forward's, and the surface tile row's
// epilogues run the images (er_s_images, er_v_images). A call runs
// er_setup, and with the free surface the first step's stress-image
// transpose, before its first step (reverse_loop). er_s and er_v run
// ahead of the image launches that the per-step engine runs between its
// passes: those write only the primal fields and the cotangents that the
// next pass reads after them, and the second passes read only dbar
// planes. din / dout: the 8 dual planes read and written, swapped by the
// caller each step. dep: each launch a programmatic dependent of the one
// before it (launch_dep).
template <int R, int TZ, int TX, bool kFS>
void estage_rfused(EFields f, EFields cb, const float* din, float* dout, float* g, EMats mt,
                   EProf pr, const ERevGlue& gl, int NZ, int NX, int S, const ETaps& tp, int dep,
                   cudaStream_t st) {
  const size_t pl = (size_t)NZ * NX;
  const int shift = ef_shift<R, TZ>(gl.fs);
  const dim3 grid((NX + TX - 1) / TX, (NZ + shift + TZ - 1) / TZ), block(TX, kFRows);
  launch_dep(dep, er_s<R, TZ, TX, kFS>, grid, block, fused_smem<R, TZ, TX>(6), st, f, cb, din,
             dout, g, mt, pr, NZ, NX, S, tp, gl);
  launch_dep(dep, er_v<R, TZ, TX, kFS>, grid, block, fused_smem<R, TZ, TX>(7), st, f, cb,
             din + 4 * pl, dout + 4 * pl, g, mt, pr, NZ, NX, S, tp, gl);
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
