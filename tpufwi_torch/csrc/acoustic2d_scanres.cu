// Whole-scan 2D acoustic engine for Hopper (sm_90a): the forward time loop
// with the bf16 snapshot tape, and the snapshot reverse.
//
// Replaces the two TPU kernels of the snapshot engine:
//   scanres_forward       <- tpufwi/kernels/acoustic2d_pallas_scanres.py::
//                            make_scanres_forward (snap_tape=True / no tape)
//   scanres_reverse_snap  <- tpufwi/kernels/acoustic2d_pallas_scanres.py::
//                            make_scanres_reverse_snap
// Plain C interface, built by nvcc into a shared library and called through
// ctypes (tpufwi_torch/kernels/acoustic2d_scanres.py).
//
// Semantics (the step twin, tpufwi_torch/kernels/acoustic2d_eager.py):
//   per axis d:  phi_d' = b phi_d + a D1_d p ;  v_d = D2_d p + D1_d phi_d'
//                psi_d' = b psi_d + a v_d    ;  lap = sum_d v_d + psi_d'
//   P_t = 2 P_{t-1} - P_{t-2} + C lap(P_{t-1}) ; P_t[src] += C[src] w[t]
//   P_t[fs row] = 0 ; seis[t] = P_t[rcv] ; tape[t] = bf16(D2z P_{t-1} + D2x P_{t-1})
// The reverse runs the exact transpose of that step on lambda (the cotangent
// of P_t), images gbar += lambda_t * tape[t] and records lambda_t at the
// sources; the wrapper adds the source-cell and wavelet terms.
//
// Design. On the TPU the whole loop is one pallas_call with the state in
// VMEM. Here the state lives in device memory (a 399x1749 fp32 field is
// 2.8 MB; the working set of one step fits the 50 MB L2) and a host loop in
// this file launches each time step as a few ordered kernels on the caller's
// stream, so the Python side makes one call per propagation:
//   forward step:  F1 phi' on the CPML strips (D1 of p)
//                  F2 one thread per cell: 17-tap D2 laplacian, tape row,
//                     D1 phi' and psi' inside the strips, leapfrog written in
//                     place over P_{t-2}, free-surface pin
//                  F3 one block: sources (serially, so coinciding sources
//                     sum in a fixed order), then the receiver gather
//   reverse step:  R0 one block: receiver-cotangent injection (each cell
//                     owned by its first receiver, which sums the others in
//                     index order), lambda at the sources
//                  R1 one thread per cell: free-surface mask, u = C lambda,
//                     imaging, psi-bar ring -> w
//                  R2 strips: phi-bar ring -> y (needs D1 u and D1 w)
//                  R3 one thread per cell: lambda_{t-1} = 2 lambda_t -
//                     lambda_{t+1} + D2 u + D2 w - D1 y, in place
// Every transposed stencil is a gather with flipped taps (D1^T = -D1,
// D2^T = D2), never an atomic scatter, so the gradient is deterministic.
// All arithmetic is fp32 (FMA); no tensor cores: the TPU's banded MXU
// products and bf16-split emulation have no counterpart here.
//
// Layout: every field is stored with a zero halo of R cells on each side
// ((NZ+2R) x (NX+2R), row stride NX+2R), so stencil gathers need no bounds
// tests; kernels write only the interior. The CPML memory variables are
// full-size fields that stay zero outside the strips.
//
// What bounds it: memory traffic and launches. Per cell and step the
// forward moves ~18 bytes (P_{t-1} read once if the stencil hits cache,
// P_{t-2} read + P_t write, C read, 2-byte tape write), the reverse ~30
// (lambda twice, u write + gather, gacc read-modify-write, C, 2-byte tape
// read). The tape (2 bytes per cell per step, 6.8 GB at 399x1749x4842) is
// the only stream that must reach HBM. Left for later: strip-only storage
// of the CPML variables, a persistent kernel (or CUDA graph) instead of 3-4
// launches per step, shared-memory tiling of the stencil, and tape
// bandwidth (compression or recomputation).

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

// index of row z (or column x) into a (2, S) strip profile, -1 outside
__device__ __forceinline__ int strip_index(int z, int n, int S) {
  if (z < S) return z;
  if (z >= n - S) return S + z - (n - S);
  return -1;
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

template <int R>
__global__ void rev_cells1(float* __restrict__ q, float* __restrict__ u,
                           const float* __restrict__ c2,
                           const __nv_bfloat16* __restrict__ tape_row, float* __restrict__ gacc,
                           float* __restrict__ psbz, float* __restrict__ wz,
                           float* __restrict__ psbx, float* __restrict__ wx,
                           const float* __restrict__ az, const float* __restrict__ bz,
                           const float* __restrict__ ax, const float* __restrict__ bx,
                           int NZ, int NX, int S, int fs) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= NX || z >= NZ) return;
  const int ld = NX + 2 * R;
  const int i = (z + R) * ld + x + R;
  float lam = q[i];
  if (z == fs) {  // transpose of the surface pin
    lam = 0.f;
    q[i] = 0.f;
  }
  const int c = z * NX + x;
  const float uu = c2[c] * lam;
  u[i] = uu;
  gacc[c] = fmaf(lam, __bfloat162float(tape_row[c]), gacc[c]);
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

// ------------------------------------------------------------ host loops

const dim3 kCellBlock(32, 8);
const int kStripBlock = 256;
const int kSmallBlock = 256;

template <int R>
int forward_loop(const float* c2, const float* az, const float* bz, const float* ax,
                 const float* bx, const float* w, const long long* src,
                 const long long* rcv, float* seis, __nv_bfloat16* tape, float* ws,
                 int NZ, int NX, int S, int nt, int nsrc, int nrec, int fs, const Taps& tp,
                 cudaStream_t st) {
  const size_t plane = (size_t)(NZ + 2 * R) * (NX + 2 * R);
  float* pa = ws;  // P_t for even t
  float* pb = ws + plane;  // P_t for odd t
  float* phiz = ws + 2 * plane;
  float* psiz = ws + 3 * plane;
  float* phix = ws + 4 * plane;
  float* psix = ws + 5 * plane;
  const dim3 cells((NX + kCellBlock.x - 1) / kCellBlock.x, (NZ + kCellBlock.y - 1) / kCellBlock.y);
  const int strips = (2 * S * NX + 2 * NZ * S + kStripBlock - 1) / kStripBlock;
  float* cur = pb;   // P_{t-1}
  float* prev = pa;  // P_{t-2}, overwritten by P_t
  for (int t = 0; t < nt; ++t) {
    fwd_strips<R><<<strips, kStripBlock, 0, st>>>(cur, phiz, phix, az, bz, ax, bx, NZ, NX, S, tp);
    __nv_bfloat16* row = tape ? tape + (size_t)t * NZ * NX : nullptr;
    fwd_cells<R><<<cells, kCellBlock, 0, st>>>(cur, prev, phiz, psiz, phix, psix, c2, az, bz,
                                               ax, bx, row, NZ, NX, S, fs, tp);
    fwd_src_rcv<<<1, kSmallBlock, 0, st>>>(prev, c2, w, t, src, rcv, seis, nsrc, nrec, NX, R, fs);
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
int reverse_loop(const float* c2, const float* az, const float* bz, const float* ax,
                 const float* bx, const float* ybar, const __nv_bfloat16* tape,
                 const long long* src, const long long* rcv, float* gacc, float* lam_src,
                 float* ws, int* chain, int NZ, int NX, int S, int nt, int nsrc, int nrec,
                 int fs, const Taps& tp, cudaStream_t st) {
  const size_t plane = (size_t)(NZ + 2 * R) * (NX + 2 * R);
  float* q0 = ws;
  float* q1 = ws + plane;
  float* u = ws + 2 * plane;
  float* psbz = ws + 3 * plane;
  float* wz = ws + 4 * plane;
  float* pbz = ws + 5 * plane;
  float* yz = ws + 6 * plane;
  float* psbx = ws + 7 * plane;
  float* wx = ws + 8 * plane;
  float* pbx = ws + 9 * plane;
  float* yx = ws + 10 * plane;
  const dim3 cells((NX + kCellBlock.x - 1) / kCellBlock.x, (NZ + kCellBlock.y - 1) / kCellBlock.y);
  const int strips = (2 * S * NX + 2 * NZ * S + kStripBlock - 1) / kStripBlock;
  rev_chain<<<(nrec + kSmallBlock - 1) / kSmallBlock, kSmallBlock, 0, st>>>(rcv, nrec, chain);
  float* qc = q0;  // lambda_t
  float* qo = q1;  // lambda_{t+1}, overwritten by lambda_{t-1}
  for (int t = nt - 1; t >= 0; --t) {
    rev_inject<<<1, kSmallBlock, 0, st>>>(qc, ybar, t, rcv, chain, src, lam_src, nsrc, nrec,
                                         NX, R, fs);
    rev_cells1<R><<<cells, kCellBlock, 0, st>>>(qc, u, c2, tape + (size_t)t * NZ * NX, gacc,
                                                psbz, wz, psbx, wx, az, bz, ax, bx, NZ, NX,
                                                S, fs);
    rev_strips<R><<<strips, kStripBlock, 0, st>>>(u, wz, wx, pbz, yz, pbx, yx, az, bz, ax, bx,
                                                  NZ, NX, S, tp);
    rev_cells2<R><<<cells, kCellBlock, 0, st>>>(qc, qo, u, wz, yz, wx, yx, NZ, NX, S, tp);
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

Taps load_taps(const float* host) {
  Taps tp;
  std::memcpy(&tp, host, sizeof(Taps));
  return tp;
}

}  // namespace

extern "C" {

// ws: 6 zeroed halo planes (pa, pb, phiz, psiz, phix, psix); tape may be null.
int tpufwi_scanres_forward(const float* c2, const float* az, const float* bz,
                           const float* ax, const float* bx, const float* w,
                           const long long* src, const long long* rcv, float* seis,
                           void* tape, float* ws, int NZ, int NX, int S, int R, int nt,
                           int nsrc, int nrec, int fs, const float* taps, void* stream) {
  const Taps tp = load_taps(taps);
  auto* tb = static_cast<__nv_bfloat16*>(tape);
  auto st = static_cast<cudaStream_t>(stream);
  switch (R) {
    case 1: return forward_loop<1>(c2, az, bz, ax, bx, w, src, rcv, seis, tb, ws, NZ, NX, S, nt, nsrc, nrec, fs, tp, st);
    case 2: return forward_loop<2>(c2, az, bz, ax, bx, w, src, rcv, seis, tb, ws, NZ, NX, S, nt, nsrc, nrec, fs, tp, st);
    case 4: return forward_loop<4>(c2, az, bz, ax, bx, w, src, rcv, seis, tb, ws, NZ, NX, S, nt, nsrc, nrec, fs, tp, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ws: 11 zeroed halo planes; gacc (NZ, NX) zeroed; chain: 2 * nrec ints.
int tpufwi_scanres_reverse_snap(const float* c2, const float* az, const float* bz,
                                const float* ax, const float* bx, const float* ybar,
                                const void* tape, const long long* src, const long long* rcv,
                                float* gacc, float* lam_src, float* ws, int* chain, int NZ,
                                int NX, int S, int R, int nt, int nsrc, int nrec, int fs,
                                const float* taps, void* stream) {
  const Taps tp = load_taps(taps);
  auto* tb = static_cast<const __nv_bfloat16*>(tape);
  auto st = static_cast<cudaStream_t>(stream);
  switch (R) {
    case 1: return reverse_loop<1>(c2, az, bz, ax, bx, ybar, tb, src, rcv, gacc, lam_src, ws, chain, NZ, NX, S, nt, nsrc, nrec, fs, tp, st);
    case 2: return reverse_loop<2>(c2, az, bz, ax, bx, ybar, tb, src, rcv, gacc, lam_src, ws, chain, NZ, NX, S, nt, nsrc, nrec, fs, tp, st);
    case 4: return reverse_loop<4>(c2, az, bz, ax, bx, ybar, tb, src, rcv, gacc, lam_src, ws, chain, NZ, NX, S, nt, nsrc, nrec, fs, tp, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* tpufwi_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
