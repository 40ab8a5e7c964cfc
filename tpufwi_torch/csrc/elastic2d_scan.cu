// Whole-scan 2D elastic P-SV engine for Hopper (sm_90a): the forward time
// loop with an optional fp32 five-field boundary-ring tape, and the reverse
// (reconstruction, exact transposed stages, imaging).
//
// Replaces two TPU kernels of tpufwi/kernels/elastic2d_pallas_scan.py:
//   escan_forward  <- make_elastic_scan_forward (with_tape or not)
//   escan_reverse  <- make_elastic_scan_reverse
// Plain C interface, built by nvcc into its own shared library and called
// through ctypes (tpufwi_torch/kernels/elastic2d_scan.py). The kernels and
// their semantics are in elastic2d_kernels.cuh.
//
// Design. On the TPU each sweep is one pallas_call with the five fields,
// the cotangents, the gradient accumulators and the CPML strips in VMEM.
// Here they live in device memory (one 399x1749 fp32 plane is 2.8 MB; a
// forward step touches ~13 planes, a reverse step ~27, within reach of the
// 50 MB L2) and a host loop in this file launches each time step as a few
// ordered kernels on the caller's stream: 4-6 per forward step, 9-12 per
// reverse step (free surface off / on). The receivers are gathered and
// injected by index, not by the TPU kernel's one-hot matmul, so there is
// no receiver-slab contract.
//
// Tape. Row t holds rings(state after step t) of vx, vz, sxx, szz, sxz,
// fp32, taken after the sources and the stress image (a surface source sits
// in the ring); the reverse step t imposes row t-1 (zeros for t = 0), so
// the tape is written unshifted where the TPU kernel delays it one step in
// VMEM. 5 x 16,352 cells = 327 KB per step at 399x1749, order 8.
//
// What bounds it: the stencils' operations in principle (~4 D+/D- of 2R
// taps per stage and cell), but at this size the launches and the one-block
// source and receiver-injection kernels. Left for later: fusing the small
// kernels, shared-memory tiling, strip-only CPML storage, a persistent
// kernel or a CUDA graph per step.

#include "elastic2d_kernels.cuh"

namespace {

template <int R>
int forward_loop(EMats mt, EProf pr, const float* w, const long long* src,
                 const long long* rcv, float* seis, const int* ring, float* ring_tape,
                 float* ws, int NZ, int NX, int S, int nt, int nsrc, int nrec, int fs,
                 int n_ring, int force, int rec_v, const ETaps& tp, cudaStream_t st) {
  const size_t hp = (size_t)(NZ + 2 * R) * (NX + 2 * R);
  EFields f{ws, ws + hp, ws + 2 * hp, ws + 3 * hp, ws + 4 * hp};
  float* mem = ws + 5 * hp;
  for (int t = 0; t < nt; ++t) {
    estage_v<R>(f, mem, mt, pr, NZ, NX, S, fs, tp, st);
    estage_s<R>(f, mem, mt, pr, w, t, src, nsrc, rcv, nrec, seis, ring,
                ring_tape ? ring_tape + (size_t)t * 5 * n_ring : nullptr, n_ring, NZ, NX, S,
                fs, force, rec_v, tp, st);
    if (t == 0) {
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return (int)cudaGetLastError();
}

template <int R>
int reverse_loop(EMats mt, EProf pr, const float* w, const float* ybar, const float* ring_tape,
                 const int* ring, const long long* src, const long long* rcv, float* g,
                 float* srcrow, float* ws, int* chain, int NZ, int NX, int S, int nt, int nsrc,
                 int nrec, int fs, int n_ring, int force, int rec_v, const ETaps& tp,
                 cudaStream_t st) {
  const size_t hp = (size_t)(NZ + 2 * R) * (NX + 2 * R);
  const size_t pl = (size_t)NZ * NX;
  EFields f{ws, ws + hp, ws + 2 * hp, ws + 3 * hp, ws + 4 * hp};
  float* qb = ws + 5 * hp;
  EFields q{qb, qb + hp, qb + 2 * hp, qb + 3 * hp, nullptr};
  float* cbb = ws + 9 * hp;
  EFields cb{cbb, cbb + pl, cbb + 2 * pl, cbb + 3 * pl, cbb + 4 * pl};
  float* dual = cbb + 5 * pl;
  er_chain<<<e_blocks(nrec), kESmallBlock, 0, st>>>(rcv, nrec, chain);
  for (int t = nt - 1; t >= 0; --t) {
    const float* row = t >= 1 ? ring_tape + (size_t)(t - 1) * 5 * n_ring : nullptr;
    estage_rs<R>(f, cb, dual, q, g, mt, pr, w, ybar, t, src, nsrc, rcv, nrec, chain, srcrow,
                 ring, row, n_ring, NZ, NX, S, fs, force, rec_v, tp, st);
    estage_rv<R>(f, cb, dual, q, g, mt, pr, ring, row, n_ring, NZ, NX, S, fs, tp, st);
    if (t == nt - 1) {
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// ws: 5 zeroed halo planes (vx, vz, sxx, szz, sxz; the final fields on
// return) then 8 zeroed compact CPML memory planes; ring and ring_tape may
// be null together (no tape). taps: z[4], x[4], dt.
int tpufwi_escan_forward(const float* lam, const float* l2m, const float* muxz,
                         const float* bxm, const float* bzm, const float* az, const float* bz,
                         const float* ax, const float* bx, const float* w,
                         const long long* src, const long long* rcv, float* seis,
                         const int* ring, float* ring_tape, float* ws, int NZ, int NX, int S,
                         int R, int nt, int nsrc, int nrec, int fs, int n_ring, int force,
                         int rec_v, const float* taps, void* stream) {
  const ETaps tp = load_etaps(taps);
  const EMats mt{lam, l2m, muxz, bxm, bzm};
  const EProf pr{az, bz, ax, bx};
  auto st = static_cast<cudaStream_t>(stream);
  TPUFWI_EDISPATCH_R(R, forward_loop<kR>(mt, pr, w, src, rcv, seis, ring, ring_tape, ws, NZ, NX,
                                         S, nt, nsrc, nrec, fs, n_ring, force, rec_v, tp, st))
}

// ws: 5 halo planes holding the final fields (set by the caller), 4 zeroed
// halo dbar planes, 5 zeroed compact cotangent planes, 8 zeroed compact
// dual planes; g: 5 zeroed compact gradient planes (lam, l2m, muxz, bx,
// bz); srcrow (nt, nsrc); chain: 2 * nrec ints; ring_tape (nt, 5 n_ring).
int tpufwi_escan_reverse(const float* lam, const float* l2m, const float* muxz,
                         const float* bxm, const float* bzm, const float* az, const float* bz,
                         const float* ax, const float* bx, const float* w, const float* ybar,
                         const float* ring_tape, const int* ring, const long long* src,
                         const long long* rcv, float* g, float* srcrow, float* ws, int* chain,
                         int NZ, int NX, int S, int R, int nt, int nsrc, int nrec, int fs,
                         int n_ring, int force, int rec_v, const float* taps, void* stream) {
  const ETaps tp = load_etaps(taps);
  const EMats mt{lam, l2m, muxz, bxm, bzm};
  const EProf pr{az, bz, ax, bx};
  auto st = static_cast<cudaStream_t>(stream);
  TPUFWI_EDISPATCH_R(R, reverse_loop<kR>(mt, pr, w, ybar, ring_tape, ring, src, rcv, g, srcrow,
                                         ws, chain, NZ, NX, S, nt, nsrc, nrec, fs, n_ring, force,
                                         rec_v, tp, st))
}

const char* tpufwi_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
