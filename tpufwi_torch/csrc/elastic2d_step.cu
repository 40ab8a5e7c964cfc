// Per-step 2D elastic P-SV kernels for Hopper (sm_90a): one C call per stage
// of a time step, driven from a Python loop (tpufwi_torch/adjoint_elastic_step.py).
//
// Replaces the four TPU calls of the per-step elastic engine
// (tpufwi/propagators/elastic2d.py::make_elastic_simulator_fused):
//   tpufwi_estep_v   <- tpufwi/kernels/elastic2d_pallas.py::
//                       make_elastic_fused_step, kernel_v (stage V), with
//                       the mid-step velocity image
//   tpufwi_estep_s   <- the same builder's kernel_s (stage S), with the
//                       sources, the stress image, the receivers and the
//                       ring row that the reference runs as XLA ops
//   tpufwi_estep_rs  <- tpufwi/kernels/elastic2d_pallas_bwd.py::
//                       make_elastic_bwd_kernels, kernel_rs (R-S), with the
//                       receiver-cotangent injection, the stress-image
//                       transpose, the source-point cotangent before it and
//                       the re-imaging and velocity-image transpose after it
//   tpufwi_estep_rv  <- the same builder's kernel_rv (R-V), with the
//                       re-imaging of the reconstructed velocities
// Built into one library with elastic2d_scan.cu. Each entry point launches
// one of the header's stage functions (elastic2d_kernels.cuh), whose cell
// bodies and glue the whole-scan engine's fused passes run too: the two
// engines agree bitwise, and these entry points are the fused passes'
// oracle on the card (chip_smoke.py). The state is the caller's tensors
// (five zero-halo field planes, compact memory, cotangent, dual and gradient
// planes, four zero-halo dbar planes); nothing is allocated here.
//
// What bounds it: the host. Each stage is one ctypes call from Python. At
// 399x1749, order 8, a call took 0.06-0.13 ms of host time and its kernels
// 0.008 (V), 0.013 (S), 0.068 (R-S) and 0.051 ms (R-V) of device time
// (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py), so the card idles through
// most of a forward step and a value-and-grad takes about twice the
// whole-scan engine's time. Left for later: one call per step, a CUDA graph
// per step.

#include "elastic2d_kernels.cuh"

namespace {

inline EFields halo_fields(float* fields, int NZ, int NX, int R) {
  const size_t hp = (size_t)(NZ + 2 * R) * (NX + 2 * R);
  return EFields{fields, fields + hp, fields + 2 * hp, fields + 3 * hp, fields + 4 * hp};
}

inline EFields compact_fields(float* planes, int NZ, int NX) {
  const size_t pl = (size_t)NZ * NX;
  return EFields{planes, planes + pl, planes + 2 * pl, planes + 3 * pl, planes + 4 * pl};
}

inline EFields dbar_planes(float* q, int NZ, int NX, int R) {
  const size_t hp = (size_t)(NZ + 2 * R) * (NX + 2 * R);
  return EFields{q, q + hp, q + 2 * hp, q + 3 * hp, nullptr};
}

template <int R>
int step_v(EMats mt, EProf pr, float* fields, float* mem, int NZ, int NX, int S, int fs,
           const ETaps& tp, cudaStream_t st) {
  estage_v<R>(halo_fields(fields, NZ, NX, R), mem, mt, pr, NZ, NX, S, fs, tp, st);
  return (int)cudaGetLastError();
}

template <int R>
int step_s(EMats mt, EProf pr, const float* w, const long long* src, const long long* rcv,
           float* seis, const int* ring, float* ring_row, float* fields, float* mem, int t,
           int NZ, int NX, int S, int nsrc, int nrec, int fs, int n_ring, int force, int rec_v,
           const ETaps& tp, cudaStream_t st) {
  estage_s<R>(halo_fields(fields, NZ, NX, R), mem, mt, pr, w, t, src, nsrc, rcv, nrec, seis,
              ring, ring_row, n_ring, NZ, NX, S, fs, force, rec_v, tp, st);
  return (int)cudaGetLastError();
}

template <int R>
int step_rs(EMats mt, EProf pr, const float* w, const float* ybar, const long long* src,
            const long long* rcv, int* chain, float* srcrow, const int* ring,
            const float* ring_row, float* fields, float* q, float* cot, float* dual, float* g,
            int t, int init_chain, int NZ, int NX, int S, int nsrc, int nrec, int fs,
            int n_ring, int force, int rec_v, const ETaps& tp, cudaStream_t st) {
  if (init_chain) er_chain<<<e_blocks(nrec), kESmallBlock, 0, st>>>(rcv, nrec, chain);
  estage_rs<R>(halo_fields(fields, NZ, NX, R), compact_fields(cot, NZ, NX), dual,
               dbar_planes(q, NZ, NX, R), g, mt, pr, w, ybar, t, src, nsrc, rcv, nrec, chain,
               srcrow, ring, ring_row, n_ring, NZ, NX, S, fs, force, rec_v, tp, st);
  return (int)cudaGetLastError();
}

template <int R>
int step_rv(EMats mt, EProf pr, const int* ring, const float* ring_row, float* fields,
            float* q, float* cot, float* dual, float* g, int NZ, int NX, int S, int fs,
            int n_ring, const ETaps& tp, cudaStream_t st) {
  estage_rv<R>(halo_fields(fields, NZ, NX, R), compact_fields(cot, NZ, NX), dual,
               dbar_planes(q, NZ, NX, R), g, mt, pr, ring, ring_row, n_ring, NZ, NX, S, fs, tp,
               st);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// fields: 5 halo planes (vx, vz, sxx, szz, sxz); mem: 8 compact CPML planes
// (stage V's four, then stage S's four); fs: the surface row or -1. taps:
// z[4], x[4], dt.
int tpufwi_estep_v(const float* lam, const float* l2m, const float* muxz, const float* bxm,
                   const float* bzm, const float* az, const float* bz, const float* ax,
                   const float* bx, float* fields, float* mem, int NZ, int NX, int S, int R,
                   int fs, const float* taps, void* stream) {
  const ETaps tp = load_etaps(taps);
  const EMats mt{lam, l2m, muxz, bxm, bzm};
  const EProf pr{az, bz, ax, bx};
  auto st = static_cast<cudaStream_t>(stream);
  TPUFWI_EDISPATCH_R(R, step_v<kR>(mt, pr, fields, mem, NZ, NX, S, fs, tp, st))
}

// Stage S on the fields and memory planes of tpufwi_estep_v, then the
// sources of step t, the stress image, seis row t ((nt, nrec, 2) (vz, vx)
// when rec_v, else (nt, nrec)) and, when ring_row is not null, the five
// fields' rings (ring: n_ring int32 cells) into it.
int tpufwi_estep_s(const float* lam, const float* l2m, const float* muxz, const float* bxm,
                   const float* bzm, const float* az, const float* bz, const float* ax,
                   const float* bx, const float* w, const long long* src, const long long* rcv,
                   float* seis, const int* ring, float* ring_row, float* fields, float* mem,
                   int t, int NZ, int NX, int S, int R, int nsrc, int nrec, int fs, int n_ring,
                   int force, int rec_v, const float* taps, void* stream) {
  const ETaps tp = load_etaps(taps);
  const EMats mt{lam, l2m, muxz, bxm, bzm};
  const EProf pr{az, bz, ax, bx};
  auto st = static_cast<cudaStream_t>(stream);
  TPUFWI_EDISPATCH_R(R, step_s<kR>(mt, pr, w, src, rcv, seis, ring, ring_row, fields, mem, t,
                                   NZ, NX, S, nsrc, nrec, fs, n_ring, force, rec_v, tp, st))
}

// Reverse step t, first half: fields hold the state after step t on entry
// and (sigma_t, v_{t+1/2} with the source undone) on return; cot: 5 compact
// cotangent planes; dual: 8 compact dual planes; g: 5 compact gradient
// planes; q: 4 zero-halo scratch planes; srcrow (nt, nsrc) row t written;
// ring_row: tape row t-1 (5 n_ring) or null for zeros; init_chain builds
// the receiver chain (2 * nrec ints) first, on the first reverse step.
int tpufwi_estep_rs(const float* lam, const float* l2m, const float* muxz, const float* bxm,
                    const float* bzm, const float* az, const float* bz, const float* ax,
                    const float* bx, const float* w, const float* ybar, const long long* src,
                    const long long* rcv, int* chain, float* srcrow, const int* ring,
                    const float* ring_row, float* fields, float* q, float* cot, float* dual,
                    float* g, int t, int init_chain, int NZ, int NX, int S, int R, int nsrc,
                    int nrec, int fs, int n_ring, int force, int rec_v, const float* taps,
                    void* stream) {
  const ETaps tp = load_etaps(taps);
  const EMats mt{lam, l2m, muxz, bxm, bzm};
  const EProf pr{az, bz, ax, bx};
  auto st = static_cast<cudaStream_t>(stream);
  TPUFWI_EDISPATCH_R(R, step_rs<kR>(mt, pr, w, ybar, src, rcv, chain, srcrow, ring, ring_row,
                                    fields, q, cot, dual, g, t, init_chain, NZ, NX, S, nsrc,
                                    nrec, fs, n_ring, force, rec_v, tp, st))
}

// Reverse step t, second half: v_{t-1/2} over the fields' velocities, the
// velocity rings of ring_row imposed; arguments as tpufwi_estep_rs.
int tpufwi_estep_rv(const float* lam, const float* l2m, const float* muxz, const float* bxm,
                    const float* bzm, const float* az, const float* bz, const float* ax,
                    const float* bx, const int* ring, const float* ring_row, float* fields,
                    float* q, float* cot, float* dual, float* g, int NZ, int NX, int S, int R,
                    int fs, int n_ring, const float* taps, void* stream) {
  const ETaps tp = load_etaps(taps);
  const EMats mt{lam, l2m, muxz, bxm, bzm};
  const EProf pr{az, bz, ax, bx};
  auto st = static_cast<cudaStream_t>(stream);
  TPUFWI_EDISPATCH_R(R, step_rv<kR>(mt, pr, ring, ring_row, fields, q, cot, dual, g, NZ, NX, S,
                                    fs, n_ring, tp, st))
}

}  // extern "C"
