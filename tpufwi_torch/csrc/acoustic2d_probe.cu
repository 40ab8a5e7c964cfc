// The 2D whole-scan machine-model probe for Hopper (sm_90a): nt leapfrog
// steps of the 2D acoustic engine from (P_{-1}, P_0), with or without the
// CPML strip work, and no sources, receivers or tape.
//
// Replaces the TPU kernel scripts/exp_2d_scanres.py::make_probe (the probe
// P0, "leapfrog only", and P1, "+ CPML strip algebra"). On the TPU the
// probe mirrored its production kernel's layout and helpers; here it
// launches the production kernels of acoustic2d_kernels.cuh from a host
// loop on halo-padded fields, as the single-step forward does
// (forward_step):
//   P0 (strips = 0): rec_cells<R> with the pin off, the bare leapfrog
//                    P_t = 2 P_{t-1} - P_{t-2} + C Lap(P_{t-1})
//                    (what tpufwi_leapfrog launches), one launch a step;
//   P1 (strips = 1): fwd_strips<R> then fwd_cells<R> with no tape row and
//                    no surface pin, the single-step forward's step
//                    without its one-block source and receiver kernel.
// So P1 - P0 on the card is the strip cost those passes pay.
// The reference's MXU precision switch (highest / default) has no
// counterpart: every operation here is fp32 FMA, no tensor cores, no TF32.
//
// What bounds it: operations and launches. A 383 x 1733 field is 2.7 MB
// and a step's working set fits the 50 MB L2, so device-memory traffic is
// the fields in and out once per call; per step the stencils' fp32
// operations bound it, and below a few microseconds a step the launch rate.
// Built into the probes library with acoustic3d_probes.cu
// (tpufwi_torch/kernels/probes.py); the production libraries are not
// rebuilt for it.

#include "acoustic2d_kernels.cuh"

namespace {

template <int R>
int probe_loop(const float* c2, const float* az, const float* bz, const float* ax,
               const float* bx, float* pa, float* pb, float* cpml, int NZ, int NX, int S,
               int nt, int strips, const Taps& tp, cudaStream_t st) {
  const size_t plane = (size_t)(NZ + 2 * R) * (NX + 2 * R);
  float* cur = pb;   // P_{t-1}
  float* prev = pa;  // P_{t-2}, overwritten by P_t
  for (int t = 0; t < nt; ++t) {
    if (strips) {
      fwd_strips<R><<<strip_blocks(NZ, NX, S), kStripBlock, 0, st>>>(
          cur, cpml, cpml + 2 * plane, az, bz, ax, bx, NZ, NX, S, tp);
      fwd_cells<R><<<cell_grid(NZ, NX), kCellBlock, 0, st>>>(
          cur, prev, cpml, cpml + plane, cpml + 2 * plane, cpml + 3 * plane, c2, az, bz, ax,
          bx, nullptr, NZ, NX, S, -1, tp);
    } else {
      rec_cells<R><<<cell_grid(NZ, NX), kCellBlock, 0, st>>>(cur, prev, c2, nullptr, NZ, NX, -1,
                                                             tp);
    }
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

}  // namespace

extern "C" {

// pa = P_{-1}, pb = P_0: halo planes; after the call P_t (t >= 1) is in pa
// for odd t and in pb for even t, so P_nt is in pb when nt is even. cpml: 4
// zeroed halo planes (phiz, psiz, phix, psix), read only when strips != 0.
int tpufwi_scan_probe(const float* c2, const float* az, const float* bz, const float* ax,
                      const float* bx, float* pa, float* pb, float* cpml, int NZ, int NX, int S,
                      int R, int nt, int strips, const float* taps, void* stream) {
  const Taps tp = load_taps(taps);
  auto st = static_cast<cudaStream_t>(stream);
  TPUFWI_DISPATCH_R(R, probe_loop<kR>(c2, az, bz, ax, bx, pa, pb, cpml, NZ, NX, S, nt, strips,
                                      tp, st))
}

const char* tpufwi_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
