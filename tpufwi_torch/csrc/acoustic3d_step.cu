// Per-step 3D acoustic kernels for Hopper (sm_90a): the bare leapfrog and the
// six-face CPML strip update of one time step, on fields stored on the
// padded grid as it is ((NY, NZ, NX), x contiguous, zero outside it).
//
// Replaces the TPU kernels of the per-step 3D forward:
//   tpufwi_leap3d  <- tpufwi/kernels/acoustic3d_pallas.py
//                     make_leapfrog3d_kernel (y/x blocks with x halos) and
//                     make_leapfrog3d_zsplit (y/z blocks with packed 8-row
//                     halo slabs): one function, tiled two ways for VMEM,
//                       p_next = 2 p - p_prev + C Lap3d(p)
//                     with zero Dirichlet borders, written over p_prev (the
//                     reference aliases p_prev to p_next; each cell reads
//                     p_prev only at itself)
//   tpufwi_strip3d <- tpufwi/kernels/acoustic3d_strips_pallas.py
//                     make_strip3d_y / make_strip3d_z / make_strip3d_x: per
//                     axis d, on both faces' strips (depth S = pml + R),
//                       phi' = b phi + a D1_d p
//                       corr = D1_d phi'   (phi' zero outside the strips),
//                                          over the strips and R cells inward
//                       psi' = b psi + a (D2_d p + corr)   on the strips
//                       p_next += C corr ; p_next += C psi'
//                     with the axes in the reference's order y, z, x
// On the TPU the faces' derivatives were band-matrix products at HIGHEST
// precision; here they are gathers in fp32 FMA (no tensor cores, no TF32).
// Plain C interface, built by nvcc into the 3D library with
// acoustic3d_scan.cu and called through ctypes
// (tpufwi_torch/kernels/acoustic3d_step.py, acoustic3d_strips.py).
//
// Design. Strip state is the whole-scan engine's packed layout (per axis 2S
// along it, low face then high; phi then psi; acoustic3d_kernels.cuh), and
// phi' and the CPML parts are that header's per-cell functions, read through
// a GridField instead of the halo layout: the per-step and whole-scan
// engines run one arithmetic. A strip update is four ordered launches: phi'
// of every strip cell (it reads p only), then one launch per axis over that
// axis's correction bands, one thread per cell, which reads phi' along the
// axis, updates psi at its own cell and read-modify-writes p_next at its
// own cell. Faces of different axes meet on the grid's edges and corners;
// the per-axis launches order their updates there as the reference's does,
// with no atomics, so the result is deterministic.
//
// What bounds them: memory traffic. leap3d must read p_prev, p and C and
// write p_next, 16 B/cell: 0.81 ms at the full SEG/EAGE Overthrust grid
// (849 x 235 x 849 padded, 169.4 M cells, 678 MB a field) at 3.35 TB/s. Its
// 27 stencil reads a cell come from the caches: one thread per cell, x
// contiguous, blocks ordered so a y plane's +-R neighbours (9 x 0.8 MB) stay
// in the 50 MB L2 while it is swept; interior cells skip the border tests.
// strip3d moves only its slabs: p, C and p_next over the correction bands
// (S + R deep on each face) and phi, psi on the strips. Left for later:
// shared-memory 2.5D tiling, and one launch for the three axes' bands.
// Element offsets fit int32 at the full grid; byte offsets are 64-bit
// pointer arithmetic on them.

#include "acoustic3d_kernels.cuh"

namespace {

// p on the padded grid with no border test, for cells whose stencil stays
// inside it
struct RawField {
  const float* p;
  template <int AX>
  __device__ __forceinline__ float along(int y, int z, int x, int k, const Dims& D) const {
    return p[grid_at(y, z, x, D) + k * grid_stride<AX>(D)];
  }
};

// D2_AX of the field F reads, at (y, z, x)
template <int R, int AX, typename F>
__device__ __forceinline__ float d2_axis(F f, int y, int z, int x, const Dims& D,
                                         const Taps3& tp) {
  float d2 = 0.f;
#pragma unroll
  for (int k = 0; k <= 2 * R; ++k)
    d2 = fmaf(tp.d2[AX][k], f.template along<AX>(y, z, x, k - R, D), d2);
  return d2;
}

template <int R, typename F>
__device__ __forceinline__ float lap_cell(F f, int y, int z, int x, const Dims& D,
                                          const Taps3& tp) {
  return d2_axis<R, 0>(f, y, z, x, D, tp) + d2_axis<R, 1>(f, y, z, x, D, tp) +
         d2_axis<R, 2>(f, y, z, x, D, tp);
}

template <int R>
__global__ void s3_leap(float* __restrict__ pprev, const float* __restrict__ p,
                        const float* __restrict__ c2, Dims D, Taps3 tp) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.y * blockDim.y + threadIdx.y;
  const int y = blockIdx.z;
  if (x >= D.n[2] || z >= D.n[1]) return;
  const bool inner = y >= R && y < D.n[0] - R && z >= R && z < D.n[1] - R && x >= R &&
                     x < D.n[2] - R;
  const float lap = inner ? lap_cell<R>(RawField{p}, y, z, x, D, tp)
                          : lap_cell<R>(GridField{p}, y, z, x, D, tp);
  const int i = grid_at(y, z, x, D);
  pprev[i] = 2.f * p[i] - pprev[i] + c2[i] * lap;
}

template <int R>
__global__ void s3_phi(const float* __restrict__ p, Strips phi, const float* __restrict__ prof,
                       Dims D, Taps3 tp) {
  phi_cells<R>(GridField{p}, phi, prof, blockIdx.x * blockDim.x + threadIdx.x, D, tp);
}

// Axis AX's correction bands: the S + R cells of each face along AX (low
// band, then high) by the padded grid's extent on the other two axes.
template <int R, int AX>
__host__ __device__ __forceinline__ int band_cells(const Dims& D) {
  const int b2 = 2 * (D.S + R);
  return b2 * (AX == 0 ? D.n[1] * D.n[2] : (AX == 1 ? D.n[0] * D.n[2] : D.n[0] * D.n[1]));
}

// (y, z, x) of element e of axis AX's bands, x fastest where it runs along
// the face
template <int R, int AX>
__device__ __forceinline__ void band_cell(int e, const Dims& D, int& y, int& z, int& x) {
  const int B = D.S + R, B2 = 2 * B;
  if (AX == 0) {
    const int j = e / (D.n[1] * D.n[2]);
    const int r = e - j * D.n[1] * D.n[2];
    z = r / D.n[2];
    x = r - z * D.n[2];
    y = j < B ? j : D.n[0] - B2 + j;
  } else if (AX == 1) {
    y = e / (B2 * D.n[2]);
    const int r = e - y * B2 * D.n[2];
    const int j = r / D.n[2];
    x = r - j * D.n[2];
    z = j < B ? j : D.n[1] - B2 + j;
  } else {
    const int yz = e / B2;
    const int j = e - yz * B2;
    y = yz / D.n[1];
    z = yz - y * D.n[1];
    x = j < B ? j : D.n[2] - B2 + j;
  }
}

// p_next += C corr, then += C psi' inside the strips, at one band cell
template <int R, int AX>
__global__ void s3_corr(const float* __restrict__ p, float* __restrict__ pn,
                        const float* __restrict__ c2, Strips phi, Strips psi,
                        const float* __restrict__ prof, Dims D, Taps3 tp) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= band_cells<R, AX>(D)) return;
  int y, z, x;
  band_cell<R, AX>(e, D, y, z, x);
  const float d2 = d2_axis<R, AX>(GridField{p}, y, z, x, D, tp);
  float corr = 0.f, ps = 0.f;
  const int where = cpml_parts<R, AX>(phi.s[AX], psi.s[AX], prof, y, z, x, d2, D, tp, corr, ps);
  const int i = grid_at(y, z, x, D);
  const float cc = c2[i];
  float v = pn[i] + cc * corr;
  if (where == 2) v += cc * ps;
  pn[i] = v;
}

template <int R>
int leap_launch(float* pprev, const float* p, const float* c2, const Dims& D, const Taps3& tp,
                cudaStream_t st) {
  s3_leap<R><<<cell_grid(D), kCellBlock, 0, st>>>(pprev, p, c2, D, tp);
  return (int)cudaGetLastError();
}

template <int R, int AX>
void corr_launch(const float* p, float* pn, const float* c2, const Strips& phi,
                 const Strips& psi, const float* prof, const Dims& D, const Taps3& tp,
                 cudaStream_t st) {
  const int n = band_cells<R, AX>(D);
  s3_corr<R, AX><<<(n + kStripBlock - 1) / kStripBlock, kStripBlock, 0, st>>>(
      p, pn, c2, phi, psi, prof, D, tp);
}

template <int R>
int strip_launch(const float* p, float* pn, const float* c2, float* strips, const float* prof,
                 const Dims& D, const Taps3& tp, cudaStream_t st) {
  const Strips phi = strips_at(strips, D.n[0], D.n[1], D.n[2], D.S);
  const Strips psi = strips_at(strips + strip_total(D.n[0], D.n[1], D.n[2], D.S), D.n[0],
                               D.n[1], D.n[2], D.S);
  s3_phi<R><<<strip_blocks(D), kStripBlock, 0, st>>>(p, phi, prof, D, tp);
  corr_launch<R, 0>(p, pn, c2, phi, psi, prof, D, tp, st);
  corr_launch<R, 1>(p, pn, c2, phi, psi, prof, D, tp, st);
  corr_launch<R, 2>(p, pn, c2, phi, psi, prof, D, tp, st);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// p_prev, p, c2: (NY, NZ, NX) fields; p_prev is overwritten by p_next.
int tpufwi_leap3d(float* p_prev, const float* p, const float* c2, int NY, int NZ, int NX, int R,
                  const float* taps, void* stream) {
  const Taps3 tp = load_taps3(taps);
  const Dims D = make_dims(NY, NZ, NX, 0, R);
  auto st = static_cast<cudaStream_t>(stream);
  TPUFWI_DISPATCH_R3(R, (leap_launch<kR>(p_prev, p, c2, D, tp, st)))
}

// p, c2: (NY, NZ, NX); pn: p_next, updated in place on the bands; strips: 2 x
// strip_total floats (phi, then psi), updated in place; prof: (3 axes x (a,
// b) x 2S). Needs each axis at least 2 (S + R) cells long.
int tpufwi_strip3d(const float* p, float* pn, const float* c2, float* strips, const float* prof,
                   int NY, int NZ, int NX, int S, int R, const float* taps, void* stream) {
  const Taps3 tp = load_taps3(taps);
  const Dims D = make_dims(NY, NZ, NX, S, R);
  auto st = static_cast<cudaStream_t>(stream);
  TPUFWI_DISPATCH_R3(R, (strip_launch<kR>(p, pn, c2, strips, prof, D, tp, st)))
}

}  // extern "C"
