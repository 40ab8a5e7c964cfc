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
//             F2 f3_cells_tiled one walk of 2.5D tiles over the grid, one
//                           thread per cell of a tile (see "2.5D marching
//                           tiles"): the three 9-tap D2 stencils of P_{t-1}
//                           from a register column and a shared plane tile,
//                           then f3_tail: D1_d phi_d' and psi_d' in the CPML
//                           reach of each axis (staged in shared memory),
//                           the leapfrog in place over P_{t-2}, the surface
//                           pin; optionally illum += P_{t-1}^2
//             F3 f3_src_rcv one block: sources (serially: coinciding sources
//                           sum in a fixed order), then receivers
//             F4 f3_ring_get optional: the ring of the post-source field into
//                           a tape row (fp32 or bf16)
//   reverse:  R0 r3_inject  one block: receiver-cotangent injection (each
//                           cell owned by its first receiver, which sums the
//                           others in index order), lambda at the sources
//             R1 r3_cells1_tiled one walk over the grid, P_t tiled (psibar
//                           staged): lapw, then r3_tail1: reconstruction
//                           of P_{t-2} over P_t, imaging, surface mask,
//                           psibar -> w
//             R1b r3_src_ring the reconstruction's sources, the ring imposed
//             R2 r3_lines   the line pass: a block owns whole lines along
//                           one axis, through both of its strips: phibar ->
//                           y (kept in shared memory), then the axis's
//                           transposed CPML term t = D2 w - D1 y of every
//                           cell within S + R of a face, into the term
//                           arrays (see "line pass")
//             R3 r3_cells2_tiled one walk over the grid, C and lambda_t
//                           tiled (u = C lambda formed once a tap read), the
//                           cell's three terms as operands: D2 u, then
//                           r3_tail2: lambda_{t-1}
// The gather variants f3_cells, r3_cells1 and r3_cells2 (one thread per
// cell of the whole grid, every tap and strip value a global load; u formed
// 25 times a cell) compute the same values in the same order: every variant
// runs the same tails, reading the strips through a reader (DeviceStrips,
// TileStrips) and the terms at the cell, so the tiled variant is bitwise
// equal to them. They run only when a check asks for them (variant 1 of the
// entry points); both variants run the same line pass.
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
// are never stored. The reverse's term arrays have the same layout, 2(S + R)
// deep on their axis (the cells within S + R of either face; where the two
// bands of a short axis overlap, a cell is held in the low band only). Ring
// cells are int32 indices into the flattened (NY, NZ, NX) padded grid.
// Every count fits int32 at the full SEG/EAGE Overthrust grid (837 x 223 x
// 837 halo cells); tape offsets are size_t.

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

// band coordinate (0 .. 2S) of padded coordinate c on an axis of n cells
// for bands S deep at either face (the strips; the terms' bands are S + R
// deep), -1 outside both bands or outside the grid
__device__ __forceinline__ int strip_coord(int c, int n, int S) {
  if (c < 0 || c >= n) return -1;
  if (c < S) return c;
  if (c >= n - S) return c - n + 2 * S;
  return -1;
}

// the padded coordinate of band coordinate j (bands S deep, axis of n)
__device__ __forceinline__ int band_pos(int j, int n, int S) { return j < S ? j : n - 2 * S + j; }

// offset of (y, z, x), with its axis-AX coordinate replaced by strip
// coordinate j, in the axis-AX strip array
template <int AX>
__device__ __forceinline__ int strip_off(int y, int z, int x, int j, const Dims& D) {
  const int S2 = 2 * D.S;
  if (AX == 0) return (j * D.n[1] + z) * D.n[2] + x;
  if (AX == 1) return (y * S2 + j) * D.n[2] + x;
  return (y * D.n[1] + z) * S2 + j;
}

// the same in an axis-AX array 2 SB deep on AX (the term arrays: SB = S + R)
template <int AX>
__device__ __forceinline__ int band_off(int y, int z, int x, int j, const Dims& D, int SB) {
  if (AX == 0) return (j * D.n[1] + z) * D.n[2] + x;
  if (AX == 1) return (y * 2 * SB + j) * D.n[2] + x;
  return (y * D.n[1] + z) * 2 * SB + j;
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

// ------------------------------------------------- interior box and shell
//
// The interior box holds the cells at least S + R from every face (the
// physical grid less R a side): there every axis's cpml_terms and
// tcpml_terms is 0 without a load and no psibar strip exists. The shell is
// the rest, the CPML reach (30% of the cells at the 3D main path's grid):
// cells whose tails read strip values or terms.
struct Box {
  int lo;    // S + R: the box's first cell on every axis
  int n[3];  // its extents, all 0 when it is empty
};

__host__ __device__ inline Box interior_box(const Dims& D, int R) {
  Box b;
  b.lo = D.S + R;
  bool empty = false;
  for (int d = 0; d < 3; ++d) {
    b.n[d] = D.n[d] - 2 * b.lo;
    empty = empty || b.n[d] <= 0;
  }
  if (empty) b.n[0] = b.n[1] = b.n[2] = 0;
  return b;
}

// this thread's cell of the 3D cell grid (cell_grid); false past the grid
__device__ __forceinline__ bool my_grid_cell(const Dims& D, int& y, int& z, int& x) {
  x = blockIdx.x * blockDim.x + threadIdx.x;
  z = blockIdx.y * blockDim.y + threadIdx.y;
  y = blockIdx.z;
  return x < D.n[2] && z < D.n[1];
}

// ---------------------------------------------------------- strip readers
//
// The strip values a pass's tail reads at its cell (y, z, x), through a
// reader: nb<AX>(a, k), the value k cells along AX of the pass's strip
// array a (phi'; w, then y), zero outside the strips; mine<AX>(o), the
// cell's own value of its own strip array (psi; psibar) at strip offset o;
// profile(), the packed profiles. DeviceStrips reads them from device
// memory (the gather passes, the box, whose cells read none, and the
// per-step engine); TileStrips (below) from a tile's shared memory.
// The tails' arithmetic is the same through either.

// a pass's strip arrays: NA read along their axis, NP at the cell
template <int NA, int NP>
struct StripIn {
  Strips nb[NA > 0 ? NA : 1];
  Strips own[NP > 0 ? NP : 1];
  const float* prof;
};

template <int NA, int NP>
struct DeviceStrips {
  const StripIn<NA, NP>& in;
  int y, z, x;
  const Dims& D;
  template <int AX>
  __device__ __forceinline__ float nb(int a, int k) const {
    return strip_at<AX>(in.nb[a].s[AX], y, z, x, k, D);
  }
  template <int AX>
  __device__ __forceinline__ float mine(int o) const {
    return in.own[0].s[AX][o];
  }
  __device__ __forceinline__ const float* profile() const { return in.prof; }
};

// ---------------------------------------------------- 2.5D marching tiles
//
// The tiled cell passes share one walk, march(). A block of kTZ x kTX threads
// (x contiguous: a warp is the 32 x of one z row) owns a (z, x) tile and
// marches along y over a chunk of planes: the tiles of the whole grid (the
// box's planes in chunks of cy, then the y slabs; walk_region); a tile at
// the far edge of its region runs only its rows and columns inside
// (TileSpan). Each thread keeps
// its column's 2R+1 values of the stencil field along y in registers (q[k] at
// plane y - R + k), shifted one plane a step; each value enters the column
// once, as plane y + R. The z and x taps come from the plane tile, (kTZ + 2R)
// x (kTX + 2R) values in shared memory: each value of the field is loaded
// from device memory once for its own tile (its halo ring, at order 8 448
// cells a 512-cell plane, are the neighbour tiles' cells, mostly L2 hits).
//
// A plane's loads must be in flight long before it is computed, and a thread
// can hold only a few of them in registers. So every load goes global ->
// shared by cp.async (4 bytes, zero-filled where masked), kAhead planes
// ahead, into two rings: the field's plane tiles (planes y .. y + R + kAhead)
// and the cell's own operands of the pass's tail (planes y .. y + kAhead),
// one cp.async group a plane. One __syncthreads() a plane: after it every
// thread has finished the previous plane, whose slots the next group then
// refills. Only a thread itself reads its operands, so a ring short of shared
// memory keeps kAhead operand slots: each thread reads plane y's before it
// issues the copies of plane y + kAhead into the same slot. A warp reads 32
// consecutive words of one tile row at every tap, so the row stride kTX + 2R
// is free of bank conflicts without padding.
//
// A tile that reaches the CPML (within S + R of a face) stages the strip
// values its tails read the same way, in the same groups, so that nothing is
// loaded after the barrier but the cell's own write-back: the x- and z-strip
// values in in-plane tiles of the strip arrays (the tile's rows by its
// columns +- R; its rows +- R by its columns), the y-strip values as a
// register column beside q (entering as an operand of plane y, its value at y
// + R), the cell's own strip values as operands, the profiles once a block. A
// tile copies an axis's strip values only where it reaches that axis's CPML
// (TileSpan reach); outside a strip a copy fills the zero the tails expect. A
// tile that reaches none runs as a box tile. The second reverse pass stages
// no strip values: its cells read the terms the line pass wrote, an operand
// per axis, copied where the tile reaches that axis's CPML (a zero fill at
// cells outside the reach) and zero elsewhere.
//
// Ragged edges: every thread copies its share and joins the barriers; a copy
// from outside the halo layout ((NY+2R) x (NZ+2R) x (NX+2R)) or past the rows
// and columns the tile's cells reach is not made (no cell reads it), nor are
// the operands of a thread off the tile's cells; only threads on the tile's
// cells run the cell. The launch plan (chunk depth cy and the largest pass's
// shared bytes, checked against these shapes) is computed in Python, and the
// walks' regions mirrored there: kernels/acoustic3d_scan.py a3d_tile_plan,
// walk_regions.
constexpr int kTZ = 16;
constexpr int kTX = 32;
constexpr int kAhead = 3;
constexpr int kTileThreads = kTZ * kTX;
// ring slots, powers of two so that a plane's slot is a mask: the field's
// planes y .. y + R + kAhead (R <= 4), the operands' and the strip tiles' y
// .. y + kAhead
constexpr int kFieldSlots = 8;
constexpr int kOpSlots = 4;
static_assert(4 + kAhead + 1 <= kFieldSlots && kAhead + 1 <= kOpSlots, "ring slots");

// NF field tiles (the stencil field is their product when NF = 2: u = C
// lambda), NH tail operands at the cell's halo offset, NG at its (NY, NZ,
// NX) offset; a staging ring's NA strip arrays read along their axis (an x
// and a z tile each, and a y column whose front is an operand) and NP read
// at the cell (an operand per axis); NT term arrays read at the cell (an
// operand per axis, zero outside its reach); operands in that order, in NO_
// slots (kOpSlots, or kAhead read before their refill)
template <int R, int NF_, int NH_, int NG_, int NA_ = 0, int NP_ = 0, int NO_ = kOpSlots,
          int NT_ = 0>
struct Ring {
  static_assert(NO_ == kOpSlots || NO_ == kAhead, "operand slots");
  static constexpr int NF = NF_, NH = NH_, NB = NH_ + NG_, NA = NA_, NP = NP_, NT = NT_;
  static constexpr int NK = NB + 3 * NT_;          // operand arrays: NB, then the terms'
  static constexpr int TERM = NB + 3 * NP_ + NA_;  // the first term operand
  static constexpr int NOP = TERM + 3 * NT_;
  static constexpr int W = kTX + 2 * R;  // row stride, floats
  static constexpr int PLANE = (kTZ + 2 * R) * W;
  static constexpr int XT = kTZ * W;            // an x-strip tile
  static constexpr int ZT = (kTZ + 2 * R) * kTX;  // a z-strip tile
  static constexpr int NS = kFieldSlots;
  static constexpr int NO = NO_;
  static constexpr bool EARLY = NO_ == kAhead;  // operands read before their refill
  static constexpr int PER = (PLANE + kTileThreads - 1) / kTileThreads;  // copies a thread
  static constexpr int PERX = (XT + kTileThreads - 1) / kTileThreads;
  static constexpr int PERZ = (ZT + kTileThreads - 1) / kTileThreads;
  static constexpr int FIELD = NF * NS * PLANE;  // floats
  static constexpr int OPS = NOP * NO * kTileThreads;
  static constexpr int STRIP = NA * kOpSlots * (XT + ZT);
  static constexpr int BYTES = (FIELD + OPS + STRIP) * (int)sizeof(float);
  // with the profiles (12 S floats) of a pass that updates a strip array
  // at the cell (NP)
  __host__ __device__ static constexpr int bytes(int S) {
    return BYTES + (NP > 0 ? 12 * S * (int)sizeof(float) : 0);
  }
};
// the passes' rings, for tiles that reach no CPML and (S, T) for tiles that
// do; every walk tiles the whole grid in one launch: f3 (P_{t-1}; P_{t-2},
// C, illum; phi' along, psi at the cell), r3_cells1 (P_{t-1}; C, P_t,
// lambda_t, gacc; psibar at the cell) and r3_cells2 (C and lambda_t;
// lambda_{t+1}; the three terms at the cell). Every tiled pass is held to 2
// blocks an SM by its 64 registers a thread, and its largest ring leaves
// room for two. Measured on the H100, two blocks of 108.7 KB an SM left too
// little L1 for the copies in flight and ran the box's tiles 14% slower than
// at 96 KB: RingF3S and RingR1S keep kAhead operand slots, and RingR1, which
// ran 3% faster so (r3_cells2's rings ran slower so).
template <int R> using RingF3 = Ring<R, 1, 2, 1>;
template <int R> using RingR1 = Ring<R, 1, 3, 1, 0, 0, kAhead>;
template <int R> using RingR2 = Ring<R, 2, 1, 0>;
template <int R> using RingF3S = Ring<R, 1, 2, 1, 1, 1, kAhead>;
template <int R> using RingR1S = Ring<R, 1, 3, 1, 0, 1, kAhead>;
template <int R> using RingR2T = Ring<R, 2, 1, 0, 0, 0, kOpSlots, 1>;
static_assert(RingR2T<4>::BYTES <= 96 * 1024 && RingF3S<4>::BYTES <= 227 * 1024,
              "r3_cells2's ring leaves room for two blocks an SM");

template <int R>
inline int ring_bytes_max(int S) {
  const int b[3] = {RingF3S<R>::bytes(S), RingR1S<R>::bytes(S), RingR2T<R>::BYTES};
  int m = 0;
  for (int v : b) m = v > m ? v : m;
  return m;
}

// 4-byte global -> shared copy, zero-filled (nothing read) unless ok
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The stencil field at slot offset o of the NF field tiles f (stride
// RG::NS * RG::PLANE between them): the tile's value, or C * lambda
template <int NF>
__device__ __forceinline__ float field_val(const float* f, int stride, int o) {
  if (NF == 1) return f[o];
  return __fmul_rn(f[o], f[stride + o]);
}

// A block's tile: its chunk [y0, y1), its first row z0 and column x0, the
// rows nz and columns nx of its cells, and whether it reaches the CPML of
// each axis (has cells within S + R of one of its faces)
struct TileSpan {
  int y0, y1, z0, x0, nz, nx;
  bool reach[3];
};

// block e of the tiles of [lo, hi) per axis: x fastest, then z, then the y
// chunks of cy planes
__device__ __forceinline__ TileSpan tile_span(int e, const int* lo, const int* hi, int cy,
                                              const Dims& D, int R) {
  const int gx = (hi[2] - lo[2] + kTX - 1) / kTX, gz = (hi[1] - lo[1] + kTZ - 1) / kTZ;
  TileSpan s;
  s.x0 = lo[2] + (e % gx) * kTX;
  s.z0 = lo[1] + (e / gx) % gz * kTZ;
  s.y0 = lo[0] + e / (gx * gz) * cy;
  s.y1 = min(s.y0 + cy, hi[0]);
  s.nz = min(kTZ, hi[1] - s.z0);
  s.nx = min(kTX, hi[2] - s.x0);
  const int SE = D.S + R;
  s.reach[0] = s.y0 < SE || s.y1 > D.n[0] - SE;
  s.reach[1] = s.z0 < SE || s.z0 + s.nz > D.n[1] - SE;
  s.reach[2] = s.x0 < SE || s.x0 + s.nx > D.n[2] - SE;
  return s;
}

__host__ __device__ inline int slab_blocks(const int* lo, const int* hi, int cy) {
  return ((hi[2] - lo[2] + kTX - 1) / kTX) * ((hi[1] - lo[1] + kTZ - 1) / kTZ) *
         ((hi[0] - lo[0] + cy - 1) / cy);
}

// Slabs of the grid around the interior box, slab k as [lo, hi) per axis
// (y, z, x), false past the last: 0 the box's planes (y in [L, L + ny)),
// 4 and 5 the low and high y slabs (whole planes); with an empty box the
// whole grid. Only walk_region reads it, and only slabs 0, 4 and 5 (it
// widens slab 0 to whole rows); cases 1-3, the z and x slabs of the box's
// planes, are reached by nothing. The function keeps this form because the
// forward's walk is compiled from it: a switch of walk_region's own changed
// that walk's SASS and ran it 2-3% slower on the H100 (PERF.md).
__host__ __device__ inline bool shell_slab(const Dims& D, const Box& b, int k, int* lo, int* hi) {
  const int L = b.lo;
  for (int d = 0; d < 3; ++d) {
    lo[d] = 0;
    hi[d] = D.n[d];
  }
  if (b.n[0] == 0) return k == 0;
  if (k < 4) {
    lo[0] = L;
    hi[0] = L + b.n[0];
  }
  if (k == 2 || k == 3) {
    lo[1] = L;
    hi[1] = L + b.n[1];
  }
  switch (k) {
    case 0: hi[1] = L; break;
    case 1: lo[1] = L + b.n[1]; break;
    case 2: hi[2] = L; break;
    case 3: lo[2] = L + b.n[2]; break;
    case 4: hi[0] = L; break;
    case 5: lo[0] = L + b.n[0]; break;
    default: return false;
  }
  return true;
}

// The whole grid's walk in whole planes: the box's planes (y in [L, L +
// ny)) in chunks of cy, then the low and high y slabs, a chunk each when cy
// allows (with an empty box, the whole grid). Region k as [lo, hi) per
// axis; false past the last. (Read off shell_slab's slabs 0, 4 and 5: a
// switch of its own changed the forward's compiled walk, which then ran
// 2-3% slower on the H100, PERF.md.)
__host__ __device__ inline bool walk_region(const Dims& D, const Box& b, int k, int* lo,
                                            int* hi) {
  if (!shell_slab(D, b, k == 0 ? 0 : k + 3, lo, hi)) return false;
  lo[1] = 0;
  hi[1] = D.n[1];
  return true;
}

template <int R>
__host__ __device__ inline int grid_blocks(const Dims& D, int cy) {
  const Box b = interior_box(D, R);
  int lo[3], hi[3], n = 0;
  for (int k = 0; walk_region(D, b, k, lo, hi); ++k) n += slab_blocks(lo, hi, cy);
  return n;
}

template <int R>
__device__ __forceinline__ TileSpan grid_tile(const Dims& D, int cy) {
  const Box b = interior_box(D, R);
  int lo[3], hi[3], e = blockIdx.x;
  for (int k = 0; walk_region(D, b, k, lo, hi); ++k) {
    const int n = slab_blocks(lo, hi, cy);
    if (e < n) break;
    e -= n;
  }
  return tile_span(e, lo, hi, cy, D, R);
}

// A cell's strip values in its tile's shared memory (the reader
// interface of DeviceStrips): xs and zs its x and z tiles of array 0 at the
// cell (array a RG::XT + RG::ZT further), col the y columns (planes y - R ..
// y + R), own its own values (y, z, x), prof the profiles
template <int R, typename RG>
struct TileStrips {
  const float* xs;
  const float* zs;
  const float (&col)[RG::NA > 0 ? RG::NA : 1][2 * R + 1];
  float own[3];
  const float* prof;
  template <int AX>
  __device__ __forceinline__ float nb(int a, int k) const {
    if constexpr (AX == 0) return col[a][R + k];
    if constexpr (AX == 1) return zs[a * (RG::XT + RG::ZT) + k * kTX];
    return xs[a * (RG::XT + RG::ZT) + k];
  }
  template <int AX>
  __device__ __forceinline__ float mine(int) const {
    return own[AX];
  }
  __device__ __forceinline__ const float* profile() const { return prof; }
};

// Walk tile s over its chunk of planes. fields: the NF halo fields whose
// value (field_val) is stenciled; ops: the tail's operand arrays, the
// first RG::NH indexed by the cell's halo offset, the rest of the first
// RG::NB by its (NY, NZ, NX) offset (a null pointer is not copied: its
// operand is unread), then, when RG has terms, the three axes' term arrays
// (read at the cell's band coordinate, zero outside each axis's reach);
// sin: the pass's strip arrays and profiles, staged when RG has strips;
// cell(y, z, x, i, c, o, q, f, rd) runs each cell of the tile: i its halo
// offset, c its (NY, NZ, NX) offset, o its operands, q its column, f its
// slot in plane y's first field tile (f[dz * W + dx] at (y, z + dz, x +
// dx); the second tile RG::NS * RG::PLANE further), rd its strip reader.
template <int R, typename RG, int NK, int NA, int NP, typename Cell>
__device__ __forceinline__ void march(const TileSpan& s, const float* const (&fields)[RG::NF],
                                      const float* const (&ops)[NK],
                                      const StripIn<NA, NP>& sin, const Dims& D,
                                      const Cell& cell) {
  constexpr int NF = RG::NF, NOP = RG::NOP, NB = RG::NB;
  constexpr bool STAGED = RG::NA + RG::NP > 0;
  static_assert(!STAGED || (RG::NA == NA && RG::NP == NP), "a ring stages the pass's strips");
  static_assert(NK >= RG::NK, "an array for every operand");
  constexpr int FS = RG::NS * RG::PLANE;  // stride between the field tiles' rings
  constexpr int ST = RG::XT + RG::ZT;     // one strip array's tiles
  constexpr int NC = RG::NA > 0 ? RG::NA : 1;
  extern __shared__ float smem[];
  float* const ring = smem;                 // [NF][NS][PLANE]
  float* const oring = smem + RG::FIELD;    // [NO][NOP][kTileThreads]
  float* const sring = oring + RG::OPS;     // [kOpSlots][NA][XT + ZT]
  float* const prof = sring + RG::STRIP;    // 12 S
  const int tx = threadIdx.x, tz = threadIdx.y, t = tz * kTX + tx;
  const int x = s.x0 + tx, z = s.z0 + tz;
  const int y0 = s.y0, y1 = s.y1;
  const int ez = D.n[1] + 2 * R;  // the halo layout's z extent; D.lx its x extent
  const bool on_grid = tz < s.nz && tx < s.nx;  // one of the tile's cells
  // this thread's cells of a plane tile: slot t + j * kTileThreads, its
  // in-plane halo offset (-1: not copied, past the tile or the halo layout
  // or the rows and columns the tile's cells reach, which no cell reads)
  int goff[RG::PER];
#pragma unroll
  for (int j = 0; j < RG::PER; ++j) {
    const int e = t + j * kTileThreads;
    const int r = e / RG::W, c = e - r * RG::W;
    const int zh = s.z0 + r, xh = s.x0 + c;  // halo coordinates of (z0 - R + r, x0 - R + c)
    goff[j] = e < RG::PLANE && zh < ez && xh < D.lx && r < s.nz + 2 * R && c < s.nx + 2 * R
                  ? zh * D.lx + xh
                  : -1;
  }
  const int own = on_grid ? (z + R) * D.lx + x + R : 0;  // in-plane halo offset
  const int own_g = on_grid ? z * D.n[2] + x : 0;         // in-plane grid offset
  const int plane_g = D.n[1] * D.n[2];
  const int S2 = 2 * D.S;
  // the strip tiles' in-plane offsets: the x tile's rows by its columns +-
  // R in the x-strip array, its rows +- R by its columns in the z-strip
  // array (-1: zero-filled, outside the strips; -2: not copied, unread)
  int xoff[RG::PERX], zoff[RG::PERZ];
  int jz = -1, jx = -1;
  if constexpr (STAGED) {
#pragma unroll
    for (int j = 0; j < RG::PERX; ++j) {
      const int e = t + j * kTileThreads;
      const int r = e / RG::W, c = e - r * RG::W;
      const int js = strip_coord(s.x0 - R + c, D.n[2], D.S);
      xoff[j] = e >= RG::XT || r >= s.nz ? -2 : (js >= 0 ? (s.z0 + r) * S2 + js : -1);
    }
#pragma unroll
    for (int j = 0; j < RG::PERZ; ++j) {
      const int e = t + j * kTileThreads;
      const int r = e / kTX, c = e - r * kTX;
      const int js = strip_coord(s.z0 - R + r, D.n[1], D.S);
      const bool unread = e >= RG::ZT || c >= s.nx || r >= s.nz + 2 * R;
      zoff[j] = unread ? -2 : (js >= 0 ? js * D.n[2] + s.x0 + c : -1);
    }
    if (on_grid) {
      jz = strip_coord(z, D.n[1], D.S);
      jx = strip_coord(x, D.n[2], D.S);
    }
  }
  // the cell's term coordinates along z and x (-1: outside the reach)
  [[maybe_unused]] const int SE = D.S + R;
  [[maybe_unused]] int tjz = -1, tjx = -1;
  if constexpr (RG::NT > 0) {
    if (on_grid) {
      tjz = strip_coord(z, D.n[1], SE);
      tjx = strip_coord(x, D.n[2], SE);
    }
  }
  // grid plane p's field tiles into their slot
  auto copy_field = [&](int p) {
    float* dst = ring + (p & (RG::NS - 1)) * RG::PLANE;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const float* src = fields[f] + (p + R) * D.ly;
#pragma unroll
      for (int j = 0; j < RG::PER; ++j)
        if (goff[j] >= 0) cp_async4(dst + f * FS + t + j * kTileThreads, src + goff[j], true);
    }
  };
  // grid plane p's operands of this cell into their slot (none off the
  // tile's cells, none of a null array), and its strip tiles
  auto copy_ops = [&](int p) {
    float* dst = oring + (p % RG::NO) * NOP * kTileThreads + t;
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      const float* a = ops[k];
      const int o = k < RG::NH ? (p + R) * D.ly + own : p * plane_g + own_g;
      if (a != nullptr && on_grid) cp_async4(dst + k * kTileThreads, a + o, true);
    }
    if constexpr (STAGED) {
#pragma unroll
      for (int b = 0; b < (on_grid ? RG::NP : 0); ++b) {
        const Strips& a = sin.own[b];
        float* d = dst + (NB + 3 * b) * kTileThreads;
        // (read only by a cell inside the strip)
        const int jy = strip_coord(p, D.n[0], D.S);
        if (jy >= 0) cp_async4(d, a.s[0] + (jy * D.n[1] + z) * D.n[2] + x, true);
        if (jz >= 0) cp_async4(d + kTileThreads, a.s[1] + (p * S2 + jz) * D.n[2] + x, true);
        if (jx >= 0) cp_async4(d + 2 * kTileThreads, a.s[2] + (p * D.n[1] + z) * S2 + jx, true);
      }
#pragma unroll
      for (int a = 0; a < RG::NA; ++a) {
        const Strips& sa = sin.nb[a];
        if (s.reach[0] && on_grid) {  // the y column's front: plane p + R
          const int jy = strip_coord(p + R, D.n[0], D.S);
          cp_async4(dst + (NB + 3 * RG::NP + a) * kTileThreads,
                    sa.s[0] + (jy >= 0 ? (jy * D.n[1] + z) * D.n[2] + x : 0), jy >= 0);
        }
        float* d = sring + (p & (kOpSlots - 1)) * RG::NA * ST + a * ST + t;
        if (s.reach[2]) {
          const float* src = sa.s[2] + p * D.n[1] * S2;
#pragma unroll
          for (int j = 0; j < RG::PERX; ++j)
            if (xoff[j] != -2)
              cp_async4(d + j * kTileThreads, src + max(xoff[j], 0), xoff[j] >= 0);
        }
        if (s.reach[1]) {
          const float* src = sa.s[1] + p * S2 * D.n[2];
#pragma unroll
          for (int j = 0; j < RG::PERZ; ++j)
            if (zoff[j] != -2)
              cp_async4(d + RG::XT + j * kTileThreads, src + max(zoff[j], 0), zoff[j] >= 0);
        }
      }
    }
    if constexpr (RG::NT > 0) {
      // the cell's terms on the axes the tile reaches (zero-filled outside
      // the reach); the others are zeroed as they are read
      float* d = dst + RG::TERM * kTileThreads;
      const int tjy = strip_coord(p, D.n[0], SE);
      if (s.reach[0] && on_grid)
        cp_async4(d, ops[NB] + (tjy >= 0 ? band_off<0>(p, z, x, tjy, D, SE) : 0), tjy >= 0);
      if (s.reach[1] && on_grid)
        cp_async4(d + kTileThreads,
                  ops[NB + 1] + (tjz >= 0 ? band_off<1>(p, z, x, tjz, D, SE) : 0), tjz >= 0);
      if (s.reach[2] && on_grid)
        cp_async4(d + 2 * kTileThreads,
                  ops[NB + 2] + (tjx >= 0 ? band_off<2>(p, z, x, tjx, D, SE) : 0), tjx >= 0);
    }
  };
  // the column below the chunk (grid planes y0 - R .. y0 - 1): plain loads
  float q[2 * R + 1];
  const int mine = (tz + R) * RG::W + tx + R;
#pragma unroll
  for (int k = 1; k <= R; ++k) {
    const int o = (y0 + k - 1) * D.ly + own;
    q[k] = !on_grid ? 0.f : (NF == 1 ? fields[0][o] : __fmul_rn(fields[0][o], fields[NF - 1][o]));
  }
  // the y-strip columns: planes y0 - R .. y0 + R - 1 by plain loads (their
  // fronts then come as operands), and the profiles
  float col[NC][2 * R + 1] = {};
  if constexpr (STAGED) {
#pragma unroll
    for (int a = 0; a < RG::NA; ++a)
#pragma unroll
      for (int k = 1; k <= 2 * R; ++k)
        col[a][k] = s.reach[0] && on_grid ? strip_at<0>(sin.nb[a].s[0], y0, z, x, k - 1 - R, D)
                                          : 0.f;
    if constexpr (RG::NP > 0)
      for (int i = t; i < 12 * D.S; i += kTileThreads) prof[i] = sin.prof[i];
  }
  // planes y0 .. y0 + R - 1 in one group, then kAhead groups: the field's
  // plane y0 + R + a and the operands of plane y0 + a
  for (int p = y0; p < y0 + R; ++p) copy_field(p);
  cp_async_commit();
#pragma unroll
  for (int a = 0; a < kAhead; ++a) {
    if (y0 + R + a < y1 + R) copy_field(y0 + R + a);
    if (y0 + a < y1) copy_ops(y0 + a);
    cp_async_commit();
  }
  cp_async_wait<kAhead>();
  __syncthreads();
#pragma unroll
  for (int k = R + 1; k <= 2 * R; ++k)
    q[k] = field_val<NF>(ring + ((y0 + k - R - 1) & (RG::NS - 1)) * RG::PLANE, FS, mine);
  for (int y = y0; y < y1; ++y) {
    cp_async_wait<kAhead - 1>();  // this thread's copies of field plane y + R, operands of y
    __syncthreads();              // everyone's; and everyone is done with plane y - 1
    float o[NOP];  // plane y's operands (before their slot is refilled: RG::EARLY)
    auto read_ops = [&] {
      const float* os = oring + (y % RG::NO) * NOP * kTileThreads + t;
#pragma unroll
      for (int k = 0; k < NOP; ++k) o[k] = os[k * kTileThreads];
      if constexpr (RG::NT > 0) {
#pragma unroll
        for (int a = 0; a < 3; ++a)
          if (!s.reach[a]) o[RG::TERM + a] = 0.f;
      }
    };
    if (RG::EARLY && on_grid) read_ops();
    if (y + R + kAhead < y1 + R) copy_field(y + R + kAhead);
    if (y + kAhead < y1) copy_ops(y + kAhead);
    cp_async_commit();
    const float* f = ring + (y & (RG::NS - 1)) * RG::PLANE + mine;
#pragma unroll
    for (int k = 0; k < 2 * R; ++k) q[k] = q[k + 1];
    q[2 * R] = field_val<NF>(ring + ((y + R) & (RG::NS - 1)) * RG::PLANE, FS, mine);
    if (on_grid) {
      if (!RG::EARLY) read_ops();
      const int i = halo_at<R>(y, z, x, D), c = (y * D.n[1] + z) * D.n[2] + x;
      if constexpr (STAGED) {
        if (s.reach[0]) {
#pragma unroll
          for (int a = 0; a < RG::NA; ++a) {
#pragma unroll
            for (int k = 0; k < 2 * R; ++k) col[a][k] = col[a][k + 1];
            col[a][2 * R] = o[NB + 3 * RG::NP + a];
          }
        }
        const float* sp = sring + (y & (kOpSlots - 1)) * RG::NA * ST;
        constexpr int ob = RG::NP > 0 ? NB : 0;  // the own values (unread without NP)
        static_assert(ob + 2 < NOP, "three own values");
        const TileStrips<R, RG> rd{sp + tz * RG::W + tx + R, sp + RG::XT + (tz + R) * kTX + tx,
                                   col, {o[ob], o[ob + 1], o[ob + 2]}, prof};
        cell(y, z, x, i, c, o, q, f, rd);
      } else {
        cell(y, z, x, i, c, o, q, f, DeviceStrips<NA, NP>{sin, y, z, x, D});
      }
    }
  }
  cp_async_wait<0>();
}

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

// axis AX's CPML parts at (y, z, x), given d2 = D2_AX p at the cell and
// phi' (rd's array 0) and psi (its own array) through the reader rd:
// corr = D1 phi' within R of the strips and, inside them, psi' (written in
// place to psi) as ps. Returns 0 outside that reach, 1 in it outside the
// strips, 2 inside a strip. psi' = b psi + a (d2 + corr), its products
// rounded as written (fmaf, __fmul_rn), so that every reader rounds alike.
template <int R, int AX, typename RD>
__device__ __forceinline__ int cpml_read(const RD& rd, float* __restrict__ psi,
                                         const float* prof, int y, int z, int x, float d2,
                                         const Dims& D, const Taps3& tp, float& corr,
                                         float& ps) {
  const int c = coord<AX>(y, z, x);
  const int SE = D.S + R;
  if (c >= SE && c < D.n[AX] - SE) return 0;
  corr = 0.f;
#pragma unroll
  for (int k = 0; k <= 2 * R; ++k)
    if (k != R) corr = fmaf(tp.d1[AX][k], rd.template nb<AX>(0, k - R), corr);
  const int j = strip_coord(c, D.n[AX], D.S);
  if (j < 0) return 1;
  const int o = strip_off<AX>(y, z, x, j, D);
  ps = fmaf(prof_b(prof, AX, D.S)[j], rd.template mine<AX>(o),
            __fmul_rn(prof_a(prof, AX, D.S)[j], d2 + corr));
  psi[o] = ps;
  return 2;
}

// the same from the axis's strip arrays in device memory (the per-step
// engine, acoustic3d_step.cu)
template <int R, int AX>
__device__ __forceinline__ int cpml_parts(const float* __restrict__ phi,
                                          float* __restrict__ psi,
                                          const float* __restrict__ prof, int y, int z, int x,
                                          float d2, const Dims& D, const Taps3& tp, float& corr,
                                          float& ps) {
  StripIn<1, 1> in{};
  in.nb[0].s[AX] = const_cast<float*>(phi);
  in.own[0].s[AX] = psi;
  return cpml_read<R, AX>(DeviceStrips<1, 1>{in, y, z, x, D}, psi, prof, y, z, x, d2, D, tp,
                          corr, ps);
}

// axis AX's CPML terms at (y, z, x): D1 phi' within R of the strips, and
// psi' (updated in place) inside them; d2 is D2_AX p at the cell
template <int R, int AX, typename RD>
__device__ __forceinline__ float cpml_terms(const RD& rd, float* __restrict__ psi,
                                            const float* prof, int y, int z, int x, float d2,
                                            const Dims& D, const Taps3& tp) {
  float corr, ps;
  const int where = cpml_read<R, AX>(rd, psi, prof, y, z, x, d2, D, tp, corr, ps);
  return where == 0 ? 0.f : (where == 1 ? corr : corr + ps);
}

// The forward cell pass's tail, shared by every variant so that they round
// alike: d2y, d2z, d2x are D2_d P_{t-1} at the cell (halo offset i,
// (NY, NZ, NX) offset c), pc = P_{t-1} there, and the cell's operands as
// F3Ops: pold = P_{t-2}, cc = C, il = the illumination sum (when illum is
// given); rd reads phi' and psi (strip readers). The leapfrog's C * lap is
// fused explicitly (fmaf) rather than left to the compiler's contraction.
// pnext holds P_{t-2} on entry and P_t (before the sources) on exit; each
// cell reads and writes it only at itself. illum, when given, accumulates
// P_{t-1}^2 on the (NY, NZ, NX) grid.
struct F3Ops {
  float pold, cc, il;
};

// (no __restrict__ on the arrays the pass writes: their loads must not take
// the read-only cache)
__device__ __forceinline__ F3Ops f3_fetch(const float* pnext, const float* __restrict__ c2,
                                          const float* illum, int i, int c) {
  return F3Ops{pnext[i], c2[i], illum != nullptr ? illum[c] : 0.f};
}

template <int R, typename RD>
__device__ __forceinline__ void f3_tail(float d2y, float d2z, float d2x, float pc,
                                        const F3Ops& o, float* __restrict__ pnext, const RD& rd,
                                        const Strips& psi, float* __restrict__ illum, int y,
                                        int z, int x, int i, int c, const Dims& D, int fs,
                                        const Taps3& tp) {
  const float* prof = rd.profile();
  float acc = d2y + d2z + d2x;
  acc += cpml_terms<R, 0>(rd, psi.s[0], prof, y, z, x, d2y, D, tp);
  acc += cpml_terms<R, 1>(rd, psi.s[1], prof, y, z, x, d2z, D, tp);
  acc += cpml_terms<R, 2>(rd, psi.s[2], prof, y, z, x, d2x, D, tp);
  if (illum != nullptr) illum[c] = fmaf(pc, pc, o.il);
  const float pn = fmaf(o.cc, acc, 2.f * pc - o.pold);
  pnext[i] = (z == fs) ? 0.f : pn;
}

// the gather variant: one thread per cell of the grid, every tap of
// P_{t-1} and every strip value a global load
template <int R>
__global__ void f3_cells(const float* __restrict__ p, float* __restrict__ pnext,
                         const float* __restrict__ c2, Strips phi, Strips psi,
                         const float* __restrict__ prof, float* __restrict__ illum, Dims D,
                         int fs, Taps3 tp) {
  int y, z, x;
  if (!my_grid_cell(D, y, z, x)) return;
  const int i = halo_at<R>(y, z, x, D), c = (y * D.n[1] + z) * D.n[2] + x;
  float d2y = 0.f, d2z = 0.f, d2x = 0.f;
#pragma unroll
  for (int k = 0; k <= 2 * R; ++k) {
    d2y = fmaf(tp.d2[0][k], p[i + (k - R) * D.ly], d2y);
    d2z = fmaf(tp.d2[1][k], p[i + (k - R) * D.lx], d2z);
    d2x = fmaf(tp.d2[2][k], p[i + k - R], d2x);
  }
  const StripIn<1, 1> in{{phi}, {psi}, prof};
  f3_tail<R>(d2y, d2z, d2x, p[i], f3_fetch(pnext, c2, illum, i, c), pnext,
             DeviceStrips<1, 1>{in, y, z, x, D}, psi, illum, y, z, x, i, c, D, fs, tp);
}

// the tiled variant: P_{t-1} marched through the 2.5D tiles (RingF3S:
// phi' and psi staged)
template <int R, typename RG>
__device__ __forceinline__ void f3_tiles(const TileSpan& s, const float* __restrict__ p,
                                         float* __restrict__ pnext,
                                         const float* __restrict__ c2, const Strips& phi,
                                         const Strips& psi, const float* __restrict__ prof,
                                         float* __restrict__ illum, const Dims& D, int fs,
                                         const Taps3& tp) {
  constexpr int W = RG::W;
  const float* const fields[1] = {p};
  const float* const ops[3] = {pnext, c2, illum};
  const StripIn<1, 1> in{{phi}, {psi}, prof};
  auto cell = [&](int y, int z, int x, int i, int c, const float (&o)[RG::NOP],
                  const float (&q)[2 * R + 1], const float* t, const auto& rd) {
    float d2y = 0.f, d2z = 0.f, d2x = 0.f;
#pragma unroll
    for (int k = 0; k <= 2 * R; ++k) {
      d2y = fmaf(tp.d2[0][k], q[k], d2y);
      d2z = fmaf(tp.d2[1][k], t[(k - R) * W], d2z);
      d2x = fmaf(tp.d2[2][k], t[k - R], d2x);
    }
    f3_tail<R>(d2y, d2z, d2x, q[R], F3Ops{o[0], o[1], o[2]}, pnext, rd, psi, illum, y, z, x, i,
               c, D, fs, tp);
  };
  march<R, RG>(s, fields, ops, in, D, cell);
}

// one walk over the whole grid: a tile that reaches the CPML stages its
// strips, one that does not runs as a box tile; ILLUM: whether illum is
// given (without it the walk compiles no illumination operand)
template <int R, bool ILLUM>
__global__ void __launch_bounds__(kTileThreads, 2)
    f3_cells_tiled(const float* __restrict__ p, float* __restrict__ pnext,
                   const float* __restrict__ c2, Strips phi, Strips psi,
                   const float* __restrict__ prof, float* __restrict__ illum_, Dims D, int fs,
                   Taps3 tp, int cy) {
  float* const illum = ILLUM ? illum_ : nullptr;
  const TileSpan s = grid_tile<R>(D, cy);
  if (s.reach[0] || s.reach[1] || s.reach[2])
    f3_tiles<R, RingF3S<R>>(s, p, pnext, c2, phi, psi, prof, illum, D, fs, tp);
  else
    f3_tiles<R, RingF3<R>>(s, p, pnext, c2, phi, psi, prof, illum, D, fs, tp);
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

// psibar at the cell on axis AX's strip, read through rd (its own array)
template <int AX, typename RD>
__device__ __forceinline__ void psibar_cell(const RD& rd, const Strips& psb, const Strips& w,
                                            const float* prof, int y, int z, int x, float u,
                                            const Dims& D) {
  const int j = strip_coord(coord<AX>(y, z, x), D.n[AX], D.S);
  if (j < 0) return;
  const int o = strip_off<AX>(y, z, x, j, D);
  const float ps = rd.template mine<AX>(o) + u;
  psb.s[AX][o] = prof_b(prof, AX, D.S)[j] * ps;
  w.s[AX][o] = prof_a(prof, AX, D.S)[j] * ps;
}

// The first reverse cell pass's tail, shared by every variant: lap = lapw,
// the D2 laplacian of p_t = P_{t-1} at the cell, pt = P_{t-1} there, and
// the cell's operands as R1Ops: cc = C, pnew = P_t (p_tp1 on entry), lam =
// lambda_t (q after injection), g = the gradient sum; rd reads psibar.
// p_tp1 holds P_t on entry and P_{t-2} (before its sources and ring) on
// exit; lapw images lambda_t. q is masked on the surface row in place. Each
// cell reads and writes q, p_tp1 and gacc only at itself. C * lap is fused
// and u = C lambda rounded explicitly, as f3_tail.
struct R1Ops {
  float cc, pnew, lam, g;
};

__device__ __forceinline__ R1Ops r1_fetch(const float* q, const float* __restrict__ c2,
                                          const float* p_tp1, const float* gacc, int i, int c) {
  return R1Ops{c2[i], p_tp1[i], q[i], gacc[c]};
}

template <int R, typename RD>
__device__ __forceinline__ void r3_tail1(float lap, float pt, const R1Ops& o,
                                         float* __restrict__ q, float* __restrict__ p_tp1,
                                         float* __restrict__ gacc, const RD& rd,
                                         const Strips& psb, const Strips& w, int y, int z, int x,
                                         int i, int c, const Dims& D, int fs) {
  p_tp1[i] = (z == fs) ? 0.f : fmaf(o.cc, lap, 2.f * pt - o.pnew);
  float lam = o.lam;
  if (z == fs) {  // transpose of the surface pin
    lam = 0.f;
    q[i] = 0.f;
  }
  gacc[c] = fmaf(lam, lap, o.g);
  const float u = __fmul_rn(o.cc, lam);
  const float* prof = rd.profile();
  psibar_cell<0>(rd, psb, w, prof, y, z, x, u, D);
  psibar_cell<1>(rd, psb, w, prof, y, z, x, u, D);
  psibar_cell<2>(rd, psb, w, prof, y, z, x, u, D);
}

template <int R>
__global__ void r3_cells1(float* __restrict__ q, const float* __restrict__ c2,
                          const float* __restrict__ p_t, float* __restrict__ p_tp1,
                          float* __restrict__ gacc, Strips psb, Strips w,
                          const float* __restrict__ prof, Dims D, int fs, Taps3 tp) {
  int y, z, x;
  if (!my_grid_cell(D, y, z, x)) return;
  const int i = halo_at<R>(y, z, x, D), c = (y * D.n[1] + z) * D.n[2] + x;
  float lap = 0.f;
#pragma unroll
  for (int k = 0; k <= 2 * R; ++k) {
    lap = fmaf(tp.d2[0][k], p_t[i + (k - R) * D.ly], lap);
    lap = fmaf(tp.d2[1][k], p_t[i + (k - R) * D.lx], lap);
    lap = fmaf(tp.d2[2][k], p_t[i + k - R], lap);
  }
  const StripIn<0, 1> in{{}, {psb}, prof};
  r3_tail1<R>(lap, p_t[i], r1_fetch(q, c2, p_tp1, gacc, i, c), q, p_tp1, gacc,
              DeviceStrips<0, 1>{in, y, z, x, D}, psb, w, y, z, x, i, c, D, fs);
}

// the tiled variant: P_t = P_{t-1} of the reconstruction marched through
// the tiles (RingR1S: psibar staged)
template <int R, typename RG>
__device__ __forceinline__ void r3_tiles1(const TileSpan& s, float* __restrict__ q,
                                          const float* __restrict__ c2,
                                          const float* __restrict__ p_t,
                                          float* __restrict__ p_tp1, float* __restrict__ gacc,
                                          const Strips& psb, const Strips& w,
                                          const float* __restrict__ prof, const Dims& D, int fs,
                                          const Taps3& tp) {
  constexpr int W = RG::W;
  const float* const fields[1] = {p_t};
  const float* const ops[4] = {c2, p_tp1, q, gacc};
  const StripIn<0, 1> in{{}, {psb}, prof};
  auto cell = [&](int y, int z, int x, int i, int c, const float (&o)[RG::NOP],
                  const float (&v)[2 * R + 1], const float* t, const auto& rd) {
    float lap = 0.f;
#pragma unroll
    for (int k = 0; k <= 2 * R; ++k) {
      lap = fmaf(tp.d2[0][k], v[k], lap);
      lap = fmaf(tp.d2[1][k], t[(k - R) * W], lap);
      lap = fmaf(tp.d2[2][k], t[k - R], lap);
    }
    r3_tail1<R>(lap, v[R], R1Ops{o[0], o[1], o[2], o[3]}, q, p_tp1, gacc, rd, psb, w, y, z, x, i,
                c, D, fs);
  };
  march<R, RG>(s, fields, ops, in, D, cell);
}

// one walk over the whole grid, as f3_cells_tiled
template <int R>
__global__ void __launch_bounds__(kTileThreads, 2)
    r3_cells1_tiled(float* __restrict__ q, const float* __restrict__ c2,
                    const float* __restrict__ p_t, float* __restrict__ p_tp1,
                    float* __restrict__ gacc, Strips psb, Strips w,
                    const float* __restrict__ prof, Dims D, int fs, Taps3 tp, int cy) {
  const TileSpan s = grid_tile<R>(D, cy);
  if (s.reach[0] || s.reach[1] || s.reach[2])
    r3_tiles1<R, RingR1S<R>>(s, q, c2, p_t, p_tp1, gacc, psb, w, prof, D, fs, tp);
  else
    r3_tiles1<R, RingR1<R>>(s, q, c2, p_t, p_tp1, gacc, psb, w, prof, D, fs, tp);
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

// ------------------------------------------------------------- line pass
//
// Axis AX's transposed CPML term at a cell, t = D2 w - D1 y along AX from
// w and y on the cell's own line, is needed at every cell within S + R of a
// face of AX, and y (phibar -> y) reads only u + w on the same line. So
// r3_lines hands a block kLines whole lines along one axis (x fastest: for
// the y and z axes 32 consecutive x of a row, for the x axis 32 consecutive
// z of a plane), through both of their strips, and runs for them: the
// lines' windows and the strip cells' phibar into shared memory, every load
// a cp.async started before the first barrier; phibar -> (phibar', y) at
// every strip cell (phibar_cell), y into the windows; then, after the
// second barrier, t at every cell within S + R of a face (tcpml_terms), into
// the axis's term array.
// A line's window of a band (0: low, 1: high) is S + 3R cells along AX from
// padded coordinate -R (low) or n - S - 2R (high): every tap of the band's
// strip cells and term cells lies in it, so a tap is one shared load at a
// fixed offset. It holds w and y (zero outside the strips; a window reaches
// into the other band's strip where the two bands of a short axis overlap,
// and a cell in both is computed once, in the low band) and C and lambda
// where the band's strip cells read them. r3_cells2 then reads at most
// three terms at its cell.
constexpr int kLines = 32;
constexpr int kLineThreads = 256;

// the lines' groups of axis AX (kLines lines each, the last of a row or a
// plane ragged)
template <int AX>
__host__ __device__ inline int line_groups(const Dims& D) {
  const int gx = (D.n[2] + kLines - 1) / kLines, gz = (D.n[1] + kLines - 1) / kLines;
  return AX == 0 ? D.n[1] * gx : (AX == 1 ? D.n[0] * gx : D.n[0] * gz);
}

// a line pass block's shared floats: w, y, C and lambda windows of both
// bands of kLines lines, then their strip cells' phibar
__host__ __device__ inline int line_floats(int S, int R) {
  return (4 * 2 * (S + 3 * R) + 2 * S) * kLines;
}

// Block g's lines of axis AX and their windows: window cell s of band b of
// array a (0 w, 1 y, 2 C, 3 lambda) of line l at slot(a, b, s, l), s
// stepping by step, so that a warp's loads and stores coalesce in device
// memory and in shared memory alike
template <int R, int AX>
struct LineGroup {
  int y, z, x;  // line 0's coordinates (its AX coordinate unused)
  int lines;    // its lines
  int n, S, L;  // the axis's cells, the strip depth, the window's S + 3R
  __device__ LineGroup(int g, const Dims& D) : y(0), z(0), x(0), n(D.n[AX]), S(D.S) {
    L = S + 3 * R;
    const int gx = (D.n[2] + kLines - 1) / kLines, gz = (D.n[1] + kLines - 1) / kLines;
    if (AX < 2) {
      (AX == 0 ? z : y) = g / gx;
      x = g % gx * kLines;
      lines = min(kLines, D.n[2] - x);
    } else {
      y = g / gz;
      z = g % gz * kLines;
      lines = min(kLines, D.n[1] - z);
    }
  }
  static constexpr int kStep = AX < 2 ? kLines : 1;  // between a window's cells
  __device__ __forceinline__ int slot(int a, int b, int s, int l) const {
    return AX < 2 ? ((a * 2 + b) * L + s) * kLines + l : ((a * 2 + b) * kLines + l) * L + s;
  }
  // the first window cell's padded coordinate
  __device__ __forceinline__ int win0(int b) const { return b == 0 ? -R : n - S - 2 * R; }
  // item e of count per line (x fastest): its line l and index i
  __device__ __forceinline__ static void split(int e, int count, int& l, int& i) {
    if (AX < 2) {
      l = e % kLines;
      i = e / kLines;
    } else {
      l = e / count;
      i = e - l * count;
    }
  }
  // the cell of line l at padded coordinate c along AX
  __device__ __forceinline__ void cell(int l, int c, int& cy, int& cz, int& cx) const {
    cy = AX == 0 ? c : y;
    cz = AX == 1 ? c : (AX == 2 ? z + l : z);
    cx = AX == 2 ? c : x + l;
  }
};

// the strip reader of a cell in its window (DeviceStrips' nb): array 0 w,
// array 1 y, at the cell's slots, taps step apart
template <int AX>
struct LineStrips {
  const float* s[2];
  int step;
  template <int A>
  __device__ __forceinline__ float nb(int a, int k) const {
    static_assert(A == AX, "a line reads along its own axis");
    return s[a][k * step];
  }
};

// phibar at a strip cell of axis AX and band coordinate j, phibar there:
// pt = phibar - D1 (u + w) (the transpose enters with a minus sign);
// returns phibar' = b pt and sets y = a pt. w, c and q: the cell's slots of
// its window's w, C and lambda, taps step apart. u = C lambda and u + w are
// rounded as written (__fmul_rn, __fadd_rn), not left to the compiler's
// contraction.
template <int R, int AX>
__device__ __forceinline__ float phibar_cell(const float* w, const float* c, const float* q,
                                             int step, float phibar,
                                             const float* __restrict__ prof, int j,
                                             const Dims& D, const Taps3& tp, float& y) {
  float d1 = 0.f;
#pragma unroll
  for (int k = 0; k <= 2 * R; ++k) {
    if (k == R) continue;
    const int h = (k - R) * step;
    d1 = fmaf(tp.d1[AX][k], __fadd_rn(__fmul_rn(c[h], q[h]), w[h]), d1);
  }
  const float pt = phibar - d1;
  y = prof_a(prof, AX, D.S)[j] * pt;
  return prof_b(prof, AX, D.S)[j] * pt;
}

// axis AX's transposed CPML terms at (y, z, x): D2 w - D1 y within R of
// the strips, w and y read through rd (its arrays 0 and 1)
template <int R, int AX, typename RD>
__device__ __forceinline__ float tcpml_terms(const RD& rd, int y, int z, int x, const Dims& D,
                                             const Taps3& tp) {
  const int c = coord<AX>(y, z, x);
  const int SE = D.S + R;
  if (c >= SE && c < D.n[AX] - SE) return 0.f;
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k <= 2 * R; ++k) {
    acc = fmaf(tp.d2[AX][k], rd.template nb<AX>(0, k - R), acc);
    if (k != R) acc = fmaf(-tp.d1[AX][k], rd.template nb<AX>(1, k - R), acc);
  }
  return acc;
}

// block g's lines of axis AX; sh: line_floats(S, R)
template <int R, int AX>
__device__ __forceinline__ void r3_line_group(int g, const float* __restrict__ q,
                                              const float* __restrict__ c2, const Strips& w,
                                              const Strips& pb, const Strips& tv,
                                              const float* __restrict__ prof, const Dims& D,
                                              const Taps3& tp, float* sh) {
  const LineGroup<R, AX> lg(g, D);
  const int n = lg.n, S = D.S, SE = D.S + R, L = lg.L;
  constexpr int step = LineGroup<R, AX>::kStep;
  float* const pbs = sh + 4 * 2 * L * kLines;  // phibar of the strip cells, item order
  int l, i, y, z, x;
  // every load a cp.async started before the first barrier: the windows (w,
  // zero-filled outside the strips; C and lambda at the band's strip
  // cells' taps, low: window cells s < S + 2R, high: s >= R) and the strip
  // cells' phibar; y zeroed
  for (int e = threadIdx.x; e < kLines * 2 * L; e += kLineThreads) {
    LineGroup<R, AX>::split(e, 2 * L, l, i);
    if (l >= lg.lines) continue;
    const int b = i / L, s = i - b * L, c = lg.win0(b) + s;
    lg.cell(l, c, y, z, x);
    const int j = strip_coord(c, n, S);
    cp_async4(sh + lg.slot(0, b, s, l), w.s[AX] + (j < 0 ? 0 : strip_off<AX>(y, z, x, j, D)),
              j >= 0);
    sh[lg.slot(1, b, s, l)] = 0.f;
    if (b == 0 ? s < S + 2 * R : s >= R) {
      const int h = halo_at<R>(y, z, x, D);
      cp_async4(sh + lg.slot(2, b, s, l), c2 + h, true);
      cp_async4(sh + lg.slot(3, b, s, l), q + h, true);
    }
  }
  for (int e = threadIdx.x; e < kLines * 2 * S; e += kLineThreads) {
    LineGroup<R, AX>::split(e, 2 * S, l, i);
    if (l >= lg.lines) continue;
    lg.cell(l, band_pos(i, n, S), y, z, x);
    cp_async4(pbs + e, pb.s[AX] + strip_off<AX>(y, z, x, i, D), true);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int e = threadIdx.x; e < kLines * 2 * S; e += kLineThreads) {
    LineGroup<R, AX>::split(e, 2 * S, l, i);
    if (l >= lg.lines) continue;
    const int b = i < S ? 0 : 1, c = band_pos(i, n, S), s = c - lg.win0(b);
    lg.cell(l, c, y, z, x);
    float yv;
    pb.s[AX][strip_off<AX>(y, z, x, i, D)] =
        phibar_cell<R, AX>(sh + lg.slot(0, b, s, l), sh + lg.slot(2, b, s, l),
                           sh + lg.slot(3, b, s, l), step, pbs[e], prof, i, D, tp, yv);
    sh[lg.slot(1, b, s, l)] = yv;
    // (and into the other band's window where it reaches this cell)
    const int so = c - lg.win0(1 - b);
    if (so >= 0 && so < L) sh[lg.slot(1, 1 - b, so, l)] = yv;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kLines * 2 * SE; e += kLineThreads) {
    LineGroup<R, AX>::split(e, 2 * SE, l, i);
    const int c = band_pos(i, n, SE);
    // (a cell in both bands of a short axis is the low band's)
    if (l >= lg.lines || strip_coord(c, n, SE) != i) continue;
    const int b = i < SE ? 0 : 1, s = c - lg.win0(b);
    lg.cell(l, c, y, z, x);
    const LineStrips<AX> rd{{sh + lg.slot(0, b, s, l), sh + lg.slot(1, b, s, l)}, step};
    tv.s[AX][band_off<AX>(y, z, x, i, D, SE)] = tcpml_terms<R, AX>(rd, y, z, x, D, tp);
  }
}

// the line pass: the y axis's line groups, then the z axis's, then the x
// axis's, a block each
template <int R>
__global__ void __launch_bounds__(kLineThreads)
    r3_lines(const float* __restrict__ q, const float* __restrict__ c2, Strips w, Strips pb,
             Strips tv, const float* __restrict__ prof, Dims D, Taps3 tp) {
  extern __shared__ float smem[];
  int g = blockIdx.x;
  if (g < line_groups<0>(D)) return r3_line_group<R, 0>(g, q, c2, w, pb, tv, prof, D, tp, smem);
  g -= line_groups<0>(D);
  if (g < line_groups<1>(D)) return r3_line_group<R, 1>(g, q, c2, w, pb, tv, prof, D, tp, smem);
  g -= line_groups<1>(D);
  r3_line_group<R, 2>(g, q, c2, w, pb, tv, prof, D, tp, smem);
}

// ------------------------------------------------------- second cell pass

// axis AX's term at (y, z, x) in its term array t, 0 outside its reach
template <int R, int AX>
__device__ __forceinline__ float term_at(const float* __restrict__ t, int y, int z, int x,
                                         const Dims& D) {
  const int SE = D.S + R;
  const int j = strip_coord(coord<AX>(y, z, x), D.n[AX], SE);
  return j < 0 ? 0.f : t[band_off<AX>(y, z, x, j, D, SE)];
}

// The second reverse cell pass's tail, shared by every variant: lap is the
// D2 laplacian of u = C lambda_t at the cell, and the cell's operands as
// R2Ops: qc = lambda_t, qold = lambda_{t+1} (qoth on entry), and the three
// axes' terms (0 outside each axis's reach), added in the order y, z, x.
// qoth holds lambda_{t+1} on entry and lambda_{t-1} (before its receiver
// injection) on exit; each cell reads and writes it only at itself.
struct R2Ops {
  float qc, qold, ty, tz, tx;
};

__device__ __forceinline__ void r3_tail2(float lap, const R2Ops& o, float* __restrict__ qoth,
                                         int i) {
  lap += o.ty;
  lap += o.tz;
  lap += o.tx;
  qoth[i] = 2.f * o.qc - o.qold + lap;
}

template <int R>
__global__ void r3_cells2(const float* __restrict__ qcur, float* __restrict__ qoth,
                          const float* __restrict__ c2, Strips tv, Dims D, Taps3 tp) {
  int y, z, x;
  if (!my_grid_cell(D, y, z, x)) return;
  const int i = halo_at<R>(y, z, x, D);
  float lap = 0.f;
#pragma unroll
  for (int k = 0; k <= 2 * R; ++k) {
    const int oy = i + (k - R) * D.ly, oz = i + (k - R) * D.lx, ox = i + k - R;
    lap = fmaf(tp.d2[0][k], __fmul_rn(c2[oy], qcur[oy]), lap);
    lap = fmaf(tp.d2[1][k], __fmul_rn(c2[oz], qcur[oz]), lap);
    lap = fmaf(tp.d2[2][k], __fmul_rn(c2[ox], qcur[ox]), lap);
  }
  r3_tail2(lap,
           R2Ops{qcur[i], qoth[i], term_at<R, 0>(tv.s[0], y, z, x, D),
                 term_at<R, 1>(tv.s[1], y, z, x, D), term_at<R, 2>(tv.s[2], y, z, x, D)},
           qoth, i);
}

// the tiled variant: C and lambda_t tiled, u = C lambda_t formed from them
// at each tap read (the same rounded product as the gather variant's), the
// terms as operands where the tile reaches the CPML (RingR2T)
template <int R, typename RG>
__device__ __forceinline__ void r3_tiles2(const TileSpan& s, const float* __restrict__ qcur,
                                          float* __restrict__ qoth,
                                          const float* __restrict__ c2, const Strips& tv,
                                          const Dims& D, const Taps3& tp) {
  constexpr int W = RG::W, FS = RG::NS * RG::PLANE, T = RG::TERM;
  const float* const fields[2] = {c2, qcur};
  const float* const ops[4] = {qoth, tv.s[0], tv.s[1], tv.s[2]};
  const StripIn<0, 0> in{};
  auto cell = [&](int, int, int, int i, int, const float (&o)[RG::NOP],
                  const float (&u)[2 * R + 1], const float* t, const auto&) {
    float lap = 0.f;
#pragma unroll
    for (int k = 0; k <= 2 * R; ++k) {
      lap = fmaf(tp.d2[0][k], u[k], lap);
      lap = fmaf(tp.d2[1][k], field_val<2>(t, FS, (k - R) * W), lap);
      lap = fmaf(tp.d2[2][k], field_val<2>(t, FS, k - R), lap);
    }
    if constexpr (RG::NT > 0)
      r3_tail2(lap, R2Ops{t[FS], o[0], o[T], o[T + 1], o[T + 2]}, qoth, i);
    else
      r3_tail2(lap, R2Ops{t[FS], o[0], 0.f, 0.f, 0.f}, qoth, i);
  };
  march<R, RG>(s, fields, ops, in, D, cell);
}

// one walk over the whole grid, as f3_cells_tiled: a tile that reaches the
// CPML copies its cells' terms, one that does not runs as a box tile
template <int R>
__global__ void __launch_bounds__(kTileThreads, 2)
    r3_cells2_tiled(const float* __restrict__ qcur, float* __restrict__ qoth,
                    const float* __restrict__ c2, Strips tv, Dims D, Taps3 tp, int cy) {
  const TileSpan s = grid_tile<R>(D, cy);
  if (s.reach[0] || s.reach[1] || s.reach[2])
    r3_tiles2<R, RingR2T<R>>(s, qcur, qoth, c2, tv, D, tp);
  else
    r3_tiles2<R, RingR2<R>>(s, qcur, qoth, c2, tv, D, tp);
}

// ------------------------------------------------------------ launch shapes

const dim3 kCellBlock(32, 8, 1);
const int kStripBlock = 256;
const int kSmallBlock = 256;

inline dim3 cell_grid(const Dims& D) {
  return dim3((D.n[2] + kCellBlock.x - 1) / kCellBlock.x,
              (D.n[1] + kCellBlock.y - 1) / kCellBlock.y, D.n[0]);
}

// the tiled passes: one block per (z, x) tile and y chunk of cy planes
const dim3 kTileBlock(kTX, kTZ, 1);

// the launch plan a3d_tile_plan computes (kernels/acoustic3d_scan.py)
struct TilePlan {
  int tz, tx, cy, smem;
};

// a plan this library was built for: the compiled tile, a chunk depth on
// the grid and the largest pass's shared bytes
template <int R>
inline bool plan_ok(const TilePlan& pl, const Dims& D) {
  return pl.tz == kTZ && pl.tx == kTX && pl.cy >= 1 && pl.cy <= D.n[0] &&
         pl.smem == ring_bytes_max<R>(D.S);
}

// let kernel take its rings' bytes of dynamic shared memory (above the
// default 48 KB only by this attribute)
template <typename K>
inline int allow_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

inline int strip_blocks(const Dims& D) {
  const size_t n = strip_total(D.n[0], D.n[1], D.n[2], D.S);
  return (int)((n + kStripBlock - 1) / kStripBlock);
}

inline int blocks_for(int n) { return (n + kSmallBlock - 1) / kSmallBlock; }

// the line pass: a block per line group of the three axes, and its shared
// bytes (its lines' windows)
inline int line_blocks(const Dims& D) {
  return line_groups<0>(D) + line_groups<1>(D) + line_groups<2>(D);
}
template <int R>
inline int line_smem(const Dims& D) { return line_floats(D.S, R) * (int)sizeof(float); }

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
