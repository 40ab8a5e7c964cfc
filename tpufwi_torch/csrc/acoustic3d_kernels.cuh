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
//             F2 the cell pass: f3_cells_tiled over the interior box, one
//                           thread per cell of a 2.5D tile (see "2.5D
//                           marching tiles"): the three 9-tap D2 stencils
//                           of P_{t-1} from a register column and a shared
//                           plane tile; beside it, on a side stream, f3_shell
//                           over the CPML shell, one thread per cell; both
//                           end in f3_tail: D1_d phi_d' and psi_d' in the
//                           CPML reach of each axis, the leapfrog in place
//                           over P_{t-2}, the surface pin; optionally
//                           illum += P_{t-1}^2
//             F3 f3_src_rcv one block: sources (serially: coinciding sources
//                           sum in a fixed order), then receivers
//             F4 f3_ring_get optional: the ring of the post-source field into
//                           a tape row (fp32 or bf16)
//   reverse:  R0 r3_inject  one block: receiver-cotangent injection (each
//                           cell owned by its first receiver, which sums the
//                           others in index order), lambda at the sources
//             R1 r3_cells1_tiled (box, P_t tiled) + r3_shell1 (shell): lapw,
//                           then r3_tail1: reconstruction of P_{t-2} over
//                           P_t, imaging, surface mask, psibar -> w
//             R1b r3_src_ring the reconstruction's sources, the ring imposed
//             R2 r3_strips  one thread per strip cell: phibar -> y
//             R3 r3_cells2_tiled (box, C and lambda_t tiled: u = C lambda
//                           formed once a tap read) + r3_shell2 (shell):
//                           D2 u, then r3_tail2: lambda_{t-1}
// The gather variants f3_cells, r3_cells1 and r3_cells2 (one thread per
// cell of the whole grid, every tap a global load; u formed 25 times a
// cell) compute the same values in the same order: the shell kernels run
// their cell code, and the tiles share their tails, so the tiled variant
// is bitwise equal to them. They run only when a check asks for them
// (variant 1 of the entry points).
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

// ------------------------------------------------- interior box and shell
//
// The interior box holds the cells at least S + R from every face (the
// physical grid less R a side): there every axis's cpml_terms and
// tcpml_terms is 0 without a load and no psibar strip exists. The shell is
// the rest, the CPML reach (30% of the cells at the 3D main path's grid):
// cells whose tails gather strip values.
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

__host__ __device__ inline int shell_count(const Dims& D, const Box& b) {
  return D.n[0] * D.n[1] * D.n[2] - b.n[0] * b.n[1] * b.n[2];
}

// (y, z, x) of shell cell e: the low y slab, then per middle plane its low
// z slab, the x slabs of its middle rows and its high z slab, then the high
// y slab (with an empty box, the whole grid in order). Consecutive cells
// are consecutive in x wherever the shell runs along x, so the shell
// kernels' loads coalesce.
__device__ __forceinline__ void shell_cell(int e, const Dims& D, const Box& b, int& y, int& z,
                                           int& x) {
  const int NX = D.n[2], plane = D.n[1] * NX, L = b.lo;
  const int low = b.n[0] == 0 ? D.n[0] * plane : L * plane;
  const int mid = plane - b.n[1] * b.n[2];  // the shell cells of a middle plane
  int r;
  if (e < low || e >= low + b.n[0] * mid) {  // a y slab: whole planes
    const int yy = e < low ? 0 : L + b.n[0];
    const int f = e < low ? e : e - low - b.n[0] * mid;
    y = yy + f / plane;
    r = f - (y - yy) * plane;
    z = r / NX;
    x = r - z * NX;
    return;
  }
  e -= low;
  y = L + e / mid;
  r = e - (y - L) * mid;
  if (r < L * NX) {  // the low z slab
    z = r / NX;
    x = r - z * NX;
    return;
  }
  r -= L * NX;
  if (r < 2 * L * b.n[1]) {  // the x slabs of the middle rows
    z = L + r / (2 * L);
    const int j = r - (z - L) * 2 * L;
    x = j < L ? j : NX - 2 * L + j;
    return;
  }
  r -= 2 * L * b.n[1];  // the high z slab
  z = L + b.n[1] + r / NX;
  x = r - (z - L - b.n[1]) * NX;
}

// this thread's shell cell in a shell launch (1D, kStripBlock threads a
// block); false past the shell
template <int R>
__device__ __forceinline__ bool my_shell_cell(const Dims& D, int& y, int& z, int& x) {
  const Box b = interior_box(D, R);
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= shell_count(D, b)) return false;
  shell_cell(e, D, b, y, z, x);
  return true;
}

// this thread's cell of the 3D cell grid (cell_grid); false past the grid
__device__ __forceinline__ bool my_grid_cell(const Dims& D, int& y, int& z, int& x) {
  x = blockIdx.x * blockDim.x + threadIdx.x;
  z = blockIdx.y * blockDim.y + threadIdx.y;
  y = blockIdx.z;
  return x < D.n[2] && z < D.n[1];
}

// ---------------------------------------------------- 2.5D marching tiles
//
// The tiled cell passes share one walk, march(), over the interior box
// (the shell around it runs one thread a cell). A block of kTZ x kTX
// threads (x contiguous: a warp is the 32 x of one z row) owns a (z, x)
// tile of the box and marches along y over a chunk of its cy planes. Each
// thread keeps its column's 2R+1 values of the stencil field along y in
// registers (q[k] at plane y - R + k), shifted one plane a step; each
// value enters the column once, as plane y + R. The z and x taps come from
// the plane tile, (kTZ + 2R) x (kTX + 2R) values in shared memory: each
// value of the field is loaded from device memory once for its own tile
// (its halo ring, at order 8 448 cells a 512-cell plane, are the neighbour
// tiles' cells, mostly L2 hits).
// A plane's loads must be in flight long before it is computed, and a
// thread can hold only a few of them in registers. So every load goes
// global -> shared by cp.async (4 bytes, zero-filled where masked), kAhead
// planes ahead, into two rings: the field's plane tiles (planes y .. y +
// R + kAhead) and the cell's own operands of the pass's tail (planes y ..
// y + kAhead), one cp.async group a plane. One __syncthreads() a plane:
// after it every thread has finished the previous plane, whose slots the
// next group then refills. A warp reads 32 consecutive words of one tile
// row at every tap, so the row stride kTX + 2R is free of bank conflicts
// without padding.
// Ragged edges: every thread copies its share and joins the barriers; a
// copy from outside the halo layout ((NY+2R) x (NZ+2R) x (NX+2R)) reads
// nothing and fills zero (never read by a cell of the box); only threads
// on the box run the cell. The launch plan (chunk depth cy and the largest
// pass's shared bytes, checked against these shapes) is computed in
// Python: kernels/acoustic3d_scan.py a3d_tile_plan.
constexpr int kTZ = 16;
constexpr int kTX = 32;
constexpr int kAhead = 3;
constexpr int kTileThreads = kTZ * kTX;
// ring slots, powers of two so that a plane's slot is a mask: the field's
// planes y .. y + R + kAhead (R <= 4), the operands' y .. y + kAhead
constexpr int kFieldSlots = 8;
constexpr int kOpSlots = 4;
static_assert(4 + kAhead + 1 <= kFieldSlots && kAhead + 1 <= kOpSlots, "ring slots");

// NF field tiles (the stencil field is their product when NF = 2: u = C
// lambda), NH tail operands at the cell's halo offset, NG at its (NY, NZ,
// NX) offset
template <int R, int NF_, int NH_, int NG_>
struct Ring {
  static constexpr int NF = NF_, NH = NH_, NOP = NH_ + NG_;
  static constexpr int W = kTX + 2 * R;  // row stride, floats
  static constexpr int PLANE = (kTZ + 2 * R) * W;
  static constexpr int NS = kFieldSlots;
  static constexpr int NO = kOpSlots;
  static constexpr int PER = (PLANE + kTileThreads - 1) / kTileThreads;  // copies a thread
  static constexpr int FIELD = NF * NS * PLANE;  // floats
  static constexpr int OPS = NOP * NO * kTileThreads;
  static constexpr int BYTES = (FIELD + OPS) * (int)sizeof(float);
};
// the three passes' rings: f3 (P_{t-1}; P_{t-2}, C, illum), r3_cells1 (P_{t-1};
// C, P_t, lambda_t, gacc), r3_cells2 (C and lambda_t; lambda_{t+1})
template <int R> using RingF3 = Ring<R, 1, 2, 1>;
template <int R> using RingR1 = Ring<R, 1, 3, 1>;
template <int R> using RingR2 = Ring<R, 2, 1, 0>;
static_assert(RingR2<4>::BYTES <= 227 * 1024, "the rings fit one block's shared memory");

template <int R>
constexpr int ring_bytes_max() {
  return RingR2<R>::BYTES > RingR1<R>::BYTES ? RingR2<R>::BYTES : RingR1<R>::BYTES;
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

// Walk this block's tile over its chunk of planes. fields: the NF halo
// fields whose value (field_val) is stenciled; ops: the tail's operand
// arrays, the first RG::NH indexed by the cell's halo offset, the rest by
// its (NY, NZ, NX) offset (a null pointer reads zeros); cell(y, z, x, i,
// c, o, q, f) runs each cell of the grid: i its halo offset, c its (NY,
// NZ, NX) offset, o its operands, q its column, f its slot in plane y's
// first field tile (f[dz * W + dx] at (y, z + dz, x + dx); the second
// tile RG::NS * RG::PLANE further).
template <int R, typename RG, typename Cell>
__device__ __forceinline__ void march(const float* const (&fields)[RG::NF],
                                      const float* const (&ops)[RG::NOP], const Dims& D, int cy,
                                      const Cell& cell) {
  constexpr int NF = RG::NF, NOP = RG::NOP;
  constexpr int FS = RG::NS * RG::PLANE;  // stride between the field tiles' rings
  extern __shared__ float smem[];
  float* const ring = smem;                // [NF][NS][PLANE]
  float* const oring = smem + RG::FIELD;   // [NO][NOP][kTileThreads]
  const Box B = interior_box(D, R);
  const int gx = (B.n[2] + kTX - 1) / kTX, gz = (B.n[1] + kTZ - 1) / kTZ;
  const int bx = blockIdx.x % gx, bz = (blockIdx.x / gx) % gz, by = blockIdx.x / (gx * gz);
  const int tx = threadIdx.x, tz = threadIdx.y, t = tz * kTX + tx;
  const int x0 = B.lo + bx * kTX, z0 = B.lo + bz * kTZ;  // the tile's first cell
  const int x = x0 + tx, z = z0 + tz;
  const int y0 = B.lo + by * cy, y1 = min(y0 + cy, B.lo + B.n[0]);
  const int ez = D.n[1] + 2 * R;  // the halo layout's z extent; D.lx its x extent
  const bool on_grid = z < B.lo + B.n[1] && x < B.lo + B.n[2];  // in the box
  // this thread's cells of a plane tile: slot t + j * kTileThreads, its
  // in-plane halo offset (-1: masked; -2: past the tile)
  int goff[RG::PER];
#pragma unroll
  for (int j = 0; j < RG::PER; ++j) {
    const int e = t + j * kTileThreads;
    const int r = e / RG::W, c = e - r * RG::W;
    const int zh = z0 + r, xh = x0 + c;  // halo coordinates of (z0 - R + r, x0 - R + c)
    goff[j] = e >= RG::PLANE ? -2 : (zh < ez && xh < D.lx ? zh * D.lx + xh : -1);
  }
  const int own = on_grid ? (z + R) * D.lx + x + R : 0;  // in-plane halo offset
  const int own_g = on_grid ? z * D.n[2] + x : 0;         // in-plane grid offset
  const int plane_g = D.n[1] * D.n[2];
  // grid plane p's field tiles into their slot
  auto copy_field = [&](int p) {
    float* dst = ring + (p & (RG::NS - 1)) * RG::PLANE;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const float* src = fields[f] + (p + R) * D.ly;
#pragma unroll
      for (int j = 0; j < RG::PER; ++j)
        if (goff[j] != -2)
          cp_async4(dst + f * FS + t + j * kTileThreads, src + max(goff[j], 0), goff[j] >= 0);
    }
  };
  // grid plane p's operands of this cell into their slot
  auto copy_ops = [&](int p) {
    float* dst = oring + (p & (RG::NO - 1)) * NOP * kTileThreads + t;
#pragma unroll
    for (int k = 0; k < NOP; ++k) {
      const float* a = ops[k];
      const int o = k < RG::NH ? (p + R) * D.ly + own : p * plane_g + own_g;
      cp_async4(dst + k * kTileThreads, a != nullptr ? a + o : fields[0], a != nullptr && on_grid);
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
    if (y + R + kAhead < y1 + R) copy_field(y + R + kAhead);
    if (y + kAhead < y1) copy_ops(y + kAhead);
    cp_async_commit();
    const float* f = ring + (y & (RG::NS - 1)) * RG::PLANE + mine;
#pragma unroll
    for (int k = 0; k < 2 * R; ++k) q[k] = q[k + 1];
    q[2 * R] = field_val<NF>(ring + ((y + R) & (RG::NS - 1)) * RG::PLANE, FS, mine);
    if (on_grid) {
      float o[NOP];
      const float* os = oring + (y & (RG::NO - 1)) * NOP * kTileThreads + t;
#pragma unroll
      for (int k = 0; k < NOP; ++k) o[k] = os[k * kTileThreads];
      cell(y, z, x, halo_at<R>(y, z, x, D), (y * D.n[1] + z) * D.n[2] + x, o, q, f);
    }
  }
  cp_async_wait<0>();
}

// the tiles of the box: x fastest, then z, then the y chunks
template <int R>
__host__ __device__ inline int tile_blocks(const Dims& D, int cy) {
  const Box b = interior_box(D, R);
  return ((b.n[2] + kTX - 1) / kTX) * ((b.n[1] + kTZ - 1) / kTZ) * ((b.n[0] + cy - 1) / cy);
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

// The forward cell pass's tail, shared by both variants so that they round
// alike: d2y, d2z, d2x are D2_d P_{t-1} at the cell (halo offset i,
// (NY, NZ, NX) offset c), pc = P_{t-1} there, and the cell's operands as
// F3Ops: pold = P_{t-2}, cc = C, il = the illumination sum (when illum is
// given). The leapfrog's C * lap is fused explicitly (fmaf) rather than
// left to the compiler's contraction. pnext holds P_{t-2} on entry and P_t
// (before the sources) on exit; each cell reads and writes it only at
// itself. illum, when given, accumulates P_{t-1}^2 on the (NY, NZ, NX)
// grid.
struct F3Ops {
  float pold, cc, il;
};

// (no __restrict__ on the arrays the pass writes: their loads must not take
// the read-only cache)
__device__ __forceinline__ F3Ops f3_fetch(const float* pnext, const float* __restrict__ c2,
                                          const float* illum, int i, int c) {
  return F3Ops{pnext[i], c2[i], illum != nullptr ? illum[c] : 0.f};
}

template <int R>
__device__ __forceinline__ void f3_tail(float d2y, float d2z, float d2x, float pc,
                                        const F3Ops& o, float* __restrict__ pnext,
                                        const Strips& phi, const Strips& psi,
                                        const float* __restrict__ prof, float* __restrict__ illum,
                                        int y, int z, int x, int i, int c, const Dims& D, int fs,
                                        const Taps3& tp) {
  float acc = d2y + d2z + d2x;
  acc += cpml_terms<R, 0>(phi.s[0], psi.s[0], prof, y, z, x, d2y, D, tp);
  acc += cpml_terms<R, 1>(phi.s[1], psi.s[1], prof, y, z, x, d2z, D, tp);
  acc += cpml_terms<R, 2>(phi.s[2], psi.s[2], prof, y, z, x, d2x, D, tp);
  if (illum != nullptr) illum[c] = fmaf(pc, pc, o.il);
  const float pn = fmaf(o.cc, acc, 2.f * pc - o.pold);
  pnext[i] = (z == fs) ? 0.f : pn;
}

// the gather variant's cell: every tap of P_{t-1} a global load
template <int R>
__device__ __forceinline__ void f3_gather_cell(const float* __restrict__ p,
                                               float* __restrict__ pnext,
                                               const float* __restrict__ c2, const Strips& phi,
                                               const Strips& psi,
                                               const float* __restrict__ prof,
                                               float* __restrict__ illum, const Dims& D, int fs,
                                               const Taps3& tp, int y, int z, int x) {
  const int i = halo_at<R>(y, z, x, D), c = (y * D.n[1] + z) * D.n[2] + x;
  float d2y = 0.f, d2z = 0.f, d2x = 0.f;
#pragma unroll
  for (int k = 0; k <= 2 * R; ++k) {
    d2y = fmaf(tp.d2[0][k], p[i + (k - R) * D.ly], d2y);
    d2z = fmaf(tp.d2[1][k], p[i + (k - R) * D.lx], d2z);
    d2x = fmaf(tp.d2[2][k], p[i + k - R], d2x);
  }
  f3_tail<R>(d2y, d2z, d2x, p[i], f3_fetch(pnext, c2, illum, i, c), pnext, phi, psi, prof, illum,
             y, z, x, i, c, D, fs, tp);
}

// the gather variant: one thread per cell of the grid
template <int R>
__global__ void f3_cells(const float* __restrict__ p, float* __restrict__ pnext,
                         const float* __restrict__ c2, Strips phi, Strips psi,
                         const float* __restrict__ prof, float* __restrict__ illum, Dims D,
                         int fs, Taps3 tp) {
  int y, z, x;
  if (my_grid_cell(D, y, z, x))
    f3_gather_cell<R>(p, pnext, c2, phi, psi, prof, illum, D, fs, tp, y, z, x);
}

// the tiled variant's shell: the gather cell, one thread per shell cell
// (kStripBlock threads a block, held to 32 registers so that an SM holds
// 2048 of them: the shell's strip gathers are latency-bound)
template <int R>
__global__ void __launch_bounds__(256, 8)
    f3_shell(const float* __restrict__ p, float* __restrict__ pnext, const float* __restrict__ c2,
             Strips phi, Strips psi, const float* __restrict__ prof, float* __restrict__ illum,
             Dims D, int fs, Taps3 tp) {
  int y, z, x;
  if (my_shell_cell<R>(D, y, z, x))
    f3_gather_cell<R>(p, pnext, c2, phi, psi, prof, illum, D, fs, tp, y, z, x);
}

// the tiled variant's box: P_{t-1} marched through the 2.5D tiles
template <int R>
__global__ void __launch_bounds__(kTileThreads, 2)
    f3_cells_tiled(const float* __restrict__ p, float* __restrict__ pnext,
                   const float* __restrict__ c2, Strips phi, Strips psi,
                   const float* __restrict__ prof, float* __restrict__ illum, Dims D, int fs,
                   Taps3 tp, int cy) {
  constexpr int W = RingF3<R>::W;
  const float* const fields[1] = {p};
  const float* const ops[3] = {pnext, c2, illum};
  auto cell = [&](int y, int z, int x, int i, int c, const float (&o)[3],
                  const float (&q)[2 * R + 1], const float* t) {
    float d2y = 0.f, d2z = 0.f, d2x = 0.f;
#pragma unroll
    for (int k = 0; k <= 2 * R; ++k) {
      d2y = fmaf(tp.d2[0][k], q[k], d2y);
      d2z = fmaf(tp.d2[1][k], t[(k - R) * W], d2z);
      d2x = fmaf(tp.d2[2][k], t[k - R], d2x);
    }
    f3_tail<R>(d2y, d2z, d2x, q[R], F3Ops{o[0], o[1], o[2]}, pnext, phi, psi, prof, illum, y,
               z, x, i, c, D, fs, tp);
  };
  march<R, RingF3<R>>(fields, ops, D, cy, cell);
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

// The first reverse cell pass's tail, shared by both variants: lap = lapw,
// the D2 laplacian of p_t = P_{t-1} at the cell, pt = P_{t-1} there, and
// the cell's operands as R1Ops: cc = C, pnew = P_t (p_tp1 on entry), lam =
// lambda_t (q after injection), g = the gradient sum. p_tp1 holds P_t on
// entry and P_{t-2} (before its sources and ring) on exit; lapw images
// lambda_t. q is masked on the surface row in place. Each cell reads and
// writes q, p_tp1 and gacc only at itself. C * lap is fused and u = C
// lambda rounded explicitly, as f3_tail.
struct R1Ops {
  float cc, pnew, lam, g;
};

__device__ __forceinline__ R1Ops r1_fetch(const float* q, const float* __restrict__ c2,
                                          const float* p_tp1, const float* gacc, int i, int c) {
  return R1Ops{c2[i], p_tp1[i], q[i], gacc[c]};
}

template <int R>
__device__ __forceinline__ void r3_tail1(float lap, float pt, const R1Ops& o,
                                         float* __restrict__ q, float* __restrict__ p_tp1,
                                         float* __restrict__ gacc, const Strips& psb,
                                         const Strips& w, const float* __restrict__ prof, int y,
                                         int z, int x, int i, int c, const Dims& D, int fs) {
  p_tp1[i] = (z == fs) ? 0.f : fmaf(o.cc, lap, 2.f * pt - o.pnew);
  float lam = o.lam;
  if (z == fs) {  // transpose of the surface pin
    lam = 0.f;
    q[i] = 0.f;
  }
  gacc[c] = fmaf(lam, lap, o.g);
  const float u = __fmul_rn(o.cc, lam);
  psibar_cell<0>(psb, w, prof, y, z, x, u, D);
  psibar_cell<1>(psb, w, prof, y, z, x, u, D);
  psibar_cell<2>(psb, w, prof, y, z, x, u, D);
}

template <int R>
__device__ __forceinline__ void r3_gather_cell1(float* __restrict__ q,
                                                const float* __restrict__ c2,
                                                const float* __restrict__ p_t,
                                                float* __restrict__ p_tp1,
                                                float* __restrict__ gacc, const Strips& psb,
                                                const Strips& w, const float* __restrict__ prof,
                                                const Dims& D, int fs, const Taps3& tp, int y,
                                                int z, int x) {
  const int i = halo_at<R>(y, z, x, D), c = (y * D.n[1] + z) * D.n[2] + x;
  float lap = 0.f;
#pragma unroll
  for (int k = 0; k <= 2 * R; ++k) {
    lap = fmaf(tp.d2[0][k], p_t[i + (k - R) * D.ly], lap);
    lap = fmaf(tp.d2[1][k], p_t[i + (k - R) * D.lx], lap);
    lap = fmaf(tp.d2[2][k], p_t[i + k - R], lap);
  }
  r3_tail1<R>(lap, p_t[i], r1_fetch(q, c2, p_tp1, gacc, i, c), q, p_tp1, gacc, psb, w, prof, y,
              z, x, i, c, D, fs);
}

template <int R>
__global__ void r3_cells1(float* __restrict__ q, const float* __restrict__ c2,
                          const float* __restrict__ p_t, float* __restrict__ p_tp1,
                          float* __restrict__ gacc, Strips psb, Strips w,
                          const float* __restrict__ prof, Dims D, int fs, Taps3 tp) {
  int y, z, x;
  if (my_grid_cell(D, y, z, x))
    r3_gather_cell1<R>(q, c2, p_t, p_tp1, gacc, psb, w, prof, D, fs, tp, y, z, x);
}

template <int R>
__global__ void r3_shell1(float* __restrict__ q, const float* __restrict__ c2,
                          const float* __restrict__ p_t, float* __restrict__ p_tp1,
                          float* __restrict__ gacc, Strips psb, Strips w,
                          const float* __restrict__ prof, Dims D, int fs, Taps3 tp) {
  int y, z, x;
  if (my_shell_cell<R>(D, y, z, x))
    r3_gather_cell1<R>(q, c2, p_t, p_tp1, gacc, psb, w, prof, D, fs, tp, y, z, x);
}

template <int R>
__global__ void __launch_bounds__(kTileThreads, 2)
    r3_cells1_tiled(float* __restrict__ q, const float* __restrict__ c2,
                    const float* __restrict__ p_t, float* __restrict__ p_tp1,
                    float* __restrict__ gacc, Strips psb, Strips w,
                    const float* __restrict__ prof, Dims D, int fs, Taps3 tp, int cy) {
  constexpr int W = RingR1<R>::W;
  const float* const fields[1] = {p_t};
  const float* const ops[4] = {c2, p_tp1, q, gacc};
  auto cell = [&](int y, int z, int x, int i, int c, const float (&o)[4],
                  const float (&v)[2 * R + 1], const float* t) {
    float lap = 0.f;
#pragma unroll
    for (int k = 0; k <= 2 * R; ++k) {
      lap = fmaf(tp.d2[0][k], v[k], lap);
      lap = fmaf(tp.d2[1][k], t[(k - R) * W], lap);
      lap = fmaf(tp.d2[2][k], t[k - R], lap);
    }
    r3_tail1<R>(lap, v[R], R1Ops{o[0], o[1], o[2], o[3]}, q, p_tp1, gacc, psb, w, prof, y, z,
                x, i, c, D, fs);
  };
  march<R, RingR1<R>>(fields, ops, D, cy, cell);
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

// The second reverse cell pass's tail, shared by both variants: lap is the
// D2 laplacian of u = C lambda_t at the cell, and the cell's operands as
// R2Ops: qc = lambda_t, qold = lambda_{t+1} (qoth on entry). qoth holds
// lambda_{t+1} on entry and lambda_{t-1} (before its receiver injection)
// on exit; each cell reads and writes it only at itself.
struct R2Ops {
  float qc, qold;
};

__device__ __forceinline__ R2Ops r2_fetch(const float* __restrict__ qcur, const float* qoth,
                                          int i) {
  return R2Ops{qcur[i], qoth[i]};
}

template <int R>
__device__ __forceinline__ void r3_tail2(float lap, const R2Ops& o, float* __restrict__ qoth,
                                         const Strips& w, const Strips& yv, int y, int z, int x,
                                         int i, const Dims& D, const Taps3& tp) {
  lap += tcpml_terms<R, 0>(w, yv, y, z, x, D, tp);
  lap += tcpml_terms<R, 1>(w, yv, y, z, x, D, tp);
  lap += tcpml_terms<R, 2>(w, yv, y, z, x, D, tp);
  qoth[i] = 2.f * o.qc - o.qold + lap;
}

template <int R>
__device__ __forceinline__ void r3_gather_cell2(const float* __restrict__ qcur,
                                                float* __restrict__ qoth,
                                                const float* __restrict__ c2, const Strips& w,
                                                const Strips& yv, const Dims& D, const Taps3& tp,
                                                int y, int z, int x) {
  const int i = halo_at<R>(y, z, x, D);
  float lap = 0.f;
#pragma unroll
  for (int k = 0; k <= 2 * R; ++k) {
    const int oy = i + (k - R) * D.ly, oz = i + (k - R) * D.lx, ox = i + k - R;
    lap = fmaf(tp.d2[0][k], __fmul_rn(c2[oy], qcur[oy]), lap);
    lap = fmaf(tp.d2[1][k], __fmul_rn(c2[oz], qcur[oz]), lap);
    lap = fmaf(tp.d2[2][k], __fmul_rn(c2[ox], qcur[ox]), lap);
  }
  r3_tail2<R>(lap, r2_fetch(qcur, qoth, i), qoth, w, yv, y, z, x, i, D, tp);
}

template <int R>
__global__ void r3_cells2(const float* __restrict__ qcur, float* __restrict__ qoth,
                          const float* __restrict__ c2, Strips w, Strips yv, Dims D, Taps3 tp) {
  int y, z, x;
  if (my_grid_cell(D, y, z, x)) r3_gather_cell2<R>(qcur, qoth, c2, w, yv, D, tp, y, z, x);
}

template <int R>
__global__ void r3_shell2(const float* __restrict__ qcur, float* __restrict__ qoth,
                          const float* __restrict__ c2, Strips w, Strips yv, Dims D, Taps3 tp) {
  int y, z, x;
  if (my_shell_cell<R>(D, y, z, x)) r3_gather_cell2<R>(qcur, qoth, c2, w, yv, D, tp, y, z, x);
}

// C and lambda_t tiled; u = C lambda_t formed from them at each tap read
// (the same rounded product as the gather variant's)
template <int R>
__global__ void __launch_bounds__(kTileThreads, 2)
    r3_cells2_tiled(const float* __restrict__ qcur, float* __restrict__ qoth,
                    const float* __restrict__ c2, Strips w, Strips yv, Dims D, Taps3 tp,
                    int cy) {
  using RG = RingR2<R>;
  constexpr int W = RG::W, FS = RG::NS * RG::PLANE;
  const float* const fields[2] = {c2, qcur};
  const float* const ops[1] = {qoth};
  auto cell = [&](int y, int z, int x, int i, int, const float (&o)[1],
                  const float (&u)[2 * R + 1], const float* t) {
    float lap = 0.f;
#pragma unroll
    for (int k = 0; k <= 2 * R; ++k) {
      lap = fmaf(tp.d2[0][k], u[k], lap);
      lap = fmaf(tp.d2[1][k], field_val<2>(t, FS, (k - R) * W), lap);
      lap = fmaf(tp.d2[2][k], field_val<2>(t, FS, k - R), lap);
    }
    r3_tail2<R>(lap, R2Ops{t[FS], o[0]}, qoth, w, yv, y, z, x, i, D, tp);
  };
  march<R, RG>(fields, ops, D, cy, cell);
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

// the shell kernels: one thread per shell cell, kStripBlock a block
template <int R>
inline int shell_blocks(const Dims& D) {
  return (shell_count(D, interior_box(D, R)) + kStripBlock - 1) / kStripBlock;
}

// the launch plan a3d_tile_plan computes (kernels/acoustic3d_scan.py)
struct TilePlan {
  int tz, tx, cy, smem;
};

// a plan this library was built for: the compiled tile, a chunk depth on
// the grid and the largest pass's shared bytes
template <int R>
inline bool plan_ok(const TilePlan& pl, const Dims& D) {
  return pl.tz == kTZ && pl.tx == kTX && pl.cy >= 1 && pl.cy <= D.n[0] &&
         pl.smem == ring_bytes_max<R>();
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
