// The 3D machine-model probes for Hopper (sm_90a): a stencil-tap probe and
// stream probes over fp32 (NY, NZ, NX) arrays, x contiguous, at the
// reference's block geometry (BY = 16 y rows by BZ = 64 z rows of whole x
// rows; (864, 256, 849) at full SEG/EAGE Overthrust width).
//
// Replaces the TPU kernels of scripts/exp_3d_lap.py:
//   tap_probe    <- run_vmem_tap_bw.make (:201): per (16, 64, NX) block,
//                     out = sum_k (0.1 + 0.01 k) blk[y+oy_k, z+oz_k, x+ox_k]
//                   for k < K (5 or 25): tap k reads at k % 9 - 4 along
//                   axis k % 3 (y, z, x) and at -4 along the other two
//                   (:205-219: the scratch slice starts at the margin, r =
//                   4 cells before the block), so y in {-4, -1, +2}, z in
//                   {-4, -3, 0, +3}, x in {-4, -2, +1, +4}. A read outside
//                   the block reads 0 (on the TPU: scratch margins it
//                   never writes, so its block faces are undefined there).
//   stream_copy  <- run_stream_bw's copy1 (:349) and its block-shape sweep
//                   (:380): o = p + 1.
//   stream_step5 <- run_stream_bw's step5 (:356) and step5s (:360):
//                     o = (pp + p) + c2     (step5s: (pp + c2) + p, p
//                                            staged through scratch)
//                   then, per block, y rows [0, 8) add rows [16gy-8, 16gy)
//                   of p (rows [0, 8) for gy = 0), y rows [8, 16) add rows
//                   [16(gy+1), +8) (the array's last 8 for the last
//                   block), then the same along z with 64-row blocks
//                   (index maps :308-323, bodies :328-344).
//   stream_step5x <- make_step5x (:428): step5, and o_i = s_i + s_{i+4}
//                   for i = 1..4 over eight (NY, NZ, 24) inputs (:415-426).
//
// Design. The TPU's grid walked blocks in order through VMEM; here:
//   tap_probe: each CTA stages a 16 (y) x 8 (z) x 64 (x) sub-tile of one
//     block with its margins (y -4..+2, z -4..+3, x -4..+4: 22 x 15 x 72
//     fp32, 95,040 B of dynamic shared memory, two CTAs an SM), reads its K
//     taps from there, so the K-slope is the per-tap shared-memory cost a
//     2.5D-tiled stencil would pay. Each tap is its own load (a volatile
//     read): the reference's 25 taps repeat 9 offsets (k and k + 9 read
//     alike), and the compiler would otherwise load each offset once.
//     Neighbouring threads read neighbouring x: no bank conflicts.
//   copy: variant 0 is a flat float4 grid-stride loop over 16 KB chunks,
//     each CTA four coalesced 16 B loads a thread in flight before its
//     stores, the grid sized from the SM count (NX = 849 is odd, so only
//     the flat view takes float4); variants 1-3 walk the (16, 64),
//     (8, 128) and (4, 256) (y, z) tiles in the TPU grid's order, one CTA a
//     run of BZ contiguous x rows at one y, scalar loads. Variant 4
//     (oneshot, the default) is a one-shot grid: one float4 a thread, no
//     loop, as many CTAs as the array needs. Variant 5 (bulk) is a TMA pipeline: each
//     CTA walks 16 KB chunks through a ring of kBulkStages shared buffers,
//     thread 0 issuing cp.async.bulk loads on an mbarrier kBulkStages - 1
//     chunks ahead, all threads adding 1 in shared memory, thread 0 storing
//     the chunk back with a bulk store.
//   step5 / step5x: one thread a cell, blocks of 32 x by 8 z rows at one y;
//     the halo rows are re-reads of p, from L2 when its neighbouring planes
//     were swept recently. staged routes each CTA's p tile through shared
//     memory and back (one store, a barrier, one load), its loads of pp and
//     C made before the barrier.
// What bounds them: device-memory traffic, each input read once and each
// output written once: 8 B/cell (copy, taps), 16 B/cell (step5), 16
// B/cell plus twelve (NY, NZ, 24) streams (step5x). The tap probe's K = 25
// does 50 fp32 operations a cell, below its byte bound. All arithmetic is
// fp32 (FMA in the taps); no tensor cores.
// Built into the probes library with acoustic2d_probe.cu
// (tpufwi_torch/kernels/probes.py). Element offsets are 64-bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// the reference's block geometry (scripts/exp_3d_lap.py :202-203 and
// :295-296): BY, BZ, the halo slab depth H
constexpr int kBY = 16;
constexpr int kBZ = 64;
constexpr int kH = 8;

// ---------------------------------------------------------------- taps

constexpr int kTZ = 8, kTX = 64;       // a CTA's sub-tile: 16 x 8 x 64
constexpr int kR = 4;                 // the reference's r: every low margin
constexpr int kSY = kR + kBY + 2;     // 22: y -4..+2
constexpr int kSZ = kR + kTZ + 3;     // 15: z -4..+3
constexpr int kSX = kR + kTX + 4;     // 72: x -4..+4
constexpr int kTapThreads = 256;
constexpr int kTapSmem = kSY * kSZ * kSX * (int)sizeof(float);  // 95,040 B

// tap k's offset along axis d (0 y, 1 z, 2 x): k % (2r + 1) - r along axis
// k % 3, -r along the others; its weight in fp32, as the reference's
// weak-typed (0.1 + 0.01 k)
__host__ __device__ constexpr int tap_offset(int k, int d) {
  return k % 3 == d ? k % 9 - kR : -kR;
}
__host__ __device__ constexpr float tap_weight(int k) { return (float)(0.1 + 0.01 * k); }

// grid (ceil(NX / 64), NZ / 8, NY / 16)
template <int K>
__global__ void __launch_bounds__(kTapThreads) tap_probe(const float* __restrict__ p,
                                                         float* __restrict__ out, int NZ,
                                                         int NX) {
  extern __shared__ float tile[];
  const int x0 = blockIdx.x * kTX;
  const int zt = blockIdx.y * kTZ;    // the sub-tile's first z
  const int zb = zt - zt % kBZ;       // its block's first z
  const int yb = blockIdx.z * kBY;    // the block's first y
  for (int i = threadIdx.x; i < kSY * kSZ * kSX; i += kTapThreads) {
    const int sy = i / (kSZ * kSX);
    const int rem = i - sy * (kSZ * kSX);
    const int sz = rem / kSX;
    const int sx = rem - sz * kSX;
    const int y = yb + sy - kR, z = zt + sz - kR, x = x0 + sx - kR;
    float v = 0.f;  // outside the block: the zero margin
    if (y >= yb && y < yb + kBY && z >= zb && z < zb + kBZ && x >= 0 && x < NX)
      v = p[((size_t)y * NZ + z) * NX + x];
    tile[i] = v;
  }
  __syncthreads();
  const volatile float* taps = tile;  // one shared-memory load a tap
  const int tx = threadIdx.x % kTX;
  const int x = x0 + tx;
  if (x >= NX) return;
  for (int lz = threadIdx.x / kTX; lz < kTZ; lz += kTapThreads / kTX) {
    for (int ly = 0; ly < kBY; ++ly) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float v = taps[((ly + kR + tap_offset(k, 0)) * kSZ + lz + kR + tap_offset(k, 1)) *
                                 kSX + tx + kR + tap_offset(k, 2)];
        acc = k == 0 ? tap_weight(k) * v : fmaf(tap_weight(k), v, acc);
      }
      out[((size_t)(yb + ly) * NZ + zt + lz) * NX + x] = acc;
    }
  }
}

template <int K>
int launch_taps(const float* p, float* out, int NY, int NZ, int NX, cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      tap_probe<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, kTapSmem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((NX + kTX - 1) / kTX, NZ / kTZ, NY / kBY);
  tap_probe<K><<<grid, kTapThreads, kTapSmem, st>>>(p, out, NZ, NX);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- copy

constexpr int kCopyThreads = 256;

__device__ __forceinline__ float4 plus_one(float4 v) {
  return make_float4(v.x + 1.f, v.y + 1.f, v.z + 1.f, v.w + 1.f);
}

// o = p + 1 over n floats, float4: each CTA takes chunks of kVec x 256
// float4 (16 KB), every thread's kVec loads in flight before its stores; the
// n % 4 tail by the first threads
constexpr int kVec = 4;

__global__ void __launch_bounds__(kCopyThreads) copy_vec4(const float* __restrict__ p,
                                                          float* __restrict__ o, long long n) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
  float4* o4 = reinterpret_cast<float4*>(o);
  const long long n4 = n / 4;
  constexpr long long chunk = (long long)kVec * kCopyThreads;
  for (long long base = blockIdx.x * chunk + threadIdx.x; base < n4;
       base += (long long)gridDim.x * chunk) {
    float4 v[kVec];
#pragma unroll
    for (int u = 0; u < kVec; ++u)
      if (base + u * kCopyThreads < n4) v[u] = p4[base + u * kCopyThreads];
#pragma unroll
    for (int u = 0; u < kVec; ++u)
      if (base + u * kCopyThreads < n4) o4[base + u * kCopyThreads] = plus_one(v[u]);
  }
  const long long t = 4 * n4 + (long long)blockIdx.x * kCopyThreads + threadIdx.x;
  if (t < n) o[t] = p[t] + 1.f;
}

// o = p + 1, one CTA a run of BZ contiguous x rows at one y, the (BY, BZ)
// tiles walked as the TPU grid (gz, gy) walks them
template <int BY, int BZ>
__global__ void __launch_bounds__(kCopyThreads) copy_rows(const float* __restrict__ p,
                                                          float* __restrict__ o, int NY, int NZ,
                                                          int NX) {
  int b = blockIdx.x;
  const int ly = b % BY;
  b /= BY;
  const int nyb = NY / BY;
  const int gy = b % nyb, gz = b / nyb;
  const size_t base = ((size_t)(gy * BY + ly) * NZ + (size_t)gz * BZ) * NX;
  const int n = BZ * NX;
  for (int i = threadIdx.x; i < n; i += kCopyThreads) o[base + i] = p[base + i] + 1.f;
}

// o = p + 1, one-shot: thread g of the grid takes float4 g, one load
// before one store, no loop (kOneThreads a CTA, each CTA a contiguous
// 2 KB); the n % 4 tail by the first threads of block 0. Plain loads and
// stores: the evict-first hints (__ldcs, __stcs) cost ~1% here.
constexpr int kOneThreads = 128;

__global__ void __launch_bounds__(kOneThreads) copy_oneshot(const float* __restrict__ p,
                                                            float* __restrict__ o,
                                                            long long n) {
  const long long n4 = n / 4;
  const long long g = (long long)blockIdx.x * kOneThreads + threadIdx.x;
  if (g < n4) reinterpret_cast<float4*>(o)[g] = plus_one(reinterpret_cast<const float4*>(p)[g]);
  const long long t = 4 * n4 + threadIdx.x;
  if (blockIdx.x == 0 && t < n) o[t] = p[t] + 1.f;
}

int launch_oneshot(const float* p, float* o, long long n, cudaStream_t st) {
  const long long blocks = (n / 4 + kOneThreads - 1) / kOneThreads;
  copy_oneshot<<<(unsigned)(blocks > 0 ? blocks : 1), kOneThreads, 0, st>>>(p, o, n);
  return (int)cudaGetLastError();
}

// o = p + 1 through the TMA: 16 KB chunks of the 16 B-aligned part, chunk
// c by CTA c % gridDim.x, in a ring of kBulkStages shared buffers, each
// filled by one cp.async.bulk load that completes on its mbarrier and
// drained by one bulk store; the n % 4 tail as the one-shot copy's
constexpr int kBulkStages = 4;
constexpr int kBulkBytes = 16384;
constexpr int kBulkSmem = kBulkStages * kBulkBytes;  // 64 KB: 3 CTAs an SM

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void bulk_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

__global__ void __launch_bounds__(kCopyThreads) copy_bulk(const float* __restrict__ p,
                                                          float* __restrict__ o, long long n) {
  extern __shared__ __align__(128) float4 buf[];
  __shared__ __align__(8) uint64_t full[kBulkStages];
  constexpr int per = kBulkBytes / 16;  // float4 a chunk
  const long long nb = n / 4 * 16;      // bytes of the aligned part
  const long long chunks = (nb + kBulkBytes - 1) / kBulkBytes;
  const char* src = reinterpret_cast<const char*>(p);
  char* dst = reinterpret_cast<char*>(o);
  auto bytes_of = [&](long long c) {
    return (uint32_t)(nb - c * kBulkBytes < kBulkBytes ? nb - c * kBulkBytes : kBulkBytes);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kBulkStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_u32(&full[s])));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    for (int s = 0; s < kBulkStages - 1; ++s) {
      const long long c = blockIdx.x + (long long)s * gridDim.x;
      if (c < chunks) bulk_load(buf + s * per, src + c * kBulkBytes, bytes_of(c), &full[s]);
    }
  }
  __syncthreads();
  for (long long i = 0;; ++i) {
    const long long c = blockIdx.x + i * gridDim.x;
    if (c >= chunks) break;
    const int s = (int)(i % kBulkStages);
    if (threadIdx.x == 0) {  // refill the stage the previous chunk's store has read
      const long long cn = c + (long long)(kBulkStages - 1) * gridDim.x;
      if (cn < chunks) {
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
        const int sn = (int)((i + kBulkStages - 1) % kBulkStages);
        bulk_load(buf + sn * per, src + cn * kBulkBytes, bytes_of(cn), &full[sn]);
      }
    }
    bulk_wait(&full[s], (uint32_t)((i / kBulkStages) & 1));
    const int m = (int)(bytes_of(c) / 16);
    float4* b = buf + s * per;
    for (int k = threadIdx.x; k < m; k += kCopyThreads) b[k] = plus_one(b[k]);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                   :: "l"(dst + c * kBulkBytes), "r"(smem_u32(b)), "r"(bytes_of(c))
                   : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
  }
  if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  const long long t = n / 4 * 4 + threadIdx.x;
  if (blockIdx.x == 0 && t < n) o[t] = p[t] + 1.f;
}

int launch_bulk(const float* p, float* o, long long n, cudaStream_t st) {
  const cudaError_t attr = cudaFuncSetAttribute(
      copy_bulk, cudaFuncAttributeMaxDynamicSharedMemorySize, kBulkSmem);
  if (attr != cudaSuccess) return (int)attr;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const cudaError_t occ = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, copy_bulk, kCopyThreads, kBulkSmem);
  if (occ != cudaSuccess) return (int)occ;
  const long long chunks = (n / 4 * 16 + kBulkBytes - 1) / kBulkBytes;
  const long long want = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int blocks = (int)(chunks < want ? (chunks > 0 ? chunks : 1) : want);
  copy_bulk<<<blocks, kCopyThreads, kBulkSmem, st>>>(p, o, n);
  return (int)cudaGetLastError();
}

template <int BY, int BZ>
int launch_rows(const float* p, float* o, int NY, int NZ, int NX, cudaStream_t st) {
  if (NY % BY || NZ % BZ) return (int)cudaErrorInvalidValue;
  copy_rows<BY, BZ><<<NY / BY * (NZ / BZ) * BY, kCopyThreads, 0, st>>>(p, o, NY, NZ, NX);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- step5

constexpr int kSX5 = 32, kSZ5 = 8;  // a CTA: 32 x by 8 z rows at one y
constexpr int kSS = 24;             // the small streams' x width (:413)

struct SmallStreams {
  const float* s[8];
  float* o[4];
};

// the y (z) row whose halo slab value cell row y (z) adds, with the
// reference's clamps at the first and last block
__device__ __forceinline__ int halo_row(int y, int B, int N) {
  const int g = y / B, l = y - g * B;
  if (l < kH) return g == 0 ? l : y - kH;
  return (g + 1) * B < N ? y + kH : N - B + l;
}

template <bool kStaged, bool kSmall>
__global__ void __launch_bounds__(kSX5 * kSZ5) step5(const float* __restrict__ pp,
                                                     const float* __restrict__ p,
                                                     const float* __restrict__ c2,
                                                     float* __restrict__ o, int NY, int NZ,
                                                     int NX, SmallStreams ss) {
  const int x = blockIdx.x * kSX5 + threadIdx.x;
  const int z = blockIdx.y * kSZ5 + threadIdx.y;
  const int y = blockIdx.z;
  const size_t i = ((size_t)y * NZ + z) * NX + x;
  const bool in = x < NX;
  float v;
  if (kStaged) {
    __shared__ float stage[kSZ5][kSX5];
    float a = 0.f, b = 0.f;
    if (in) {
      a = pp[i];
      b = c2[i];
      stage[threadIdx.y][threadIdx.x] = p[i];
    }
    __syncthreads();
    if (!in) return;
    v = (a + b) + stage[threadIdx.y][threadIdx.x];
  } else {
    if (!in) return;
    v = (pp[i] + p[i]) + c2[i];
  }
  v += p[((size_t)halo_row(y, kBY, NY) * NZ + z) * NX + x];
  const int lz = z % kBZ;
  if (lz < kH || lz >= kBZ - kH) v += p[((size_t)y * NZ + halo_row(z, kBZ, NZ)) * NX + x];
  o[i] = v;
  if (kSmall && x < kSS) {
    const size_t j = ((size_t)y * NZ + z) * kSS + x;
#pragma unroll
    for (int k = 0; k < 4; ++k) ss.o[k][j] = ss.s[k][j] + ss.s[k + 4][j];
  }
}

template <bool kStaged, bool kSmall>
int launch_step5(const float* pp, const float* p, const float* c2, float* o, int NY, int NZ,
                 int NX, const SmallStreams& ss, cudaStream_t st) {
  if (NY % kBY || NZ % kBZ) return (int)cudaErrorInvalidValue;
  const dim3 grid((NX + kSX5 - 1) / kSX5, NZ / kSZ5, NY);
  step5<kStaged, kSmall><<<grid, dim3(kSX5, kSZ5), 0, st>>>(pp, p, c2, o, NY, NZ, NX, ss);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out <- the K-tap sum of p (K = 5 or 25); NY a multiple of 16, NZ of 64
int tpufwi_tap_probe(const float* p, float* out, int NY, int NZ, int NX, int K, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (NY % kBY || NZ % kBZ) return (int)cudaErrorInvalidValue;
  if (K == 5) return launch_taps<5>(p, out, NY, NZ, NX, st);
  if (K == 25) return launch_taps<25>(p, out, NY, NZ, NX, st);
  return (int)cudaErrorInvalidValue;
}

// o <- p + 1. variant 0: flat float4 grid-stride loop (p and o 16 B
// aligned); 1, 2, 3: the (16, 64), (8, 128), (4, 256) row tiles; 4: the
// one-shot float4 grid, 5: the TMA bulk pipeline (both 16 B aligned)
int tpufwi_stream_copy(const float* p, float* o, int NY, int NZ, int NX, int variant,
                       void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: {
      int dev = 0, sms = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      const long long n = (long long)NY * NZ * NX;
      // eight 256-thread CTAs an SM fill its 2,048 threads
      const long long want = (n / 4 + kVec * kCopyThreads - 1) / (kVec * kCopyThreads);
      const int blocks = (int)(want < 8LL * sms ? (want > 0 ? want : 1) : 8LL * sms);
      copy_vec4<<<blocks, kCopyThreads, 0, st>>>(p, o, n);
      return (int)cudaGetLastError();
    }
    case 1: return launch_rows<16, 64>(p, o, NY, NZ, NX, st);
    case 2: return launch_rows<8, 128>(p, o, NY, NZ, NX, st);
    case 3: return launch_rows<4, 256>(p, o, NY, NZ, NX, st);
    case 4: return launch_oneshot(p, o, (long long)NY * NZ * NX, st);
    case 5: return launch_bulk(p, o, (long long)NY * NZ * NX, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// o <- step5(pp, p, c2) (staged: step5s); NY a multiple of 16, NZ of 64
int tpufwi_stream_step5(const float* pp, const float* p, const float* c2, float* o, int NY,
                        int NZ, int NX, int staged, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const SmallStreams none{};
  return staged ? launch_step5<true, false>(pp, p, c2, o, NY, NZ, NX, none, st)
                : launch_step5<false, false>(pp, p, c2, o, NY, NZ, NX, none, st);
}

// step5 into o, and o_i = s_i + s_{i+4} (i = 0..3) over (NY, NZ, 24) arrays:
// s holds 8 input pointers, so 4 output pointers
int tpufwi_stream_step5x(const float* pp, const float* p, const float* c2, float* o,
                         const float* const* s, float* const* so, int NY, int NZ, int NX,
                         void* stream) {
  SmallStreams ss;
  for (int k = 0; k < 8; ++k) ss.s[k] = s[k];
  for (int k = 0; k < 4; ++k) ss.o[k] = so[k];
  return launch_step5<false, true>(pp, p, c2, o, NY, NZ, NX, ss, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
