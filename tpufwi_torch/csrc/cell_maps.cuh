// Cell maps of the fused whole-scan passes (acoustic2d_scanres.cu,
// elastic2d_kernels.cuh): a tiled pass applies the step's sources, reads its
// receivers and writes its ring-tape entries in the thread that owns each
// cell, so it needs, per cell, the first source, receiver and ring entry
// there, and per tile whether it holds any. One setup launch a call builds
// them (cell_map_entry, one thread per source, receiver and ring cell).

#pragma once

#include <cuda_runtime.h>

namespace {

// the maps, in one zeroed int buffer: per cell of the (NZ, NX) grid the
// first source, receiver and ring entry there + 1 (0: none), a flag word per
// tile (1 a source, 2 a receiver, 4 a ring cell), and per source and
// receiver the next one at its cell (-1: none)
struct SMaps {
  int *smap, *rmap, *gmap, *flags, *snext, *rnext;
};

inline SMaps carve_maps(int* iws, int NZ, int NX, int ntiles, int nsrc) {
  const size_t cells = (size_t)NZ * NX;
  SMaps m;
  m.smap = iws;
  m.rmap = iws + cells;
  m.gmap = iws + 2 * cells;
  m.flags = iws + 3 * cells;
  m.snext = m.flags + ntiles;
  m.rnext = m.snext + nsrc;
  return m;
}

__device__ __forceinline__ bool same_cell(const long long* __restrict__ a, int i, int j) {
  return a[2 * i] == a[2 * j] && a[2 * i + 1] == a[2 * j + 1];
}

// whether entry k of a is the first of its cell, and the next entry there
__device__ __forceinline__ bool chain_at(const long long* __restrict__ a, int n, int k,
                                         int& next) {
  int head = 1;
  next = -1;
  for (int j = 0; j < k && head; ++j) head = !same_cell(a, j, k);
  for (int j = k + 1; j < n && next < 0; ++j)
    if (same_cell(a, j, k)) next = j;
  return head;
}

// Thread k of nsrc + nrec + n_ring: the map entries of source k, receiver
// k - nsrc or ring cell k - nsrc - nrec. Tiles are tz x tx cells, ntx a
// row, the first tile row starting zshift rows above row 0 (ring cells are
// int32 indices into the flattened (NZ, NX) grid).
__device__ __forceinline__ void cell_map_entry(int k, const long long* __restrict__ src,
                                               int nsrc, const long long* __restrict__ rcv,
                                               int nrec, const int* __restrict__ ring,
                                               int n_ring, int NX, int tz, int tx, int ntx,
                                               int zshift, SMaps m) {
  int next, z, x, bit;
  if (k < nsrc) {
    const bool head = chain_at(src, nsrc, k, next);
    m.snext[k] = next;
    if (!head) return;
    z = (int)src[2 * k], x = (int)src[2 * k + 1];
    m.smap[z * NX + x] = k + 1;
    bit = 1;
  } else if (k < nsrc + nrec) {
    const int r = k - nsrc;
    const bool head = chain_at(rcv, nrec, r, next);
    m.rnext[r] = next;
    if (!head) return;
    z = (int)rcv[2 * r], x = (int)rcv[2 * r + 1];
    m.rmap[z * NX + x] = r + 1;
    bit = 2;
  } else if (k < nsrc + nrec + n_ring) {
    const int g = k - nsrc - nrec;
    const int cell = ring[g];
    m.gmap[cell] = g + 1;
    z = cell / NX;
    x = cell - z * NX;
    bit = 4;
  } else {
    return;
  }
  atomicOr(&m.flags[((z + zshift) / tz) * ntx + x / tx], bit);
}

}  // namespace
