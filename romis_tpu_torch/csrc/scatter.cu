// Kernel 13: scatter-add into a row table, the transpose of the row gather
// (kernel 2): out[r, c] += sum over p with clamp(idx[p]) = r of ct[c, p].
//
// Replaces romis_tpu/ops/pallas_scatter.py scatter_rows_add / _scatter_kernel
// (a one-hot built per tile and contracted on the MXU into a VMEM
// accumulator, capped at 2048 rows). Neither the one-hot nor the cap carries
// over: here every index adds its C components to its row directly.
//
// Bound: device memory, (C + 1) x 4 B per index read once, once the adds
// cost less than the reads. What costs is contention and its cure: on the
// flagship scene a frame's 2 M pixels land on 1 material row and a few
// triangle rows, the light re-evaluations' 4 M indices on 512 rows (on the
// torus field on 3), and the torus field's hit triangles come in runs along
// the image rows. __match_any_sync, which finds the lanes sharing a row,
// takes time in proportion to the distinct rows of a warp (it set the pace
// of the design before this one on the 512 random light rows), and a warp's
// 32 device atomics on one address are served one by one. So each warp-group
// of 32 indices is classed once by its distinct rows, with shuffles and
// ballots (group_rows): at most kHeld = 4 rows ("few": a row's lanes are
// found by a compare) or more ("many": random rows, each lane adds alone).
// A warp keeps up to kHeld rows in registers, each lane its own partial sum
// of each: while every lane's row is held it only adds; a few-row group
// with a row not held flushes them (a shuffle sum a row, one add from lane
// 0) and holds the group's rows; a many-row group's lanes whose row is not
// held add their values directly. Runs of one row (the material row, a
// triangle seen by many adjacent pixels, the 3 torus light rows) so cost
// one flush a run, and no lane waits on another's row.
//
// A table that fits in shared memory (scatter_rows_tiled; the wrapper
// passes ops/scatter.scatter_tile's tile of 2048 indices, or 0 for the
// device path, and warp_cols' columns a warp):
// - persistent blocks, as many an SM as fit (up to 4: a narrow table's 8
//   or 9 warps need company to keep loads in flight); a tile's indices
//   come into shared memory by cp.async while the block sums the tile
//   before it;
// - a pre-pass clamps each index and classes its group once for all C
//   columns, as a code a lane (row * 8 + a slot) and a record a group; in
//   a many-row group each lane writes its id to one of kTags tags of its
//   warp (by row) and reads it back: the lanes that own their tag are on
//   rows no other owner has;
// - a warp owns kCols columns of the block's table (2 or 3 for a wide
//   table, 1 for a narrow one), so no two warps add to one address; its
//   groups' classes and held rows serve all of them, and their kCols
//   chains of adds run side by side (a warp's chain of votes, shuffles and
//   read-modify-writes is what held the 512 random light rows back, not
//   shared memory's bandwidth or its atomics: PERF.md). It reads the
//   values from device memory a batch of groups ahead of its adds. A
//   flush is a plain read-modify-write; a many-row group's owners add with
//   a plain read-modify-write and the other lanes after them with atomics
//   (compare-and-swap loops in shared memory: about one lane a group on
//   512 random rows shares its row with another). The table's row stride
//   is C rounded up to odd;
// - one device-memory atomicAdd per non-zero (row, component) per block.
// A larger table (the torus field's 24,202 triangle rows) is summed in
// device memory (scatter_rows_global): a warp takes a run of kRunGroups
// groups and 8 columns at a time, classes each group once for the 8,
// flushes held rows with device atomics and sums a many-row group's runs
// of equal rows (an image's triangles come in runs along its rows) by a
// segmented scan, one device atomic a run. Float atomics add in no fixed
// order, so the result is not bit-reproducible; the wrapper zero-fills
// `out`.
#include <cuda_pipeline.h>

#include "common.cuh"

namespace romis {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kHeld = 4;         // rows a warp sums in registers
constexpr int kNone = -2;        // an empty slot (-1 is a tail index's row)
// Groups whose loads go before their adds: 8 for a warp of one column, 4
// for a warp of several (their registers).
template <int kCols>
constexpr int kGroupBatch = kCols == 1 ? 8 : 4;
constexpr int kColBatch = 8;     // columns a warp sums at once (device path)
constexpr int kRunGroups = 16;   // groups a warp takes in turn (device path)
constexpr int kGlobalThreads = 256;
constexpr int kTags = 256;       // a warp's row tags in the tiled pre-pass
constexpr int kOwn = kHeld;      // code: a many-row lane that owns its row's tag
constexpr int kShare = kHeld + 1;  // code: one whose row another lane may own
constexpr int kMaxBlocksPerSm = 4;

// The sum of v over the warp, at every lane.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// A warp-group's distinct rows, in the order of their first lanes: row(k)
// for k < min(count(), kHeld), and the calling lane's slot (its row's k;
// -1 where the group has more than kHeld rows, "many": the count stops at
// kHeld + 1). Called by the whole warp with each lane's row r.
struct GroupRows {
  int rows[kHeld];
  int n;
  int s;
  __device__ __forceinline__ bool few() const { return n <= kHeld; }
  __device__ __forceinline__ int count() const { return n; }
  __device__ __forceinline__ int row(int k) const { return rows[k]; }
  __device__ __forceinline__ int slot() const { return s; }
};

__device__ __forceinline__ GroupRows group_rows(int r) {
  GroupRows g;
  g.n = 0;
  g.s = -1;
  unsigned rem = kFull;
#pragma unroll
  for (int k = 0; k < kHeld; ++k) {
    if (rem == 0u) break;
    const int row = __shfl_sync(kFull, r, __ffs(rem) - 1);
    rem &= ~__ballot_sync(kFull, r == row);
    g.rows[k] = row;
    if (r == row) g.s = k;
    g.n = k + 1;
  }
  if (rem != 0u) {
    g.n = kHeld + 1;
    g.s = -1;
  }
  return g;
}

// The same, as the tiled path's pre-pass left it in shared memory: a code
// per index, row * 8 + slot (a few-row group's lane: its row's k; a
// many-row group's: kOwn or kShare), and a record per group, its count and
// rows (read only where the group's rows are to be held).
struct TiledGroup {
  const int* rec;
  int code;
  __device__ __forceinline__ int slot() const { return code & 7; }
  __device__ __forceinline__ bool few() const { return slot() < kHeld; }
  __device__ __forceinline__ int count() const { return rec[0]; }
  __device__ __forceinline__ int row(int k) const { return rec[1 + k]; }
};

// The up to kHeld rows a warp holds (held[] warp-uniform, kNone where
// empty; the same rows for all the warp's columns, which see the same
// groups) and, for each of its kCols columns, one partial sum a row in each
// lane. Column j of the table is col + j, its rows `stride` apart; only the
// first `ncols` columns are the table's. Device atomics when kGlobal, else
// plain adds into the warp's own shared-memory columns.
template <bool kGlobal, int kCols>
struct Held {
  int held[kHeld];
  float acc[kCols][kHeld];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int k = 0; k < kHeld; ++k) {
      held[k] = kNone;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[j][k] = 0.0f;
    }
  }

  // Every held row's warp sums into the table; the slots emptied.
  __device__ __forceinline__ void flush(float* col, long long stride, int lane,
                                        int ncols) {
#pragma unroll
    for (int k = 0; k < kHeld; ++k) {
      if (held[k] == kNone) continue;
      float s[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[j] = warp_sum(acc[j][k]);
      if (lane == 0 && held[k] >= 0) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          if (j >= ncols || s[j] == 0.0f) continue;
          if (kGlobal) atomicAdd(col + j + held[k] * stride, s[j]);
          else col[j + held[k] * stride] += s[j];
        }
      }
      held[k] = kNone;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[j][k] = 0.0f;
    }
  }

  // One group's values x of row r, the group classed as g: added to a held
  // row, or the held rows flushed and the group's held (few rows), or added
  // directly (many rows). Called by the whole warp.
  template <class G>
  __device__ __forceinline__ void add(float* col, long long stride, int lane,
                                      int ncols, int r, const float (&x)[kCols],
                                      const G& g) {
    bool hit = false;
    if (held[0] != kNone) {  // held[] fills from slot 0
#pragma unroll
      for (int k = 0; k < kHeld; ++k) {
        if (r == held[k]) {
#pragma unroll
          for (int j = 0; j < kCols; ++j) acc[j][k] += x[j];
          hit = true;
        }
      }
    }
    if (__all_sync(kFull, hit)) return;
    if (g.few()) {
      flush(col, stride, lane, ncols);
      const int count = g.count(), slot = g.slot();
#pragma unroll
      for (int k = 0; k < kHeld; ++k) {
        if (k < count) held[k] = g.row(k);
        if (!hit && slot == k) {
#pragma unroll
          for (int j = 0; j < kCols; ++j) acc[j][k] = x[j];
        }
      }
    } else if (kGlobal) {
      add_runs(col, stride, lane, ncols, hit ? kNone : r, hit, x);
    } else {
      // A lane that owns its row's tag adds with a plain read-modify-write
      // (no other owner of the warp is on its row); then the others, whose
      // row may have a second lane, with atomics.
      const bool mine = !hit && r >= 0, own = g.slot() == kOwn;
      float* row = col + r * stride;
      if (mine && own) {
        float v[kCols];
#pragma unroll
        for (int j = 0; j < kCols; ++j) v[j] = j < ncols ? row[j] : 0.0f;
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          if (j < ncols) row[j] = v[j] + x[j];
      }
      __syncwarp();
      if (mine && !own) {
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          if (j < ncols) atomicAdd(row + j, x[j]);
      }
    }
    __syncwarp();  // this group's adds before the next group's
  }

  // Device path, many rows: each run of adjacent lanes on one row (key) is
  // summed by a segmented scan, and its last lane adds the sum (the hit
  // triangles of an image come in runs along its rows).
  static __device__ __forceinline__ void add_runs(float* col, long long stride,
                                                  int lane, int ncols, int key,
                                                  bool hit,
                                                  const float (&x)[kCols]) {
    const int prev = __shfl_up_sync(kFull, key, 1);
    const unsigned heads = __ballot_sync(kFull, lane == 0 || prev != key);
    const int head = 31 - __clz(heads & (kFull >> (31 - lane)));
    const bool tail = lane == 31 || ((heads >> (lane + 1)) & 1u);
    float v[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) v[j] = hit ? 0.0f : x[j];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float t = __shfl_up_sync(kFull, v[j], o);
        if (lane - o >= head) v[j] += t;
      }
    }
    if (tail && key >= 0) {
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        if (j < ncols && v[j] != 0.0f) atomicAdd(col + j + key * stride, v[j]);
    }
  }
};

// The tile's indices [base, base + tile) ∩ [0, n), copied into `buf` by
// cp.async. With kVec, n and base are multiples of 4 and idx 16-byte
// aligned.
template <bool kVec>
__device__ __forceinline__ void issue_tile(int* buf, const int* __restrict__ idx,
                                           long long n, long long base, int tile) {
  const int cnt = static_cast<int>(min(static_cast<long long>(tile), n - base));
  constexpr int kWidth = kVec ? 4 : 1;
  for (int j = kWidth * threadIdx.x; j < cnt; j += kWidth * blockDim.x)
    __pipeline_memcpy_async(buf + j, idx + base + j, kWidth * sizeof(int));
}

// The values of columns c0 .. c0 + kCols - 1 (those below ncols) of groups
// g0 .. g0 + kGroupBatch - 1 of the tile at `base`, 0 past n.
template <int kCols>
__device__ __forceinline__ void load_batch(float (&x)[kGroupBatch<kCols>][kCols],
                                           const float* __restrict__ ct,
                                           long long n, int c0, int ncols,
                                           long long base, int g0, int lane) {
#pragma unroll
  for (int u = 0; u < kGroupBatch<kCols>; ++u) {
    const long long p = base + 32 * (g0 + u) + lane;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      x[u][j] = p < n && j < ncols ? __ldg(ct + (c0 + j) * n + p) : 0.0f;
  }
}

// A block sums its tiles into its table; warp w takes columns kCols * w ..
// kCols * w + kCols - 1 (and every warps * kCols-th column group after).
template <bool kVec, int kCols>
__global__ void __launch_bounds__(1024)
scatter_rows_tiled(const float* __restrict__ ct, int n_cols,
                   const int* __restrict__ idx, long long n, int n_rows,
                   int tile, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* tab = reinterpret_cast<float*>(smem4);
  const int stride = n_cols | 1;
  const int tab_len = (n_rows * stride + 3) & ~3;
  const int groups = tile / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  // Two buffers of a tile's indices, rewritten in place as codes by the
  // pre-pass; per group its count and rows; a warp's row tags.
  int* bufs[2] = {reinterpret_cast<int*>(tab + tab_len),
                  reinterpret_cast<int*>(tab + tab_len) + tile};
  int* s_group = bufs[1] + tile;
  int* s_tags = s_group + (kHeld + 1) * groups;
  const long long n_tiles = (n + tile - 1) / tile;

  long long t = blockIdx.x;
  if (t < n_tiles) issue_tile<kVec>(bufs[0], idx, n, t * tile, tile);
  __pipeline_commit();
  for (int i = threadIdx.x; i < tab_len; i += blockDim.x) tab[i] = 0.0f;

  for (int b = 0; t < n_tiles; t += gridDim.x, b ^= 1) {
    if (t + gridDim.x < n_tiles)
      issue_tile<kVec>(bufs[b ^ 1], idx, n, (t + gridDim.x) * tile, tile);
    __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncthreads();  // tile t is in bufs[b] (and the table is zeroed)
    int* code = bufs[b];
    const long long base = t * tile;
    for (int g = warp; g < groups; g += warps) {
      const int j = 32 * g + lane;
      const int r = base + j < n ? min(max(code[j], 0), n_rows - 1) : -1;
      const GroupRows gr = group_rows(r);
      int slot = gr.slot();
      if (!gr.few()) {  // many rows: which lanes own their row's tag
        int* tag = s_tags + warp * kTags + (r & (kTags - 1));
        *tag = lane;
        __syncwarp();
        slot = *tag == lane ? kOwn : kShare;
        __syncwarp();
      }
      code[j] = r * 8 + slot;
      int rec = gr.count();  // lane 0: the count; lanes 1..kHeld: the rows
#pragma unroll
      for (int k = 0; k < kHeld; ++k)
        if (lane == k + 1 && k < gr.count()) rec = gr.row(k);
      if (lane <= kHeld) s_group[(kHeld + 1) * g + lane] = rec;
    }
    __syncthreads();
    for (int c0 = kCols * warp; c0 < n_cols; c0 += kCols * warps) {
      const int ncols = min(kCols, n_cols - c0);
      Held<false, kCols> h;
      h.clear();
      constexpr int kB = kGroupBatch<kCols>;
      float x[kB][kCols];
      load_batch<kCols>(x, ct, n, c0, ncols, base, 0, lane);
      for (int g0 = 0; g0 < groups; g0 += kB) {
        // The next batch's values are loaded before this batch's adds.
        float xn[kB][kCols];
        if (g0 + kB < groups)
          load_batch<kCols>(xn, ct, n, c0, ncols, base, g0 + kB, lane);
        int cd[kB];
#pragma unroll
        for (int u = 0; u < kB; ++u) cd[u] = code[32 * (g0 + u) + lane];
#pragma unroll
        for (int u = 0; u < kB; ++u)
          h.add(tab + c0, stride, lane, ncols, cd[u] >> 3, x[u],
                TiledGroup{s_group + (kHeld + 1) * (g0 + u), cd[u]});
#pragma unroll
        for (int u = 0; u < kB; ++u)
#pragma unroll
          for (int j = 0; j < kCols; ++j) x[u][j] = xn[u][j];
      }
      h.flush(tab + c0, stride, lane, ncols);
      __syncwarp();
    }
    __syncthreads();  // bufs[b] is free for the tile after next
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_rows * n_cols; i += blockDim.x) {
    const float s = tab[(i / n_cols) * stride + i % n_cols];
    if (s != 0.0f) atomicAdd(out + i, s);
  }
}

// A warp per run of kRunGroups groups of 32 indices, kColBatch columns at a
// time, into the [n_rows, n_cols] table in device memory.
__global__ void __launch_bounds__(kGlobalThreads)
scatter_rows_global(const float* __restrict__ ct, int n_cols,
                    const int* __restrict__ idx, long long n, int n_rows,
                    float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long first = warp * kRunGroups * 32;
  if (first >= n) return;  // whole warps leave together
  for (int c0 = 0; c0 < n_cols; c0 += kColBatch) {
    const int ncols = min(kColBatch, n_cols - c0);
    Held<true, kColBatch> h;
    h.clear();
    for (int g = 0; g < kRunGroups; ++g) {
      const long long p = first + 32 * g + lane;
      if (p - lane >= n) break;  // warp-uniform
      const bool live = p < n;
      const int r = live ? min(max(idx[p], 0), n_rows - 1) : -1;
      float x[kColBatch];
#pragma unroll
      for (int u = 0; u < kColBatch; ++u)
        x[u] = live && u < ncols ? ct[(c0 + u) * n + p] : 0.0f;
      h.add(out + c0, n_cols, lane, ncols, r, x, group_rows(r));
    }
    h.flush(out + c0, n_cols, lane, ncols);
  }
}

// The tiled path's shared memory in bytes (ops/scatter.scatter_smem).
inline long long tiled_smem(int n_cols, int n_rows, int tile, int warps) {
  const long long tab_len = (static_cast<long long>(n_rows) * (n_cols | 1) + 3) & ~3LL;
  return (tab_len + 2LL * tile + (kHeld + 1LL) * (tile / 32) +
          static_cast<long long>(kTags) * warps) *
         static_cast<long long>(sizeof(float));
}

template <int kCols>
int launch_tiled(const float* ct, int n_cols, const int* idx, long long n,
                 int n_rows, int tile, float* out, cudaStream_t stream) {
  // Per device its SM count and the shared memory each instantiation was
  // last allowed there, and per instantiation its blocks an SM for the last
  // shape, kept across calls.
  static int sms[64], allowed[64][2], occ_key[2][2] = {{-1, -1}, {-1, -1}}, occ[2];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev < 64 && sms[dev] == 0)
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess || dev >= 64)
    return static_cast<int>(err != cudaSuccess ? err : cudaErrorInvalidDevice);
  const int warps = min(max((n_cols + kCols - 1) / kCols, 4), 32);
  const long long smem = tiled_smem(n_cols, n_rows, tile, warps);
  if (smem > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 32 * warps;
  const int vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(idx) % 16 == 0;
  auto kernel = vec ? scatter_rows_tiled<true, kCols> : scatter_rows_tiled<false, kCols>;
  if (smem > allowed[dev][vec]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed[dev][vec] = static_cast<int>(smem);
  }
  // As many blocks an SM as fit, up to kMaxBlocksPerSm: a narrow table's
  // few warps need company to keep loads in flight (one flush more a
  // block).
  if (occ_key[vec][0] != threads || occ_key[vec][1] != smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ[vec], kernel, threads,
                                                        static_cast<size_t>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    occ[vec] = max(1, min(occ[vec], kMaxBlocksPerSm));
    occ_key[vec][0] = threads;
    occ_key[vec][1] = static_cast<int>(smem);
  }
  const long long n_tiles = (n + tile - 1) / tile;
  const long long want = static_cast<long long>(sms[dev]) * occ[vec];
  const int blocks = static_cast<int>(n_tiles < want ? n_tiles : want);
  kernel<<<blocks, threads, static_cast<size_t>(smem), stream>>>(ct, n_cols, idx, n,
                                                                n_rows, tile, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace romis

// `tile` is ops/scatter.scatter_tile's choice: the indices a tile of the
// shared-memory path, or 0 for the device-memory path; `cols` the columns
// a warp of the shared-memory path takes (1, 2 or 3: ops/scatter.warp_cols).
extern "C" int romis_scatter_rows_add(const float* ct, int n_cols, const int* idx,
                                      long long n, int n_rows, int tile, int cols,
                                      float* out, cudaStream_t stream) {
  using namespace romis;
  if (tile > 0) {
    if (tile % (32 * 8) != 0) return static_cast<int>(cudaErrorInvalidValue);
    switch (cols) {
      case 1: return launch_tiled<1>(ct, n_cols, idx, n, n_rows, tile, out, stream);
      case 2: return launch_tiled<2>(ct, n_cols, idx, n, n_rows, tile, out, stream);
      case 3: return launch_tiled<3>(ct, n_cols, idx, n, n_rows, tile, out, stream);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const long long warps = (n + 32LL * kRunGroups - 1) / (32LL * kRunGroups);
  const long long blocks = (warps * 32 + kGlobalThreads - 1) / kGlobalThreads;
  scatter_rows_global<<<static_cast<unsigned>(blocks), kGlobalThreads, 0, stream>>>(
      ct, n_cols, idx, n, n_rows, out);
  return static_cast<int>(cudaGetLastError());
}
