// Variants of kernel 13 (the row scatter-add) that the package leaves out,
// for scripts/torch_scatter_shade_micro.py:
// - variant 0: the earlier design of the package's kernel: a
//   grid of 4 blocks an SM striding over the indices, __match_any_sync a
//   warp-group, each column's load followed by its shuffle sum and its
//   shared-memory atomic, one flush a block; tables above 96 KB add to
//   device memory;
// - variant 1: variant 0 with the loads of 8 columns issued before their
//   adds (the columns' loads in flight together);
// - variant 2: the first tiled design: the
//   package's tiles, blocks and column-owning warps, but each group's
//   lanes on one row found by __match_any_sync in the pre-pass; up to 4
//   rows held in registers while every lane's row is held, else a flush
//   and the group's rows held if at most 4, else each row's lanes summed by
//   shuffles and its lowest lane adding the sum with a plain
//   read-modify-write;
// - variant 3: the second tiled design: each
//   group classed by its distinct rows with shuffles and ballots, up to 4
//   rows held in registers, every lane of a many-row group adding with a
//   shared-memory atomic (a compare-and-swap loop);
// - variant 4: the second design's device-memory path: a warp's run of 16
//   groups, 8 columns at a time, held rows flushed and a many-row group's
//   lanes adding with one device atomic each;
// - variant 5: the third tiled design: the
//   second, with a many-row group's lanes that own their row's tag adding
//   by a plain read-modify-write (the rest by atomics after them), the
//   tile's values still staged through shared memory by cp.async;
// - variant 6: the fifth tiled design: each
//   many-row lane hands its value by shuffles to a target lane of its row,
//   found in the pre-pass by rounds of tags, the targets adding with one
//   plain read-modify-write (no shared-memory atomics), as many blocks an
//   SM as fit (up to 4);
// - variants 21-22: the fourth tiled design (the third with each warp
//   reading its values from device memory a batch ahead) compiled for at
//   most 768 threads and 2 blocks an SM (42 registers a thread), launched
//   with 1 or 2 blocks an SM.
#include "scatter.cu"

namespace micro {
using namespace romis;

constexpr int kMaxSmemBytes = 96 * 1024;
constexpr int kBlocksPerSm = 4;

// The sum of v over the lanes in `peers` (which holds the calling lane), at
// every lane of the group. Every lane of `peers` calls this with the same
// `peers`.
__device__ __forceinline__ float group_sum(unsigned peers, float v) {
  if (peers == 0xffffffffu) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
  }
  if ((peers & (peers - 1u)) == 0u) return v;  // alone on its row
  float s = 0.0f;
  for (unsigned m = peers; m != 0u; m &= m - 1u)
    s += __shfl_sync(peers, v, __ffs(m) - 1);
  return s;
}

template <bool kSmem, bool kBatched>
__global__ void __launch_bounds__(kThreads)
parent_kernel(const float* __restrict__ ct, int n_cols,
                    const int* __restrict__ idx, long long n, int n_rows,
                    float* __restrict__ out) {
  extern __shared__ float s_acc[];
  const int stride = kSmem ? (n_cols | 1) : n_cols;
  if (kSmem) {
    for (int i = threadIdx.x; i < n_rows * stride; i += blockDim.x) s_acc[i] = 0.0f;
    __syncthreads();
  }
  float* acc = kSmem ? s_acc : out;
  const int lane = threadIdx.x & 31;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  // The bound is tested inside the loop so that whole warps iterate together
  // and the full-mask warp intrinsics below are legal.
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x; base < n;
       base += step) {
    const long long p = base + threadIdx.x;
    const bool live = p < n;
    const int r = live ? min(max(idx[p], 0), n_rows - 1) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, r);
    const bool leader = lane == __ffs(peers) - 1;
    if (!kBatched) {
      for (int c = 0; c < n_cols; ++c) {
        const float s = group_sum(peers, live ? ct[c * n + p] : 0.0f);
        if (live && leader) atomicAdd(acc + r * stride + c, s);
      }
    } else {
      for (int c0 = 0; c0 < n_cols; c0 += 8) {
        float x[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          x[u] = live && c0 + u < n_cols ? ct[(c0 + u) * n + p] : 0.0f;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          if (c0 + u >= n_cols) break;
          const float s = group_sum(peers, x[u]);
          if (live && leader) atomicAdd(acc + r * stride + c0 + u, s);
        }
      }
    }
  }
  if (kSmem) {
    __syncthreads();
    for (int i = threadIdx.x; i < n_rows * n_cols; i += blockDim.x) {
      const float s = s_acc[(i / n_cols) * stride + i % n_cols];
      if (s != 0.0f) atomicAdd(out + i, s);
    }
  }
}


namespace run1 {
constexpr unsigned kFull = 0xffffffffu;
constexpr int kGroupBatch = 4;   // warp-groups whose loads go before their adds
constexpr int kHeld = 4;         // rows a warp sums in registers
constexpr int kNone = -2;        // an empty slot (-1 is a tail index's row)

// The sum of v over the lanes in `peers` (which holds the calling lane), at
// every lane of the group. Every lane of `peers` calls this with the same
// `peers`.
__device__ __forceinline__ float group_sum(unsigned peers, float v) {
  if (peers == kFull) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    return v;
  }
  if ((peers & (peers - 1u)) == 0u) return v;  // alone on its row
  float s = 0.0f;
  for (unsigned m = peers; m != 0u; m &= m - 1u)
    s += __shfl_sync(peers, v, __ffs(m) - 1);
  return s;
}

// The kHeld rows' sums into the table column `col` (lane 0 adds each
// warp's sum), and the slots emptied. Called by the whole warp.
__device__ __forceinline__ void flush_held(float* col, int stride, int lane,
                                           int (&held)[kHeld], float (&acc)[kHeld]) {
#pragma unroll
  for (int k = 0; k < kHeld; ++k) {
    if (held[k] == kNone) continue;
    const float s = group_sum(kFull, acc[k]);
    if (lane == 0 && held[k] >= 0) col[held[k] * stride] += s;
    held[k] = kNone;
    acc[k] = 0.0f;
  }
}

// The tile's indices [base, base + tile) ∩ [0, n) and its C cotangent rows,
// copied into `buf` (C rows of `tile` floats, then the indices) by cp.async.
// With kVec, n and base are multiples of 4 and the pointers 16-byte aligned.
template <bool kVec>
__device__ __forceinline__ void issue_tile(float* buf, const float* __restrict__ ct,
                                           const int* __restrict__ idx, int n_cols,
                                           long long n, long long base, int tile) {
  const int cnt = static_cast<int>(min(static_cast<long long>(tile), n - base));
  constexpr int kWidth = kVec ? 4 : 1;
  const int q = cnt / kWidth;
  const int total = (n_cols + 1) * q;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int c = i / q, j = (i - c * q) * kWidth;
    const float* src = c < n_cols ? ct + c * n + base + j
                                  : reinterpret_cast<const float*>(idx) + base + j;
    __pipeline_memcpy_async(buf + c * tile + j, src, kWidth * sizeof(float));
  }
}

template <bool kVec>
__global__ void __launch_bounds__(1024)
tiled(const float* __restrict__ ct, int n_cols,
                   const int* __restrict__ idx, long long n, int n_rows,
                   int tile, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int stride = n_cols | 1;
  const int tab_len = (n_rows * stride + 3) & ~3;
  float* tab = smem;
  float* bufs[2] = {tab + tab_len, tab + tab_len + (n_cols + 1) * tile};
  unsigned* s_peers = reinterpret_cast<unsigned*>(bufs[1] + (n_cols + 1) * tile);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const long long n_tiles = (n + tile - 1) / tile;

  long long t = blockIdx.x;
  if (t < n_tiles) issue_tile<kVec>(bufs[0], ct, idx, n_cols, n, t * tile, tile);
  __pipeline_commit();
  for (int i = threadIdx.x; i < tab_len; i += blockDim.x) tab[i] = 0.0f;

  for (int b = 0; t < n_tiles; t += gridDim.x, b ^= 1) {
    if (t + gridDim.x < n_tiles)
      issue_tile<kVec>(bufs[b ^ 1], ct, idx, n_cols, n, (t + gridDim.x) * tile, tile);
    __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncthreads();  // tile t is in bufs[b] (and the table is zeroed)
    const float* vals = bufs[b];
    int* rows = reinterpret_cast<int*>(bufs[b] + n_cols * tile);
    const long long base = t * tile;
    for (int j = warp * 32 + lane; j < tile; j += blockDim.x) {
      const int r = base + j < n ? min(max(rows[j], 0), n_rows - 1) : -1;
      s_peers[j] = __match_any_sync(kFull, r);
      rows[j] = r;
    }
    __syncthreads();
    for (int c = warp; c < n_cols; c += warps) {
      float* col = tab + c;
      const float* v = vals + c * tile;
      // Up to kHeld rows (warp-uniform; kNone marks an empty slot) whose
      // sums this lane keeps in registers, acc[k] for held[k].
      int held[kHeld];
      float acc[kHeld];
#pragma unroll
      for (int k = 0; k < kHeld; ++k) {
        held[k] = kNone;
        acc[k] = 0.0f;
      }
      for (int g0 = 0; g0 < tile; g0 += 32 * kGroupBatch) {
        float x[kGroupBatch];
        int r[kGroupBatch];
        unsigned peers[kGroupBatch];
#pragma unroll
        for (int u = 0; u < kGroupBatch; ++u) {
          const int j = g0 + 32 * u + lane;
          x[u] = v[j];
          r[u] = rows[j];
          peers[u] = s_peers[j];
        }
#pragma unroll
        for (int u = 0; u < kGroupBatch; ++u) {
          bool hit = false;
#pragma unroll
          for (int k = 0; k < kHeld; ++k) {
            if (r[u] == held[k]) {
              acc[k] += x[u];
              hit = true;
            }
          }
          if (__all_sync(kFull, hit)) continue;
          // A row the registers do not hold: flush them, then hold the
          // group's new rows if they are few, else add them directly.
          flush_held(col, stride, lane, held, acc);
          const unsigned lead = __ballot_sync(kFull, !hit && lane == __ffs(peers[u]) - 1);
          if (__popc(lead) <= kHeld) {
            unsigned m = lead;
#pragma unroll
            for (int k = 0; k < kHeld; ++k) {
              if (m == 0u) break;
              held[k] = __shfl_sync(kFull, r[u], __ffs(m) - 1);
              m &= m - 1u;
              if (!hit && r[u] == held[k]) acc[k] = x[u];
            }
          } else if (!hit) {
            const float sum = group_sum(peers[u], x[u]);
            if (r[u] >= 0 && lane == __ffs(peers[u]) - 1) col[r[u] * stride] += sum;
          }
          __syncwarp();  // this group's adds are seen by the next group's
        }
      }
      flush_held(col, stride, lane, held, acc);
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


}  // namespace run1

namespace run2 {
constexpr unsigned kFull = 0xffffffffu;
constexpr int kHeld = 4;         // rows a warp sums in registers
constexpr int kNone = -2;        // an empty slot (-1 is a tail index's row)
constexpr int kGroupBatch = 4;   // groups whose loads go before their adds
constexpr int kColBatch = 8;     // columns a warp sums at once (device path)
constexpr int kRunGroups = 16;   // groups a warp takes in turn (device path)
constexpr int kGlobalThreads = 256;

// The sum of v over the warp, at every lane.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// A warp-group's distinct rows, in the order of their first lanes: row(k)
// for k < min(count, kHeld), and the calling lane's slot (its row's k, or
// -1 where count > kHeld, "many": the count stops at kHeld + 1). Called by
// the whole warp with each lane's row r.
struct GroupRows {
  int rows[kHeld];
  int count;
  int slot;
  __device__ __forceinline__ int row(int k) const { return rows[k]; }
};

__device__ __forceinline__ GroupRows group_rows(int r) {
  GroupRows g;
  g.count = 0;
  g.slot = -1;
  unsigned rem = kFull;
#pragma unroll
  for (int k = 0; k < kHeld; ++k) {
    if (rem == 0u) break;
    const int row = __shfl_sync(kFull, r, __ffs(rem) - 1);
    rem &= ~__ballot_sync(kFull, r == row);
    g.rows[k] = row;
    if (r == row) g.slot = k;
    g.count = k + 1;
  }
  if (rem != 0u) {
    g.count = kHeld + 1;
    g.slot = -1;
  }
  return g;
}

// The same, as the tiled path's pre-pass left it in shared memory: the
// count and the rows at `rows` (read only where the group's rows are held),
// the slot read on demand from `slot_at`.
struct SharedGroupRows {
  int count;
  const int* rows;
  const int* slot_at;
  __device__ __forceinline__ int row(int k) const { return rows[k]; }
};

// The registers of up to kHeld rows a warp holds (held[] warp-uniform,
// kNone where empty), one partial sum a row in each lane, for one table
// column `col` whose rows are `stride` apart. Device atomics when kGlobal,
// else a plain add into the warp's own shared-memory column.
template <bool kGlobal>
struct Held {
  int held[kHeld];
  float acc[kHeld];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int k = 0; k < kHeld; ++k) {
      held[k] = kNone;
      acc[k] = 0.0f;
    }
  }

  // Adds x to its row's register if held → whether it was.
  __device__ __forceinline__ bool take(int r, float x) {
    bool hit = false;
#pragma unroll
    for (int k = 0; k < kHeld; ++k) {
      if (r == held[k]) {
        acc[k] += x;
        hit = true;
      }
    }
    return hit;
  }

  // Every held row's warp sum into the table; the slots emptied.
  __device__ __forceinline__ void flush(float* col, long long stride, int lane) {
#pragma unroll
    for (int k = 0; k < kHeld; ++k) {
      if (held[k] == kNone) continue;
      const float s = warp_sum(acc[k]);
      if (lane == 0 && held[k] >= 0 && s != 0.0f) {
        if (kGlobal) atomicAdd(col + held[k] * stride, s);
        else col[held[k] * stride] += s;
      }
      held[k] = kNone;
      acc[k] = 0.0f;
    }
  }

  // One group's value x of row r, the group classed as g: added to a held
  // row, or the held rows flushed and the group's held (few rows), or added
  // directly (many rows). Called by the whole warp.
  template <class G>
  __device__ __forceinline__ void add(float* col, long long stride, int lane,
                                      int r, float x, const G& g) {
    const bool hit = take(r, x);
    if (__all_sync(kFull, hit)) return;
    if (g.count <= kHeld) {
      flush(col, stride, lane);
      const int slot = slot_of(g);
#pragma unroll
      for (int k = 0; k < kHeld; ++k) {
        if (k < g.count) held[k] = g.row(k);
        if (!hit && slot == k) acc[k] = x;
      }
    } else if (!hit && r >= 0) {
      atomicAdd(col + r * stride, x);
    }
    __syncwarp();  // this group's adds before the next group's
  }

  static __device__ __forceinline__ int slot_of(const GroupRows& g) { return g.slot; }
  static __device__ __forceinline__ int slot_of(const SharedGroupRows& g) {
    return *g.slot_at;
  }
};

// The tile's indices [base, base + tile) ∩ [0, n) and its C cotangent rows,
// copied into `buf` (C rows of `tile` floats, then the indices) by cp.async.
// With kVec, n and base are multiples of 4 and the pointers 16-byte aligned.
template <bool kVec>
__device__ __forceinline__ void issue_tile(float* buf, const float* __restrict__ ct,
                                           const int* __restrict__ idx, int n_cols,
                                           long long n, long long base, int tile) {
  const int cnt = static_cast<int>(min(static_cast<long long>(tile), n - base));
  constexpr int kWidth = kVec ? 4 : 1;
  const int q = cnt / kWidth;
  const int total = (n_cols + 1) * q;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int c = i / q, j = (i - c * q) * kWidth;
    const float* src = c < n_cols ? ct + c * n + base + j
                                  : reinterpret_cast<const float*>(idx) + base + j;
    __pipeline_memcpy_async(buf + c * tile + j, src, kWidth * sizeof(float));
  }
}

template <bool kVec>
__global__ void __launch_bounds__(1024)
tiled(const float* __restrict__ ct, int n_cols,
                   const int* __restrict__ idx, long long n, int n_rows,
                   int tile, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int stride = n_cols | 1;
  const int tab_len = (n_rows * stride + 3) & ~3;
  const int groups = tile / 32;
  float* tab = smem;
  float* bufs[2] = {tab + tab_len, tab + tab_len + (n_cols + 1) * tile};
  // Per index its slot; per group its count and rows (kHeld + 1 ints).
  int* s_slot = reinterpret_cast<int*>(bufs[1] + (n_cols + 1) * tile);
  int* s_group = s_slot + tile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const long long n_tiles = (n + tile - 1) / tile;

  long long t = blockIdx.x;
  if (t < n_tiles) issue_tile<kVec>(bufs[0], ct, idx, n_cols, n, t * tile, tile);
  __pipeline_commit();
  for (int i = threadIdx.x; i < tab_len; i += blockDim.x) tab[i] = 0.0f;

  for (int b = 0; t < n_tiles; t += gridDim.x, b ^= 1) {
    if (t + gridDim.x < n_tiles)
      issue_tile<kVec>(bufs[b ^ 1], ct, idx, n_cols, n, (t + gridDim.x) * tile, tile);
    __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncthreads();  // tile t is in bufs[b] (and the table is zeroed)
    const float* vals = bufs[b];
    int* rows = reinterpret_cast<int*>(bufs[b] + n_cols * tile);
    const long long base = t * tile;
    for (int g = warp; g < groups; g += warps) {
      const int j = 32 * g + lane;
      const int r = base + j < n ? min(max(rows[j], 0), n_rows - 1) : -1;
      const GroupRows gr = group_rows(r);
      rows[j] = r;
      s_slot[j] = gr.slot;
      int rec = gr.count;  // lane 0: the count; lanes 1..kHeld: the rows
#pragma unroll
      for (int k = 0; k < kHeld; ++k)
        if (lane == k + 1 && k < gr.count) rec = gr.rows[k];
      if (lane <= kHeld) s_group[(kHeld + 1) * g + lane] = rec;
    }
    __syncthreads();
    for (int c = warp; c < n_cols; c += warps) {
      const float* v = vals + c * tile;
      Held<false> h;
      h.clear();
      for (int g0 = 0; g0 < groups; g0 += kGroupBatch) {
        float x[kGroupBatch];
        int r[kGroupBatch];
        SharedGroupRows gr[kGroupBatch];
#pragma unroll
        for (int u = 0; u < kGroupBatch; ++u) {
          const int j = 32 * (g0 + u) + lane;
          const int* sg = s_group + (kHeld + 1) * (g0 + u);
          x[u] = v[j];
          r[u] = rows[j];
          gr[u] = SharedGroupRows{sg[0], sg + 1, s_slot + j};
        }
#pragma unroll
        for (int u = 0; u < kGroupBatch; ++u)
          h.add(tab + c, stride, lane, r[u], x[u], gr[u]);
      }
      h.flush(tab + c, stride, lane);
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
global(const float* __restrict__ ct, int n_cols,
                    const int* __restrict__ idx, long long n, int n_rows,
                    float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long first = warp * kRunGroups * 32;
  if (first >= n) return;  // whole warps leave together
  for (int c0 = 0; c0 < n_cols; c0 += kColBatch) {
    Held<true> h[kColBatch];
#pragma unroll
    for (int u = 0; u < kColBatch; ++u) h[u].clear();
    for (int g = 0; g < kRunGroups; ++g) {
      const long long p = first + 32 * g + lane;
      if (p - lane >= n) break;  // warp-uniform
      const bool live = p < n;
      const int r = live ? min(max(idx[p], 0), n_rows - 1) : -1;
      float x[kColBatch];
#pragma unroll
      for (int u = 0; u < kColBatch; ++u)
        x[u] = live && c0 + u < n_cols ? ct[(c0 + u) * n + p] : 0.0f;
      const GroupRows gr = group_rows(r);
#pragma unroll
      for (int u = 0; u < kColBatch; ++u)
        if (c0 + u < n_cols) h[u].add(out + c0 + u, n_cols, lane, r, x[u], gr);
    }
#pragma unroll
    for (int u = 0; u < kColBatch; ++u)
      if (c0 + u < n_cols) h[u].flush(out + c0 + u, n_cols, lane);
  }
}

}  // namespace run2

namespace run3 {
constexpr unsigned kFull = 0xffffffffu;
constexpr int kHeld = 4;         // rows a warp sums in registers
constexpr int kNone = -2;        // an empty slot (-1 is a tail index's row)
constexpr int kGroupBatch = 4;   // groups whose loads go before their adds
constexpr int kColBatch = 8;     // columns a warp sums at once (device path)
constexpr int kRunGroups = 16;   // groups a warp takes in turn (device path)
constexpr int kGlobalThreads = 256;
constexpr int kTags = 256;       // a warp's row tags in the tiled pre-pass
constexpr int kOwn = -1;         // a many-row lane that alone adds to its row
constexpr int kShare = -3;       // one that may share its row's address

// The sum of v over the warp, at every lane.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// A warp-group's distinct rows, in the order of their first lanes: row(k)
// for k < min(count, kHeld), and the calling lane's slot (its row's k, or
// -1 where count > kHeld, "many": the count stops at kHeld + 1). Called by
// the whole warp with each lane's row r.
struct GroupRows {
  int rows[kHeld];
  int count;
  int slot;
  __device__ __forceinline__ int row(int k) const { return rows[k]; }
};

__device__ __forceinline__ GroupRows group_rows(int r) {
  GroupRows g;
  g.count = 0;
  g.slot = -1;
  unsigned rem = kFull;
#pragma unroll
  for (int k = 0; k < kHeld; ++k) {
    if (rem == 0u) break;
    const int row = __shfl_sync(kFull, r, __ffs(rem) - 1);
    rem &= ~__ballot_sync(kFull, r == row);
    g.rows[k] = row;
    if (r == row) g.slot = k;
    g.count = k + 1;
  }
  if (rem != 0u) {
    g.count = kHeld + 1;
    g.slot = -1;
  }
  return g;
}

// The same, as the tiled path's pre-pass left it in shared memory: the
// count and the rows at `rows` (read only where the group's rows are held),
// the slot read on demand from `slot_at`.
struct SharedGroupRows {
  int count;
  const int* rows;
  const int* slot_at;
  __device__ __forceinline__ int row(int k) const { return rows[k]; }
};

// The registers of up to kHeld rows a warp holds (held[] warp-uniform,
// kNone where empty), one partial sum a row in each lane, for one table
// column `col` whose rows are `stride` apart. Device atomics when kGlobal,
// else a plain add into the warp's own shared-memory column.
template <bool kGlobal>
struct Held {
  int held[kHeld];
  float acc[kHeld];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int k = 0; k < kHeld; ++k) {
      held[k] = kNone;
      acc[k] = 0.0f;
    }
  }

  // Adds x to its row's register if held → whether it was.
  __device__ __forceinline__ bool take(int r, float x) {
    bool hit = false;
#pragma unroll
    for (int k = 0; k < kHeld; ++k) {
      if (r == held[k]) {
        acc[k] += x;
        hit = true;
      }
    }
    return hit;
  }

  // Every held row's warp sum into the table; the slots emptied.
  __device__ __forceinline__ void flush(float* col, long long stride, int lane) {
#pragma unroll
    for (int k = 0; k < kHeld; ++k) {
      if (held[k] == kNone) continue;
      const float s = warp_sum(acc[k]);
      if (lane == 0 && held[k] >= 0 && s != 0.0f) {
        if (kGlobal) atomicAdd(col + held[k] * stride, s);
        else col[held[k] * stride] += s;
      }
      held[k] = kNone;
      acc[k] = 0.0f;
    }
  }

  // One group's value x of row r, the group classed as g: added to a held
  // row, or the held rows flushed and the group's held (few rows), or added
  // directly (many rows). Called by the whole warp.
  template <class G>
  __device__ __forceinline__ void add(float* col, long long stride, int lane,
                                      int r, float x, const G& g) {
    const bool hit = take(r, x);
    if (__all_sync(kFull, hit)) return;
    if (g.count <= kHeld) {
      flush(col, stride, lane);
      const int slot = slot_of(g);
#pragma unroll
      for (int k = 0; k < kHeld; ++k) {
        if (k < g.count) held[k] = g.row(k);
        if (!hit && slot == k) acc[k] = x;
      }
    } else if (kGlobal) {
      add_runs(col, stride, lane, hit ? kNone : r, hit ? 0.0f : x);
    } else {
      // A lane that owns its row's tag adds with a plain read-modify-write
      // (no other lane of the warp is on its row); then the others, whose
      // row may have a second lane, with atomics.
      const int own = slot_of(g);
      if (!hit && r >= 0 && own == kOwn) col[r * stride] += x;
      __syncwarp();
      if (!hit && r >= 0 && own != kOwn) atomicAdd(col + r * stride, x);
    }
    __syncwarp();  // this group's adds before the next group's
  }

  // Device path, many rows: each run of adjacent lanes on one row (key) is
  // summed by a segmented scan, and its last lane adds the sum (the hit
  // triangles of an image come in runs along its rows).
  static __device__ __forceinline__ void add_runs(float* col, long long stride,
                                                  int lane, int key, float v) {
    const int prev = __shfl_up_sync(kFull, key, 1);
    const unsigned heads = __ballot_sync(kFull, lane == 0 || prev != key);
    const int head = 31 - __clz(heads & (kFull >> (31 - lane)));
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_up_sync(kFull, v, o);
      if (lane - o >= head) v += t;
    }
    const bool tail = lane == 31 || ((heads >> (lane + 1)) & 1u);
    if (tail && key >= 0 && v != 0.0f) atomicAdd(col + key * stride, v);
  }

  static __device__ __forceinline__ int slot_of(const GroupRows& g) { return g.slot; }
  static __device__ __forceinline__ int slot_of(const SharedGroupRows& g) {
    return *g.slot_at;
  }
};

// The tile's indices [base, base + tile) ∩ [0, n) and its C cotangent rows,
// copied into `buf` (C rows of `tile` floats, then the indices) by cp.async.
// With kVec, n and base are multiples of 4 and the pointers 16-byte aligned.
template <bool kVec>
__device__ __forceinline__ void issue_tile(float* buf, const float* __restrict__ ct,
                                           const int* __restrict__ idx, int n_cols,
                                           long long n, long long base, int tile) {
  const int cnt = static_cast<int>(min(static_cast<long long>(tile), n - base));
  constexpr int kWidth = kVec ? 4 : 1;
  const int q = cnt / kWidth;
  const int total = (n_cols + 1) * q;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int c = i / q, j = (i - c * q) * kWidth;
    const float* src = c < n_cols ? ct + c * n + base + j
                                  : reinterpret_cast<const float*>(idx) + base + j;
    __pipeline_memcpy_async(buf + c * tile + j, src, kWidth * sizeof(float));
  }
}

template <bool kVec>
__global__ void __launch_bounds__(1024)
tiled(const float* __restrict__ ct, int n_cols,
                   const int* __restrict__ idx, long long n, int n_rows,
                   int tile, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int stride = n_cols | 1;
  const int tab_len = (n_rows * stride + 3) & ~3;
  const int groups = tile / 32;
  float* tab = smem;
  float* bufs[2] = {tab + tab_len, tab + tab_len + (n_cols + 1) * tile};
  // Per index its slot (few rows) or whether it owns its row's tag (many);
  // per group its count and rows (kHeld + 1 ints); a warp's row tags.
  int* s_slot = reinterpret_cast<int*>(bufs[1] + (n_cols + 1) * tile);
  int* s_group = s_slot + tile;
  int* s_tags = s_group + (kHeld + 1) * groups;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const long long n_tiles = (n + tile - 1) / tile;

  long long t = blockIdx.x;
  if (t < n_tiles) issue_tile<kVec>(bufs[0], ct, idx, n_cols, n, t * tile, tile);
  __pipeline_commit();
  for (int i = threadIdx.x; i < tab_len; i += blockDim.x) tab[i] = 0.0f;

  for (int b = 0; t < n_tiles; t += gridDim.x, b ^= 1) {
    if (t + gridDim.x < n_tiles)
      issue_tile<kVec>(bufs[b ^ 1], ct, idx, n_cols, n, (t + gridDim.x) * tile, tile);
    __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncthreads();  // tile t is in bufs[b] (and the table is zeroed)
    const float* vals = bufs[b];
    int* rows = reinterpret_cast<int*>(bufs[b] + n_cols * tile);
    const long long base = t * tile;
    for (int g = warp; g < groups; g += warps) {
      const int j = 32 * g + lane;
      const int r = base + j < n ? min(max(rows[j], 0), n_rows - 1) : -1;
      const GroupRows gr = group_rows(r);
      int slot = gr.slot;
      if (gr.count > kHeld) {  // many rows: which lanes own their row's tag
        int* tag = s_tags + warp * kTags + (r & (kTags - 1));
        *tag = lane;
        __syncwarp();
        slot = *tag == lane ? kOwn : kShare;
        __syncwarp();
      }
      rows[j] = r;
      s_slot[j] = slot;
      int rec = gr.count;  // lane 0: the count; lanes 1..kHeld: the rows
#pragma unroll
      for (int k = 0; k < kHeld; ++k)
        if (lane == k + 1 && k < gr.count) rec = gr.rows[k];
      if (lane <= kHeld) s_group[(kHeld + 1) * g + lane] = rec;
    }
    __syncthreads();
    for (int c = warp; c < n_cols; c += warps) {
      const float* v = vals + c * tile;
      Held<false> h;
      h.clear();
      for (int g0 = 0; g0 < groups; g0 += kGroupBatch) {
        float x[kGroupBatch];
        int r[kGroupBatch];
        SharedGroupRows gr[kGroupBatch];
#pragma unroll
        for (int u = 0; u < kGroupBatch; ++u) {
          const int j = 32 * (g0 + u) + lane;
          const int* sg = s_group + (kHeld + 1) * (g0 + u);
          x[u] = v[j];
          r[u] = rows[j];
          gr[u] = SharedGroupRows{sg[0], sg + 1, s_slot + j};
        }
#pragma unroll
        for (int u = 0; u < kGroupBatch; ++u)
          h.add(tab + c, stride, lane, r[u], x[u], gr[u]);
      }
      h.flush(tab + c, stride, lane);
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

}  // namespace run3

namespace run4 {
constexpr unsigned kFull = 0xffffffffu;
constexpr int kHeld = 4;         // rows a warp sums in registers
constexpr int kNone = -2;        // an empty slot (-1 is a tail index's row)
constexpr int kGroupBatch = 8;   // groups whose loads go before their adds
constexpr int kColBatch = 8;     // columns a warp sums at once (device path)
constexpr int kRunGroups = 16;   // groups a warp takes in turn (device path)
constexpr int kGlobalThreads = 256;
constexpr int kTags = 256;       // a warp's row tags in the tiled pre-pass
constexpr int kOwn = kHeld;      // code: a many-row lane that owns its row's tag
constexpr int kShare = kHeld + 1;  // code: one that may share its row's address

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
// per index, row * 8 + slot (the slot of a few-row group's lane, else kOwn
// or kShare), and a record per group, its count and rows (read only where
// the group's rows are to be held).
struct TiledGroup {
  const int* rec;
  int code;
  __device__ __forceinline__ int slot() const { return code & 7; }
  __device__ __forceinline__ bool few() const { return slot() < kHeld; }
  __device__ __forceinline__ int count() const { return rec[0]; }
  __device__ __forceinline__ int row(int k) const { return rec[1 + k]; }
};

// The registers of up to kHeld rows a warp holds (held[] warp-uniform,
// kNone where empty), one partial sum a row in each lane, for one table
// column `col` whose rows are `stride` apart. Device atomics when kGlobal,
// else a plain add into the warp's own shared-memory column.
template <bool kGlobal>
struct Held {
  int held[kHeld];
  float acc[kHeld];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int k = 0; k < kHeld; ++k) {
      held[k] = kNone;
      acc[k] = 0.0f;
    }
  }

  // Adds x to its row's register if held → whether it was.
  __device__ __forceinline__ bool take(int r, float x) {
    bool hit = false;
#pragma unroll
    for (int k = 0; k < kHeld; ++k) {
      if (r == held[k]) {
        acc[k] += x;
        hit = true;
      }
    }
    return hit;
  }

  // Every held row's warp sum into the table; the slots emptied.
  __device__ __forceinline__ void flush(float* col, long long stride, int lane) {
#pragma unroll
    for (int k = 0; k < kHeld; ++k) {
      if (held[k] == kNone) continue;
      const float s = warp_sum(acc[k]);
      if (lane == 0 && held[k] >= 0 && s != 0.0f) {
        if (kGlobal) atomicAdd(col + held[k] * stride, s);
        else col[held[k] * stride] += s;
      }
      held[k] = kNone;
      acc[k] = 0.0f;
    }
  }

  // One group's value x of row r, the group classed as g: added to a held
  // row, or the held rows flushed and the group's held (few rows), or added
  // directly (many rows). Called by the whole warp.
  template <class G>
  __device__ __forceinline__ void add(float* col, long long stride, int lane,
                                      int r, float x, const G& g) {
    // held[] fills from slot 0, so nothing is held while held[0] is empty.
    const bool hit = held[0] != kNone && take(r, x);
    if (__all_sync(kFull, hit)) return;
    if (g.few()) {
      flush(col, stride, lane);
      const int count = g.count(), slot = g.slot();
#pragma unroll
      for (int k = 0; k < kHeld; ++k) {
        if (k < count) held[k] = g.row(k);
        if (!hit && slot == k) acc[k] = x;
      }
    } else if (kGlobal) {
      add_runs(col, stride, lane, hit ? kNone : r, hit ? 0.0f : x);
    } else {
      // A lane that owns its row's tag adds with a plain read-modify-write
      // (no other owner of the warp is on its row); then the others, whose
      // row may have a second lane, with atomics.
      const bool own = g.slot() == kOwn;
      if (!hit && r >= 0 && own) col[r * stride] += x;
      __syncwarp();
      if (!hit && r >= 0 && !own) atomicAdd(col + r * stride, x);
    }
    __syncwarp();  // this group's adds before the next group's
  }

  // Device path, many rows: each run of adjacent lanes on one row (key) is
  // summed by a segmented scan, and its last lane adds the sum (the hit
  // triangles of an image come in runs along its rows).
  static __device__ __forceinline__ void add_runs(float* col, long long stride,
                                                  int lane, int key, float v) {
    const int prev = __shfl_up_sync(kFull, key, 1);
    const unsigned heads = __ballot_sync(kFull, lane == 0 || prev != key);
    const int head = 31 - __clz(heads & (kFull >> (31 - lane)));
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_up_sync(kFull, v, o);
      if (lane - o >= head) v += t;
    }
    const bool tail = lane == 31 || ((heads >> (lane + 1)) & 1u);
    if (tail && key >= 0 && v != 0.0f) atomicAdd(col + key * stride, v);
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

// Column c's values of groups g0 .. g0 + kGroupBatch - 1 of the tile at
// `base`, 0 past n.
__device__ __forceinline__ void load_batch(float (&x)[kGroupBatch],
                                           const float* __restrict__ src,
                                           long long base, long long n,
                                           int g0, int lane) {
#pragma unroll
  for (int u = 0; u < kGroupBatch; ++u) {
    const long long p = base + 32 * (g0 + u) + lane;
    x[u] = p < n ? __ldg(src + p) : 0.0f;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(768, 2)
tiled2(const float* __restrict__ ct, int n_cols,
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
    for (int c = warp; c < n_cols; c += warps) {
      const float* src = ct + c * n;
      Held<false> h;
      h.clear();
      float x[kGroupBatch];
      load_batch(x, src, base, n, 0, lane);
      for (int g0 = 0; g0 < groups; g0 += kGroupBatch) {
        // The next batch's values are loaded before this batch's adds.
        float xn[kGroupBatch];
        if (g0 + kGroupBatch < groups)
          load_batch(xn, src, base, n, g0 + kGroupBatch, lane);
        int cd[kGroupBatch];
#pragma unroll
        for (int u = 0; u < kGroupBatch; ++u) cd[u] = code[32 * (g0 + u) + lane];
#pragma unroll
        for (int u = 0; u < kGroupBatch; ++u)
          h.add(tab + c, stride, lane, cd[u] >> 3, x[u],
                TiledGroup{s_group + (kHeld + 1) * (g0 + u), cd[u]});
#pragma unroll
        for (int u = 0; u < kGroupBatch; ++u) x[u] = xn[u];
      }
      h.flush(tab + c, stride, lane);
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

}  // namespace run4

namespace run6 {
constexpr unsigned kFull = 0xffffffffu;
constexpr int kHeld = 4;         // rows a warp sums in registers
constexpr int kNone = -2;        // an empty slot (-1 is a tail index's row)
constexpr int kGroupBatch = 8;   // groups whose loads go before their adds
constexpr int kColBatch = 8;     // columns a warp sums at once (device path)
constexpr int kRunGroups = 16;   // groups a warp takes in turn (device path)
constexpr int kGlobalThreads = 256;
constexpr int kTags = 256;       // a warp's row tags in the tiled pre-pass
constexpr int kToLane = 32;      // code: a many-row lane's slot is 32 + its target
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
// per index, row * 64 + slot (a few-row group's lane: its row's k; a
// many-row group's: kToLane + the lane that adds its row), and a record per
// group, its count and rows (read only where the group's rows are to be
// held).
struct TiledGroup {
  const int* rec;
  int code;
  __device__ __forceinline__ int slot() const { return code & 63; }
  __device__ __forceinline__ bool few() const { return slot() < kToLane; }
  __device__ __forceinline__ int count() const { return rec[0]; }
  __device__ __forceinline__ int row(int k) const { return rec[1 + k]; }
};

// The lane of a many-row group that adds row r's values: lanes write their
// ids to their warp's tags (tag r mod kTags) and read them back; a lane
// that reads the id of a lane on its own row (itself, if its write landed)
// has its target, the others (another row shares the tag) go round again.
// A target's row is that of no other target: two lanes on one row share a
// tag and so a target, and a row whose tag another row's lane took in a
// round finds no target of its own row there. Called by the whole warp.
__device__ __forceinline__ int row_target(int* tags, int r, int lane) {
  int* tag = tags + (r & (kTags - 1));
  int target = -1;
  for (unsigned left = kFull; left != 0u;
       left = __ballot_sync(kFull, target < 0)) {
    const bool mine = (left >> lane) & 1u;
    if (mine) *tag = lane;
    __syncwarp();
    const int o = mine ? *tag : lane;
    const int r_o = __shfl_sync(kFull, r, o);
    if (mine && r_o == r) target = o;
    __syncwarp();
  }
  return target;
}

// The registers of up to kHeld rows a warp holds (held[] warp-uniform,
// kNone where empty), one partial sum a row in each lane, for one table
// column `col` whose rows are `stride` apart. Device atomics when kGlobal,
// else a plain add into the warp's own shared-memory column.
template <bool kGlobal>
struct Held {
  int held[kHeld];
  float acc[kHeld];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int k = 0; k < kHeld; ++k) {
      held[k] = kNone;
      acc[k] = 0.0f;
    }
  }

  // Adds x to its row's register if held → whether it was.
  __device__ __forceinline__ bool take(int r, float x) {
    bool hit = false;
#pragma unroll
    for (int k = 0; k < kHeld; ++k) {
      if (r == held[k]) {
        acc[k] += x;
        hit = true;
      }
    }
    return hit;
  }

  // Every held row's warp sum into the table; the slots emptied.
  __device__ __forceinline__ void flush(float* col, long long stride, int lane) {
#pragma unroll
    for (int k = 0; k < kHeld; ++k) {
      if (held[k] == kNone) continue;
      const float s = warp_sum(acc[k]);
      if (lane == 0 && held[k] >= 0 && s != 0.0f) {
        if (kGlobal) atomicAdd(col + held[k] * stride, s);
        else col[held[k] * stride] += s;
      }
      held[k] = kNone;
      acc[k] = 0.0f;
    }
  }

  // One group's value x of row r, the group classed as g: added to a held
  // row, or the held rows flushed and the group's held (few rows), or added
  // directly (many rows). Called by the whole warp.
  template <class G>
  __device__ __forceinline__ void add(float* col, long long stride, int lane,
                                      int r, float x, const G& g) {
    // held[] fills from slot 0, so nothing is held while held[0] is empty.
    const bool hit = held[0] != kNone && take(r, x);
    if (__all_sync(kFull, hit)) return;
    if (g.few()) {
      flush(col, stride, lane);
      const int count = g.count(), slot = g.slot();
#pragma unroll
      for (int k = 0; k < kHeld; ++k) {
        if (k < count) held[k] = g.row(k);
        if (!hit && slot == k) acc[k] = x;
      }
    } else if (kGlobal) {
      add_runs(col, stride, lane, hit ? kNone : r, hit ? 0.0f : x);
    } else {
      // Each lane not held hands its value to its row's target lane, which
      // adds the sum with a plain read-modify-write: the targets' rows are
      // distinct, so one instruction's adds hit distinct addresses. (A row
      // held is held for all its lanes, so no target waits on a held lane.)
      const int target = g.slot() - kToLane;
      float v = x;
      for (unsigned send = __ballot_sync(kFull, !hit && target != lane);
           send != 0u; send &= send - 1u) {
        const int from = __ffs(send) - 1;
        const float w = __shfl_sync(kFull, v, from);
        if (lane == __shfl_sync(kFull, target, from)) v += w;
      }
      if (!hit && r >= 0 && target == lane) col[r * stride] += v;
    }
    __syncwarp();  // this group's adds before the next group's
  }

  // Device path, many rows: each run of adjacent lanes on one row (key) is
  // summed by a segmented scan, and its last lane adds the sum (the hit
  // triangles of an image come in runs along its rows).
  static __device__ __forceinline__ void add_runs(float* col, long long stride,
                                                  int lane, int key, float v) {
    const int prev = __shfl_up_sync(kFull, key, 1);
    const unsigned heads = __ballot_sync(kFull, lane == 0 || prev != key);
    const int head = 31 - __clz(heads & (kFull >> (31 - lane)));
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_up_sync(kFull, v, o);
      if (lane - o >= head) v += t;
    }
    const bool tail = lane == 31 || ((heads >> (lane + 1)) & 1u);
    if (tail && key >= 0 && v != 0.0f) atomicAdd(col + key * stride, v);
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

// Column c's values of groups g0 .. g0 + kGroupBatch - 1 of the tile at
// `base`, 0 past n.
__device__ __forceinline__ void load_batch(float (&x)[kGroupBatch],
                                           const float* __restrict__ src,
                                           long long base, long long n,
                                           int g0, int lane) {
#pragma unroll
  for (int u = 0; u < kGroupBatch; ++u) {
    const long long p = base + 32 * (g0 + u) + lane;
    x[u] = p < n ? __ldg(src + p) : 0.0f;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(1024)
tiled(const float* __restrict__ ct, int n_cols,
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
      const int slot = gr.few() ? gr.slot()
                                : kToLane + row_target(s_tags + warp * kTags, r, lane);
      code[j] = r * 64 + slot;
      int rec = gr.count();  // lane 0: the count; lanes 1..kHeld: the rows
#pragma unroll
      for (int k = 0; k < kHeld; ++k)
        if (lane == k + 1 && k < gr.count()) rec = gr.row(k);
      if (lane <= kHeld) s_group[(kHeld + 1) * g + lane] = rec;
    }
    __syncthreads();
    for (int c = warp; c < n_cols; c += warps) {
      const float* src = ct + c * n;
      Held<false> h;
      h.clear();
      float x[kGroupBatch];
      load_batch(x, src, base, n, 0, lane);
      for (int g0 = 0; g0 < groups; g0 += kGroupBatch) {
        // The next batch's values are loaded before this batch's adds.
        float xn[kGroupBatch];
        if (g0 + kGroupBatch < groups)
          load_batch(xn, src, base, n, g0 + kGroupBatch, lane);
        int cd[kGroupBatch];
#pragma unroll
        for (int u = 0; u < kGroupBatch; ++u) cd[u] = code[32 * (g0 + u) + lane];
#pragma unroll
        for (int u = 0; u < kGroupBatch; ++u)
          h.add(tab + c, stride, lane, cd[u] >> 6, x[u],
                TiledGroup{s_group + (kHeld + 1) * (g0 + u), cd[u]});
#pragma unroll
        for (int u = 0; u < kGroupBatch; ++u) x[u] = xn[u];
      }
      h.flush(tab + c, stride, lane);
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

}  // namespace run6

}  // namespace micro

extern "C" int micro_scatter(int variant, const float* ct, int n_cols,
                             const int* idx, long long n, int n_rows, int tile,
                             float* out, cudaStream_t stream) {
  using namespace micro;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (variant == 3) {
    // the second design's tiled path (its tile: the package's formula
    // without the tags)
    const long long tab_len = (static_cast<long long>(n_rows) * (n_cols | 1) + 3) & ~3LL;
    const long long smem = (tab_len + 2LL * (n_cols + 1) * tile + tile +
                            (run2::kHeld + 1LL) * (tile / 32)) * 4;
    if (tile <= 0 || smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
    const long long n_tiles = (n + tile - 1) / tile;
    const int blocks = static_cast<int>(n_tiles < sms ? n_tiles : sms);
    const int threads = 32 * min(max(n_cols, 4), 32);
    auto kernel = n % 4 == 0 ? run2::tiled<true> : run2::tiled<false>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<blocks, threads, static_cast<size_t>(smem), stream>>>(
        ct, n_cols, idx, n, n_rows, tile, out);
    return static_cast<int>(cudaGetLastError());
  }
  if (variant > 20) {  // the fourth design at 42 registers
    const int bps = variant % 10;
    const int warps = min(max(n_cols, 4), 24);
    const long long tab_len = (static_cast<long long>(n_rows) * (n_cols | 1) + 3) & ~3LL;
    const long long smem = (tab_len + 2LL * tile + (run4::kHeld + 1LL) * (tile / 32) +
                            static_cast<long long>(run4::kTags) * warps) * 4;
    if (tile <= 0 || smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
    const long long n_tiles = (n + tile - 1) / tile;
    const long long want = static_cast<long long>(sms) * bps;
    const int blocks = static_cast<int>(n_tiles < want ? n_tiles : want);
    auto kernel = n % 4 == 0 ? run4::tiled2<true> : run4::tiled2<false>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<blocks, 32 * warps, static_cast<size_t>(smem), stream>>>(
        ct, n_cols, idx, n, n_rows, tile, out);
    return static_cast<int>(cudaGetLastError());
  }
  if (variant == 6) {  // the fifth design, as many blocks an SM as fit (up to 4)
    const int warps = min(max(n_cols, 4), 32);
    const long long tab_len = (static_cast<long long>(n_rows) * (n_cols | 1) + 3) & ~3LL;
    const long long smem = (tab_len + 2LL * tile + (run6::kHeld + 1LL) * (tile / 32) +
                            static_cast<long long>(run6::kTags) * warps) * 4;
    if (tile <= 0 || smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
    auto kernel = n % 4 == 0 ? run6::tiled<true> : run6::tiled<false>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    int occ = 1;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, 32 * warps,
                                                        static_cast<size_t>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long n_tiles = (n + tile - 1) / tile;
    const long long want = static_cast<long long>(sms) * max(1, min(occ, 4));
    const int blocks = static_cast<int>(n_tiles < want ? n_tiles : want);
    kernel<<<blocks, 32 * warps, static_cast<size_t>(smem), stream>>>(
        ct, n_cols, idx, n, n_rows, tile, out);
    return static_cast<int>(cudaGetLastError());
  }
  if (variant == 5) {
    const int warps = min(max(n_cols, 4), 32);
    const long long tab_len = (static_cast<long long>(n_rows) * (n_cols | 1) + 3) & ~3LL;
    const long long smem = (tab_len + 2LL * (n_cols + 1) * tile + tile +
                            (run3::kHeld + 1LL) * (tile / 32) +
                            static_cast<long long>(run3::kTags) * warps) * 4;
    if (tile <= 0 || smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
    const long long n_tiles = (n + tile - 1) / tile;
    const int blocks = static_cast<int>(n_tiles < sms ? n_tiles : sms);
    auto kernel = n % 4 == 0 ? run3::tiled<true> : run3::tiled<false>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<blocks, 32 * warps, static_cast<size_t>(smem), stream>>>(
        ct, n_cols, idx, n, n_rows, tile, out);
    return static_cast<int>(cudaGetLastError());
  }
  if (variant == 4) {
    const long long warps = (n + 32LL * run2::kRunGroups - 1) / (32LL * run2::kRunGroups);
    const long long blocks = (warps * 32 + run2::kGlobalThreads - 1) / run2::kGlobalThreads;
    run2::global<<<static_cast<unsigned>(blocks), run2::kGlobalThreads, 0, stream>>>(
        ct, n_cols, idx, n, n_rows, out);
    return static_cast<int>(cudaGetLastError());
  }
  if (variant == 2) {
    const long long tab_len = (static_cast<long long>(n_rows) * (n_cols | 1) + 3) & ~3LL;
    const long long smem = (tab_len + 2LL * (n_cols + 1) * tile + tile) * 4;
    if (tile <= 0 || smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
    const long long n_tiles = (n + tile - 1) / tile;
    const int blocks = static_cast<int>(n_tiles < sms ? n_tiles : sms);
    const int threads = 32 * min(max(n_cols, 4), 32);
    const bool vec = n % 4 == 0;
    auto kernel = vec ? run1::tiled<true> : run1::tiled<false>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<blocks, threads, static_cast<size_t>(smem), stream>>>(
        ct, n_cols, idx, n, n_rows, tile, out);
    return static_cast<int>(cudaGetLastError());
  }
  const long long want = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(
      want < static_cast<long long>(kBlocksPerSm) * sms ? want : kBlocksPerSm * sms);
  const long long smem = static_cast<long long>(n_rows) * (n_cols | 1) * sizeof(float);
  const bool batched = variant == 1;
  if (smem <= kMaxSmemBytes) {
    auto kernel = batched ? parent_kernel<true, true> : parent_kernel<true, false>;
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<blocks, kThreads, static_cast<size_t>(smem), stream>>>(ct, n_cols, idx, n,
                                                                    n_rows, out);
  } else {
    auto kernel = batched ? parent_kernel<false, true> : parent_kernel<false, false>;
    kernel<<<blocks, kThreads, 0, stream>>>(ct, n_cols, idx, n, n_rows, out);
  }
  return static_cast<int>(cudaGetLastError());
}
