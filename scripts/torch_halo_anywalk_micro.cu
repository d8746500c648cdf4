// Variants of kernels 9 (the halo offset gather, csrc/halo.cu) and 19 (the
// BVH any-hit, csrc/walk.cu) that the package leaves out, for
// scripts/torch_halo_anywalk_micro.py. The package's halo.cu and walk.cu
// are included for their kernels and walks.
//
// Kernel 9, out[d, c, i, j] = planes[c, clamp(i + dy), clamp(j + dx)]:
// - variant 0: a thread per (d, pixel) at any D (the first design; the
//   package's kernel at D = 1);
// - variants 1-5, 7-14: a block a tile of output pixels with the
//   channels' windows staged in shared memory: 1 the first window design
//   (32 x 32 tile, margin 16, 4 channels a stage, staged by loads and
//   stores in turn with the copies out, 2 blocks an SM, 8 offset fields
//   resolved at once); the rest double-buffered by cp.async, 16 bytes a
//   copy where the rows allow (the package's kernel at D >= 2: 32 x 32,
//   margin 16, 1 channel a stage, 4 blocks an SM, 5 fields at once): 2 2
//   channels, 2 blocks an SM, 8 fields (the first cp.async design); 3 2
//   with 4 channels; 4 2 with margin 12 (a radius hint's window for the
//   spatial offsets); 5 2 with a 16 x 32 tile; 7 2 with 4-byte copies; 8
//   2 with 1 channel; 9 2 at 3 blocks an SM; 10 the package's with plain
//   stores instead of streaming ones; 11 margin 12, 2 channels, 4 blocks
//   an SM, 5 fields; 12 2 channels, 3 blocks an SM, 5 fields; 13 the
//   package's at 5 blocks an SM; 14 the package's with 8 fields; 15 this
//   template at the package's settings (the package's kernel folds them);
// - variant 6: pixel-major records, a transposing pre-pass into
//   ``scratch`` ([H W, C4] floats, C4 = C rounded up to 4), then a thread
//   per (d, pixel) reading its source's record as float4 loads.
// Kernel 19, rays [S, 3, N], t_max [S, N], out [S, N] bytes (the
// package's: the two-box records, the left child first, a speculative
// while-while loop, the triangle records, 8 x 4 tiles, 40 registers):
// - variant 1: the package's walk with no register bound;
// - variant 2: the package's walk, a warp's rays a row of 32 pixels;
// - variants 3, 7, 9: the two-box walk as one loop that tests a leaf where
//   it meets it, the left (3), the farther (7; a shadow ray starts on a
//   surface, whose own boxes are the nearest) or the nearer (9, this
//   design's first) child first;
// - variant 4: the preorder walk (walk_any) on the triangle records, on
//   tiles, 40 registers;
// - variant 5: the parent kernel (the preorder walk on the [10, T]
//   columns, rows of 32, no register bound);
// - variant 6: the package's walk reading the [10, T] columns;
// - variant 8: the package's walk taking the nearer child first.
// Kernel 20 on the package's walk (micro_any_k): a pixel's S rays in
// adjacent lanes, as kernel 20, each walking nearer first on the two-box
// records, the preorder walk again where its stack fills.
#include "halo.cu"
#include "walk.cu"
#include "torch_walk_micro_coltris.cuh"

namespace micro {
using namespace romis;

// ---- kernel 9 ----

// The window design with its knobs: a kTH x 32 output tile, margin kM, kCC
// channels a stage, staged by cp.async double-buffered (kAsync) or by
// loads and stores in turn with the copies out, 16-byte copies (kVec),
// kMinBlocks blocks an SM, streaming stores (kStream), kDG offset fields
// resolved at once. The package's kernel is <32, 16, 1, true, kVec, 4,
// true, 5>.
template <int kTH, int kM, int kCC, bool kAsync>
struct GatherWindow {
  static constexpr int kWinH = kTH + 2 * kM, kWinW = kGatherTileW + 2 * kM;
  static constexpr int kArea = kWinH * kWinW;
  static constexpr int kRows = kGatherThreads / kGatherTileW;  // a pass's
  static constexpr int kPerThread = kTH * kGatherTileW / kGatherThreads;
  static constexpr int kBuffers = kAsync ? 2 : 1;
  static constexpr size_t kSmem = sizeof(float) * kBuffers * kCC * kArea;
  static_assert(kGatherTileW == 32 && kTH % kRows == 0,
                "a warp a row of the tile");
  static_assert(kArea % 4 == 0, "16-byte aligned stages");
};

// Stage the window of channels [c0, c0 + cc) into dst [cc][kArea].
template <int kTH, int kM, int kCC, bool kAsync, bool kVec>
__device__ __forceinline__ void stage_variant(float* dst,
                                              const float* __restrict__ pc,
                                              int cc, int n, int h, int w,
                                              int y0, int x0) {
  using Win = GatherWindow<kTH, kM, kCC, kAsync>;
  if (kVec) {
    constexpr int kQuads = Win::kWinW / 4, kCells = Win::kWinH * kQuads;
#pragma unroll 4
    for (int e = threadIdx.x; e < cc * kCells; e += kGatherThreads) {
      const int c = e / kCells, a = e - c * kCells;
      const int wy = a / kQuads, wx = 4 * (a - wy * kQuads);
      const int gy = y0 - kM + wy, gx = x0 - kM + wx;
      if (gy >= 0 && gy < h && gx >= 0 && gx < w)
        cp_async16(dst + c * Win::kArea + wy * Win::kWinW + wx,
                   pc + static_cast<long long>(c) * n + gy * w + gx);
    }
  } else {
#pragma unroll 4
    for (int e = threadIdx.x; e < cc * Win::kArea; e += kGatherThreads) {
      const int c = e / Win::kArea, a = e - c * Win::kArea;
      const int gy = y0 - kM + a / Win::kWinW;
      const int gx = x0 - kM + a % Win::kWinW;
      if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
        const float* src = pc + static_cast<long long>(c) * n + gy * w + gx;
        if (kAsync)
          cp_async4(dst + e, src);
        else
          dst[e] = __ldg(src);
      }
    }
  }
}

template <int kTH, int kM, int kCC, bool kAsync, bool kVec, int kMinBlocks,
          bool kStream, int kDG>
__global__ void __launch_bounds__(kGatherThreads, kMinBlocks)
window_variant_kernel(const float* __restrict__ planes, int c_n, int h, int w,
                      int d_n, const int* __restrict__ dy,
                      const int* __restrict__ dx, float* __restrict__ out) {
  using Win = GatherWindow<kTH, kM, kCC, kAsync>;
  extern __shared__ float4 win_raw[];  // [kBuffers][kCC][kArea]
  float* win = reinterpret_cast<float*>(win_raw);
  const int x0 = blockIdx.x * kGatherTileW, y0 = blockIdx.y * kTH;
  const int n = h * w;
  const int j = x0 + static_cast<int>(threadIdx.x) % kGatherTileW;
  const int i_first = y0 + static_cast<int>(threadIdx.x) / kGatherTileW;
  const int n_chunks = (c_n + kCC - 1) / kCC;
  for (int d0 = 0; d0 < d_n; d0 += kDG) {
    if (kAsync) {  // the first chunk in flight while the offsets load
      stage_variant<kTH, kM, kCC, kAsync, kVec>(win, planes, min(kCC, c_n),
                                                n, h, w, y0, x0);
      cp_async_commit();
    }
    const int dg = min(kDG, d_n - d0);
    int src[kDG][Win::kPerThread];
#pragma unroll
    for (int q = 0; q < Win::kPerThread; ++q) {
      const int i = i_first + q * Win::kRows;
      const bool in = i < h && j < w;
      const int p = i * w + j;
#pragma unroll
      for (int e = 0; e < kDG; ++e) {
        int s = 0;
        if (in && e < dg) {
          const long long o = static_cast<long long>(d0 + e) * n + p;
          const int sy = min(max(i + min(max(__ldg(dy + o), -h), h), 0), h - 1);
          const int sx = min(max(j + min(max(__ldg(dx + o), -w), w), 0), w - 1);
          const int wy = sy - y0 + kM, wx = sx - x0 + kM;
          s = (wy >= 0 && wy < Win::kWinH && wx >= 0 && wx < Win::kWinW)
                  ? wy * Win::kWinW + wx
                  : -1 - (sy * w + sx);
        }
        src[e][q] = s;
      }
    }
    for (int k = 0; k < n_chunks; ++k) {
      const int c0 = k * kCC, cc = min(kCC, c_n - c0);
      float* buf = win + (k % Win::kBuffers) * kCC * Win::kArea;
      if (kAsync) {
        if (k + 1 < n_chunks) {  // the next chunk into the other buffer
          stage_variant<kTH, kM, kCC, kAsync, kVec>(
              win + ((k + 1) % Win::kBuffers) * kCC * Win::kArea,
              planes + static_cast<long long>(c0 + kCC) * n,
              min(kCC, c_n - c0 - kCC), n, h, w, y0, x0);
          cp_async_commit();
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
      } else {
        __syncthreads();  // the previous chunk's reads are done
        stage_variant<kTH, kM, kCC, kAsync, kVec>(
            buf, planes + static_cast<long long>(c0) * n, cc, n, h, w, y0, x0);
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < kCC; ++c) {
        if (c >= cc) break;
        const float* __restrict__ wc = buf + c * Win::kArea;
        const float* __restrict__ gc = planes + static_cast<long long>(c0 + c) * n;
#pragma unroll
        for (int e = 0; e < kDG; ++e) {
          if (e >= dg) break;
          float* __restrict__ oc =
              out + (static_cast<long long>(d0 + e) * c_n + c0 + c) * n;
#pragma unroll
          for (int q = 0; q < Win::kPerThread; ++q) {
            const int i = i_first + q * Win::kRows;
            if (i >= h || j >= w) continue;
            const int s = src[e][q];
            const float v = s >= 0 ? wc[s] : __ldg(gc + (-1 - s));
            if (kStream)
              __stcs(oc + i * w + j, v);
            else
              oc[i * w + j] = v;
          }
        }
      }
      if (kAsync) __syncthreads();  // this buffer is staged again at k + 2
    }
  }
}

template <int kTH, int kM, int kCC, bool kAsync, bool kVec, int kMinBlocks,
          bool kStream, int kDG>
int launch_window_kernel(const float* planes, int c_n, int h, int w, int d_n,
                         const int* dy, const int* dx, float* out,
                         cudaStream_t stream) {
  using Win = GatherWindow<kTH, kM, kCC, kAsync>;
  auto kernel = window_variant_kernel<kTH, kM, kCC, kAsync, kVec, kMinBlocks,
                                      kStream, kDG>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Win::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((w + kGatherTileW - 1) / kGatherTileW, (h + kTH - 1) / kTH);
  kernel<<<grid, kGatherThreads, Win::kSmem, stream>>>(planes, c_n, h, w, d_n,
                                                       dy, dx, out);
  return static_cast<int>(cudaGetLastError());
}

// kVec where the rows allow 16-byte copies (kVecOk = false forces 4).
template <int kTH, int kM, int kCC, bool kAsync, bool kVecOk = true,
          int kMinBlocks = kGatherMinBlocks, bool kStream = true,
          int kDG = kGatherDGroup>
int launch_halo_window(const float* planes, int c_n, int h, int w, int d_n,
                       const int* dy, const int* dx, float* out,
                       cudaStream_t stream) {
  const bool vec = kVecOk && kAsync && kM % 4 == 0 && w % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(planes) % 16 == 0;
  return vec ? launch_window_kernel<kTH, kM, kCC, kAsync, kAsync && kVecOk,
                                    kMinBlocks, kStream, kDG>(
                   planes, c_n, h, w, d_n, dy, dx, out, stream)
             : launch_window_kernel<kTH, kM, kCC, kAsync, false, kMinBlocks,
                                    kStream, kDG>(planes, c_n, h, w, d_n, dy,
                                                  dx, out, stream);
}

__global__ void __launch_bounds__(kThreads)
records_kernel(const float* __restrict__ planes, int c_n, int c4, long long n,
               float4* __restrict__ recs) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n * c4) return;
  const long long p = idx / c4;
  const int g = static_cast<int>(idx - p * c4);
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int c = 4 * g + e;
    v[e] = c < c_n ? __ldg(planes + c * n + p) : 0.0f;
  }
  recs[idx] = make_float4(v[0], v[1], v[2], v[3]);
}

__global__ void __launch_bounds__(kThreads)
gather_records_kernel(const float4* __restrict__ recs, int c_n, int c4, int h,
                      int w, const int* __restrict__ dy,
                      const int* __restrict__ dx, long long n_out,
                      float* __restrict__ out) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n_out) return;
  const long long n = static_cast<long long>(h) * w;
  const long long di = idx / n, p = idx - di * n;
  const int i = static_cast<int>(p / w), j = static_cast<int>(p - static_cast<long long>(i) * w);
  const long long y = min(max(static_cast<long long>(i) + dy[idx], 0LL), static_cast<long long>(h - 1));
  const long long x = min(max(static_cast<long long>(j) + dx[idx], 0LL), static_cast<long long>(w - 1));
  const float4* r = recs + (y * w + x) * c4;
  float* ob = out + di * c_n * n + p;
  for (int g = 0; g < c4; ++g) {
    const float4 v = __ldg(r + g);
    const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (4 * g + k < c_n) ob[(4 * g + k) * n] = e[k];
  }
}

// ---- kernels 19 and 20 ----

// The two-box walk as one loop that tests a leaf where it meets it (this
// design's first loop): kOrder 0 the nearer child first (variant 9), 1 the
// left (variant 3), 2 the farther (variant 7).
template <int kOrder, class Tris>
__device__ __forceinline__ int walk_any_order(const float4* __restrict__ nodes,
                                             const float4* __restrict__ wide,
                                             const Tris& tris, float ox, float oy,
                                             float oz, float dx, float dy, float dz,
                                             float tm) {
  const float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
  const Node root = load_node(nodes, 0);
  if (!slab_hit(root, ox, oy, oz, ix, iy, iz, tm)) return 0;
  int ref = -root.leaf();
  int stack[kWalkStack];
  int sp = 0;
  while (true) {
    if (ref < 0) {
      const int first = (-ref) >> kLeafCountBits;
      const int count = (-ref) & ((1 << kLeafCountBits) - 1);
      for (int j = 0; j < count; ++j) {
        float t, u, v;
        if (mt_tri(ox, oy, oz, dx, dy, dz, tris(first + j), t, u, v) && t < tm)
          return 1;
      }
    } else {
      const float4* rec = wide + 4 * ref;
      const float4 x = __ldg(rec), y = __ldg(rec + 1), z = __ldg(rec + 2);
      const int4 kids = __ldg(reinterpret_cast<const int4*>(rec + 3));
      float tnl, tfl, tnr, tfr;
      slabs(x.x, x.y, y.x, y.y, z.x, z.y, ox, oy, oz, ix, iy, iz, tnl, tfl);
      slabs(x.z, x.w, y.z, y.w, z.z, z.w, ox, oy, oz, ix, iy, iz, tnr, tfr);
      const bool gl = tnl <= tfl && tfl >= 0.0f && tnl <= tm;
      const bool gr = tnr <= tfr && tfr >= 0.0f && tnr <= tm;
      if (gl || gr) {
        const bool left = kOrder == 0   ? gl && (!gr || tnl <= tnr)
                          : kOrder == 2 ? gl && (!gr || tnl > tnr)
                                        : gl;
        if (gl && gr) {
          if (sp == kWalkStack) return -1;
          stack[sp++] = left ? kids.y : kids.x;
        }
        ref = left ? kids.x : kids.y;
        continue;
      }
    }
    if (sp == 0) return 0;
    ref = stack[--sp];
  }
}

// The package's walk_any_wide taking the nearer child first (variant 8).
constexpr int kDone = kWalkDone;

template <bool kNearer, class Tris>
__device__ __forceinline__ int walk_any_ww(const float4* __restrict__ nodes,
                                           const float4* __restrict__ wide,
                                           const Tris& tris, float ox, float oy,
                                           float oz, float dx, float dy, float dz,
                                           float tm) {
  const float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
  const Node root = load_node(nodes, 0);
  if (!slab_hit(root, ox, oy, oz, ix, iy, iz, tm)) return 0;
  int ref = -root.leaf();  // >= 0 an inner node, < 0 a leaf, kDone the end
  int leaf = 0;            // a leaf put aside (its word negated), 0 none
  if (ref < 0) {           // the root is a leaf
    leaf = ref;
    ref = kDone;
  }
  int stack[kWalkStack];
  int sp = 0;
  while (ref != kDone || leaf != 0) {
    while (ref >= 0) {  // inner nodes
      const float4* rec = wide + 4 * ref;
      const float4 x = __ldg(rec), y = __ldg(rec + 1), z = __ldg(rec + 2);
      const int4 kids = __ldg(reinterpret_cast<const int4*>(rec + 3));
      float tnl, tfl, tnr, tfr;
      slabs(x.x, x.y, y.x, y.y, z.x, z.y, ox, oy, oz, ix, iy, iz, tnl, tfl);
      slabs(x.z, x.w, y.z, y.w, z.z, z.w, ox, oy, oz, ix, iy, iz, tnr, tfr);
      const bool gl = tnl <= tfl && tfl >= 0.0f && tnl <= tm;
      const bool gr = tnr <= tfr && tfr >= 0.0f && tnr <= tm;
      if (gl || gr) {
        const bool left = kNearer ? gl && (!gr || tnl <= tnr) : gl;
        if (gl && gr) {
          if (sp == kWalkStack) return -1;
          stack[sp++] = left ? kids.y : kids.x;
        }
        ref = left ? kids.x : kids.y;
      } else {
        ref = sp > 0 ? stack[--sp] : kDone;
      }
      if (ref < 0 && ref != kDone && leaf == 0) {  // put the leaf aside
        leaf = ref;
        ref = sp > 0 ? stack[--sp] : kDone;
      }
      if (!__any_sync(__activemask(), leaf == 0)) break;
    }
    while (leaf != 0) {  // the leaves put aside, then the current one
      const int first = (-leaf) >> kLeafCountBits;
      const int count = (-leaf) & ((1 << kLeafCountBits) - 1);
      for (int j = 0; j < count; ++j) {
        float t, u, v;
        if (mt_tri(ox, oy, oz, dx, dy, dz, tris(first + j), t, u, v) && t < tm)
          return 1;
      }
      leaf = 0;
      if (ref < 0 && ref != kDone) {
        leaf = ref;
        ref = sp > 0 ? stack[--sp] : kDone;
      }
    }
  }
  return 0;
}

template <int kVariant>
__device__ __forceinline__ bool any_one(const float4* __restrict__ nodes,
                                        const float4* __restrict__ wide,
                                        const float4* __restrict__ recs,
                                        const float* __restrict__ cols, int n_tris,
                                        float ox, float oy, float oz, float dx,
                                        float dy, float dz, float tm) {
  if (kVariant == 4) return walk_any(nodes, RecTris{recs}, ox, oy, oz, dx, dy, dz, tm);
  if (kVariant == 5)
    return walk_any(nodes, ColTris{cols, n_tris}, ox, oy, oz, dx, dy, dz, tm);
  int occ;
  if (kVariant == 8)
    occ = walk_any_ww<true>(nodes, wide, RecTris{recs}, ox, oy, oz, dx, dy, dz, tm);
  else if (kVariant == 3 || kVariant == 7 || kVariant == 9)
    occ = walk_any_order<kVariant == 9 ? 0 : kVariant == 3 ? 1 : 2>(
        nodes, wide, RecTris{recs}, ox, oy, oz, dx, dy, dz, tm);
  else if (kVariant == 6)
    occ = walk_any_wide(nodes, wide, ColTris{cols, n_tris}, ox, oy, oz, dx, dy,
                        dz, tm);
  else
    occ = walk_any_wide(nodes, wide, RecTris{recs}, ox, oy, oz, dx, dy, dz, tm);
  if (occ < 0) return walk_any(nodes, RecTris{recs}, ox, oy, oz, dx, dy, dz, tm);
  return occ != 0;
}

template <int kMinBlocks, bool kTiles, int kVariant>
__global__ void __launch_bounds__(128, kMinBlocks)
any_variant_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ t_max, int h, int w, int s_n,
                   const float4* __restrict__ nodes, const float4* __restrict__ wide,
                   const float4* __restrict__ recs, const float* __restrict__ cols,
                   int n_tris, unsigned char* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long n_pix = static_cast<long long>(h) * w;
  const long long per_plane = kTiles ? tiled_rays(h, w) : n_pix;
  const long long si = i / per_plane;
  if (si >= s_n) return;
  const long long r = i - si * per_plane;
  const long long p = kTiles ? tile_pixel(r, h, w) : r;
  if (p < 0) return;
  const long long base = si * 3 * n_pix + p;
  out[si * n_pix + p] =
      any_one<kVariant>(nodes, wide, recs, cols, n_tris, o[base], o[base + n_pix],
                        o[base + 2 * n_pix], d[base], d[base + n_pix],
                        d[base + 2 * n_pix], t_max[si * n_pix + p])
          ? 1 : 0;
}

template <int kMinBlocks, bool kTiles, int kVariant>
int launch_any(const float* o, const float* d, const float* t_max, int h, int w,
               int s, const float* nodes, const float* wide, const float* recs,
               const float* cols, int n_tris, unsigned char* out,
               cudaStream_t stream) {
  const long long per_plane =
      kTiles ? tiled_rays(h, w) : static_cast<long long>(h) * w;
  any_variant_kernel<kMinBlocks, kTiles, kVariant>
      <<<static_cast<int>((per_plane * s + 127) / 128), 128, 0, stream>>>(
          o, d, t_max, h, w, s, reinterpret_cast<const float4*>(nodes),
          reinterpret_cast<const float4*>(wide),
          reinterpret_cast<const float4*>(recs), cols, n_tris, out);
  return static_cast<int>(cudaGetLastError());
}

// Kernel 20's layout (ray p * S + s of the launch is ray s of pixel p) on
// the package's kernel 19 walk.
__global__ void __launch_bounds__(128, kAnyMinBlocks)
any_k_wide_kernel(const float* __restrict__ o, const float* __restrict__ d,
                  const float* __restrict__ t_max, long long n_pix, int s_n,
                  const float4* __restrict__ nodes, const float4* __restrict__ wide,
                  const float4* __restrict__ recs, unsigned char* __restrict__ out) {
  const long long r = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= n_pix * s_n) return;
  const long long p = r / s_n;
  const long long s = r - p * s_n;
  const long long base = s * 3 * n_pix + p;
  const float ox = o[base], oy = o[base + n_pix], oz = o[base + 2 * n_pix];
  const float dx = d[base], dy = d[base + n_pix], dz = d[base + 2 * n_pix];
  const float tm = t_max[s * n_pix + p];
  int occ = walk_any_wide(nodes, wide, RecTris{recs}, ox, oy, oz, dx, dy, dz, tm);
  if (occ < 0) occ = walk_any(nodes, RecTris{recs}, ox, oy, oz, dx, dy, dz, tm) ? 1 : 0;
  out[s * n_pix + p] = static_cast<unsigned char>(occ);
}

}  // namespace micro

extern "C" int micro_halo(int variant, const float* planes, int c_n, int h, int w,
                          int d_n, const int* dy, const int* dx, float* out,
                          float* scratch, cudaStream_t stream) {
  using namespace micro;
  const long long n = static_cast<long long>(h) * w;
  switch (variant) {
    case 0:
      halo_gather_kernel<<<blocks_for(n * d_n), kThreads, 0, stream>>>(
          planes, c_n, h, w, dy, dx, n * d_n, out);
      return static_cast<int>(cudaGetLastError());
#define MICRO_WINDOW(TH, M, CC, ASYNC, VEC, ...) \
  launch_halo_window<TH, M, CC, ASYNC, VEC, ##__VA_ARGS__>(planes, c_n, h, w, d_n, dy, dx, \
                                                         out, stream)
    case 1: return MICRO_WINDOW(32, 16, 4, false, false, 2, true, 8);
    case 2: return MICRO_WINDOW(32, 16, 2, true, true, 2, true, 8);
    case 3: return MICRO_WINDOW(32, 16, 4, true, true, 2, true, 8);
    case 4: return MICRO_WINDOW(32, 12, 2, true, true, 2, true, 8);
    case 5: return MICRO_WINDOW(16, 16, 2, true, true, 2, true, 8);
    case 7: return MICRO_WINDOW(32, 16, 2, true, false, 2, true, 8);
    case 8: return MICRO_WINDOW(32, 16, 1, true, true, 2, true, 8);
    case 9: return MICRO_WINDOW(32, 16, 2, true, true, 3, true, 8);
    case 10: return MICRO_WINDOW(32, 16, 1, true, true, 4, false);
    case 11: return MICRO_WINDOW(32, 12, 2, true, true, 4, true, 5);
    case 12: return MICRO_WINDOW(32, 16, 2, true, true, 3, true, 5);
    case 13: return MICRO_WINDOW(32, 16, 1, true, true, 5, true, 5);
    case 14: return MICRO_WINDOW(32, 16, 1, true, true, 4, true, 8);
    case 15: return MICRO_WINDOW(32, 16, 1, true, true);
#undef MICRO_WINDOW
    case 6: {
      const int c4 = (c_n + 3) / 4;
      records_kernel<<<blocks_for(n * c4), kThreads, 0, stream>>>(
          planes, c_n, c4, n, reinterpret_cast<float4*>(scratch));
      gather_records_kernel<<<blocks_for(n * d_n), kThreads, 0, stream>>>(
          reinterpret_cast<const float4*>(scratch), c_n, c4, h, w, dy, dx,
          n * d_n, out);
      return static_cast<int>(cudaGetLastError());
    }
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int micro_any(int variant, const float* o, const float* d,
                         const float* t_max, int h, int w, int s, const float* nodes,
                         const float* wide, const float* recs, const float* cols,
                         int n_tris, unsigned char* out, cudaStream_t stream) {
  using namespace micro;
#define MICRO_ANY(MIN, TILES, V) \
  launch_any<MIN, TILES, V>(o, d, t_max, h, w, s, nodes, wide, recs, cols, n_tris, \
                            out, stream)
  switch (variant) {
    case 1: return MICRO_ANY(1, true, 1);
    case 2: return MICRO_ANY(kAnyMinBlocks, false, 1);
    case 3: return MICRO_ANY(kAnyMinBlocks, true, 3);
    case 4: return MICRO_ANY(kAnyMinBlocks, true, 4);
    case 5: return MICRO_ANY(1, false, 5);
    case 6: return MICRO_ANY(kAnyMinBlocks, true, 6);
    case 7: return MICRO_ANY(kAnyMinBlocks, true, 7);
    case 8: return MICRO_ANY(kAnyMinBlocks, true, 8);
    case 9: return MICRO_ANY(kAnyMinBlocks, true, 9);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MICRO_ANY
}

extern "C" int micro_any_k(const float* o, const float* d, const float* t_max,
                           long long n_pix, int s, const float* nodes,
                           const float* wide, const float* recs, unsigned char* out,
                           cudaStream_t stream) {
  using namespace micro;
  any_k_wide_kernel<<<static_cast<int>((n_pix * s + 127) / 128), 128, 0, stream>>>(
      o, d, t_max, n_pix, s, reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const float4*>(wide), reinterpret_cast<const float4*>(recs),
      out);
  return static_cast<int>(cudaGetLastError());
}
