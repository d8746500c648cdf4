// Kernel 9: exact-offset halo gather,
// out[d, c, i, j] = planes[c, clamp(i + dy[d, i, j]), clamp(j + dx[d, i, j])],
// and kernel 10, its transpose (the gather's backward): the scatter-add
// out[c, clamp(i + dy), clamp(j + dx)] += ct[d, c, i, j].
//
// Kernel 9 replaces romis_tpu/ops/pallas_spatial.py
// halo_offset_gather_pallas / _offset_gather_kernel. The TPU kernel DMAs a
// ±radius halo window per tile and resolves rows and lanes with rolls and
// windowed lane gathers, which limits radius to 64 lanes. Here the offset
// is any integer and the indices are clamped into the image (the
// reference's border clamp, render_utils.cpp:109-110), so no offset can
// read out of bounds. The copy is exact (loads and stores of 32-bit
// patterns: infinities, NaNs and signed zeros pass unchanged).
//
// Bound: device-memory bandwidth, (C + D·C + 2D) x 4 B a pixel (each plane
// read once, each output written once, the offsets read once); at D = 5
// the D·C outputs are most of it.
//
// What held the first design back (a thread per (d, pixel) reading its
// source pixel's C planes from device memory): at random per-pixel
// offsets the 32 lanes of a warp touch up to 32 different 32-byte sectors
// of each plane, and nothing shares the window that the D fields of a
// tile draw from: a 32-byte sector from L2 for each 4-byte output (12.9 GB
// at D = 5, C = 39, 1080p: 2.41 ms against a 0.60-ms bound).
// The design (D >= 2): a block owns a kGatherTileH x kGatherTileW tile of
// OUTPUT pixels. Each thread reads its pixels' D offset pairs once and
// resolves each source: its cell in the tile's window (the tile
// +- kGatherMargin in both directions) or, beyond it, its pixel in device
// memory ("far": camera shifts beyond the margin, offsets clamped from far
// outside the image), so any integer offset stays exact and the kernel
// needs no host sync and no largest offset from the host. The block then
// loops over the channels, one a stage: it stages the channel's window
// into shared memory (only the cells inside the image: a clamped source
// always lies there), and each thread copies its D outputs a pixel from
// the window (a far source from device memory), a warp writing a row of
// 32 pixels of out[d, c] with streaming stores. Each plane is read from
// device memory about once (neighbouring windows overlap in L2) and each
// output written once, coalesced. The stages go by cp.async, 16 bytes a
// copy where the rows allow, double-buffered: the next channel is in
// flight while this one is copied out, and the first while the offsets
// load. Staged by loads and stores in turn with the copies out, the
// window was slower than the first design (one load in flight a thread at
// 2 blocks an SM); by cp.async it takes 0.91 ms at D = 5, C = 39
// (PERF.md). One channel a stage (32 KB of shared memory a block,
// double-buffered) and the D offset pairs resolved in groups of
// kGatherDGroup = 5, the frames' D (20 registers of sources), let
// kGatherMinBlocks = 4 blocks share an SM at 64 registers; D beyond a
// group stages the windows again for the next group. The variants that
// lost (more channels a stage, staging in turns, 4-byte copies, plain
// stores, other tiles, margins and occupancies) are in
// scripts/torch_halo_anywalk_micro.cu.
//
// D = 1 (temporal reprojection: one smooth camera-shift field) keeps the
// first design: neighbouring threads read neighbouring source pixels, so
// its loads coalesce, and a window staged for one output would be read
// about once (kGatherTileH + 2 kGatherMargin)(kGatherTileW + 2
// kGatherMargin) / (kGatherTileH kGatherTileW) = 4 cells an output.
//
// Kernel 10 replaces romis_tpu/ops/pallas_spatial.py
// halo_offset_scatter_pallas / _offset_scatter_kernel, which decomposes the
// transpose into (2r+1)^2 masked shifts per tile (radius <= 64) because a
// TPU core has no scatter. It is the gather's backward,
// out[c, clamp(i + dy), clamp(j + dx)] += ct[d, c, i, j], for offsets that
// may be any integer.
//
// What bounds it on the H100: the bytes are (C + 2) x 4 B read per input
// pixel and C x 4 B written per output pixel (0.054 ms at D = 5, C = 2,
// 1080p), but a thread per input pixel issuing C float atomics into device
// memory (as index_add_ does) waits on the L2's atomic units instead:
// D·C·H·W atomics onto C·H·W addresses, a warp's 32 of them on ~32 lines.
//
// The design keeps those atomics out of device memory. A block owns a
// kTileH x kTileW tile of SOURCE pixels and up to kChanChunk channels,
// and accumulates into a shared-memory window, the tile +- kMargin in both
// directions: each thread loads the offsets and cotangents of its sources
// of one d together (no load waits on another), and adds every source whose
// clamped target lies within kMargin of it ("near") to the window with a
// shared-memory atomic. The window is then added to `out` once, coalesced
// along W, skipping its zero cells. A source whose clamped target lies
// beyond kMargin ("far": large camera shifts, offsets clamped from far
// outside the image) is added straight to its target with a device-memory
// atomic; the kernel finds these sources from the offsets it reads and
// never asks the host for the largest offset. Neighbouring windows overlap,
// so the flush and the far adds are both atomic adds onto the zero-filled
// `out` (red.global): they commute, and no order between blocks is needed.
// Zero cotangents are skipped (adding +-0 to the zero-filled sum changes no
// bit). The sum's order, and its last bits, vary from run to run.
//
// The alternative the TPU layout suggests, a block owning an OUTPUT tile
// and scanning its source window for the sources that land in it, reads
// each source's offsets (1 + 2 kMargin / tile)^2 times and can load a
// cotangent only after its offsets said where it lands; measured against
// this design in one call it was slower than index_add_ (PERF.md).
#include "common.cuh"

namespace romis {

// D = 1: a thread per pixel.
__global__ void __launch_bounds__(kThreads)
halo_gather_kernel(const float* __restrict__ planes, int c_n, int h, int w,
                   const int* __restrict__ dy, const int* __restrict__ dx,
                   long long n_out, float* __restrict__ out) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n_out) return;
  const long long n = static_cast<long long>(h) * w;
  const long long di = idx / n, p = idx - di * n;
  const int i = static_cast<int>(p / w), j = static_cast<int>(p - static_cast<long long>(i) * w);
  const long long y = min(max(static_cast<long long>(i) + dy[idx], 0LL), static_cast<long long>(h - 1));
  const long long x = min(max(static_cast<long long>(j) + dx[idx], 0LL), static_cast<long long>(w - 1));
  const long long q = y * w + x;
  float* ob = out + di * c_n * n + p;
  for (int c = 0; c < c_n; ++c) ob[c * n] = __ldg(planes + c * n + q);
}

// D >= 2: a block a tile of output pixels, the channels' windows staged in
// shared memory one channel a stage. kGatherTileW is a warp's width, so a
// warp owns a row of the tile and writes 128 contiguous bytes of out[d, c].
constexpr int kGatherThreads = 256;
constexpr int kGatherTileH = 32, kGatherTileW = 32;  // output tile (pixels)
constexpr int kGatherMargin = 16;  // ops/spatial.HALO_GATHER_MARGIN
constexpr int kGatherDGroup = 5;   // offset fields resolved at once (R = 5)
constexpr int kGatherMinBlocks = 4;  // blocks an SM (64 registers)
constexpr int kGatherWinH = kGatherTileH + 2 * kGatherMargin;
constexpr int kGatherWinW = kGatherTileW + 2 * kGatherMargin;
constexpr int kGatherArea = kGatherWinH * kGatherWinW;  // a stage's cells
constexpr int kGatherRows = kGatherThreads / kGatherTileW;  // a pass's rows
constexpr int kGatherPerThread = kGatherTileH * kGatherTileW / kGatherThreads;
constexpr size_t kGatherSmem = sizeof(float) * 2 * kGatherArea;  // 2 stages
static_assert(kGatherTileW == 32 && kGatherTileH % kGatherRows == 0,
              "a warp a row of the tile");
static_assert(kGatherMargin % 4 == 0 && kGatherArea % 4 == 0,
              "16-byte aligned stages");

// cp.async (sm_80 and later): a copy from device memory into shared memory
// that holds no register and is waited for only at cp_async_wait, so a
// thread keeps all its copies of a stage in flight at once.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Stage one channel's window into dst [kGatherArea]: the cells inside the
// image (a clamped source always lies there), by cp.async, 16 bytes a copy
// where kVec (rows 16-byte aligned: W % 4 == 0, the planes 16-byte
// aligned), else 4.
template <bool kVec>
__device__ __forceinline__ void stage_window(float* dst,
                                             const float* __restrict__ pc,
                                             int h, int w, int y0, int x0) {
  if (kVec) {
    constexpr int kQuads = kGatherWinW / 4, kCells = kGatherWinH * kQuads;
#pragma unroll 4
    for (int e = threadIdx.x; e < kCells; e += kGatherThreads) {
      const int wy = e / kQuads, wx = 4 * (e - wy * kQuads);
      const int gy = y0 - kGatherMargin + wy, gx = x0 - kGatherMargin + wx;
      if (gy >= 0 && gy < h && gx >= 0 && gx < w)
        cp_async16(dst + wy * kGatherWinW + wx, pc + gy * w + gx);
    }
  } else {
#pragma unroll 4
    for (int e = threadIdx.x; e < kGatherArea; e += kGatherThreads) {
      const int gy = y0 - kGatherMargin + e / kGatherWinW;
      const int gx = x0 - kGatherMargin + e % kGatherWinW;
      if (gy >= 0 && gy < h && gx >= 0 && gx < w)
        cp_async4(dst + e, pc + gy * w + gx);
    }
  }
}

// grid (ceil(W / kGatherTileW), ceil(H / kGatherTileH)); H * W < 2^31 (the
// wrapper checks), so in-plane indices are 32-bit and the plane bases
// 64-bit. A far source is held as -1 - its pixel index, a window source as
// its cell (>= 0). The stages are double-buffered: channel c + 1 is in
// flight while channel c is copied out.
template <bool kVec>
__global__ void __launch_bounds__(kGatherThreads, kGatherMinBlocks)
halo_gather_window_kernel(const float* __restrict__ planes, int c_n, int h,
                          int w, int d_n, const int* __restrict__ dy,
                          const int* __restrict__ dx,
                          float* __restrict__ out) {
  extern __shared__ float4 win_raw[];  // [2][kGatherArea]
  float* win = reinterpret_cast<float*>(win_raw);
  const int x0 = blockIdx.x * kGatherTileW, y0 = blockIdx.y * kGatherTileH;
  const int n = h * w;
  const int j = x0 + static_cast<int>(threadIdx.x) % kGatherTileW;
  const int i_first = y0 + static_cast<int>(threadIdx.x) / kGatherTileW;
  for (int d0 = 0; d0 < d_n; d0 += kGatherDGroup) {
    // the first channel in flight while the offsets load
    stage_window<kVec>(win, planes, h, w, y0, x0);
    cp_async_commit();
    const int dg = min(kGatherDGroup, d_n - d0);
    int src[kGatherDGroup][kGatherPerThread];
#pragma unroll
    for (int q = 0; q < kGatherPerThread; ++q) {
      const int i = i_first + q * kGatherRows;
      const bool in = i < h && j < w;
      const int p = i * w + j;
#pragma unroll
      for (int e = 0; e < kGatherDGroup; ++e) {
        int s = 0;
        if (in && e < dg) {
          const long long o = static_cast<long long>(d0 + e) * n + p;
          // An offset beyond the image clamps like one at its edge, and
          // cannot overflow i + offset once cut to [-h, h].
          const int sy = min(max(i + min(max(__ldg(dy + o), -h), h), 0), h - 1);
          const int sx = min(max(j + min(max(__ldg(dx + o), -w), w), 0), w - 1);
          const int wy = sy - y0 + kGatherMargin, wx = sx - x0 + kGatherMargin;
          s = (wy >= 0 && wy < kGatherWinH && wx >= 0 && wx < kGatherWinW)
                  ? wy * kGatherWinW + wx
                  : -1 - (sy * w + sx);
        }
        src[e][q] = s;
      }
    }
    for (int c = 0; c < c_n; ++c) {
      const float* __restrict__ wc = win + (c & 1) * kGatherArea;
      if (c + 1 < c_n) {  // the next channel into the other buffer
        stage_window<kVec>(win + ((c + 1) & 1) * kGatherArea,
                           planes + static_cast<long long>(c + 1) * n, h, w,
                           y0, x0);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* __restrict__ gc = planes + static_cast<long long>(c) * n;
#pragma unroll
      for (int e = 0; e < kGatherDGroup; ++e) {
        if (e >= dg) break;
        float* __restrict__ oc =
            out + (static_cast<long long>(d0 + e) * c_n + c) * n;
#pragma unroll
        for (int q = 0; q < kGatherPerThread; ++q) {
          const int i = i_first + q * kGatherRows;
          if (i >= h || j >= w) continue;
          const int s = src[e][q];
          __stcs(oc + i * w + j, s >= 0 ? wc[s] : __ldg(gc + (-1 - s)));
        }
      }
      __syncthreads();  // this buffer is staged again at c + 2
    }
  }
}

template <bool kVec>
int launch_gather_window(const float* planes, int c_n, int h, int w, int d_n,
                         const int* dy, const int* dx, float* out,
                         cudaStream_t stream) {
  auto kernel = halo_gather_window_kernel<kVec>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kGatherSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((w + kGatherTileW - 1) / kGatherTileW,
                  (h + kGatherTileH - 1) / kGatherTileH);
  kernel<<<grid, kGatherThreads, kGatherSmem, stream>>>(planes, c_n, h, w, d_n,
                                                        dy, dx, out);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kTileH = 16, kTileW = 32;  // source tile (pixels)
constexpr int kMargin = 16;  // ops/spatial.HALO_SCATTER_MARGIN
constexpr int kWinH = kTileH + 2 * kMargin, kWinW = kTileW + 2 * kMargin;
constexpr int kChanChunk = 2;  // channels a block accumulates at once
constexpr int kScatterThreads = 256;
constexpr int kPerThread = kTileH * kTileW / kScatterThreads;

// grid (ceil(W / kTileW), ceil(H / kTileH), ceil(C / kChanChunk)); H * W
// < 2^31 (the wrapper checks), so in-plane indices are 32-bit and only the
// plane bases are 64-bit: few registers, many blocks an SM.
__global__ void __launch_bounds__(kScatterThreads)
halo_scatter_kernel(const float* __restrict__ ct, int d_n, int c_n, int h,
                    int w, const int* __restrict__ dy,
                    const int* __restrict__ dx, float* __restrict__ out) {
  __shared__ float acc[kChanChunk][kWinH * kWinW];
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int c0 = blockIdx.z * kChanChunk;
  const int cc = min(kChanChunk, c_n - c0);
  const int n = h * w;
  float* __restrict__ outc = out + static_cast<long long>(c0) * n;
  for (int e = threadIdx.x; e < kChanChunk * kWinH * kWinW; e += kScatterThreads)
    acc[e / (kWinH * kWinW)][e % (kWinH * kWinW)] = 0.0f;
  __syncthreads();
  for (int di = 0; di < d_n; ++di) {
    const int* __restrict__ dyd = dy + static_cast<long long>(di) * n;
    const int* __restrict__ dxd = dx + static_cast<long long>(di) * n;
    const float* __restrict__ ctd = ct + (static_cast<long long>(di) * c_n + c0) * n;
    int oy[kPerThread], ox[kPerThread];
    float v[kPerThread][kChanChunk];
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {  // every load of this d first
      const int e = threadIdx.x + q * kScatterThreads;
      const int i = y0 + e / kTileW, j = x0 + e % kTileW;
      const bool in = i < h && j < w;
      const int p = i * w + j;
      oy[q] = in ? __ldg(dyd + p) : 0;
      ox[q] = in ? __ldg(dxd + p) : 0;
#pragma unroll
      for (int c = 0; c < kChanChunk; ++c)
        v[q][c] = in && c < cc ? __ldg(ctd + static_cast<long long>(c) * n + p) : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const int e = threadIdx.x + q * kScatterThreads;
      const int i = y0 + e / kTileW, j = x0 + e % kTileW;
      if (i >= h || j >= w) continue;
      // An offset beyond the image clamps like one at its edge, and cannot
      // overflow i + offset once cut to [-h, h].
      const int ty = min(max(i + min(max(oy[q], -h), h), 0), h - 1);
      const int tx = min(max(j + min(max(ox[q], -w), w), 0), w - 1);
      const bool near = abs(ty - i) <= kMargin && abs(tx - j) <= kMargin;
      const int a = (ty - y0 + kMargin) * kWinW + (tx - x0 + kMargin);
      const int t = ty * w + tx;
#pragma unroll
      for (int c = 0; c < kChanChunk; ++c) {
        if (v[q][c] == 0.0f) continue;  // also the channels past cc
        if (near) atomicAdd(&acc[c][a], v[q][c]);
        else atomicAdd(outc + static_cast<long long>(c) * n + t, v[q][c]);
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < cc * kWinH * kWinW; e += kScatterThreads) {
    const int c = e / (kWinH * kWinW), a = e % (kWinH * kWinW);
    const int i = y0 - kMargin + a / kWinW, j = x0 - kMargin + a % kWinW;
    const float val = acc[c][a];
    if (i >= 0 && i < h && j >= 0 && j < w && val != 0.0f)
      atomicAdd(outc + static_cast<long long>(c) * n + i * w + j, val);
  }
}

}  // namespace romis

extern "C" int romis_halo_gather(const float* planes, int c_n, int h, int w,
                                 int d_n, const int* dy, const int* dx,
                                 float* out, cudaStream_t stream) {
  using namespace romis;
  if (d_n == 1) {
    const long long n_out = static_cast<long long>(h) * w;
    halo_gather_kernel<<<blocks_for(n_out), kThreads, 0, stream>>>(
        planes, c_n, h, w, dy, dx, n_out, out);
    return static_cast<int>(cudaGetLastError());
  }
  const bool vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(planes) % 16 == 0;
  return vec ? launch_gather_window<true>(planes, c_n, h, w, d_n, dy, dx, out,
                                          stream)
             : launch_gather_window<false>(planes, c_n, h, w, d_n, dy, dx, out,
                                           stream);
}

extern "C" int romis_halo_scatter(const float* ct, int d_n, int c_n, int h,
                                  int w, const int* dy, const int* dx,
                                  float* out, cudaStream_t stream) {
  using namespace romis;
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH,
                  (c_n + kChanChunk - 1) / kChanChunk);
  halo_scatter_kernel<<<grid, kScatterThreads, 0, stream>>>(ct, d_n, c_n, h, w,
                                                            dy, dx, out);
  return static_cast<int>(cudaGetLastError());
}
