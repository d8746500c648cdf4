// Kernel 9: exact-offset halo gather,
// out[d, c, i, j] = planes[c, clamp(i + dy[d, i, j]), clamp(j + dx[d, i, j])],
// and kernel 10, its transpose (the gather's backward): the scatter-add
// out[c, clamp(i + dy), clamp(j + dx)] += ct[d, c, i, j].
//
// Replaces romis_tpu/ops/pallas_spatial.py halo_offset_gather_pallas /
// _offset_gather_kernel. The TPU kernel DMAs a ±radius halo window per tile
// and resolves rows and lanes with rolls and windowed lane gathers, which
// limits radius to 64 lanes. Here one thread per (d, pixel) reads its
// source pixel's C planes directly; the offset is any integer and the
// indices are clamped into the image (the reference's border clamp,
// render_utils.cpp:109-110), so no offset can read out of bounds. The copy
// is exact.
//
// Bound: device-memory bandwidth, (C + 2) x 4 B per output pixel. For the
// smooth fields of temporal reprojection neighbouring threads read
// neighbouring source pixels, so the loads coalesce; random fields within a
// small radius are served mostly from L1/L2.
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
                                 const int* dy, const int* dx, long long n_out,
                                 float* out, cudaStream_t stream) {
  romis::halo_gather_kernel<<<romis::blocks_for(n_out), romis::kThreads, 0, stream>>>(
      planes, c_n, h, w, dy, dx, n_out, out);
  return static_cast<int>(cudaGetLastError());
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
