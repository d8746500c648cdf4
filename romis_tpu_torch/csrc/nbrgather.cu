// Kernel 12: the neighbour gather with offsets drawn in the kernel,
// out[n, c, i, j] = planes[c, clamp(i + dy[n, i, j]), clamp(j + dx[n, i, j])]
// for R neighbours n, each offset uniform on [-radius, radius]^2.
//
// Replaces romis_tpu/ops/pallas_spatial.py spatial_neighbour_gather_pallas
// / _gather_kernel. The TPU kernel DMAs a halo window per 32 x 128 tile and
// resolves offsets with lane gathers inside one 128-lane vreg, so it shares
// dx down each column and takes radius <= 64; its edge padding is the
// reference's border clamp (render_utils.cpp:109-110). Here dy and dx are
// drawn per pixel (as kernel 9's callers and the XLA path draw them), the
// source pixel is clamped into the image, so any radius reads in bounds, and
// the same offset serves every plane.
//
// Random numbers: the injected offsets [2, R, N] (the plain version's
// draws, ops/spatial.spatial_noise), or Philox4x32-10 keyed by a 64-bit key
// read from device memory, counter (n, pixel, tag) with tag = 0x5352 in the
// high half and the pass index in the low half (disjoint from RIS's tag 0
// and the passes' 0x5350 / 0x5351): x gives dy, y gives dx
// (offset_from). ops/spatial.neighbour_offsets draws the same offsets in
// PyTorch.
//
// One thread per pixel on 32 x 8 blocks: it draws its neighbours' offsets
// once (up to 8 source pixels held in registers at a time) and then copies
// plane by plane, every neighbour's value of a plane before the next plane,
// so the writes are coalesced along W and a block's ±radius reads at any
// moment fall in one plane's (8 + 2r) x (32 + 2r) window, which stays in
// L1 (neighbour by neighbour, all C planes' windows are live at once and
// the reads go to L2). Bound: device-memory bandwidth, C planes read once
// and R·C planes written (and 2R offset planes read when injected).
#include "common.cuh"

namespace romis {

constexpr int kGatherX = 32, kGatherY = 8;
constexpr int kNbrChunk = 8;  // neighbours whose source pixels a thread holds

__global__ void __launch_bounds__(kGatherX * kGatherY)
neighbour_gather_kernel(const float* __restrict__ planes, int c_n, int h, int w,
                        int n_nbr, int radius, const int* __restrict__ offs,
                        const long long* __restrict__ key, uint32_t tag,
                        float* __restrict__ out) {
  const int x = blockIdx.x * kGatherX + threadIdx.x;
  const int y = blockIdx.y * kGatherY + threadIdx.y;
  if (x >= w || y >= h) return;
  const long long n = static_cast<long long>(h) * w;
  const long long p = static_cast<long long>(y) * w + x;
  uint32_t k0 = 0, k1 = 0;
  if (offs == nullptr) {
    const unsigned long long kk = static_cast<unsigned long long>(key[0]);
    k0 = static_cast<uint32_t>(kk);
    k1 = static_cast<uint32_t>(kk >> 32);
  }
  for (int nb0 = 0; nb0 < n_nbr; nb0 += kNbrChunk) {
    const int cnt = min(kNbrChunk, n_nbr - nb0);
    long long src[kNbrChunk];
#pragma unroll
    for (int j = 0; j < kNbrChunk; ++j) {
      if (j >= cnt) break;
      const int nb = nb0 + j;
      long long dy, dx;
      if (offs != nullptr) {
        dy = offs[static_cast<long long>(nb) * n + p];
        dx = offs[static_cast<long long>(n_nbr + nb) * n + p];
      } else {
        const U4 b = philox4x32_10(U4{static_cast<uint32_t>(nb), static_cast<uint32_t>(p),
                                      static_cast<uint32_t>(p >> 32), tag}, k0, k1);
        dy = offset_from(b.x, radius);
        dx = offset_from(b.y, radius);
      }
      const long long sy = min(max(y + dy, 0LL), static_cast<long long>(h - 1));
      const long long sx = min(max(x + dx, 0LL), static_cast<long long>(w - 1));
      src[j] = sy * w + sx;
    }
    // Plane by plane, so that a block's reads stay in one plane's window.
    float* dst = out + static_cast<long long>(nb0) * c_n * n + p;
    for (int c = 0; c < c_n; ++c) {
#pragma unroll
      for (int j = 0; j < kNbrChunk; ++j) {
        if (j >= cnt) break;
        dst[(static_cast<long long>(j) * c_n + c) * n] = __ldg(planes + c * n + src[j]);
      }
    }
  }
}

}  // namespace romis

extern "C" int romis_neighbour_gather(const float* planes, int c_n, int h, int w,
                                      int n_nbr, int radius, const int* offs,
                                      const long long* key, unsigned int tag,
                                      float* out, cudaStream_t stream) {
  const dim3 block(romis::kGatherX, romis::kGatherY);
  const dim3 grid((w + romis::kGatherX - 1) / romis::kGatherX,
                  (h + romis::kGatherY - 1) / romis::kGatherY);
  romis::neighbour_gather_kernel<<<grid, block, 0, stream>>>(
      planes, c_n, h, w, n_nbr, radius, offs, key, tag, out);
  return static_cast<int>(cudaGetLastError());
}
