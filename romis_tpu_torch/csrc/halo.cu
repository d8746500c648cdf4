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
// TPU core has no scatter. Here one thread per (d, pixel) adds its C
// cotangents at the same clamped source pixel the gather read, with global
// float atomics (so the sum's order, and its last bits, vary from run to
// run; the wrapper zero-fills `out`). Bound: device-memory bandwidth and
// atomic throughput, (C + 2) x 4 B read and C atomics per input pixel; D
// inputs land on a source pixel on average, more on the clamped border.
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

__global__ void __launch_bounds__(kThreads)
halo_scatter_kernel(const float* __restrict__ ct, int c_n, int h, int w,
                    const int* __restrict__ dy, const int* __restrict__ dx,
                    long long n_in, float* __restrict__ out) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n_in) return;
  const long long n = static_cast<long long>(h) * w;
  const long long di = idx / n, p = idx - di * n;
  const int i = static_cast<int>(p / w), j = static_cast<int>(p - static_cast<long long>(i) * w);
  const long long y = min(max(static_cast<long long>(i) + dy[idx], 0LL), static_cast<long long>(h - 1));
  const long long x = min(max(static_cast<long long>(j) + dx[idx], 0LL), static_cast<long long>(w - 1));
  const long long q = y * w + x;
  const float* cb = ct + di * c_n * n + p;
  for (int c = 0; c < c_n; ++c) {
    const float v = cb[c * n];
    if (v != 0.0f) atomicAdd(out + c * n + q, v);
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

extern "C" int romis_halo_scatter(const float* ct, int c_n, int h, int w,
                                  const int* dy, const int* dx, long long n_in,
                                  float* out, cudaStream_t stream) {
  romis::halo_scatter_kernel<<<romis::blocks_for(n_in), romis::kThreads, 0, stream>>>(
      ct, c_n, h, w, dy, dx, n_in, out);
  return static_cast<int>(cudaGetLastError());
}
