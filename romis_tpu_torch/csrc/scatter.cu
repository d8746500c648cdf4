// Kernel 13: scatter-add into a small row table, the transpose of the row
// gather (kernel 2): out[r, c] += sum over p with clamp(idx[p]) = r of
// ct[c, p].
//
// Replaces romis_tpu/ops/pallas_scatter.py scatter_rows_add / _scatter_kernel
// (a one-hot built per tile and contracted on the MXU into a VMEM
// accumulator, capped at 2048 rows). Neither the one-hot nor the cap carries
// over: here every index adds its C components to its row directly.
//
// Bound: contention, not bytes. On the flagship scene the 2 M pixels of a
// frame land on 1 material row and 2 triangle rows, and the light
// re-evaluations' 4 M indices on 512 rows; plain global atomics would
// serialise on those few addresses. So the sum is reduced in three stages:
// 1. in the warp: lanes holding the same row (__match_any_sync) sum their
//    values with shuffles, and only the group's lowest lane adds; a lane
//    alone on its row (the common case for random rows) adds directly,
//    so only lanes that share a row diverge into the shuffle loop;
// 2. in the block: into a block-private accumulator in shared memory
//    (512 x 25 x 4 B = 50 KB for the light table), with shared atomics;
//    its row stride is C rounded up to odd, so that lanes on different
//    rows hit different banks;
// 3. across blocks: one global atomicAdd per non-zero (row, component) per
//    block, from a grid capped at a few blocks per SM.
// Tables above kMaxSmemBytes skip stage 2 and add to device memory from
// stage 1. The device-memory traffic is (C + 1) x 4 B per index, read once
// and coalesced. Float atomics add in no fixed order, so the result is not
// bit-reproducible; the wrapper zero-fills `out`.
#include "common.cuh"

namespace romis {

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

template <bool kSmem>
__global__ void __launch_bounds__(kThreads)
scatter_rows_kernel(const float* __restrict__ ct, int n_cols,
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
    for (int c = 0; c < n_cols; ++c) {
      const float s = group_sum(peers, live ? ct[c * n + p] : 0.0f);
      if (live && leader) atomicAdd(acc + r * stride + c, s);
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

}  // namespace romis

extern "C" int romis_scatter_rows_add(const float* ct, int n_cols, const int* idx,
                                      long long n, int n_rows, float* out,
                                      cudaStream_t stream) {
  using namespace romis;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long want = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(
      want < static_cast<long long>(kBlocksPerSm) * sms ? want : kBlocksPerSm * sms);
  const long long smem = static_cast<long long>(n_rows) * (n_cols | 1) * sizeof(float);
  if (smem <= kMaxSmemBytes) {
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(scatter_rows_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    scatter_rows_kernel<true><<<blocks, kThreads, static_cast<size_t>(smem), stream>>>(
        ct, n_cols, idx, n, n_rows, out);
  } else {
    scatter_rows_kernel<false><<<blocks, kThreads, 0, stream>>>(ct, n_cols, idx, n,
                                                                n_rows, out);
  }
  return static_cast<int>(cudaGetLastError());
}
