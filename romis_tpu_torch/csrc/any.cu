// Kernel 6: boolean any-hit of segment batches against a triangle soup.
//
// Replaces romis_tpu/ops/pallas_trace.py pallas_any / _any_kernel (with
// occlusion_into): occluded = some triangle at t in (0, t_max). The
// wrapper keeps the leading sample axes as `planes` of H x W segments:
// origins and directions [planes, 3, H, W], t_max and out [planes, H, W].
// The test is ops/intersect._mt (Moller-Trumbore with the reciprocal of
// the determinant, mt_tri in common.cuh), so the bool is the plain
// intersect_any's on every segment.
//
// A soup of more than kZBlock triangles is culled as the TPU kernel culls
// it (occlusion_into skips a 16-triangle block whose box no pending ray
// overlaps) and as kernel 4 culls its shadow rays: the wrapper's blocks
// (ops/trace.zcount_blocks, built once a soup) are staged with their grown
// boxes and the near-parallel guard's data into shared memory once a
// persistent thread block (stage_cull), and each segment walks them with
// cull.cuh's soup_any, kernel 4's walk (the box over [0, t_max], the guard
// where the box rejects it, a block's triangles dealt out to the warp when
// few lanes need it, the first hit ending the segment); unlike kernel 4
// it defers no block's guard. The guard takes each direction's unit
// vector and the window's length t_max·|d|, so directions of any length
// are culled exactly (ops/trace.any_hit_culled is the plain model of the
// walk). A pixel's planes go to adjacent lanes (PixelMap: the initial
// check's segments of a pixel leave nearly one point), the pixels row by
// row. Bound: operations, the walk's
// box and triangle tests (the box alone deciding; the guard's printed
// apart) and three reciprocals a segment.
//
// A soup of at most kZBlock triangles (the flagship's 2, padded to 8) has
// nothing to cull: it is staged as given (stage_direct) and each segment
// tests its triangles up to the last active one, the padding left out,
// row by row. Bound: bytes, 7 floats in and a byte out a segment.
#include <algorithm>

#include "cull.cuh"

namespace romis {

template <bool kMany>
constexpr int any_threads() { return kMany ? 1024 : 256; }
// No block's guard deferred: a second pass that few lanes keep alive
// costs more here than the guards it saves (kernel 4 defers the flagged
// blocks').
constexpr int kAnyDefer = kDeferNone;

extern __shared__ float any_smem[];

template <bool kMany, class Map, int kDefer>
__global__ void __launch_bounds__(any_threads<kMany>())
any_hit_kernel(const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ t_max, int h, int w, int planes,
               const float* __restrict__ cols, const float* __restrict__ boxes,
               const float* __restrict__ normals, int n_tris,
               unsigned char* __restrict__ out) {
  const CullSoup s = kMany ? stage_cull(any_smem, cols, boxes, normals, n_tris)
                           : stage_direct(any_smem, cols, n_tris);
  __syncthreads();
  const int end = kMany ? 0 : active_end(s);
  const long long n = static_cast<long long>(h) * w;
  const long long slots = kMany ? Map::slots(h, w, planes) : n * planes;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < slots; i += stride) {  // whole warps on a culled soup
    const long long r = kMany ? Map::seg(i, h, w, planes) : i;
    const bool live = r >= 0;
    SegRay q{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (live) {
      const long long base = r / n * 3 * n + r % n;
      q = SegRay{o[base], o[base + n], o[base + 2 * n], d[base], d[base + n],
                 d[base + 2 * n], t_max[r]};
    }
    // t_max <= 0 (or NaN) hits nothing: the segment is not traced.
    const bool occluded = soup_any<kMany>(s, MtTris{s.tri, s.n_tris},
                                          MtGuard<false, kDefer>{s}, end,
                                          live && q.tm > 0.0f, q);
    if (live) out[r] = occluded ? 1 : 0;
  }
}

namespace {
PersistentGrid any_grids[2];  // [kMany]
}  // namespace

template <bool kMany, class Map = PixelMap, int kDefer = kAnyDefer>
int launch_any(PersistentGrid& grids, const float* o, const float* d, const float* t_max,
               int h, int w, int planes, const float* cols, const float* boxes,
               const float* normals, int n_tris, unsigned char* out, cudaStream_t stream) {
  const size_t smem = kMany ? cull_smem_bytes(n_tris)
                            : sizeof(float) * 10 * static_cast<size_t>(n_tris);
  auto kernel = any_hit_kernel<kMany, Map, kDefer>;
  constexpr int kThr = any_threads<kMany>();
  int blocks = 0;
  const int err = persistent_blocks(grids, kernel, kThr, smem, blocks);
  if (err != 0) return err;
  const long long slots = kMany ? Map::slots(h, w, planes)
                                : static_cast<long long>(h) * w * planes;
  const int grid = static_cast<int>(std::min<long long>((slots + kThr - 1) / kThr, blocks));
  kernel<<<grid, kThr, smem, stream>>>(o, d, t_max, h, w, planes, cols, boxes, normals,
                                       n_tris, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace romis

// A culled soup: cols [10, T] block-ordered, T a multiple of kZBlock above
// it (at most 2048), boxes [13, T / kZBlock], normals [5, T]
// (ops/trace.zcount_blocks). A soup of at most kZBlock triangles: its cols
// [10, T] as given (T may be 0), boxes and normals null.
extern "C" int romis_any_hit(const float* o, const float* d, const float* t_max, int h,
                             int w, int planes, const float* cols, const float* boxes,
                             const float* normals, int n_tris, unsigned char* out,
                             cudaStream_t stream) {
  using namespace romis;
  const bool many = boxes != nullptr;
  if (many ? (normals == nullptr || n_tris <= kZBlock || n_tris % kZBlock != 0 ||
              n_tris > 2048)
           : (normals != nullptr || n_tris < 0 || n_tris > kZBlock))
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(h) * w * planes == 0) return 0;
  return many ? launch_any<true>(any_grids[1], o, d, t_max, h, w, planes, cols, boxes,
                                 normals, n_tris, out, stream)
              : launch_any<false>(any_grids[0], o, d, t_max, h, w, planes, cols, boxes,
                                  normals, n_tris, out, stream);
}
