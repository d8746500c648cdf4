// A leaf's triangles read from the [10, T] columns (ten floats from ten
// columns a triangle), as the walks read them before the 48-byte records
// (walk.cuh RecTris): the micros' variants that read the columns. Include
// after walk.cuh.
#pragma once

namespace romis {

struct ColTris {
  const float* __restrict__ cols;
  int n_tris;
  __device__ __forceinline__ Tri operator()(int i) const {
    return load_tri(cols + i, n_tris);
  }
};

}  // namespace romis
