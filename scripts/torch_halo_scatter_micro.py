#!/usr/bin/env python3
"""Microbenchmark: variants of kernel 10 (the halo offset scatter,
``romis_tpu_torch/csrc/halo.cu``) at D = 5, C = 2, 1920x1080, on random
offsets within ±10 and ±3, beside ``index_add_`` and the package's own
kernel, each time with the zero-fill of the output. It shows what sets the
pace of the output-tile design and how the source-tile push compares
(``PERF.md``). Needs one NVIDIA GPU and ``nvcc``; builds the variants into
``build/romis_tpu_torch_micro/``. Run:
python3 scripts/torch_halo_scatter_micro.py [mode ...]

Modes: 0 output tiles 64x64 (a block owns an output tile and scans the
tile +- 16 for the sources landing in it: a cotangent is loaded after its
offsets), 1 the same with a racy shared add in place of the atomic, 2
cotangents loaded but not added, 3 offsets only, 4 no flush, 5 integer
shared atomics in place of the float ones (timing only: wrong sums), 6
output tiles 32x64, 16 output tiles 32x64 with the cotangents loaded beside
the offsets; 9 and 10 source-tile push (a block owns a source tile and adds
into a shared window, the tile +- 16) with 64x64 and 32x32 tiles; 11
output tiles with per-pixel lists built by integer atomics; 13, 14, 15
the push with each thread's loads of a d issued together, 32x32, 32x64 and
16x32 tiles (the package's kernel is 15's design).
"""

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CUDA_SOURCE = r'''
#include <cuda_runtime.h>
#include <stdint.h>

template <int MODE, int TH, int TW>
__global__ void __launch_bounds__(256)
k_tile(const float* __restrict__ ct, int d_n, int c_n, int h, int w,
       const int* __restrict__ dy, const int* __restrict__ dx, float* __restrict__ out) {
  constexpr int M = 16, WH = TH + 2 * M, WW = TW + 2 * M, COLS = WW / 32, ROWS = 8;
  extern __shared__ float acc[];
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int cc = c_n;  // c_n <= 2 here
  const int n = h * w;
  for (int e = threadIdx.x; e < cc * TH * TW; e += 256) acc[e] = 0.0f;
  __syncthreads();
  const int lane = threadIdx.x & 31, row = threadIdx.x >> 5;
  for (int di = 0; di < d_n; ++di) {
    const int* dyd = dy + di * n; const int* dxd = dx + di * n;
    const float* ctd = ct + di * c_n * n;
    for (int wy = row; wy < WH; wy += ROWS) {
      const int i = y0 - M + wy;
      if (i < 0 || i >= h) continue;
      int oy[COLS], ox[COLS];
#pragma unroll
      for (int m = 0; m < COLS; ++m) {
        const int j = x0 - M + 32 * m + lane;
        const bool in = j >= 0 && j < w;
        oy[m] = in ? __ldg(dyd + i * w + j) : 0;
        ox[m] = in ? __ldg(dxd + i * w + j) : 0;
      }
#pragma unroll
      for (int m = 0; m < COLS; ++m) {
        const int j = x0 - M + 32 * m + lane;
        if (j < 0 || j >= w) continue;
        const int p = i * w + j;
        const int ty = min(max(i + oy[m], 0), h - 1), tx = min(max(j + ox[m], 0), w - 1);
        const bool near = abs(ty - i) <= M && abs(tx - j) <= M;
        if (MODE == 3) { if (!near && ty == -5) out[0] = 1.f; continue; }
        if (near) {
          if (ty < y0 || ty >= y0 + TH || tx < x0 || tx >= x0 + TW) continue;
          float* a = acc + (ty - y0) * TW + (tx - x0);
          for (int c = 0; c < cc; ++c) {
            const float v = __ldg(ctd + c * n + p);
            if (MODE == 0 || MODE == 4) { if (v != 0.0f) atomicAdd(a + c * TH * TW, v); }
            else if (MODE == 1) { a[c * TH * TW] += v; }
            else if (MODE == 2) { if (v == 12345.f) a[c * TH * TW] = v; }
            else if (MODE == 5) { atomicAdd(reinterpret_cast<int*>(a + c * TH * TW), __float2int_rn(v * 1048576.f)); }
          }
        } else if (i >= y0 && i < y0 + TH && j >= x0 && j < x0 + TW) {
          const int q = ty * w + tx;
          for (int c = 0; c < cc; ++c) {
            const float v = __ldg(ctd + c * n + p);
            if (v != 0.0f) atomicAdd(out + c * n + q, v);
          }
        }
      }
    }
  }
  __syncthreads();
  if (MODE == 4) return;
  for (int e = threadIdx.x; e < cc * TH * TW; e += 256) {
    const int c = e / (TH * TW), t = e - c * TH * TW;
    const int i = y0 + t / TW, j = x0 + t % TW;
    const float v = acc[e];
    if (i < h && j < w && v != 0.0f) atomicAdd(out + c * n + i * w + j, v);
  }
}

// Source-tile push: a block owns a source tile, accumulates into its
// window in shared memory, flushes the window with device atomics.
template <int TH, int TW>
__global__ void __launch_bounds__(256)
k_push(const float* __restrict__ ct, int d_n, int c_n, int h, int w,
       const int* __restrict__ dy, const int* __restrict__ dx, float* __restrict__ out) {
  constexpr int M = 16, WH = TH + 2 * M, WW = TW + 2 * M;
  extern __shared__ float acc[];
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH, n = h * w;
  for (int e = threadIdx.x; e < c_n * WH * WW; e += 256) acc[e] = 0.0f;
  __syncthreads();
  for (int di = 0; di < d_n; ++di) {
    for (int e = threadIdx.x; e < TH * TW; e += 256) {
      const int i = y0 + e / TW, j = x0 + e % TW;
      if (i >= h || j >= w) continue;
      const int p = i * w + j;
      const int ty = min(max(i + __ldg(dy + di * n + p), 0), h - 1);
      const int tx = min(max(j + __ldg(dx + di * n + p), 0), w - 1);
      const bool near = abs(ty - i) <= M && abs(tx - j) <= M;
      for (int c = 0; c < c_n; ++c) {
        const float v = __ldg(ct + (di * c_n + c) * n + p);
        if (v == 0.f) continue;
        if (near) atomicAdd(acc + c * WH * WW + (ty - y0 + M) * WW + (tx - x0 + M), v);
        else atomicAdd(out + c * n + ty * w + tx, v);
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < c_n * WH * WW; e += 256) {
    const int c = e / (WH * WW), t = e - c * WH * WW;
    const int i = y0 - M + t / WW, j = x0 - M + t % WW;
    const float v = acc[e];
    if (i >= 0 && i < h && j >= 0 && j < w && v != 0.f) atomicAdd(out + c * n + i * w + j, v);
  }
}


// List design: per d, a counting pass puts each near in-tile source's
// window index in its target's slot list (integer shared atomics), then
// each thread sums its own pixels' lists into registers.
template <int CAP>
__global__ void __launch_bounds__(256)
k_list(const float* __restrict__ ct, int d_n, int c_n, int h, int w,
       const int* __restrict__ dy, const int* __restrict__ dx, float* __restrict__ out) {
  constexpr int T = 64, M = 16, WIN = T + 2 * M, COLS = WIN / 32, ROWS = 8, NPIX = T * T, PER = NPIX / 256;
  __shared__ int cnt[NPIX];
  __shared__ unsigned short lst[NPIX * CAP];
  const int x0 = blockIdx.x * T, y0 = blockIdx.y * T, n = h * w;
  float acc[2][PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) acc[0][q] = acc[1][q] = 0.f;
  for (int e = threadIdx.x; e < NPIX; e += 256) cnt[e] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31, row = threadIdx.x >> 5;
  for (int di = 0; di < d_n; ++di) {
    const int* dyd = dy + di * n; const int* dxd = dx + di * n;
    const float* ctd = ct + di * c_n * n;
    for (int wy = row; wy < WIN; wy += ROWS) {
      const int i = y0 - M + wy;
      if (i < 0 || i >= h) continue;
      int oy[COLS], ox[COLS];
#pragma unroll
      for (int m = 0; m < COLS; ++m) {
        const int j = x0 - M + 32 * m + lane;
        const bool in = j >= 0 && j < w;
        oy[m] = in ? __ldg(dyd + i * w + j) : 0;
        ox[m] = in ? __ldg(dxd + i * w + j) : 0;
      }
#pragma unroll
      for (int m = 0; m < COLS; ++m) {
        const int wx = 32 * m + lane, j = x0 - M + wx;
        if (j < 0 || j >= w) continue;
        const int p = i * w + j;
        const int ty = min(max(i + oy[m], 0), h - 1), tx = min(max(j + ox[m], 0), w - 1);
        const bool near = abs(ty - i) <= M && abs(tx - j) <= M;
        if (near) {
          if (ty < y0 || ty >= y0 + T || tx < x0 || tx >= x0 + T) continue;
          const int t = (ty - y0) * T + (tx - x0);
          const int slot = atomicAdd(cnt + t, 1);
          if (slot < CAP) {
            lst[t * CAP + slot] = static_cast<unsigned short>(wy * WIN + wx);
          } else {
            for (int c = 0; c < c_n; ++c) {
              const float v = __ldg(ctd + c * n + p);
              if (v != 0.f) atomicAdd(out + c * n + ty * w + tx, v);
            }
          }
        } else if (i >= y0 && i < y0 + T && j >= x0 && j < x0 + T) {
          for (int c = 0; c < c_n; ++c) {
            const float v = __ldg(ctd + c * n + p);
            if (v != 0.f) atomicAdd(out + c * n + ty * w + tx, v);
          }
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int t = threadIdx.x + q * 256;
      const int m = min(cnt[t], CAP);
      for (int e = 0; e < m; ++e) {
        const int widx = lst[t * CAP + e];
        const int p = (y0 - M + widx / WIN) * w + (x0 - M + widx % WIN);
        acc[0][q] += __ldg(ctd + p);
        if (c_n > 1) acc[1][q] += __ldg(ctd + n + p);
      }
      cnt[t] = 0;
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int t = threadIdx.x + q * 256;
    const int i = y0 + t / T, j = x0 + t % T;
    if (i >= h || j >= w) continue;
    if (acc[0][q] != 0.f) atomicAdd(out + i * w + j, acc[0][q]);
    if (c_n > 1 && acc[1][q] != 0.f) atomicAdd(out + n + i * w + j, acc[1][q]);
  }
}


// Push with batched loads: each thread loads its S sources' offsets and
// cotangents of one d before any arithmetic.
template <int TH, int TW>
__global__ void __launch_bounds__(256)
k_push2(const float* __restrict__ ct, int d_n, int c_n, int h, int w,
        const int* __restrict__ dy, const int* __restrict__ dx, float* __restrict__ out) {
  constexpr int M = 16, WH = TH + 2 * M, WW = TW + 2 * M, PER = TH * TW / 256;
  __shared__ float acc[2 * WH * WW];
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH, n = h * w;
  for (int e = threadIdx.x; e < c_n * WH * WW; e += 256) acc[e] = 0.0f;
  __syncthreads();
  for (int di = 0; di < d_n; ++di) {
    int oy[PER], ox[PER]; float v0[PER], v1[PER];
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int e = threadIdx.x + q * 256;
      const int i = y0 + e / TW, j = x0 + e % TW;
      const bool in = i < h && j < w;
      const int p = i * w + j;
      oy[q] = in ? __ldg(dy + di * n + p) : 0;
      ox[q] = in ? __ldg(dx + di * n + p) : 0;
      v0[q] = in ? __ldg(ct + (di * c_n) * n + p) : 0.f;
      v1[q] = in && c_n > 1 ? __ldg(ct + (di * c_n + 1) * n + p) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int e = threadIdx.x + q * 256;
      const int i = y0 + e / TW, j = x0 + e % TW;
      if (i >= h || j >= w) continue;
      const int ty = min(max(i + oy[q], 0), h - 1), tx = min(max(j + ox[q], 0), w - 1);
      const bool near = abs(ty - i) <= M && abs(tx - j) <= M;
      if (near) {
        float* a = acc + (ty - y0 + M) * WW + (tx - x0 + M);
        if (v0[q] != 0.f) atomicAdd(a, v0[q]);
        if (v1[q] != 0.f) atomicAdd(a + WH * WW, v1[q]);
      } else {
        if (v0[q] != 0.f) atomicAdd(out + ty * w + tx, v0[q]);
        if (v1[q] != 0.f) atomicAdd(out + n + ty * w + tx, v1[q]);
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < c_n * WH * WW; e += 256) {
    const int c = e / (WH * WW), t = e - c * WH * WW;
    const int i = y0 - M + t / WW, j = x0 - M + t % WW;
    const float v = acc[e];
    if (i >= 0 && i < h && j >= 0 && j < w && v != 0.f) atomicAdd(out + c * n + i * w + j, v);
  }
}

// Owner tiles with the cotangents loaded beside the offsets (no dependent
// load), 32 x 64 tiles.
__global__ void __launch_bounds__(256)
k_owner2(const float* __restrict__ ct, int d_n, int c_n, int h, int w,
         const int* __restrict__ dy, const int* __restrict__ dx, float* __restrict__ out) {
  constexpr int TH = 32, TW = 64, M = 16, WH = TH + 2 * M, WW = TW + 2 * M, COLS = WW / 32, ROWS = 8;
  __shared__ float acc[2 * TH * TW];
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH, n = h * w;
  for (int e = threadIdx.x; e < c_n * TH * TW; e += 256) acc[e] = 0.0f;
  __syncthreads();
  const int lane = threadIdx.x & 31, row = threadIdx.x >> 5;
  for (int di = 0; di < d_n; ++di) {
    for (int wy = row; wy < WH; wy += ROWS) {
      const int i = y0 - M + wy;
      if (i < 0 || i >= h) continue;
      int oy[COLS], ox[COLS]; float v0[COLS], v1[COLS];
#pragma unroll
      for (int m = 0; m < COLS; ++m) {
        const int j = x0 - M + 32 * m + lane;
        const bool in = j >= 0 && j < w;
        const int p = i * w + j;
        oy[m] = in ? __ldg(dy + di * n + p) : 0;
        ox[m] = in ? __ldg(dx + di * n + p) : 0;
        v0[m] = in ? __ldg(ct + (di * c_n) * n + p) : 0.f;
        v1[m] = in && c_n > 1 ? __ldg(ct + (di * c_n + 1) * n + p) : 0.f;
      }
#pragma unroll
      for (int m = 0; m < COLS; ++m) {
        const int j = x0 - M + 32 * m + lane;
        if (j < 0 || j >= w) continue;
        const int ty = min(max(i + oy[m], 0), h - 1), tx = min(max(j + ox[m], 0), w - 1);
        const bool near = abs(ty - i) <= M && abs(tx - j) <= M;
        if (near) {
          if (ty < y0 || ty >= y0 + TH || tx < x0 || tx >= x0 + TW) continue;
          float* a = acc + (ty - y0) * TW + (tx - x0);
          if (v0[m] != 0.f) atomicAdd(a, v0[m]);
          if (v1[m] != 0.f) atomicAdd(a + TH * TW, v1[m]);
        } else if (i >= y0 && i < y0 + TH && j >= x0 && j < x0 + TW) {
          if (v0[m] != 0.f) atomicAdd(out + ty * w + tx, v0[m]);
          if (v1[m] != 0.f) atomicAdd(out + n + ty * w + tx, v1[m]);
        }
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < c_n * TH * TW; e += 256) {
    const int c = e / (TH * TW), t = e - c * TH * TW;
    const int i = y0 + t / TW, j = x0 + t % TW;
    const float v = acc[e];
    if (i < h && j < w && v != 0.f) atomicAdd(out + c * n + i * w + j, v);
  }
}

template <int MODE, int TH, int TW>
static int run_tile(const float* ct, int d, int c, int h, int w, const int* dy, const int* dx, float* out, cudaStream_t s) {
  size_t smem = (size_t)c * TH * TW * 4;
  if (smem > 48 * 1024) cudaFuncSetAttribute(k_tile<MODE, TH, TW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 g((w + TW - 1) / TW, (h + TH - 1) / TH);
  k_tile<MODE, TH, TW><<<g, 256, smem, s>>>(ct, d, c, h, w, dy, dx, out);
  return (int)cudaGetLastError();
}

extern "C" int exp_halo(int mode, const float* ct, int d, int c, int h, int w, const int* dy, const int* dx, float* out, cudaStream_t s) {
  switch (mode) {
    case 0: return run_tile<0, 64, 64>(ct, d, c, h, w, dy, dx, out, s);
    case 1: return run_tile<1, 64, 64>(ct, d, c, h, w, dy, dx, out, s);
    case 2: return run_tile<2, 64, 64>(ct, d, c, h, w, dy, dx, out, s);
    case 3: return run_tile<3, 64, 64>(ct, d, c, h, w, dy, dx, out, s);
    case 4: return run_tile<4, 64, 64>(ct, d, c, h, w, dy, dx, out, s);
    case 5: return run_tile<5, 64, 64>(ct, d, c, h, w, dy, dx, out, s);
    case 6: return run_tile<0, 32, 64>(ct, d, c, h, w, dy, dx, out, s);
    case 9: {
      constexpr int TH = 64, TW = 64;
      size_t smem = (size_t)c * (TH + 32) * (TW + 32) * 4;
      if (smem > 48 * 1024) cudaFuncSetAttribute(k_push<TH, TW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      dim3 g((w + TW - 1) / TW, (h + TH - 1) / TH);
      k_push<TH, TW><<<g, 256, smem, s>>>(ct, d, c, h, w, dy, dx, out);
      return (int)cudaGetLastError();
    }
    case 10: {
      constexpr int TH = 32, TW = 32;
      size_t smem = (size_t)c * (TH + 32) * (TW + 32) * 4;
      dim3 g((w + TW - 1) / TW, (h + TH - 1) / TH);
      k_push<TH, TW><<<g, 256, smem, s>>>(ct, d, c, h, w, dy, dx, out);
      return (int)cudaGetLastError();
    }
    case 13: { dim3 g((w + 31) / 32, (h + 31) / 32); k_push2<32, 32><<<g, 256, 0, s>>>(ct, d, c, h, w, dy, dx, out); return (int)cudaGetLastError(); }
    case 14: { dim3 g((w + 63) / 64, (h + 31) / 32); k_push2<32, 64><<<g, 256, 0, s>>>(ct, d, c, h, w, dy, dx, out); return (int)cudaGetLastError(); }
    case 15: { dim3 g((w + 31) / 32, (h + 15) / 16); k_push2<16, 32><<<g, 256, 0, s>>>(ct, d, c, h, w, dy, dx, out); return (int)cudaGetLastError(); }
    case 16: { dim3 g((w + 63) / 64, (h + 31) / 32); k_owner2<<<g, 256, 0, s>>>(ct, d, c, h, w, dy, dx, out); return (int)cudaGetLastError(); }
    case 11: {
      dim3 g((w + 63) / 64, (h + 63) / 64);
      k_list<4><<<g, 256, 0, s>>>(ct, d, c, h, w, dy, dx, out);
      return (int)cudaGetLastError();
    }
  }
  return -1;
}
'''

MODES = (0, 1, 2, 3, 4, 5, 6, 16, 9, 10, 11, 13, 14, 15)


def main() -> None:
    import torch

    import chip_smoke
    from romis_tpu_torch.ops import _build, spatial

    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is False")
    out_dir = ROOT / "build" / "romis_tpu_torch_micro"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib_path = out_dir / "halo_variants.cu", out_dir / "libhalo_variants.so"
    src.write_text(CUDA_SOURCE)
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-std=c++17", "--fmad=false", "-Xcompiler", "-fPIC",
                    "-shared", "-Xptxas", "-v", "-o", str(lib_path), str(src)],
                   check=True)
    lib = ctypes.CDLL(str(lib_path))
    p_, i_ = ctypes.c_void_p, ctypes.c_int
    lib.exp_halo.argtypes = [i_, p_, i_, i_, i_, i_, p_, p_, p_, p_]
    lib.exp_halo.restype = i_
    modes = [int(a) for a in sys.argv[1:]] or MODES
    h, w, d_n, c_n = chip_smoke.H, chip_smoke.W, 5, 2
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(3)
    ct = torch.randn((d_n, c_n, h, w), generator=g, device=dev)
    card = chip_smoke.card_line()
    print(card)
    for r in (10, 3):
        dy, dx = (a.int().contiguous() for a in spatial.clamped_offsets(
            torch.randint(-r, r + 1, (2, d_n, h, w), generator=g,
                          device=dev, dtype=torch.int32), h, w))
        plain = spatial.halo_offset_scatter_plain(ct, dy, dx)
        mag = spatial.halo_offset_scatter_plain(ct.abs(), dy, dx
                                                ).clamp_min(1e-30)
        q = (torch.clamp(torch.arange(h, device=dev)[:, None] + dy.long(), 0,
                         h - 1) * w
             + torch.clamp(torch.arange(w, device=dev)[None] + dx.long(), 0,
                           w - 1)).reshape(-1)
        src_ct = ct.movedim(1, 0).reshape(c_n, -1).contiguous()

        def variant(mode):
            out = torch.zeros((c_n, h, w), device=dev)
            err = lib.exp_halo(mode, ct.data_ptr(), d_n, c_n, h, w,
                               dy.data_ptr(), dx.data_ptr(), out.data_ptr(),
                               torch.cuda.current_stream().cuda_stream)
            if err:
                chip_smoke.fail(f"mode {mode}: CUDA error {err}")
            return out

        ms = chip_smoke.cuda_ms
        print(f"±{r}: zero-fill {ms(torch, lambda: torch.zeros((c_n, h, w), device=dev), 50):.4f} ms, "
              f"index_add_ {ms(torch, lambda: torch.zeros((c_n, h * w), device=dev).index_add_(1, q, src_ct), 30):.4f} ms, "
              f"the package's kernel {ms(torch, lambda: spatial.halo_offset_scatter(ct, dy, dx), 30):.4f} ms [{card}]")
        for mode in modes:
            err = ((variant(mode) - plain).abs() / mag).max().item()
            t = ms(torch, lambda: variant(mode), 30)
            print(f"±{r} mode {mode}: {t:.4f} ms, max err / sum|ct| "
                  f"{err:.2e} [{card}]")


if __name__ == "__main__":
    main()
